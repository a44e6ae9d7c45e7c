"""step_roofline.hmc: the least time of the Dirac work the trajectories'
iteration counts imply, over the untraced window's seconds: one Qhat_pm
(four hops, `yardstick.qpm_seconds`) for each CG iteration and for each
solve's initial residual, and one Mhat (two hops) for each force's
Qhat_+ X.  The solves are the acceptance solve and the force evaluations of
every fermion monomial (the nested 2MN schedule of `reference.hmc`, kicks
with no drift between them summed).  The heatbath's solves, the
chronological guesses and the force surrogates' hops are left out, so it is
a lower bound.  It reads the same work whatever implements it."""

from reference import hmc as ref_hmc


def _force_evaluations(h: dict) -> list:
    pending = [False] * len(h["monomials"])
    counts = [0] * len(h["monomials"])
    for ev in ref_hmc.schedule(h["integrator"]["steps"], h["tau"]) + [("drift", 0.0)]:
        if ev[0] == "kick":
            for i, m in enumerate(h["monomials"]):
                pending[i] |= m["timescale"] == ev[1]
        else:
            counts = [n + p for n, p in zip(counts, pending)]
            pending = [False] * len(pending)
    return counts


def read(ctx):
    h = ctx.cfg["hmc"]
    forces = [n for n, m in zip(_force_evaluations(h), h["monomials"])
              if m["type"].upper() != "GAUGE"]
    solves = sum(n + 1 for n in forces)
    sites = ctx.dims[0] * ctx.dims[1] * ctx.dims[2] * ctx.dims[3] // 2
    clover = any(m.get("csw", 0.0) for m in h["monomials"])
    qpm = ctx.yardstick.qpm_seconds(sites, 1, clover)
    iters = sum(r["cg_iters"] for r in ctx.records)
    work = (iters + solves * ctx.units) * qpm + 0.5 * sum(forces) * ctx.units * qpm
    return 100.0 * work / ctx.window_s
