"""The general traffic generator and the drivers of the system under test.

A traffic file names its `kind` and the parameters of that kind:

* "trajectories": back-to-back HMC trajectories of the configuration's `hmc`
  action through the port's `config.build_hmc` and `hmc.hmc_trajectory`,
  from a start (`"hot"`: random links from the seed), with the momenta,
  pseudofermion noise and Metropolis uniform of trajectory k drawn from
  (seed, k) and handed in as `Draws`; the chronological solver guesses carry
  over from trajectory to trajectory, as in `cli.hmc`.
* "propagators": point-source propagators back to back on the
  configuration's smooth field (`fields.smooth_field`), each the `columns`
  spin-colour columns of one source, solved as one `inverter.invert_eo_rhs`
  batch with the configuration's `operator` and unpacked to the full
  lattice.  The sources cycle through a fixed set of `sites` sites (drawn
  from the traffic's `site_seed`) in an order drawn from the seed: the
  iterations depend on the site, and a set drawn anew from each seed made
  the seeds do different work.

Each driver has `warm_up()` (the cell's own shapes, discarded), `unit(k)`
(one unit, the device synchronised; returns its record), `abandon()` (the
last unit ended after the cut and does not count), `release()` (frees
the program's state once the window has closed) and `check(records, seed)`
(the numbers compared with the reference, each beside its limit).  Only
`__init__`, `warm_up` and `unit` touch the program.
"""

from __future__ import annotations

import math

import torch

import fields
from reference import hmc as ref_hmc
from reference import ops


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Trajectories:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device, log):
        from tmlqcd_tpu_torch.config import IntegratorSpec, MonomialSpec, RunConfig, build_hmc
        from tmlqcd_tpu_torch.hmc import chrono_states

        self.cfg, self.traffic, self.seed, self.device, self.log = cfg, traffic, seed, device, log
        self.dims = fields.dims_of(cfg)
        self.action = h = dict(cfg["hmc"], gauge_action=cfg["gauge"]["action"],
                               beta=cfg["gauge"]["beta"])
        specs = tuple(MonomialSpec(
            type=m["type"], timescale=m["timescale"], kappa=m.get("kappa", 0.0),
            two_kappa_mu=m.get("2KappaMu", 0.0), two_kappa_mu2=m.get("2KappaMu2", 0.0),
            acceptance_precision=m.get("AcceptancePrecision", 1e-18),
            force_precision=m.get("ForcePrecision", 1e-16),
            max_solver_iterations=m.get("MaxSolverIterations", 5000),
            theta=tuple(m.get("theta", (1.0, 0.0, 0.0, 0.0)))) for m in h["monomials"])
        t, x, y, z = self.dims

        def run_config(steps):
            return RunConfig(t=t, lx=x, ly=y, lz=z, beta=h["beta"],
                             gauge_action=h["gauge_action"], monomials=specs,
                             integrator=IntegratorSpec(
                                 tau=h["tau"], steps=tuple(steps),
                                 types=(h["integrator"]["scheme"],) * len(steps)))

        self.hmc = build_hmc(run_config(h["integrator"]["steps"]))
        self.hmc_warm = build_hmc(run_config([1] * len(h["integrator"]["steps"])))
        self.maxiter = [m.get("MaxSolverIterations", 5000) for m in h["monomials"]]
        self._chrono_states = chrono_states
        if traffic["start"] != "hot":
            raise ValueError(f"unknown start {traffic['start']!r}")
        self.u = fields.hot_field(self.dims, seed, device)
        self.chrono = chrono_states(self.hmc, device)
        self.inputs = []

    def draws(self, k):
        from tmlqcd_tpu_torch.hmc import Draws

        gen = fields.generator(self.device, "draws", self.seed, k)
        t, x, y, z = self.dims
        mom = fields.momenta((4, t, x, y * z), gen, self.device)
        etas = [None if m["type"].upper() == "GAUGE"
                else fields.gaussian((4, 3, t, x, y * z // 2), gen, self.device)
                for m in self.cfg["hmc"]["monomials"]]
        uni = float(torch.rand((), generator=gen, device=self.device))
        return Draws(momenta=mom, etas=etas, uniform=uni)

    def _trajectory(self, hmc, u, draws, chrono):
        from tmlqcd_tpu_torch import rng
        from tmlqcd_tpu_torch.hmc import hmc_trajectory

        with torch.no_grad():
            out = hmc_trajectory(hmc, u, rng.Key(0), chrono, draws=draws)
        _sync(self.device)
        return out

    def warm_up(self):
        self._trajectory(self.hmc_warm, self.u, self.draws(-1),
                         self._chrono_states(self.hmc_warm, self.device))

    def unit(self, k):
        u_in = self.u
        self.u, st, self.chrono = self._trajectory(self.hmc, u_in, self.draws(k), self.chrono)
        self.inputs.append(u_in)
        iters = sum(st.acc_iterations) + sum(st.force_iterations)
        failed = (not math.isfinite(st.delta_h)
                  or any(i >= m for i, m in zip(st.acc_iterations, self.maxiter) if m))
        return {"k": k, "cg_iters": iters, "dh": st.delta_h, "accepted": st.accepted,
                "plaquette": st.plaquette, "failed": failed}

    def abandon(self):
        pass  # the chain goes on from the links it returned

    def release(self):
        # unit k's input links are chain[k], the links it returned chain[k + 1]
        self.chain = self.inputs + [self.u]
        self.hmc = self.hmc_warm = self.chrono = self.u = self.inputs = None

    def reference(self, rec: dict) -> dict:
        """The reference's trajectory on unit rec's input links and draws,
        with the links the program returned beside it (reference layout)."""
        d = self.draws(rec["k"])
        u_in = fields.to_reference(self.chain[rec["k"]], self.dims)
        out = ref_hmc.trajectory(self.action, u_in, fields.to_reference(d.momenta, self.dims),
                                 list(d.etas))
        out.update(u_in=u_in, u_prog=fields.to_reference(self.chain[rec["k"] + 1], self.dims),
                   uniform=d.uniform)
        return out

    @staticmethod
    def judge(rec: dict, ref: dict, u_prog: torch.Tensor) -> dict:
        """The numbers compared: `dh_rel`, |dH_program - dH_reference| per
        unit of the energy the trajectory moved between momenta and links
        (from a hot start some 10^6 move and dH is their small difference,
        so f32 on either side reads ~1e-7 of it, bfloat16 ~3e-3);
        `accept`, 1 where the program's accept decision is not the
        reference's (uniform < exp(-dH)), unless the two dH, each sound,
        lie on either side of the threshold; `link_gap`, the largest
        |U_program - U_expected| over every link element of the links the
        program returned, U_expected the reference's evolved links if the
        trajectory is accepted, else its input links."""
        def takes(dh):
            return ref["uniform"] < math.exp(min(-dh, 700.0))

        expected = takes(ref["dh"]) if takes(ref["dh"]) == takes(rec["dh"]) else rec["accepted"]
        u_exp = ref["u"] if expected else ref["u_in"]
        return {"dh_rel": abs(rec["dh"] - ref["dh"]) / max(ref["moved"], 1.0),
                "accept": float(rec["accepted"] != expected),
                "link_gap": float((u_prog - u_exp).abs().max())}

    def check(self, records: list, seed: int) -> dict:
        """The reference follows one trajectory drawn from the seed, on its
        input links and draws (`judge`)."""
        j = int(torch.randint(len(records), (), generator=fields.generator("cpu", "pick", seed)))
        rec = records[j]
        ref = self.reference(rec)
        self.chain = None
        out = self.judge(rec, ref, ref["u_prog"])
        self.log(f"[check] trajectory {rec['k']}: dH program {rec['dh']:.6f} "
                 f"reference {ref['dh']:.6f}, energy moved {ref['moved']:.1f}; accepted "
                 f"{rec['accepted']}; plaquette of the returned links program "
                 f"{ops.plaquette(ref['u_prog']):.6f} expected "
                 f"{ops.plaquette(ref['u'] if rec['accepted'] else ref['u_in']):.6f}")
        return out


class Propagators:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device, log):
        from tmlqcd_tpu_torch.lattice import Lattice
        from tmlqcd_tpu_torch.ops.wilson import DiracParams

        self.cfg, self.traffic, self.seed, self.device, self.log = cfg, traffic, seed, device, log
        self.dims = fields.dims_of(cfg)
        self.lat = Lattice(self.dims)
        op = cfg["operator"]
        kappa = op["kappa"]
        self.params = DiracParams(kappa=kappa, mu=op["2KappaMu"] / (2.0 * kappa),
                                  c_sw=op.get("csw", 0.0),
                                  theta=tuple(op.get("theta", (1.0, 0.0, 0.0, 0.0))))
        self.tol = op["SolverPrecision"] ** 0.5
        self.maxiter = op["MaxSolverIterations"]
        if traffic["source"] != "point":
            raise ValueError(f"unknown source {traffic['source']!r}")
        self.columns = traffic["columns"]
        self.u = fields.smooth_field(cfg, cfg["_path"], device, log)
        # the solutions the check reads: the one with the most iterations
        # and one drawn uniformly from the seed (a reservoir of one); the
        # last unit's waits in `pending` until it is known to have counted
        self.kept, self.pending = {}, None
        self._pick = fields.generator("cpu", "pick", seed)

    def site(self, k) -> tuple:
        """Unit k's source site: the traffic's fixed set of `sites` sites
        (drawn from its `site_seed`), each cycle through them in an order
        drawn from (seed, cycle), so that every seed does the same work."""
        n = self.traffic["sites"]
        gen = fields.generator("cpu", "sites", self.traffic["site_seed"])
        sites = [tuple(int(v) for v in torch.randint(0, 1 << 30, (4,), generator=gen))
                 for _ in range(n)]
        order = torch.randperm(n, generator=fields.generator("cpu", "order", self.seed, k // n))
        return tuple(v % d for v, d in zip(sites[int(order[k % n])], self.dims))

    def source(self, site) -> torch.Tensor:
        """The point sources of the first `columns` spin-colour pairs at a
        site: [R, 4, 3, T, X, Y*Z]."""
        t, x, y, z = site
        b = torch.zeros((self.columns, 4, 3, self.dims[0], self.dims[1],
                         self.dims[2] * self.dims[3]), dtype=torch.complex64, device=self.device)
        for r in range(self.columns):
            b[r, r // 3, r % 3, t, x, y * self.dims[3] + z] = 1.0
        return b

    def _solve(self, b, maxiter):
        from tmlqcd_tpu_torch.inverter import invert_eo_rhs

        res = invert_eo_rhs(self.u, b, self.params, self.lat, tol=self.tol, maxiter=maxiter)
        _sync(self.device)
        return res

    def warm_up(self):
        self._solve(self.source((0, 0, 0, 0)), self.traffic["warmup_iterations"])

    def _commit(self):
        rec, x = self.pending
        if "most" not in self.kept or rec["cg_iters"] > self.kept["most"][0]["cg_iters"]:
            self.kept["most"] = (rec, x)
        if float(torch.rand((), generator=self._pick)) * (rec["k"] + 1) < 1.0:
            self.kept["drawn"] = (rec, x)
        self.pending = None

    def unit(self, k):
        if self.pending is not None:  # the harness starts a unit only after one that counted
            self._commit()
        site = self.site(k)
        res = self._solve(self.source(site), self.maxiter)
        rec = {"k": k, "site": site, "cg_iters": int(res.iterations),
               "failed": int(res.iterations) >= self.maxiter}
        self.pending = (rec, res.x)
        return rec

    def abandon(self):
        self.pending = None

    def release(self):
        self.u_ref = self.u
        self.u = None

    def residuals(self, site, x: torch.Tensor) -> torch.Tensor:
        """|b - M x| / |b| of each column, M the reference's operator in
        complex128 on the same links."""
        op = self.cfg["operator"]
        u7 = fields.to_reference(self.u_ref, self.dims).to(torch.complex128)
        m = ops.Operator(u7, op["kappa"], op["2KappaMu"], op.get("csw", 0.0),
                         tuple(op.get("theta", (1.0, 0.0, 0.0, 0.0))))
        b = fields.to_reference(self.source(site), self.dims).to(torch.complex128)
        r = b - m(fields.to_reference(x, self.dims).to(torch.complex128))
        num = r.abs().pow(2).flatten(1).sum(1).sqrt()
        return num / b.abs().pow(2).flatten(1).sum(1).sqrt()

    def check(self, records: list, seed: int) -> dict:
        """Every column of the propagators kept (the one with the most
        iterations, one drawn from the seed) against the reference operator;
        only units counted in the window qualify."""
        if self.pending is not None and self.pending[0]["k"] in {r["k"] for r in records}:
            self._commit()
        worst = 0.0
        for rec, x in {v[0]["k"]: v for v in self.kept.values()}.values():
            res = self.residuals(rec["site"], x)
            self.log(f"[check] propagator {rec['k']} at {rec['site']}: "
                     f"max column residual {float(res.max()):.3e}")
            worst = max(worst, float(res.max()))
        self.kept = self.pending = None
        return {"resid": worst}


def make(kind: str, cfg, traffic, seed, device, log):
    if kind == "trajectories":
        return Trajectories(cfg, traffic, seed, device, log)
    if kind == "propagators":
        return Propagators(cfg, traffic, seed, device, log)
    raise ValueError(f"unknown traffic kind {kind!r}")
