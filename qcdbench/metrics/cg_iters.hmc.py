"""cg_iters.hmc: CG iterations a trajectory, acceptance and force solves of
every monomial (`TrajectoryStats.acc_iterations` + `.force_iterations`),
averaged over the trajectories of the window."""


def read(ctx):
    return sum(r["cg_iters"] for r in ctx.records) / ctx.units
