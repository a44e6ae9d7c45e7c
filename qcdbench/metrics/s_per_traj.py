"""s_per_traj: the window's seconds over the trajectories completed in it."""


def read(ctx):
    return ctx.window_s / ctx.units
