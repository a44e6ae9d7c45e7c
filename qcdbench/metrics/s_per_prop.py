"""s_per_prop: the window's seconds over the propagators completed in it."""


def read(ctx):
    return ctx.window_s / ctx.units
