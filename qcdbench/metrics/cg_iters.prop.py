"""cg_iters.prop: CG iterations a propagator (`InvertResult.iterations`, the
most over its columns), averaged over the propagators of the window."""


def read(ctx):
    return sum(r["cg_iters"] for r in ctx.records) / ctx.units
