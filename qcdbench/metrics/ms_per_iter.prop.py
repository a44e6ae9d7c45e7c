"""ms_per_iter.prop: the untraced window's milliseconds over its CG
iterations: the batched operator and the solver's vector work and host syncs
together."""


def read(ctx):
    iters = sum(r["cg_iters"] for r in ctx.records)
    return 1e3 * ctx.window_s / iters if iters else None
