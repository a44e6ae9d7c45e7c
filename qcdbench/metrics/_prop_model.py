"""The K1-R launches a batched propagator makes and their least time, from
the benchmark's byte and flop model (`yardstick`).  Per propagator of n CG
iterations on R columns (`inverter.invert_eo_rhs`): the prologue hop (no
epilogue), the right-hand side's Qhat_- (two hops, the second reading
psi_o), the initial residual and n iterations of Qhat_pm (four hops each,
two reading psi_o), the epilogue hop: 4 n + 8 launches, 2 n + 3 of them
reading psi_o; with a clover operator every launch but the prologue's
reads the blocks."""


def launches(ctx, records):
    """(launches, launches reading psi_o, launches reading clover blocks)
    of the propagators `records`."""
    clover = ctx.cfg["operator"].get("csw", 0.0) != 0.0
    n = sum(4 * r["cg_iters"] + 8 for r in records)
    mhat = sum(2 * r["cg_iters"] + 3 for r in records)
    return n, mhat, (n - len(records)) if clover else 0


def least_seconds(ctx, records) -> float:
    y = ctx.yardstick
    r = ctx.traffic["columns"]
    sites = ctx.dims[0] * ctx.dims[1] * ctx.dims[2] * ctx.dims[3] // 2
    n, mhat, clover = launches(ctx, records)
    b = (n * y.k1r_bytes(r, False, False) + mhat * r * y.SPINOR + clover * y.CLOVER) * sites
    f = (n * r * y.FLOPS_HOP + clover * r * y.FLOPS_CLOVER) * sites
    return y.least_seconds(b, f)
