"""dslash_roofline.hmc: the least time of the traced window's K1-S hops (the
Schur operators of every solve: `hopping_schur.hops`, 624 B a site and hop
on the 12-real f32 copy, 576 more with clover blocks; `yardstick`) over the
device time torch.profiler gives the kernel `hopping_schur_kernel`.  Where
the profiler reported fewer intervals than were launched, its mean interval
stands for the missing ones.  No reading with hops on a bf16 copy, whose
bytes the model does not count."""

KERNEL = "hopping_schur_kernel"


def read(ctx):
    if ctx.trace is None:
        return None
    seen, device_s = ctx.trace.kernel(KERNEL)
    c = ctx.traced.counters
    made = c.get("hopping_schur.launches", 0)
    if seen == 0 or made == 0 or c.get("hopping_schur.bf16_hops", 0):
        return None
    y = ctx.yardstick
    sites = ctx.dims[0] * ctx.dims[1] * ctx.dims[2] * ctx.dims[3] // 2
    hops, clover = c["hopping_schur.hops"], c.get("hopping_schur.clover_hops", 0)
    b = (hops * y.K1S_HOP_BYTES + clover * y.CLOVER) * sites
    f = (hops * y.FLOPS_HOP + clover * y.FLOPS_CLOVER) * sites
    return 100.0 * y.least_seconds(b, f) / (device_s * made / seen)
