"""dslash_roofline.prop: the least time of the K1-R launches of the traced
window (`_prop_model`) over the device time torch.profiler gives the kernel
`hopping_rhs_kernel`; where the profiler reported fewer intervals than were
launched, its mean interval stands for the missing ones.  Where the launches
the port counts (`hopping_split_rhs.launches`, `.clover_launches`) are not
the model's, as after a change that fuses or moves a hop, the model does not
know their bytes: no reading."""

import importlib.util
import os

KERNEL = "hopping_rhs_kernel"

_spec = importlib.util.spec_from_file_location(
    "qcdbench_prop_model", os.path.join(os.path.dirname(__file__), "_prop_model.py"))
_model = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_model)


def read(ctx):
    if ctx.trace is None:
        return None
    seen, device_s = ctx.trace.kernel(KERNEL)
    if seen == 0:
        return None
    c, records = ctx.traced.counters, ctx.traced.records
    made = c.get("hopping_split_rhs.launches", 0)
    n, _, clover = _model.launches(ctx, records)
    if made != n or c.get("hopping_split_rhs.clover_launches", 0) != clover:
        ctx.log(f"[dslash_roofline.prop] the port counted {made} launches of {KERNEL}, "
                f"the model {n}: no reading")
        return None
    return 100.0 * _model.least_seconds(ctx, records) / (device_s * made / seen)
