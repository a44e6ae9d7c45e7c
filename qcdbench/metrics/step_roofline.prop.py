"""step_roofline.prop: the least time of the Dirac work the propagators'
iteration counts imply (`_prop_model`, at 3.35 TB/s and 67 TF/s) over the
untraced window's seconds.  It reads the same work whatever implements it."""

import importlib.util
import os

_spec = importlib.util.spec_from_file_location(
    "qcdbench_prop_model", os.path.join(os.path.dirname(__file__), "_prop_model.py"))
_model = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_model)


def read(ctx):
    return 100.0 * _model.least_seconds(ctx, ctx.records) / ctx.window_s
