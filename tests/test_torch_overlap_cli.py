"""`cli.invert --cpu` with an OVERLAP block: the setup line, one point
column, its true residual on the same setup and the npz propagator.  The
inverter's Lanczos setup and SUMR solve take seconds, so this case has a
file of its own, which the test runner queues behind
tests/test_multirhs.py; the overlap operator's own checks are in
tests/test_torch_overlap.py.
"""

import numpy as np
import torch

from test_torch_overlap import LAT, _rel
from tmlqcd_tpu_torch import bridge
from tmlqcd_tpu_torch.ops import overlap as ov

torch.set_num_threads(1)


def test_cli_invert_overlap_cpu(tmp_path):
    """`cli.invert --cpu` with an OVERLAP block (an unknown solver name runs
    SUMR, as in the reference): the setup line, one point column, its true
    residual |D_ov x - b| / |b| on the same setup (the CLI draws the Lanczos
    start from the default key) at the solver's tolerance 1e-5 (measured
    5.4e-6), and the npz propagator."""
    from tmlqcd_tpu_torch.cli import invert as cli
    from tmlqcd_tpu_torch.io.checkpoint import save_checkpoint
    from tmlqcd_tpu_torch.meas.sources import point_source

    u = bridge.gauge_from_numpy(bridge.numpy_smooth_su3(np.random.default_rng(5),
                                                        (4,) + LAT.site_shape), LAT)
    conf = save_checkpoint(str(tmp_path), u, 3, 1, LAT)
    inp = tmp_path / "ov.input"
    inp.write_text("L = 4\nT = 4\nBeginOperator OVERLAP\n m = 0.3\n s = 0.0\n"
                   " DegreeOfSignFunction = 16\n NoEigenvalues = 2\n SolverPrecision = 1e-10\n"
                   " Solver = bogus\nEndOperator\n")
    out = tmp_path / "props"
    assert cli.main(["-f", str(inp), "-c", conf, "--format", "npz", "--columns", "1", "-o",
                     str(out), "--cpu"]) == 0
    with np.load(out / "propagator.00.000003.npz") as z:
        x = z["propagator"]
    assert x.shape == (1, 4, 3) + LAT.site_shape
    s = ov.make_overlap(u, ov.OverlapParams(rho=1.0, m=0.3, degree=16, n_ev=2), LAT)
    b = point_source(LAT, 0, 0, (0, 0, 0, 0), device="cpu")
    assert _rel(ov.dov_psi(s, torch.as_tensor(x[0])), b) <= 1e-5
