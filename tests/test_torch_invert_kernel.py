"""The port's multi-RHS hopping K1-R (plain version) against the JAX
reference's multi-RHS Pallas kernel in interpret mode, as the reference's
own tests run it on the CPU: the 18-real gauge without epilogue and the
12-real gauge with the fused mhat + gamma5 epilogue.  The rest of the
inverter path is in tests/test_torch_invert.py; the reference's
interpret-mode builds have a file of their own so that the test runner's
workers share the load.

Inputs come from seeded numpy generators through `bridge` (the draws of
tests/test_torch_invert.py) and go to both packages as numpy arrays.

Tolerance: 1e-5 absolute on unit-normal inputs, outputs of O(10): both
sides are f32 and differ by summation order (measured 1.9e-6).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from tmlqcd_tpu.lattice import EVEN as J_EVEN
from tmlqcd_tpu.lattice import Lattice as JLattice
from tmlqcd_tpu.ops import dslash_pallas as jdp
from tmlqcd_tpu.ops import wilson as jw
from tmlqcd_tpu.ops import wilson_fast as jwf
from tmlqcd_tpu_torch import bridge
from tmlqcd_tpu_torch.lattice import EVEN, Lattice
from tmlqcd_tpu_torch.ops import dslash_cuda as dc
from tmlqcd_tpu_torch.ops import wilson as w
from tmlqcd_tpu_torch.ops import wilson_fast as wf

torch.set_num_threads(1)

DIMS = (4, 4, 4, 4)
JL, LAT = JLattice(DIMS), Lattice(DIMS)
KAPPA, MU = 0.13, 0.1
JP, TP = jw.DiracParams(kappa=KAPPA, mu=MU), w.DiracParams(kappa=KAPPA, mu=MU)
R = 3
K2 = KAPPA * KAPPA
EPILOGUES = {
    "none": ("none",),
    "mee_inv": ("mee_inv", TP.mutld, 1.0),
    "mhat+g5": ("mhat", TP.mutld, 1.0, K2, True),
    "mhat-": ("mhat", TP.mutld, -1.0, K2, False),
}


def _maxdiff(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


@pytest.fixture(scope="module")
def fields():
    u = bridge.numpy_su3(np.random.default_rng(30), (4,) + JL.site_shape)
    psis = bridge.numpy_spinor(np.random.default_rng(31), (R, 4, 3) + JL.eo_site_shape)
    psis_o = bridge.numpy_spinor(np.random.default_rng(32), (R, 4, 3) + JL.eo_site_shape)
    ut = bridge.gauge_from_numpy(u, LAT)
    return dict(u=u, ut=ut, psis=psis, psis_o=psis_o,
                p2=wf.to_split_rhs(torch.as_tensor(psis)),
                po2=wf.to_split_rhs(torch.as_tensor(psis_o)),
                fg12=wf.make_fast_gauge(ut, TP, LAT),
                fg18=wf.make_fast_gauge(ut, TP, LAT, compress=False))


@pytest.mark.parametrize("gauge, epi", [("fg18", "none"), ("fg12", "mhat+g5")])
def test_hopping_rhs_matches_reference_kernel(fields, gauge, epi):
    """The reference's multi-RHS Pallas kernel in interpret mode: the 18-real
    gauge without epilogue, and the 12-real gauge with the fused mhat + gamma5
    epilogue that the batched solve runs."""
    fg, e = fields[gauge], EPILOGUES[epi]
    jfg = jwf.make_fast_gauge(jnp.asarray(fields["u"]), JP, JL, compress=gauge == "fg12")
    p2, po2 = (jnp.asarray(bridge.to_numpy(fields[k])) for k in ("p2", "po2"))
    mhat = e[0] == "mhat"
    ref = jdp.hopping_pallas_split(jfg.ug_even, p2, J_EVEN, JL, interpret=True, epi=e,
                                   psi_o=po2 if mhat else None, gcomp=jfg.gcomp)
    out = dc.hopping_split_rhs(fg.ug_even, fields["p2"], EVEN, LAT, epi=e,
                               psi_o=fields["po2"] if mhat else None, gcomp=fg.gcomp, r_axis=3)
    assert float(np.max(np.abs(np.asarray(ref)))) > 1.0
    assert _maxdiff(out, ref) < 1e-5
