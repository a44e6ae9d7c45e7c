"""Parity of the port's clover term with the JAX reference (tmlqcd_tpu), on
the CPU, in complex128 and complex64: the field strength and the clover
blocks (`ops/clover.py`), and the blocks' application, inverse and log
determinant.  The cases of tests/test_torch_clover.py that take seconds of
reference compiles each, in a file of at most 8 tests, which the test
runner queues behind tests/test_multirhs.py; the gauge and the spinor are
those of tests/test_torch_clover.py, drawn by its `_data`.

Tolerances: complex128 inputs, 1e-12 on entries of O(1) (the same closed
forms in f64, only the summation order differs); complex64 inputs, 2e-6
(f32 rounding of sums of ~30 terms; measured 7e-8 .. 7.5e-7).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_clover import (  # noqa: F401  (the module's autouse fixture too)
    JL,
    JP,
    LAT,
    TP,
    _data,
    _maxdiff,
    _quick_reference_compiles,
)
from tmlqcd_tpu.ops import clover as jcl
from tmlqcd_tpu_torch.ops import clover as cl

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def fields():
    return _data()


@pytest.mark.parametrize("dtype, tol", [(np.complex128, 1e-12), (np.complex64, 2e-6)])
def test_field_strength_and_sw_blocks_match_reference(fields, dtype, tol):
    u = fields["u"].astype(dtype)
    ut = torch.as_tensor(u)
    for g_out, g_ref in zip(cl.field_strength(ut, LAT), jcl.field_strength(jnp.asarray(u), JL)):
        assert _maxdiff(g_out, g_ref) < tol
        # hermitian and traceless
        assert float((g_out - torch.conj_physical(g_out.transpose(0, 1))).abs().max()) < tol
    sw = cl.sw_blocks(ut, TP.kappa, TP.c_sw, LAT)
    ref = jcl.sw_blocks(jnp.asarray(u), TP.kappa, TP.c_sw, JL)
    assert tuple(sw.shape) == (2, 2, 2, 3, 3) + LAT.site_shape
    assert float(np.max(np.abs(np.asarray(ref)))) > 0.05
    assert _maxdiff(sw, ref) < tol


@pytest.mark.parametrize("dtype, tol", [(np.complex128, 1e-12), (np.complex64, 2e-6)])
def test_sw_apply_inverse_and_logdet_match_reference(fields, dtype, tol):
    u = fields["u"].astype(dtype)
    psi = fields["psi"].astype(dtype)
    sw_e, _ = cl.sw_blocks_eo(torch.as_tensor(u), TP.kappa, TP.c_sw, LAT)
    jsw_e, _ = jcl.sw_blocks_eo(jnp.asarray(u), TP.kappa, TP.c_sw, JL)
    pt = torch.as_tensor(psi)
    for sign in (+1.0, -1.0):
        out = cl.sw_apply(sw_e, pt, TP.mutld, sign)
        assert _maxdiff(out, jcl.sw_apply(jsw_e, jnp.asarray(psi), JP.mutld, sign)) < tol
        inv = cl.sw_inv_apply(sw_e, pt, TP.mutld, sign)
        assert _maxdiff(inv, jcl.sw_inv_apply(jsw_e, jnp.asarray(psi), JP.mutld, sign)) < tol
        # sw_inv_apply(sw_apply(psi)) = psi
        assert _maxdiff(cl.sw_inv_apply(sw_e, out, TP.mutld, sign), psi) < 10 * tol
    ld, ld_ref = float(cl.sw_logdet(sw_e, TP.mutld)), float(jcl.sw_logdet(jsw_e, JP.mutld))
    # a sum of 256 f64 logs of f32 (or f64) determinants of O(1)
    assert abs(ld - ld_ref) < 256 * tol and abs(ld_ref) > 1.0
