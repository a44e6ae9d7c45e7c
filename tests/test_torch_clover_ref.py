"""Parity of the port's twisted-clover operator with the JAX reference's
(tmlqcd_tpu) on the reference's own clover blocks, on the CPU: the 6 x 6
block algebra (`ops/clover.py`), Qsw_pm and the fused Schur complement
against the reference's jnp operators, and the split-field operators
(`ops/wilson_fast.py`) on both packages' blocks, moved across by `bridge`.
The reference's blocks and operators compile for seconds, so these cases
have a file of at most 8 tests, which the test runner queues behind
tests/test_multirhs.py; the rest of the clover operator is in
tests/test_torch_clover.py, whose `_data` draws the gauge and spinors here.

Tolerances, each derived where it is used:
* complex64 inputs: 2e-6 on blocks and single applications (entries of O(1),
  f32 rounding of sums of ~30 terms; measured 7e-8 .. 7.5e-7), 1e-5 on Qsw_pm
  (two Schur complements, outputs of O(5); measured 7.2e-7).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from test_torch_clover import (  # noqa: F401  (the module's autouse fixture too)
    JL,
    JP,
    LAT,
    TP,
    _data,
    _maxdiff,
    _quick_reference_compiles,
)
from tmlqcd_tpu.lattice import pack_gauge_eo as j_pack
from tmlqcd_tpu.ops import clover as jcl
from tmlqcd_tpu.ops import wilson as jw
from tmlqcd_tpu.ops import wilson_fast as jwf
from tmlqcd_tpu_torch import bridge
from tmlqcd_tpu_torch import gamma as tgamma
from tmlqcd_tpu_torch.lattice import pack_gauge_eo
from tmlqcd_tpu_torch.ops import clover as cl
from tmlqcd_tpu_torch.ops import dslash_cuda as dc
from tmlqcd_tpu_torch.ops import wilson as w
from tmlqcd_tpu_torch.ops import wilson_fast as wf

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def fields():
    f = _data()
    return dict(f, jsw=jcl.sw_blocks_eo(jnp.asarray(f["u"]), TP.kappa, TP.c_sw, JL),
                jfc=jwf.make_fast_clover(jnp.asarray(f["u"]), JP, JL))


# ---------------------------------------------------------------------------
# ops/clover.py
# ---------------------------------------------------------------------------


def test_mee_blocks_and_inverse_match_reference(fields):
    (jsw_e, jsw_o), (sw_e, sw_o) = fields["jsw"], fields["tsw"]
    psi = fields["pt"]
    for sign in (+1.0, -1.0):
        m = cl.mee_blocks(sw_o, TP.mutld, sign)
        mi = cl.mee_inv_blocks(sw_e, TP.mutld, sign)
        assert _maxdiff(m, jcl.mee_blocks(jsw_o, JP.mutld, sign)) < 2e-6
        assert _maxdiff(mi, jcl.mee_inv_blocks(jsw_e, JP.mutld, sign)) < 2e-6
        # the materialised blocks act as the operators they were built from
        assert _maxdiff(cl.blocks_apply(m, psi), cl.sw_apply(sw_o, psi, TP.mutld, sign)) < 2e-6
        assert _maxdiff(cl.blocks_apply(mi, psi), cl.sw_inv_apply(sw_e, psi, TP.mutld, sign)) < 2e-6
    # 1 + T +- i mu g5 is normal, not hermitian: every entry is needed
    m = cl.mee_blocks(sw_o, TP.mutld, +1.0)
    assert float((m[0, 0, 0] - torch.conj_physical(m[0, 0, 0].transpose(0, 1))).abs().max()) > 1e-3


def test_q_hat_pm_clover_matches_reference(fields):
    (jsw_e, jsw_o), (sw_e, sw_o) = fields["jsw"], fields["tsw"]
    ref = jcl.q_hat_pm_clover(j_pack(jnp.asarray(fields["u"]), JL), jsw_e, jsw_o,
                              jnp.asarray(fields["psi"]), JP, JL, jw.boundary_phases(JP, JL))
    out = cl.q_hat_pm_clover(pack_gauge_eo(fields["ut"], LAT), sw_e, sw_o, fields["pt"], TP, LAT,
                             w.boundary_phases(TP, LAT))
    assert float(np.max(np.abs(np.asarray(ref)))) > 1.0
    assert _maxdiff(out, ref) < 1e-5


@pytest.mark.parametrize("sign", [+1.0, -1.0])
def test_fused_clover_schur_complement_matches_reference_operator(fields, sign):
    """Both epilogues in sequence, M_oo psi - k^2 H_oe M_ee^-1 H_eo psi with
    gamma5, against the reference's jnp q_hat_clover; 2e-6 relative to
    outputs of O(5) (measured 4.8e-7)."""
    jsw_e, jsw_o = fields["jsw"]
    ref = jcl.q_hat_clover(j_pack(jnp.asarray(fields["u"]), JL), jsw_e, jsw_o,
                           jnp.asarray(fields["psi"]), JP, JL, jw.boundary_phases(JP, JL), sign)
    out = wf.q_hat_clover_fast(fields["fc"], wf.to_split(fields["pt"]), TP, LAT, sign)
    assert _maxdiff(wf.from_split(out), ref) < 2e-6 * max(1.0, float(np.max(np.abs(ref))))
    # without gamma5 the lower two spins flip sign
    m = wf.m_hat_clover_fast(fields["fc"], wf.to_split(fields["pt"]), TP, LAT, sign)
    assert torch.equal(tgamma.gamma5_split(m), out)


# ---------------------------------------------------------------------------
# ops/wilson_fast.py and bridge
# ---------------------------------------------------------------------------


def test_make_fast_clover_matches_reference_blocks(fields):
    """The four block fields in the kernels' [2, 72, T, X, M] layout against
    the reference's, moved across by `bridge` in both directions."""
    fc, jfc = fields["fc"], fields["jfc"]
    arrs = bridge.fast_clover_to_numpy(fc)
    for name in ("moo_p", "moo_m", "mee_inv_p", "mee_inv_m"):
        ref = np.asarray(getattr(jfc, name))
        assert arrs[name].shape == ref.shape == (2, 72) + LAT.eo_site_shape
        assert arrs[name].dtype == np.float32
        assert _maxdiff(arrs[name], ref) < 2e-6
    assert _maxdiff(arrs["ug_even"], jfc.fg.ug_even) < 1e-7
    assert arrs["gcomp"] == tuple(tuple(map(float, c)) for c in jfc.fg.gcomp)
    # flatten order: k = ((b 2 + s) 2 + s') 9 + 3 c + c'
    m = dc.split_c(cl.mee_blocks(fields["tsw"][1], TP.mutld, +1.0)).to(torch.float32)
    k = ((1 * 2 + 0) * 2 + 1) * 9 + 3 * 2 + 1
    assert torch.equal(fc.moo_p[:, k], m[:, 1, 0, 1, 2, 1])
    assert torch.equal(dc.blk_unflatten(fc.moo_p), m)
    # the reference's packed clover term through the bridge
    sw_e = bridge.clover_blocks_from_numpy(np.asarray(fields["jsw"][0]), LAT)
    assert _maxdiff(sw_e, fields["tsw"][0]) < 2e-6
    same = wf.fast_clover_from(fc.fg, *fields["tsw"], TP.mutld)
    assert torch.equal(same.mee_inv_m, fc.mee_inv_m)


def test_q_hat_pm_clover_fast_matches_reference(fields):
    """The pair of tests/test_pallas_dslash.py::test_q_clover_fast_matches_reference
    on this file's fields: the split operator on the port's blocks, and on
    the reference's blocks carried over by `bridge`, against the reference's
    complex operator."""
    jsw_e, jsw_o = fields["jsw"]
    ref = jcl.q_hat_pm_clover(j_pack(jnp.asarray(fields["u"]), JL), jsw_e, jsw_o,
                              jnp.asarray(fields["psi"]), JP, JL, jw.boundary_phases(JP, JL))
    p2 = wf.to_split(fields["pt"])
    out = wf.from_split(wf.q_hat_pm_clover_fast(fields["fc"], p2, TP, LAT))
    assert _maxdiff(out, ref) < 1e-5
    jfc = fields["jfc"]
    fc = bridge.fast_clover_from_numpy(
        fields["fc"].fg, *(np.asarray(getattr(jfc, n)) for n in
                           ("moo_p", "moo_m", "mee_inv_p", "mee_inv_m")), LAT)
    assert _maxdiff(wf.from_split(wf.q_hat_pm_clover_fast(fc, p2, TP, LAT)), ref) < 1e-5
