"""Parity of the port's twisted-clover operator with the JAX reference
(tmlqcd_tpu), on the CPU: the clover term and its 6 x 6 block algebra
(`ops/clover.py`), the plain versions of the kernel's clov_inv / clov_mhat
epilogues for K1 and K1-R, the split-field operators on them
(`ops/wilson_fast.py`) and the state converters of `bridge`.

Inputs come from seeded numpy generators through `bridge` and go to both
packages as numpy arrays.  The port runs its plain path (CPU tensors).  The
reference runs its jnp operators.  The two epilogue cases that hold the
plain versions against its Pallas kernel in interpret mode, and the clover
force surrogate, are in tests/test_torch_clover_kernel.py.

Tolerances, each derived where it is used:
* complex128 inputs: 1e-12 on entries of O(1): the same closed forms in f64,
  only the summation order differs.
* complex64 inputs: 2e-6 on blocks and single applications (entries of O(1),
  f32 rounding of sums of ~30 terms; measured 7e-8 .. 7.5e-7), 1e-5 on Qsw_pm
  (two Schur complements, outputs of O(5); measured 7.2e-7).
* K1-R plain against K1 plain per column: identical arithmetic, bound 0.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from tmlqcd_tpu.lattice import Lattice as JLattice
from tmlqcd_tpu.lattice import pack_gauge_eo as j_pack
from tmlqcd_tpu.ops import clover as jcl
from tmlqcd_tpu.ops import wilson as jw
from tmlqcd_tpu.ops import wilson_fast as jwf
from tmlqcd_tpu_torch import bridge
from tmlqcd_tpu_torch import gamma as tgamma
from tmlqcd_tpu_torch.lattice import EVEN, ODD, Lattice, eo_pack, pack_gauge_eo
from tmlqcd_tpu_torch.ops import clover as cl
from tmlqcd_tpu_torch.ops import dslash_cuda as dc
from tmlqcd_tpu_torch.ops import wilson as w
from tmlqcd_tpu_torch.ops import wilson_fast as wf

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _quick_reference_compiles():
    """XLA's backend optimisations off while this module runs: the
    reference's programs here take far longer to compile than to run."""
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", False)


DIMS = (4, 4, 4, 4)
JL, LAT = JLattice(DIMS), Lattice(DIMS)
# the point of tests/test_pallas_dslash.py::test_q_clover_fast_matches_reference
KW = dict(kappa=0.14, mu=0.04, c_sw=1.3)
JP, TP = jw.DiracParams(**KW), w.DiracParams(**KW)
K2 = TP.kappa * TP.kappa
R = 3


def _maxdiff(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


@pytest.fixture(scope="module")
def fields():
    g = np.random.default_rng(40)
    u = bridge.numpy_su3(g, (4,) + JL.site_shape)
    psi = bridge.numpy_spinor(g, (4, 3) + JL.eo_site_shape)
    psis = bridge.numpy_spinor(g, (R, 4, 3) + JL.eo_site_shape)
    ut = bridge.gauge_from_numpy(u, LAT)
    return dict(u=u, ut=ut, psi=psi, pt=bridge.spinor_from_numpy(psi, LAT), psis=psis,
                jsw=jcl.sw_blocks_eo(jnp.asarray(u), TP.kappa, TP.c_sw, JL),
                tsw=cl.sw_blocks_eo(ut, TP.kappa, TP.c_sw, LAT),
                fc=wf.make_fast_clover(ut, TP, LAT),
                jfc=jwf.make_fast_clover(jnp.asarray(u), JP, JL))


# ---------------------------------------------------------------------------
# ops/clover.py
# ---------------------------------------------------------------------------


def test_sigma_munu_and_matvec_match_reference():
    from tmlqcd_tpu import gamma as jgamma
    from tmlqcd_tpu import su3 as jsu3
    from tmlqcd_tpu_torch import su3

    np.testing.assert_array_equal(tgamma.SIGMA_MUNU, jgamma.SIGMA_MUNU)
    g = np.random.default_rng(41)
    m = bridge.numpy_su3(g, (5,))
    v = bridge.numpy_spinor(g, (3, 5))
    assert _maxdiff(su3.matvec(torch.as_tensor(m), torch.as_tensor(v)),
                    jsu3.matvec(jnp.asarray(m), jnp.asarray(v))) < 1e-6


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


def test_clover_operator_at_csw_zero_is_twisted_mass(fields):
    p0 = w.DiracParams(kappa=TP.kappa, mu=TP.mu, c_sw=0.0)
    ueo, ph = pack_gauge_eo(fields["ut"], LAT), w.boundary_phases(p0, LAT)
    sw_e, sw_o = cl.sw_blocks_eo(fields["ut"], p0.kappa, 0.0, LAT)
    assert float(sw_e.abs().max()) == 0.0
    out = cl.q_hat_pm_clover(ueo, sw_e, sw_o, fields["pt"], p0, LAT, ph)
    assert _maxdiff(out, w.q_hat_pm(ueo, fields["pt"], p0, LAT, ph)) < 2e-6
    fast = wf.q_hat_pm_clover_fast(wf.make_fast_clover(fields["ut"], p0, LAT),
                                   wf.to_split(fields["pt"]), p0, LAT)
    ref = wf.q_hat_pm_fast(wf.make_fast_gauge(fields["ut"], p0, LAT), wf.to_split(fields["pt"]),
                           p0, LAT)
    assert _maxdiff(fast, ref) < 2e-6


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


@pytest.mark.parametrize("compress", [False, True], ids=["18real", "12real"])
@pytest.mark.parametrize("epi", [("clov_inv",), ("clov_mhat", K2, True), ("clov_mhat", K2, False)],
                         ids=["clov_inv", "clov_mhat+g5", "clov_mhat"])
def test_clover_rhs_plain_equals_per_column_plain(fields, compress, epi):
    """K1-R's plain version is K1's plain version column by column, to the
    last bit: the links and the blocks only broadcast over R."""
    fc = fields["fc"]
    fg = wf.make_fast_gauge(fields["ut"], TP, LAT, compress=compress)
    p2 = wf.to_split_rhs(torch.as_tensor(fields["psis"]))
    po2 = torch.flip(p2, dims=(3,)) if epi[0] == "clov_mhat" else None
    out = dc.hopping_split_rhs(fg.ug_odd, p2, ODD, LAT, epi=epi, psi_o=po2, gcomp=fg.gcomp,
                               r_axis=3, blocks=fc.moo_p)
    for r in range(R):
        one = dc.hopping_split(fg.ug_odd, p2[:, :, :, r].contiguous(), ODD, LAT, epi=epi,
                               psi_o=None if po2 is None else po2[:, :, :, r].contiguous(),
                               gcomp=fg.gcomp, blocks=fc.moo_p)
        assert torch.equal(out[:, :, :, r], one)


def test_clover_epilogues_check_their_arguments(fields):
    fc, p2 = fields["fc"], wf.to_split(fields["pt"])
    kw = dict(gcomp=fc.fg.gcomp)
    with pytest.raises(ValueError, match="needs blocks"):
        dc.hopping_split(fc.fg.ug_even, p2, EVEN, LAT, epi=("clov_inv",), **kw)
    with pytest.raises(ValueError, match="needs psi_o"):
        dc.hopping_split(fc.fg.ug_odd, p2, ODD, LAT, epi=("clov_mhat", K2, True),
                         blocks=fc.moo_p, **kw)
    with pytest.raises(ValueError, match="blocks has shape"):
        dc.hopping_split(fc.fg.ug_even, p2, EVEN, LAT, epi=("clov_inv",),
                         blocks=dc.blk_unflatten(fc.mee_inv_p), **kw)
    with pytest.raises(TypeError, match="blocks must be float32"):
        dc.hopping_split(fc.fg.ug_even, p2, EVEN, LAT, epi=("clov_inv",),
                         blocks=fc.mee_inv_p.double(), **kw)
    with pytest.raises(ValueError, match="blocks must be contiguous"):
        dc.hopping_split(fc.fg.ug_even, p2, EVEN, LAT, epi=("clov_inv",),
                         blocks=torch.stack([fc.mee_inv_p] * 2, dim=-1)[..., 0], **kw)
    with pytest.raises(ValueError, match="none, mee_inv, mhat, clov_inv, clov_mhat"):
        dc.hopping_split(fc.fg.ug_even, p2, EVEN, LAT, epi=("clov",), **kw)
    p7 = wf.to_split_rhs(torch.as_tensor(fields["psis"]))
    with pytest.raises(ValueError, match="blocks has shape"):
        dc.hopping_split_rhs(fc.fg.ug_even, p7, EVEN, LAT, epi=("clov_inv",), r_axis=3,
                             blocks=torch.stack([fc.mee_inv_p] * R, dim=2), **kw)


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


def test_q_hat_pm_clover_fast_rhs_matches_single(fields):
    fc = fields["fc"]
    p7 = wf.to_split_rhs(torch.as_tensor(fields["psis"]))
    out = wf.q_hat_pm_clover_fast(fc, p7, TP, LAT, r_axis=3)
    for r in range(R):
        one = wf.q_hat_pm_clover_fast(fc, p7[:, :, :, r].contiguous(), TP, LAT)
        assert torch.equal(out[:, :, :, r], one)
    # the flavour-doublet axis carries no fused epilogue
    with pytest.raises(ValueError, match="epilogue 'none' only"):
        wf.q_hat_pm_clover_fast(fc, p7, TP, LAT, r_axis=1)


def test_eo_pack_of_blocks_round_trips(fields):
    sw = cl.sw_blocks(fields["ut"], TP.kappa, TP.c_sw, LAT)
    sw_e, sw_o = eo_pack(sw, LAT)
    assert torch.equal(sw_e, fields["tsw"][0]) and torch.equal(sw_o, fields["tsw"][1])
