"""Parity of the port's non-degenerate doublet operators with the JAX
reference (tmlqcd_tpu), on the CPU: the multi-RHS hopping on the
flavour-doublet axis (plain version), `ops/ndoublet.py`, the ND half of
`ops/clover.py` and the split-field doublet operators of
`ops/wilson_fast.py` with their force surrogates.

Inputs come from seeded numpy generators through `bridge` and go to both
packages as numpy arrays.  The port runs its plain path (CPU tensors).  The
reference runs its jnp operators.  The doublet hop against the reference's
Pallas kernel in interpret mode, the split-field clover doublet operator
and the force surrogates are in tests/test_torch_nd_kernel.py.

Tolerances, each stated where it is used:
* the doublet hop: 1e-5 absolute on unit-normal inputs, outputs of O(10)
  (both sides f32, another summation order); per flavour against the
  single-RHS plain version the arithmetic is identical, so the bound is 0.
* complex operators: 1e-12 in c128 on outputs of O(10), 1e-5 in c64; the
  split-field operators against the complex ones 1e-5 (f32 on both sides).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from tmlqcd_tpu.lattice import Lattice as JLattice
from tmlqcd_tpu.lattice import pack_gauge_eo as j_pack
from tmlqcd_tpu.ops import clover as jcl
from tmlqcd_tpu.ops import dslash_pallas as jdp
from tmlqcd_tpu.ops import ndoublet as jnd
from tmlqcd_tpu.ops import wilson as jw
from tmlqcd_tpu_torch import bridge
from tmlqcd_tpu_torch.lattice import EVEN, ODD, Lattice, pack_gauge_eo
from tmlqcd_tpu_torch.ops import clover as cl
from tmlqcd_tpu_torch.ops import dslash_cuda as dc
from tmlqcd_tpu_torch.ops import ndoublet as nd
from tmlqcd_tpu_torch.ops import split_diag as sd
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
ND = dict(kappa=0.13, mubar=0.35, epsbar=0.4)
JP, TP = jnd.NDParams(**ND), nd.NDParams(**ND)
JPC, TPC = jnd.NDParams(c_sw=1.3, **ND), nd.NDParams(c_sw=1.3, **ND)


def _maxdiff(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


@pytest.fixture(scope="module")
def fields():
    u = bridge.numpy_su3(np.random.default_rng(60), (4,) + JL.site_shape)
    chi = bridge.numpy_spinor(np.random.default_rng(61), (2, 4, 3) + JL.eo_site_shape)
    ut = bridge.gauge_from_numpy(u, LAT)
    chit = bridge.doublet_from_numpy(chi, LAT)
    return dict(u=u, ut=ut, chi=chi, chit=chit, c2=wf.to_split(chit),
                fg12=wf.make_fast_gauge(ut, TP.wilson, LAT),
                fg18=wf.make_fast_gauge(ut, TP.wilson, LAT, compress=False))


# ---------------------------------------------------------------------------
# the hop on the flavour-doublet axis
# ---------------------------------------------------------------------------


def test_doublet_split_layout(fields):
    c2 = fields["c2"]
    assert tuple(c2.shape) == (2, 2, 4, 3) + LAT.eo_site_shape and c2.dtype == torch.float32
    np.testing.assert_array_equal(bridge.to_numpy(c2),
                                  np.asarray(jdp.split_c(jnp.asarray(fields["chi"]))))
    np.testing.assert_array_equal(bridge.to_numpy(wf.from_split(c2)), fields["chi"])


@pytest.mark.parametrize("gauge", ["fg18", "fg12"])
@pytest.mark.parametrize("p", [EVEN, ODD])
def test_doublet_hop_plain_equals_per_flavour_plain(fields, gauge, p):
    """The doublet hop is K1's plain version flavour by flavour, to the last
    bit: the links only broadcast over the flavour axis.  The two flavours
    hold different fields, so a swapped or repeated flavour shows."""
    fg = fields[gauge]
    ug = fg.ug_even if p == EVEN else fg.ug_odd
    c2 = fields["c2"]
    n0 = dc.hopping_split_rhs_plain.calls
    out = dc.hopping_split_rhs(ug, c2, p, LAT, gcomp=fg.gcomp, r_axis=1)
    assert dc.hopping_split_rhs_plain.calls == n0 + 1  # a CPU tensor takes the plain version
    assert out.shape == c2.shape and out.is_contiguous()
    for f in range(2):
        one = dc.hopping_split(ug, c2[:, f].contiguous(), p, LAT, gcomp=fg.gcomp)
        assert torch.equal(out[:, f], one)
    assert not torch.equal(out[:, 0], out[:, 1])


def test_doublet_hop_checks_its_arguments(fields):
    fg, c2 = fields["fg12"], fields["c2"]
    kw = dict(gcomp=fg.gcomp, r_axis=1)
    with pytest.raises(ValueError, match="epilogue 'none' only"):
        dc.hopping_split_rhs(fg.ug_even, c2, EVEN, LAT, epi=("mee_inv", 0.1, 1.0), **kw)
    with pytest.raises(ValueError, match="2 flavours"):
        dc.hopping_split_rhs(fg.ug_even, torch.zeros((2, 4, 3, 2) + LAT.eo_site_shape), EVEN, LAT,
                             **kw)
    with pytest.raises(ValueError, match="r_axis = 2"):
        dc.hopping_split_rhs(fg.ug_even, c2, EVEN, LAT, gcomp=fg.gcomp, r_axis=2)
    with pytest.raises(ValueError, match="shape"):  # a doublet on the batch axis
        dc.hopping_split_rhs(fg.ug_even, c2, EVEN, LAT, gcomp=fg.gcomp, r_axis=3)
    with pytest.raises(ValueError, match="contiguous"):
        dc.hopping_split_rhs(fg.ug_even, torch.stack([c2, c2], dim=-1)[..., 0], EVEN, LAT, **kw)
    with pytest.raises(TypeError, match="float32"):
        dc.hopping_split_rhs(fg.ug_even, c2.double(), EVEN, LAT, **kw)
    # the flat block matvec names the function that serves a doublet
    with pytest.raises(ValueError, match="mee_nd_apply_split"):
        wf.blocks_apply_flat(torch.zeros((2, 72) + LAT.eo_site_shape), c2, r_axis=1)
    dc.reset_counters()
    dc.hopping_split_rhs(fg.ug_even, c2, EVEN, LAT, **kw)
    # the counters count kernel launches only; the CPU ran the plain version
    assert dc.hopping_split_rhs.launches == 0 and dc.hopping_split_rhs.doublet_launches == 0
    assert dc.hopping_split_rhs_plain.calls == 1


# ---------------------------------------------------------------------------
# ops/ndoublet.py
# ---------------------------------------------------------------------------


def test_nd_params_match_reference():
    assert (TP.mubar_t, TP.epsbar_t) == (JP.mubar_t, JP.epsbar_t)
    assert TP.wilson.kappa == JP.wilson.kappa and TP.wilson.mu == 0.0
    assert TPC.wilson.c_sw == 1.3
    with pytest.raises(ValueError, match="non-degenerate doublet needs"):
        nd.NDParams(kappa=0.5, mubar=0.1, epsbar=1.5)
    assert bridge.nd_params_from(JPC) == TPC


@pytest.mark.parametrize("dtype, tol", [(torch.complex128, 1e-12), (torch.complex64, 1e-5)])
def test_mee_nd_inverse_and_q_nd_hermitian(fields, dtype, tol):
    chi = fields["chit"].to(dtype)
    u = fields["ut"].to(dtype)
    for sign in (+1.0, -1.0):
        back = nd.mee_inv_nd(nd.mee_nd(chi, TP.mubar_t, TP.epsbar_t, sign), TP.mubar_t,
                             TP.epsbar_t, sign)
        assert float((back - chi).abs().max()) < tol
    ueo, ph = pack_gauge_eo(u, LAT), w.boundary_phases(TP.wilson, LAT)
    psi = torch.as_tensor(bridge.numpy_spinor(np.random.default_rng(62), chi.shape)).to(dtype)
    # <psi, Q chi> = <Q psi, chi>
    lhs = torch.sum(torch.conj(psi) * nd.q_nd(ueo, chi, TP, LAT, ph))
    rhs = torch.sum(torch.conj(nd.q_nd(ueo, psi, TP, LAT, ph)) * chi)
    assert abs(complex(lhs - rhs)) < tol * 1e3  # a sum over 3072 terms of O(10)
    # gamma5 tau1 Mhat(+) gamma5 tau1 = Mhat(+)^+, held as Q = (g5 tau1 Mhat)
    m = nd.m_hat_nd(ueo, chi, TP, LAT, ph)
    assert torch.equal(nd.q_nd(ueo, chi, TP, LAT, ph), nd.gamma5_tau1(m))
    assert torch.equal(nd.tau1(nd.tau1(chi)), chi)


@pytest.mark.parametrize("dtype, jdtype, tol", [(torch.complex128, jnp.complex128, 1e-12),
                                                (torch.complex64, jnp.complex64, 1e-5)])
def test_q_nd_and_q_nd_sq_match_reference(fields, dtype, jdtype, tol):
    u, chi = jnp.asarray(fields["u"], jdtype), jnp.asarray(fields["chi"], jdtype)
    jueo, jph = j_pack(u, JL), jw.boundary_phases(JP.wilson, JL)
    ueo = pack_gauge_eo(fields["ut"].to(dtype), LAT)
    ph = w.boundary_phases(TP.wilson, LAT)
    chit = fields["chit"].to(dtype)
    ref = jnd.q_nd(jueo, chi, JP, JL, jph)
    assert float(np.max(np.abs(np.asarray(ref)))) > 1.0
    assert _maxdiff(nd.q_nd(ueo, chit, TP, LAT, ph), ref) < tol
    assert _maxdiff(nd.q_nd_sq(ueo, chit, TP, LAT, ph), jnd.q_nd_sq(jueo, chi, JP, JL, jph)) < tol
    assert _maxdiff(nd.m_hat_nd(ueo, chit, TP, LAT, ph, -1.0),
                    jnd.m_hat_nd(jueo, chi, JP, JL, jph, -1.0)) < tol


# ---------------------------------------------------------------------------
# the ND half of ops/clover.py
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def clover(fields):
    sw_e, sw_o = cl.sw_blocks_eo(fields["ut"], TPC.kappa, TPC.c_sw, LAT)
    jsw_e, jsw_o = jcl.sw_blocks_eo(jnp.asarray(fields["u"]), JPC.kappa, JPC.c_sw, JL)
    return dict(sw_e=sw_e, sw_o=sw_o, jsw_e=jsw_e, jsw_o=jsw_o)


def test_nd_clover_diagonal_matches_reference(fields, clover):
    """M_ee^nd, its closed-form inverse, the materialised (A, B, E) blocks and
    the trlog.  1e-5 on outputs of O(1..10) in c64; the trlog (an f64 sum of
    logs of f32 determinants, |S| ~ 1e2) to 1e-6 relative."""
    chi, jchi = fields["chit"], jnp.asarray(fields["chi"])
    mu, eps = TPC.mubar_t, TPC.epsbar_t
    for sign in (+1.0, -1.0):
        fwd = cl.mee_nd_clover(clover["sw_e"], chi, mu, eps, sign)
        assert _maxdiff(fwd, jcl.mee_nd_clover(clover["jsw_e"], jchi, mu, eps, sign)) < 1e-5
        inv = cl.mee_inv_nd_clover(clover["sw_e"], chi, mu, eps, sign)
        assert _maxdiff(inv, jcl.mee_inv_nd_clover(clover["jsw_e"], jchi, mu, eps, sign)) < 1e-5
        assert float((cl.mee_inv_nd_clover(clover["sw_e"], fwd, mu, eps, sign) - chi).abs().max()) < 1e-5
    blocks = cl.mee_inv_nd_blocks(clover["sw_e"], mu, eps)
    for out, ref in zip(blocks, jcl.mee_inv_nd_blocks(clover["jsw_e"], mu, eps)):
        assert tuple(out.shape) == (2, 2, 2, 3, 3) + LAT.eo_site_shape
        assert _maxdiff(out, ref) < 1e-5
    # the blocks are the inverse: [[A, -eps E], [-eps E, B]] on a doublet
    a, b, e = blocks
    up = cl.blocks_apply(a, chi[0]) - eps * cl.blocks_apply(e, chi[1])
    dn = cl.blocks_apply(b, chi[1]) - eps * cl.blocks_apply(e, chi[0])
    assert _maxdiff(torch.stack([up, dn]), cl.mee_inv_nd_clover(clover["sw_e"], chi, mu, eps)) < 1e-5
    ref = float(jcl.sw_logdet_nd(clover["jsw_e"], mu, eps))
    assert abs(ref) > 10.0
    assert abs(float(cl.sw_logdet_nd(clover["sw_e"], mu, eps)) - ref) < 1e-6 * abs(ref)


def test_q_nd_clover_matches_reference_and_is_hermitian(fields, clover):
    jueo, jph = j_pack(jnp.asarray(fields["u"]), JL), jw.boundary_phases(JPC.wilson, JL)
    ueo, ph = pack_gauge_eo(fields["ut"], LAT), w.boundary_phases(TPC.wilson, LAT)
    chi = fields["chit"]
    ref = jcl.q_nd_clover(jueo, clover["jsw_e"], clover["jsw_o"], jnp.asarray(fields["chi"]), JPC,
                          JL, jph)
    out = cl.q_nd_clover(ueo, clover["sw_e"], clover["sw_o"], chi, TPC, LAT, ph)
    assert _maxdiff(out, ref) < 1e-5
    assert _maxdiff(out, nd.q_nd(ueo, chi, TP, LAT, ph)) > 1e-2  # the clover term is there
    psi = bridge.doublet_from_numpy(bridge.numpy_spinor(np.random.default_rng(63), chi.shape), LAT)
    q = lambda x: cl.q_nd_clover(ueo, clover["sw_e"], clover["sw_o"], x, TPC, LAT, ph)  # noqa: E731
    lhs, rhs = torch.sum(torch.conj(psi) * q(chi)), torch.sum(torch.conj(q(psi)) * chi)
    assert abs(complex(lhs - rhs)) < 1e-2  # c64 sums over 3072 terms of O(10)


# ---------------------------------------------------------------------------
# the split-field operators of ops/wilson_fast.py
# ---------------------------------------------------------------------------


def test_q_nd_fast_matches_complex_operator_and_reference(fields):
    """Q_nd and Q_nd^2 on split doublets (the hops on the doublet axis of the
    multi-RHS version) against the port's complex operator and the
    reference's.  1e-5: two or four hops in f32, outputs of O(10)."""
    ueo, ph = pack_gauge_eo(fields["ut"], LAT), w.boundary_phases(TP.wilson, LAT)
    jueo, jph = j_pack(jnp.asarray(fields["u"]), JL), jw.boundary_phases(JP.wilson, JL)
    jchi = jnp.asarray(fields["chi"])
    for fg in (fields["fg12"], fields["fg18"]):
        out = wf.from_split(wf.q_nd_fast(fg, fields["c2"], TP, LAT))
        assert _maxdiff(out, nd.q_nd(ueo, fields["chit"], TP, LAT, ph)) < 1e-5
        assert _maxdiff(out, jnd.q_nd(jueo, jchi, JP, JL, jph)) < 1e-5
    sq = wf.from_split(wf.q_nd_sq_fast(fields["fg12"], fields["c2"], TP, LAT))
    assert _maxdiff(sq, jnd.q_nd_sq(jueo, jchi, JP, JL, jph)) < 1e-5
    # the split diagonals against the complex ones
    for sign in (+1.0, -1.0):
        assert _maxdiff(wf.from_split(sd.mee_nd_split(fields["c2"], TP.mubar_t, TP.epsbar_t, sign)),
                        nd.mee_nd(fields["chit"], TP.mubar_t, TP.epsbar_t, sign)) < 1e-6
        assert _maxdiff(wf.from_split(sd.mee_inv_nd_split(fields["c2"], TP.mubar_t, TP.epsbar_t,
                                                           sign)),
                        nd.mee_inv_nd(fields["chit"], TP.mubar_t, TP.epsbar_t, sign)) < 1e-6
