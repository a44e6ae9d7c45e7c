"""Parity of the port's non-degenerate doublet operators with the JAX
reference's jnp operators (tmlqcd_tpu), on the CPU: Q_nd, Q_nd^2 and
Mhat_nd in complex128 and complex64 (`ops/ndoublet.py`), the ND half of
`ops/clover.py`, and the split-field doublet operators of
`ops/wilson_fast.py`.  Seconds of reference compiles each, so they have a
file of at most 8 tests, which the test runner queues behind
tests/test_multirhs.py; the gauge and the doublets are those of
tests/test_torch_nd.py (its fixture, imported).

Tolerances, each stated where it is used: complex operators, 1e-12 in c128
on outputs of O(10), 1e-5 in c64; the split-field operators against the
complex ones 1e-5 (f32 on both sides).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_nd import (  # noqa: F401  (fixtures, the autouse one too)
    JL,
    JP,
    JPC,
    LAT,
    TP,
    TPC,
    _quick_reference_compiles,
    fields,
)
from tmlqcd_tpu.lattice import pack_gauge_eo as j_pack
from tmlqcd_tpu.ops import clover as jcl
from tmlqcd_tpu.ops import ndoublet as jnd
from tmlqcd_tpu.ops import wilson as jw
from tmlqcd_tpu_torch import bridge
from tmlqcd_tpu_torch.lattice import pack_gauge_eo
from tmlqcd_tpu_torch.ops import clover as cl
from tmlqcd_tpu_torch.ops import ndoublet as nd
from tmlqcd_tpu_torch.ops import split_diag as sd
from tmlqcd_tpu_torch.ops import wilson as w
from tmlqcd_tpu_torch.ops import wilson_fast as wf

torch.set_num_threads(1)


def _maxdiff(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


# ---------------------------------------------------------------------------
# ops/ndoublet.py
# ---------------------------------------------------------------------------


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
