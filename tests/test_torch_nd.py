"""Parity of the port's non-degenerate doublet operators with the JAX
reference (tmlqcd_tpu), on the CPU: the multi-RHS hopping on the
flavour-doublet axis (plain version) and the doublet algebra of
`ops/ndoublet.py`.  The complex doublet operators, the ND half of
`ops/clover.py` and the split-field doublet operators of
`ops/wilson_fast.py` against the reference's jnp operators are in
tests/test_torch_nd_ref.py (seconds of reference compiles each, in a file
of at most 8 tests, which the test runner queues behind
tests/test_multirhs.py); the doublet hop against the reference's Pallas
kernel in interpret mode, the split-field clover doublet operator and the
force surrogates are in tests/test_torch_nd_kernel.py.

Inputs come from seeded numpy generators through `bridge` and go to both
packages as numpy arrays.  The port runs its plain path (CPU tensors).

Tolerances, each stated where it is used:
* the doublet hop: per flavour against the single-RHS plain version the
  arithmetic is identical, so the bound is 0.
* M_ee^nd and its inverse: 1e-12 in c128, 1e-5 in c64 (entries of O(1));
  the hermiticity of Q_nd to 1e3 times that (sums of 3072 terms of O(10)).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from tmlqcd_tpu.lattice import Lattice as JLattice
from tmlqcd_tpu.ops import dslash_pallas as jdp
from tmlqcd_tpu.ops import ndoublet as jnd
from tmlqcd_tpu_torch import bridge
from tmlqcd_tpu_torch.lattice import EVEN, ODD, Lattice, pack_gauge_eo
from tmlqcd_tpu_torch.ops import dslash_cuda as dc
from tmlqcd_tpu_torch.ops import ndoublet as nd
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
