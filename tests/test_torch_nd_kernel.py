"""Parity of the port's doublet hop and doublet operators with the JAX
reference (tmlqcd_tpu), on the CPU, where the reference side compiles
slowly: the multi-RHS hopping on the flavour-doublet axis (plain version)
against the reference's multi-RHS Pallas kernel in interpret mode (two
cases, as its own tests run it), the split-field twisted-clover doublet
operator, and the doublet force surrogates with their gradients.  The other
doublet operators are in tests/test_torch_nd.py; these have a file of their
own so that the test runner's workers share the load.

Inputs come from seeded numpy generators through `bridge` (the draws of
tests/test_torch_nd.py) and go to both packages as numpy arrays.  The port
runs its plain path (CPU tensors).

Tolerances, each stated where it is used:
* the doublet hop: 1e-5 absolute on unit-normal inputs, outputs of O(10)
  (both sides f32, another summation order).
* the split-field operators against the complex ones 1e-5 (f32 on both
  sides).
* gradients of a surrogate with respect to U: 1e-5 on entries of O(1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmlqcd_tpu.lattice import ODD as J_ODD
from tmlqcd_tpu.lattice import Lattice as JLattice
from tmlqcd_tpu.lattice import pack_gauge_eo as j_pack
from tmlqcd_tpu.ops import clover as jcl
from tmlqcd_tpu.ops import dslash_pallas as jdp
from tmlqcd_tpu.ops import ndoublet as jnd
from tmlqcd_tpu.ops import wilson as jw
from tmlqcd_tpu.ops import wilson_fast as jwf
from tmlqcd_tpu_torch import bridge
from tmlqcd_tpu_torch.lattice import ODD, Lattice, pack_gauge_eo
from tmlqcd_tpu_torch.ops import clover as cl
from tmlqcd_tpu_torch.ops import dslash_cuda as dc
from tmlqcd_tpu_torch.ops import ndoublet as nd
from tmlqcd_tpu_torch.ops import wilson as w
from tmlqcd_tpu_torch.ops import wilson_fast as wf
from tmlqcd_tpu_torch.ops.gauge_action import torch_grad_to_jax

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


@pytest.mark.parametrize("gauge", ["fg18", "fg12"])
def test_doublet_hop_matches_reference_kernel(fields, gauge):
    """The reference's multi-RHS Pallas kernel on a doublet (it picks the
    flavour axis itself) in interpret mode.  1e-5 on outputs of O(10)."""
    fg = fields[gauge]
    jfg = jwf.make_fast_gauge(jnp.asarray(fields["u"]), JP.wilson, JL, compress=gauge == "fg12")
    ref = jdp.hopping_pallas_split(jfg.ug_odd, jnp.asarray(bridge.to_numpy(fields["c2"])), J_ODD,
                                   JL, interpret=True, gcomp=jfg.gcomp)
    out = dc.hopping_split_rhs(fg.ug_odd, fields["c2"], ODD, LAT, gcomp=fg.gcomp, r_axis=1)
    assert float(np.max(np.abs(np.asarray(ref)))) > 1.0
    assert _maxdiff(out, ref) < 1e-5


# ---------------------------------------------------------------------------
# the ND half of ops/clover.py
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def clover(fields):
    sw_e, sw_o = cl.sw_blocks_eo(fields["ut"], TPC.kappa, TPC.c_sw, LAT)
    jsw_e, jsw_o = jcl.sw_blocks_eo(jnp.asarray(fields["u"]), JPC.kappa, JPC.c_sw, JL)
    return dict(sw_e=sw_e, sw_o=sw_o, jsw_e=jsw_e, jsw_o=jsw_o)


def test_q_nd_clover_fast_matches_complex_operator_and_reference(fields, clover):
    ueo, ph = pack_gauge_eo(fields["ut"], LAT), w.boundary_phases(TPC.wilson, LAT)
    fc = wf.make_fast_clover_nd(fields["ut"], TPC, LAT)
    jfc = jwf.make_fast_clover_nd(jnp.asarray(fields["u"]), JPC, JL)
    assert fc.epsbar_t == jfc.epsbar_t == TPC.epsbar_t
    for name in ("moo_u", "moo_d", "minv_a", "minv_b", "minv_e"):
        assert tuple(getattr(fc, name).shape) == (2, 2, 2, 2, 3, 3) + LAT.eo_site_shape
        assert _maxdiff(getattr(fc, name), getattr(jfc, name)) < 1e-5
    out = wf.from_split(wf.q_nd_clover_fast(fc, fields["c2"], TPC, LAT))
    ref = cl.q_nd_clover(ueo, clover["sw_e"], clover["sw_o"], fields["chit"], TPC, LAT, ph)
    assert _maxdiff(out, ref) < 1e-5
    jref = jwf.q_nd_sq_clover_fast(jfc, jnp.asarray(bridge.to_numpy(fields["c2"])), JPC, JL)
    # the reference's blocks through the bridge give the reference's operator
    fcb = bridge.fast_clover_nd_from_numpy(
        fc.fg, *(np.asarray(getattr(jfc, n)) for n in ("moo_u", "moo_d", "minv_a", "minv_b",
                                                       "minv_e")), jfc.epsbar_t, LAT)
    for f in (fc, fcb):
        assert _maxdiff(wf.q_nd_sq_clover_fast(f, fields["c2"], TPC, LAT), jref) < 1e-5


@pytest.mark.parametrize("clov", [False, True])
def test_q_nd_diff_matches_fast_operator_and_reference_gradient(fields, clov):
    """Forward: the differentiable doublet operator equals the fast one.
    Backward: the gradient of Re<y, Q_nd(U) x> with respect to U (hops through
    HoppingDiff flavour by flavour, the clover blocks through autograd of
    sw_blocks) against jax.grad of the reference's complex operator.  1e-5 on
    gradients of O(1)."""
    tp, jp = (TPC, JPC) if clov else (TP, JP)
    x2 = fields["c2"]
    y = bridge.doublet_from_numpy(bridge.numpy_spinor(np.random.default_rng(64), fields["chi"].shape),
                                  LAT)
    uu = fields["ut"].clone().requires_grad_(True)
    if clov:
        parts = wf.split_clover_nd_pair(uu, tp, LAT)
        qx = wf.q_nd_clover_diff(*parts, x2, tp, LAT)
        fast = wf.q_nd_clover_fast(wf.make_fast_clover_nd(fields["ut"], tp, LAT), x2, tp, LAT)
    else:
        parts = wf.split_gauge_pair(uu, tp.wilson, LAT)
        qx = wf.q_nd_diff(*parts, x2, tp, LAT)
        fast = wf.q_nd_fast(fields["fg12"], x2, tp, LAT)
    assert _maxdiff(qx.detach(), fast) < 1e-5
    (g,) = torch.autograd.grad(wf.dot_re_f64_split(wf.to_split(y), qx), uu)

    def surrogate(u):
        ueo, ph = j_pack(u, JL), jw.boundary_phases(jp.wilson, JL)
        if clov:
            sw_e, sw_o = jcl.sw_blocks_eo(u, jp.kappa, jp.c_sw, JL)
            q = jcl.q_nd_clover(ueo, sw_e, sw_o, jnp.asarray(fields["chi"]), jp, JL, ph)
        else:
            q = jnd.q_nd(ueo, jnp.asarray(fields["chi"]), jp, JL, ph)
        return jnp.sum((jnp.conj(jnp.asarray(bridge.to_numpy(y))) * q).real.astype(jnp.float64))

    ref = jax.jit(jax.grad(surrogate))(jnp.asarray(fields["u"]))
    assert float(np.max(np.abs(np.asarray(ref)))) > 0.1
    assert _maxdiff(torch_grad_to_jax(g), ref) < 1e-5
