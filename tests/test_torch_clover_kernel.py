"""Parity of the port's twisted-clover kernel epilogues and clover force
surrogate with the JAX reference (tmlqcd_tpu), on the CPU: the plain
versions of K1's clov_inv / clov_mhat epilogues against the reference's
Pallas kernel in interpret mode (two cases, as its own tests run it), and
the differentiable clover Schur complement against the fused operator and
the reference's gradient.  The rest of the clover operator is in
tests/test_torch_clover.py; these have a file of their own so that the test
runner's workers share the load.

Inputs come from seeded numpy generators through `bridge` (the draws of
tests/test_torch_clover.py) and go to both packages as numpy arrays.

Tolerances, each derived where it is used: complex64 inputs, 2e-6 on single
applications (entries of O(1), f32 rounding of sums of ~30 terms), 1e-5 on
outputs of O(5).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from tmlqcd_tpu.lattice import EVEN as J_EVEN
from tmlqcd_tpu.lattice import ODD as J_ODD
from tmlqcd_tpu.lattice import Lattice as JLattice
from tmlqcd_tpu.lattice import pack_gauge_eo as j_pack
from tmlqcd_tpu.ops import clover as jcl
from tmlqcd_tpu.ops import dslash_pallas as jdp
from tmlqcd_tpu.ops import wilson as jw
from tmlqcd_tpu.ops import wilson_fast as jwf
from tmlqcd_tpu_torch import bridge
from tmlqcd_tpu_torch.lattice import EVEN, ODD, Lattice
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
# the plain clov_inv / clov_mhat epilogues of K1 and K1-R
# ---------------------------------------------------------------------------


def _split_np(t):
    return jnp.asarray(bridge.to_numpy(t))


@pytest.mark.parametrize("case", ["clov_inv 12-real", "clov_mhat+g5 18-real"])
def test_clover_epilogues_match_reference_kernel(fields, case):
    """The reference's Pallas kernel in interpret mode, with the reference's
    own block fields carried over by `bridge`: clov_inv on the even sites
    (M_ee^-1 blocks, 12-real gauge) and clov_mhat with gamma5 on the odd
    sites (M_oo blocks, 18-real gauge).  1e-5 on outputs of O(10): f32 on
    both sides, another summation order (measured 2.4e-6)."""
    compress = case.endswith("12-real")
    jfc = fields["jfc"]
    jfg = jwf.make_fast_gauge(jnp.asarray(fields["u"]), JP, JL, compress=compress)
    fg = bridge.fast_gauge_from_numpy(np.asarray(jfg.ug_even), np.asarray(jfg.ug_odd), jfg.gcomp)
    fc = bridge.fast_clover_from_numpy(fg, *(np.asarray(getattr(jfc, n)) for n in
                                             ("moo_p", "moo_m", "mee_inv_p", "mee_inv_m")), LAT)
    p2 = wf.to_split(fields["pt"])
    if case.startswith("clov_inv"):
        ref = jdp.hopping_pallas_split(jfg.ug_even, _split_np(p2), J_EVEN, JL, interpret=True,
                                       epi=("clov_inv",), blocks=jfc.mee_inv_p, gcomp=jfg.gcomp)
        out = dc.hopping_split(fg.ug_even, p2, EVEN, LAT, epi=("clov_inv",),
                               blocks=fc.mee_inv_p, gcomp=fg.gcomp)
    else:
        po2 = wf.to_split(bridge.spinor_from_numpy(fields["psis"][0], LAT))
        epi = ("clov_mhat", K2, True)
        ref = jdp.hopping_pallas_split(jfg.ug_odd, _split_np(p2), J_ODD, JL, interpret=True,
                                       epi=epi, blocks=jfc.moo_m, psi_o=_split_np(po2),
                                       gcomp=jfg.gcomp)
        out = dc.hopping_split(fg.ug_odd, p2, ODD, LAT, epi=epi, blocks=fc.moo_m, psi_o=po2,
                               gcomp=fg.gcomp)
    assert float(np.max(np.abs(np.asarray(ref)))) > 1.0
    assert _maxdiff(out, ref) < 1e-5


def test_q_hat_clover_diff_matches_fused_operator_and_reference_gradient(fields):
    """Forward: the differentiable operator equals the fused one.  Backward:
    the gradient of Re<y, Qsw_+(U) x> with respect to U (hops through
    HoppingDiff, blocks through autograd of sw_blocks) against jax.grad of
    the reference's complex operator.  1e-5 on gradients of O(1): f32
    operators on both sides, f64 sums (measured 3.6e-7)."""
    from tmlqcd_tpu_torch.ops.gauge_action import torch_grad_to_jax

    x2 = wf.to_split(fields["pt"])
    y = bridge.spinor_from_numpy(fields["psis"][1], LAT)
    y2 = wf.to_split(y)
    uu = fields["ut"].clone().requires_grad_(True)
    parts = wf.split_clover_pair(uu, TP, LAT, +1.0)
    assert [tuple(p.shape[:2]) for p in parts] == [(2, 8), (2, 8), (2, 2), (2, 2)]
    qx = wf.q_hat_clover_diff(*parts, x2, TP, LAT)
    assert _maxdiff(qx.detach(), wf.q_hat_clover_fast(fields["fc"], x2, TP, LAT, +1.0)) < 2e-6
    (g,) = torch.autograd.grad(wf.dot_re_f64_split(y2, qx), uu)

    def j_s(u):
        sw_e, sw_o = jcl.sw_blocks_eo(u, JP.kappa, JP.c_sw, JL)
        q = jcl.q_hat_clover(j_pack(u, JL), sw_e, sw_o, jnp.asarray(fields["psi"]), JP, JL,
                             jw.boundary_phases(JP, JL), +1.0)
        return jnp.sum(jnp.real(jnp.conj(jnp.asarray(fields["psis"][1])) * q).astype(jnp.float64))

    ref = jax.jit(jax.grad(j_s))(jnp.asarray(fields["u"]))
    assert float(np.max(np.abs(np.asarray(ref)))) > 0.1
    assert _maxdiff(torch_grad_to_jax(g), ref) < 1e-5
