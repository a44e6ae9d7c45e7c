"""The port's PHMC pieces (solvers/chebyshev.py, hmc/poly_monomials.py,
hmc/reweight.py) against the JAX reference (tmlqcd_tpu) and against their
own identities, at 4^4 on the CPU.

* Chebyshev: the coefficients bit for bit the reference's (the same numpy
  f64 arithmetic); the scalar accuracy of tests/test_phmc.py; the Clenshaw
  matrix recursion on a 12 x 12 hermitian matrix against the same polynomial
  in its eigenbasis (complex128, 1e-10).
* NDPOLY, port-only, degree 12: S = |eta|^2 after the heatbath up to the CG
  tolerance (1e-7 relative at heatbath_tol 1e-8), and the force against the
  central difference of the port's action along a random algebra direction
  (eps = 1e-3: 2e-3 relative, the f32 action's noise over eps beside the
  O(eps^2) truncation).
* NDPOLY against the reference's jnp doublet operators (degree 8, twisted
  mass and clover) on the same U and phi, the polynomial applied by the
  Clenshaw recursion and its adjoint (`_reference_action_and_force`): the
  action to 1e-6 relative (an f64 sum of f32 fields after 9 applications of
  Q^2 in another order), the force to 1e-5 of max|F| (measured 3e-7 and
  4e-7).
* mu-shift reweighting on injected eta against the samples built from the
  reference's Qhat_pm and CG: 1e-4 absolute on exponents of O(1) (f64 sums
  of |eta|^2 ~ 400 minus Re<eta, M eta>, both f32 solutions at tol 1e-9).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmlqcd_tpu.hmc import poly_monomials as jpoly
from tmlqcd_tpu.hmc.monomials import dot_re_f64 as j_dot_re
from tmlqcd_tpu.hmc.monomials import norm_sq_f64 as j_norm_sq
from tmlqcd_tpu.lattice import Lattice as JLattice
from tmlqcd_tpu.lattice import pack_gauge_eo as j_pack
from tmlqcd_tpu.ops import clover as jcl
from tmlqcd_tpu.ops import ndoublet as jnd
from tmlqcd_tpu.ops import wilson as jw
from tmlqcd_tpu.ops.gauge_action import ta_force_from_grad as j_ta_force_from_grad
from tmlqcd_tpu.solvers import chebyshev as jcheb
from tmlqcd_tpu.solvers.cg import cg as j_cg
from tmlqcd_tpu_torch import bridge, rng, su3
from tmlqcd_tpu_torch.hmc.poly_monomials import NDPolyMonomial
from tmlqcd_tpu_torch.hmc.reweight import mu_shift_reweighting
from tmlqcd_tpu_torch.lattice import Lattice
from tmlqcd_tpu_torch.ops import ndoublet as nd
from tmlqcd_tpu_torch.ops import wilson_fast as wf
from tmlqcd_tpu_torch.ops.wilson import DiracParams
from tmlqcd_tpu_torch.solvers.chebyshev import chebyshev_apply, chebyshev_coeffs, chebyshev_eval

torch.set_num_threads(1)

DIMS = (4, 4, 4, 4)
JL, LAT = JLattice(DIMS), Lattice(DIMS)
ND = dict(kappa=0.15, mubar=0.15, epsbar=0.05)


@pytest.fixture(scope="module", autouse=True)
def _quick_reference_compiles():
    """XLA's backend optimisations off while this module runs: the
    reference's programs here take far longer to compile than to run."""
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", False)


@pytest.fixture(scope="module")
def gauge():
    u = bridge.numpy_su3(np.random.default_rng(7), (4,) + JL.site_shape)
    return u, bridge.gauge_from_numpy(u, LAT)


def test_chebyshev_coeffs_match_reference_and_converge():
    fun = lambda x: x**-0.25  # noqa: E731
    for degree, lo, hi in ((8, 0.05, 6.0), (32, 0.01, 4.7), (80, 1e-2, 4.0)):
        out = chebyshev_coeffs(fun, degree, lo, hi)
        assert out.tobytes() == jcheb.chebyshev_coeffs(fun, degree, lo, hi).tobytes()
    xs = np.geomspace(1e-2, 4.0, 2001)
    for degree, bound in ((80, 1e-4), (200, 1e-9)):
        c = chebyshev_coeffs(fun, degree, 1e-2, 4.0)
        assert np.max(np.abs(chebyshev_eval(c, xs, 1e-2, 4.0) * xs**0.25 - 1.0)) < bound
        assert chebyshev_eval(c, xs, 1e-2, 4.0).tobytes() == \
            jcheb.chebyshev_eval(c, xs, 1e-2, 4.0).tobytes()


def test_chebyshev_apply_matches_eigenbasis():
    rs = np.random.default_rng(0)
    a = rs.normal(size=(12, 12)) + 1j * rs.normal(size=(12, 12))
    h = a @ a.conj().T / 24 + 0.05 * np.eye(12)
    w_, v_ = np.linalg.eigh(h)
    lo, hi = 0.5 * w_.min(), 2.0 * w_.max()
    c = chebyshev_coeffs(lambda x: x**-0.25, 40, lo, hi)
    x = rs.normal(size=(12,)) + 1j * rs.normal(size=(12,))
    ref = v_ @ (chebyshev_eval(c, w_, lo, hi) * (v_.conj().T @ x))
    ht = torch.as_tensor(h)
    out = chebyshev_apply(lambda v: ht @ v, c, torch.as_tensor(x), lo, hi)
    assert float((out - torch.as_tensor(ref)).abs().max()) < 1e-10


def _mono(c_sw=0.0, degree=12, **kw):
    return NDPolyMonomial(lat=LAT, params=nd.NDParams(c_sw=c_sw, **ND), degree=degree,
                          s_min=0.05, s_max=6.0, **kw)


def test_ndpoly_heatbath_action_consistency(gauge):
    mono = _mono(heatbath_tol=1e-8, maxiter=500)
    assert mono.max_rel_err < 5e-2
    phi2, s0, iters = mono.heatbath_info(gauge[1], rng.Key(1))
    assert 0 < iters < 500 and phi2.shape == (2, 2, 4, 3) + LAT.eo_site_shape
    s = mono.action(gauge[1], phi2)
    assert abs(float(s - s0)) / float(s0) < 1e-7


def test_ndpoly_force_vs_finite_difference(gauge):
    mono = _mono(c_sw=1.2)
    u = gauge[1]
    phi2 = wf.to_split(bridge.doublet_from_numpy(
        bridge.numpy_spinor(np.random.default_rng(2), (2, 4, 3) + LAT.eo_site_shape), LAT))
    f = mono.force(u, phi2)
    p = su3.random_momenta(rng.generator(rng.Key(3), "cpu"), (4,) + LAT.site_shape)
    eps = 1e-3
    fd = float(mono.action(su3.mul(su3.expm_ta(eps * p), u), phi2)
               - mono.action(su3.mul(su3.expm_ta(-eps * p), u), phi2)) / (2 * eps)
    pred = float(torch.sum(torch.einsum("ij...,ji...->...", f, p)).real)
    assert abs(fd - pred) < 2e-3 * abs(fd), (fd, pred)


def _reference_action_and_force(u_np, phi_np, c_sw: float, degree: int = 8):
    """S = |P(Q^2) phi|^2 and its force from the reference's jnp doublet
    operator Q (`ndoublet.q_nd`, `clover.q_nd_clover` on its own
    `sw_blocks_eo`), by the adjoint of the Clenshaw recursion.  The
    reference's own NDPolyMonomial.force (jax.grad through the checkpointed
    recursion, the clover term rebuilt at every Q) compiles for 2 and 13
    minutes here; this compiles one Q and the gradient of one Re<v, Q w>,
    and is the same derivative:

        B_k = 2 t B_{k+1} - B_{k+2} + c_k phi,  psi = t B_1 - B_2 + c_0/2 phi,
        t = a Q^2 + b,  dpsi = a dA B_1 + sum_{k=1}^{n-1} 2a T_k(t) dA B_{k+1},

    so dS = 2 Re<psi, dpsi> is a sum of Re<V_j, dQ (Q W_j)> + Re<Q V_j, dQ W_j>
    with V_j in {psi, T_k(t) psi} and W_j the B's, all stopped."""
    params = jnd.NDParams(c_sw=c_sw, **ND)
    jm = jpoly.NDPolyMonomial(lat=JL, params=params, degree=degree, s_min=0.05, s_max=6.0)
    c, lo, hi = jm.coeffs, jm.s_min, jm.s_max
    a, b = 2.0 / (hi - lo), -(hi + lo) / (hi - lo)
    ph = jw.boundary_phases(params.wilson, JL)

    def q_apply(uu, x):
        ueo = j_pack(uu, JL)
        if c_sw:
            sw_e, sw_o = jcl.sw_blocks_eo(uu, params.kappa, params.c_sw, JL)
            return jcl.q_nd_clover(ueo, sw_e, sw_o, x, params, JL, ph)
        return jnd.q_nd(ueo, x, params, JL, ph)

    q = jax.jit(q_apply)
    grad_pair = jax.jit(jax.grad(lambda uu, v, w: j_dot_re(v, q_apply(uu, w))))
    u, phi = jnp.asarray(u_np), jnp.asarray(phi_np)

    def t(v):
        return a * q(u, q(u, v)) + b * v

    b1 = b2 = jnp.zeros_like(phi)
    bs = []
    for ck in c[:0:-1]:
        b1, b2 = 2.0 * t(b1) - b2 + float(ck) * phi, b1
        bs.append(b1)
    psi = t(b1) - b2 + 0.5 * c[0] * phi
    w, v = bs[::-1], [psi, t(psi)]
    while len(v) < degree:
        v.append(2.0 * t(v[-1]) - v[-2])
    g = 0.0
    for j in range(degree):
        beta = 2.0 * a if j == 0 else 4.0 * a
        g = g + beta * (grad_pair(u, v[j], q(u, w[j])) + grad_pair(u, q(u, v[j]), w[j]))
    return float(j_norm_sq(psi)), np.asarray(j_ta_force_from_grad(u, g)), jm.coeffs


@pytest.mark.parametrize("c_sw", [0.0, 1.2], ids=["tm", "clover"])
def test_ndpoly_action_and_force_match_reference(gauge, c_sw):
    u_np, u = gauge
    phi_np = bridge.numpy_spinor(np.random.default_rng(4), (2, 4, 3) + JL.eo_site_shape)
    s_ref, f_ref, coeffs = _reference_action_and_force(u_np, phi_np, c_sw)
    mono = _mono(c_sw=c_sw, degree=8)
    np.testing.assert_array_equal(mono.coeffs, coeffs)
    phi2 = wf.to_split(bridge.doublet_from_numpy(phi_np, LAT))
    s = float(mono.action(u, phi2))
    assert abs(s - s_ref) < 1e-6 * abs(s_ref), (s, s_ref)
    f = bridge.to_numpy(mono.force(u, phi2))
    assert np.max(np.abs(f - f_ref)) < 1e-5 * np.max(np.abs(f_ref))


def test_mu_shift_reweighting_matches_reference(gauge):
    u_np, u = gauge
    p_old, p_new = dict(kappa=0.13, mu=0.05), dict(kappa=0.13, mu=0.1)
    etas = [bridge.numpy_spinor(np.random.default_rng(20 + i), (4, 3) + JL.eo_site_shape)
            for i in range(2)]
    ueo = j_pack(jnp.asarray(u_np), JL)
    jold, jnew = jw.DiracParams(**p_old), jw.DiracParams(**p_new)
    ph_old, ph_new = jw.boundary_phases(jold, JL), jw.boundary_phases(jnew, JL)

    @jax.jit
    def ref_sample(eta):
        x = jw.q_hat_pm(ueo, eta, jnew, JL, ph_new)
        m_eta = j_cg(lambda v: jw.q_hat_pm(ueo, v, jold, JL, ph_old), x, tol=1e-9,
                     maxiter=1000).x
        return j_norm_sq(eta) - j_dot_re(eta, m_eta)

    ref = np.array([float(ref_sample(jnp.asarray(e))) for e in etas])
    out = mu_shift_reweighting(u, DiracParams(**p_old), DiracParams(**p_new), LAT, rng.Key(0),
                               tol=1e-9, maxiter=1000,
                               etas=[bridge.spinor_from_numpy(e, LAT) for e in etas])
    assert out.dtype == torch.float64 and out.shape == (2,)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4)
    assert np.all(ref < 0)  # det grows with |mu|: exponents of det(M)^-1 < 1


def test_mu_shift_reweighting_identity(gauge):
    """Equal parameters: M = 1, every sample 0 up to the solve."""
    p = DiracParams(kappa=0.13, mu=0.05)
    s = mu_shift_reweighting(gauge[1], p, p, LAT, rng.Key(10), n_samples=2, tol=1e-10)
    assert s.shape == (2,) and float(s.abs().max()) < 1e-3
