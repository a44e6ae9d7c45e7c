"""Parity of the port's overlap operator with the JAX reference
(`tmlqcd_tpu.ops.overlap`), on the CPU: the setup from the same Lanczos
start vector, sign(Q_W) and D_ov on the reference's setup carried across as
numpy (`bridge.overlap_setup_from_numpy`), and `invert_overlap` with SUMR
(CGNE: tests/test_torch_overlap_cgne.py, a file of its own for its compile
time).

4^4, a weakly fluctuating gauge (`bridge.numpy_smooth_su3`), rho = 1,
m = 0.3, degree 8, 2 deflated modes, 30 Lanczos steps: the sign is a poor
approximation at this degree, which does not matter here — both packages
evaluate the same polynomial.  The reference runs its jnp `d_full` in
complex64; the port runs every Q_W on K1's plain version (f32 split
fields).  Tolerances:
* setup: lo^2, hi^2 and the Ritz values <v, Q^2 v> of the deflated modes
  1e-4 relative, the Ritz signs equal (f32 Lanczos with full
  reorthogonalisation in both, different summation orders);
* sign_q and dov_psi on the same setup: 1e-5 relative (f32 rounding over
  4 (8 + 1) + 2 = 38 hops);
* SUMR: iteration counts within 1, solutions 1e-5 relative.
The reference compiles one D_ov and the SUMR loop body once each; its
sign_q for the sign test is derived from the jitted D_ov.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmlqcd_tpu import rng as jrng
from tmlqcd_tpu.lattice import Lattice as JLattice
from tmlqcd_tpu.ops import overlap as jov
from tmlqcd_tpu_torch import bridge
from tmlqcd_tpu_torch.gamma import apply_gamma5
from tmlqcd_tpu_torch.lattice import Lattice
from tmlqcd_tpu_torch.ops import overlap as ov

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
JPARAMS = jov.OverlapParams(rho=1.0, m=0.3, degree=8, n_ev=2, lanczos_steps=30)
TOL = 1e-6


def _rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def pair():
    """(reference setup, port setup from the same v0, port setup from the
    reference's, gauge, two spinors as numpy)."""
    gen = np.random.default_rng(31)
    u = bridge.numpy_smooth_su3(gen, (4,) + LAT.site_shape)
    psi = bridge.numpy_spinor(gen, (4, 3) + LAT.site_shape)
    phi = bridge.numpy_spinor(gen, (4, 3) + LAT.site_shape)
    key = jax.random.key(8)
    s_ref = jov.make_overlap(jnp.asarray(u), JPARAMS, JL, key=key)
    # the reference's Lanczos start vector (ops/overlap.py:123-124)
    v0 = np.asarray(jrng.normal_spinor(key, (4, 3) + JL.site_shape, jnp.complex64))
    ut = bridge.gauge_from_numpy(u, LAT)
    s_own = ov.make_overlap(ut, bridge.overlap_params_from(JPARAMS), LAT,
                            v0=torch.as_tensor(np.array(v0)))
    s_via = bridge.overlap_setup_from_numpy(
        u, np.asarray(s_ref.evecs), np.asarray(s_ref.ev_signs), s_ref.coeffs, s_ref.lo2,
        s_ref.hi2, s_ref.params, LAT, s_ref.ev_resid)
    return s_ref, s_own, s_via, u, psi, phi


def test_setup_from_the_same_start_vector(pair):
    s_ref, s_own, _, u, _, _ = pair
    assert s_own.evecs.shape[0] == np.asarray(s_ref.evecs).shape[0] == 2
    assert abs(s_own.lo2 - s_ref.lo2) <= 1e-4 * s_ref.lo2
    assert abs(s_own.hi2 - s_ref.hi2) <= 1e-4 * s_ref.hi2
    np.testing.assert_array_equal(s_own.ev_signs.numpy(), np.asarray(s_ref.ev_signs))
    np.testing.assert_allclose(s_own.coeffs, s_ref.coeffs, rtol=2e-4)
    # Ritz values of the deflated modes, <v, Q^2 v> = |Q v|^2, on one operator
    ut = bridge.gauge_from_numpy(u, LAT)
    p = s_own.params

    def ritz(vs):
        return np.array([float(torch.linalg.vector_norm(ov.qw_plain(ut, v, p, LAT)) ** 2)
                         for v in vs])

    mine = ritz(s_own.evecs)
    ref = ritz(torch.as_tensor(np.array(s_ref.evecs)))
    np.testing.assert_allclose(mine, ref, rtol=1e-4)
    assert s_own.lanczos_steps == 30


def test_sign_and_dov_on_the_reference_setup(pair):
    s_ref, _, s_via, _, psi, _ = pair
    d_ref = np.asarray(jax.jit(lambda x: jov.dov_psi(s_ref, x))(jnp.asarray(psi)))
    p = s_via.params
    # sign(Q) psi = gamma5 (D psi - (rho + m/2) psi) / (rho - m/2)
    sign_ref = apply_gamma5(torch.as_tensor((d_ref - (p.rho + 0.5 * p.m) * psi)
                                            / (p.rho - 0.5 * p.m)))
    x = torch.as_tensor(psi)
    assert _rel(ov.dov_psi(s_via, x), d_ref) <= 1e-5
    assert _rel(ov.sign_q(s_via, x), sign_ref) <= 1e-5


def test_invert_overlap_sumr_matches_reference(pair):
    s_ref, _, s_via, _, _, phi = pair
    ref = jov.invert_overlap(s_ref, jnp.asarray(phi), tol=TOL, maxiter=100, solver="sumr")
    mine = ov.invert_overlap(s_via, torch.as_tensor(phi), tol=TOL, maxiter=100, solver="sumr")
    assert abs(mine.iterations - int(ref.iterations)) <= 1, (mine.iterations, int(ref.iterations))
    assert 5 < mine.iterations < 100
    assert _rel(mine.x, np.asarray(ref.x)) <= 1e-5
