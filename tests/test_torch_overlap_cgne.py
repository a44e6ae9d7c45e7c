"""Parity of the port's overlap CGNE solve with the JAX reference's
`invert_overlap(..., solver="cgne")`, on the CPU, in a file of its own: the
reference runs two sign functions eagerly before its CG loop and compiles
two in the loop body (~17 s here), and the port's own setup is carried to
the reference's `OverlapSetup` so that no reference Lanczos runs.

4^4, a weakly fluctuating gauge (`bridge.numpy_smooth_su3`), rho = 1.2
(s = 0.2), m = 0.2, degree 8, 2 deflated modes.  Tolerances: the same CG
iteration count within 1 (both stop at |r|^2 <= tol^2 |D^+ b|^2 with f64
norms on f32 fields) and solutions 1e-5 relative; the true residual
|D_ov x - b| / |b| of both within 5e-5 (the normal equations' stopping
test bounds it by tol times the condition number of D_ov, here ~10).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmlqcd_tpu.lattice import Lattice as JLattice
from tmlqcd_tpu.ops import overlap as jov
from tmlqcd_tpu_torch import bridge
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
TOL = 1e-6


def _rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_invert_overlap_cgne_matches_reference():
    gen = np.random.default_rng(41)
    u = bridge.numpy_smooth_su3(gen, (4,) + LAT.site_shape)
    v0 = torch.as_tensor(bridge.numpy_spinor(gen, (4, 3) + LAT.site_shape))
    b = bridge.numpy_spinor(gen, (4, 3) + LAT.site_shape)
    params = ov.OverlapParams(rho=1.2, m=0.2, degree=8, n_ev=2, lanczos_steps=30)
    mine_setup = ov.make_overlap(bridge.gauge_from_numpy(u, LAT), params, LAT, v0=v0)
    ref_setup = jov.OverlapSetup(
        u=jnp.asarray(u), evecs=jnp.asarray(mine_setup.evecs.numpy()),
        ev_signs=jnp.asarray(mine_setup.ev_signs.numpy()), coeffs=mine_setup.coeffs,
        lo2=mine_setup.lo2, hi2=mine_setup.hi2,
        params=jov.OverlapParams(rho=1.2, m=0.2, degree=8, n_ev=2, lanczos_steps=30),
        lat=JL, ev_resid=mine_setup.ev_resid)
    ref = jov.invert_overlap(ref_setup, jnp.asarray(b), tol=TOL, maxiter=100, solver="cgne")
    mine = ov.invert_overlap(mine_setup, torch.as_tensor(b), tol=TOL, maxiter=100,
                             solver="cgne")
    assert abs(mine.iterations - int(ref.iterations)) <= 1, (mine.iterations, int(ref.iterations))
    assert 5 < mine.iterations < 100
    assert _rel(mine.x, np.asarray(ref.x)) <= 1e-5
    bt = torch.as_tensor(b)
    for x in (mine.x, torch.as_tensor(np.array(ref.x))):
        assert _rel(ov.dov_psi(mine_setup, x), bt) <= 5e-5
