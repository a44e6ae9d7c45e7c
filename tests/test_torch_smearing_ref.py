"""The port's smearing (meas/smearing.py) and polar SU(3) projection
(su3.project_su3_polar) against the JAX reference (tmlqcd_tpu), on one 4^4
random gauge on the CPU (the reference's jnp functions jitted, XLA's backend
optimisations off).

Tolerance 1e-5 absolute on links and spinor entries of O(1): both packages
run the same f32 formulas in another order; the polar projection's Newton
steps and the determinant phase would differ by a Z3 phase (O(1)) on another
branch of the cube root.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmlqcd_tpu import su3 as jsu3
from tmlqcd_tpu.lattice import Lattice as JLattice
from tmlqcd_tpu.meas import smearing as jsmear
from tmlqcd_tpu_torch import bridge, su3
from tmlqcd_tpu_torch.lattice import Lattice
from tmlqcd_tpu_torch.meas import smearing

torch.set_num_threads(1)

DIMS = (4, 4, 4, 4)
JL, LAT = JLattice(DIMS), Lattice(DIMS)


@pytest.fixture(scope="module", autouse=True)
def _quick_reference_compiles():
    """XLA's backend optimisations off while this module runs."""
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", False)


@pytest.fixture(scope="module")
def gauge():
    u = bridge.numpy_su3(np.random.default_rng(41), (4,) + JL.site_shape)
    return jnp.asarray(u), bridge.gauge_from_numpy(u, LAT)


def _maxdiff(out: torch.Tensor, ref) -> float:
    return float(np.max(np.abs(bridge.to_numpy(out) - np.asarray(ref))))


def test_project_su3_polar_matches_reference(gauge):
    """A sum far from SU(3) (its determinant's phase spread over the whole
    circle, so every branch of angle(det) / 3 is exercised)."""
    ju, tu = gauge
    jm = 1.7 * ju[:, :, 0] + 0.9 * ju[:, :, 1] - 0.5j * ju[:, :, 2]
    tm = 1.7 * tu[:, :, 0] + 0.9 * tu[:, :, 1] - 0.5j * tu[:, :, 2]
    ref = jax.jit(jsu3.project_su3_polar)(jm)
    assert _maxdiff(su3.project_su3_polar(tm), ref) < 1e-5


def test_stout_smear_matches_reference(gauge):
    ju, tu = gauge
    ref = jax.jit(lambda u: jsmear.stout_smear(u, JL, rho=0.1, n_iter=3))(ju)
    assert _maxdiff(smearing.stout_smear(tu, LAT, rho=0.1, n_iter=3), ref) < 1e-5


def test_ape_smear_spatial_matches_reference(gauge):
    ju, tu = gauge
    ref = jax.jit(lambda u: jsmear.ape_smear_spatial(u, JL, alpha=0.5, n_iter=2))(ju)
    assert _maxdiff(smearing.ape_smear_spatial(tu, LAT, alpha=0.5, n_iter=2), ref) < 1e-5


def test_jacobi_smear_matches_reference(gauge):
    ju, tu = gauge
    psi = bridge.numpy_spinor(np.random.default_rng(42), (4, 3) + JL.site_shape)
    ref = jax.jit(lambda p, u: jsmear.jacobi_smear(p, u, JL, kappa=0.2, n_iter=10))(
        jnp.asarray(psi), ju)
    out = smearing.jacobi_smear(torch.as_tensor(psi), tu, LAT, kappa=0.2, n_iter=10)
    assert _maxdiff(out, ref) < 1e-5
