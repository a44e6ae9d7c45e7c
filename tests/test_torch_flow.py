"""Gauge observables and the Wilson flow of the port against the JAX
reference (tmlqcd_tpu), on one 4^4 random gauge on the CPU.

The reference runs its jnp functions (jitted, XLA's backend optimisations
off).  Tolerances: the observables are f64 volume sums of f32 link products,
which agree to ~1e-7 per site, so 1e-5 absolute; the flow runs 3 RK3 steps of
f32 arithmetic in a different order, so t^2 E agrees to 1e-5 relative and
the flowed links to 1e-5 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmlqcd_tpu.lattice import Lattice as JLattice
from tmlqcd_tpu.meas import gauge_obs as jobs
from tmlqcd_tpu.meas import gradient_flow as jflow
from tmlqcd_tpu_torch import bridge
from tmlqcd_tpu_torch.lattice import Lattice
from tmlqcd_tpu_torch.meas import gauge_obs, gradient_flow

torch.set_num_threads(1)

DIMS = (4, 4, 4, 4)
JL, LAT = JLattice(DIMS), Lattice(DIMS)


@pytest.fixture(scope="module", autouse=True)
def _quick_reference_compiles():
    """XLA's backend optimisations off while this module runs: the
    reference's programs here take far longer to compile than to run."""
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", False)


@pytest.fixture(scope="module")
def gauge():
    u = bridge.numpy_su3(np.random.default_rng(31), (4,) + JL.site_shape)
    return jnp.asarray(u), bridge.gauge_from_numpy(u, LAT)


@pytest.mark.parametrize("direction", [0, 3])
def test_polyakov_loop_matches_reference(gauge, direction):
    ju, tu = gauge
    ref = complex(jax.jit(lambda u: jobs.polyakov_loop(u, JL, direction))(ju))
    out = complex(gauge_obs.polyakov_loop(tu, LAT, direction))
    assert abs(out - ref) < 1e-5 and abs(ref) > 1e-4


def test_oriented_plaquettes_match_reference(gauge):
    ju, tu = gauge
    ref = np.asarray(jax.jit(lambda u: jobs.oriented_plaquettes(u, JL))(ju))
    np.testing.assert_allclose(gauge_obs.oriented_plaquettes(tu, LAT).numpy(), ref, atol=1e-5)


def test_field_strength_observables_match_reference(gauge):
    """E_plaq, E_clover and the clover charge Q."""
    ju, tu = gauge
    ref = [float(v) for v in jax.jit(lambda u: jobs.field_strength_observables(u, JL))(ju)]
    out = [float(v) for v in gauge_obs.field_strength_observables(tu, LAT)]
    np.testing.assert_allclose(out, ref, atol=1e-5)
    assert abs(float(gauge_obs.topological_charge(tu, LAT)) - ref[2]) < 1e-5


def test_wilson_flow_matches_reference(gauge):
    ju, tu = gauge
    ref = jax.jit(lambda u: jflow.wilson_flow(u, JL, eps=0.02, n_steps=3))(ju)
    out = gradient_flow.wilson_flow(tu, LAT, eps=0.02, n_steps=3)
    np.testing.assert_allclose(out.times.numpy(), np.asarray(ref.times), rtol=1e-15)
    np.testing.assert_allclose(out.t2e_plaq.numpy(), np.asarray(ref.t2e_plaq), rtol=1e-5)
    np.testing.assert_allclose(out.t2e_clover.numpy(), np.asarray(ref.t2e_clover), rtol=1e-5)
    assert float(np.abs(bridge.to_numpy(out.v) - np.asarray(ref.v)).max()) < 1e-5
    t0 = jflow.t0_scale(ref.times, ref.t2e_plaq, 0.05)
    assert abs(gradient_flow.t0_scale(out.times, out.t2e_plaq, 0.05) - t0) < 1e-5 * t0
