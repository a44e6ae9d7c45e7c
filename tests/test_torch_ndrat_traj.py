"""One full GAUGE + NDRAT trajectory of the port against the JAX reference
(tmlqcd_tpu) on the CPU.

The action is lowered from one input text by both packages' `build_hmc`; the
reference's draws are re-derived from its key and injected into the port,
which runs its plain path (CPU tensors: split f32 doublets, every hop through
the plain multi-RHS version on the flavour axis).  The reference runs its
complex jnp operator.  In a file of its own: the reference's trajectory
compiles for a minute or more.

Tolerances (4^4, steps (1, 2), rational order 6 on [0.01, 4.7], tol 1e-10):
|ddH| <= 1e-3, |dplaq| <= 1e-5 and max|dU| <= 1e-4, as for the twisted-mass
and clover trajectories: both sides run the same f32 trajectory with the same
draws in another summation order; the acceptance and every multishift
iteration count are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmlqcd_tpu import config as jconfig
from tmlqcd_tpu import config_tmlqcd as jconfig_tmlqcd
from tmlqcd_tpu import rng as jrng
from tmlqcd_tpu import su3 as jsu3
from tmlqcd_tpu.hmc import hmc_trajectory as j_hmc_trajectory
from tmlqcd_tpu.lattice import Lattice as JLattice
from tmlqcd_tpu_torch import bridge, config, config_tmlqcd, rng
from tmlqcd_tpu_torch.hmc import Draws, hmc_trajectory
from tmlqcd_tpu_torch.lattice import Lattice

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

_TRAJ_INPUT = """L = 4
T = 4
beta = 5.3
tau = 1.0
NumberOfTimescales = 2
BeginMonomial GAUGE
  Timescale = 0
  IntegrationSteps = 1
EndMonomial
BeginMonomial NDRAT
  Timescale = 1
  kappa = 0.13
  2Kappamubar = 0.1
  2Kappaepsbar = 0.12
  DegreeOfRational = 6
  StildeMin = 0.01
  StildeMax = 4.7
  AcceptancePrecision = 1e-20
  ForcePrecision = 1e-20
  MaxSolverIterations = 1000
  IntegrationSteps = 2
EndMonomial
"""


@pytest.fixture(scope="module")
def trajectory_pair():
    u = bridge.numpy_su3(np.random.default_rng(80), (4,) + JL.site_shape)
    cfg = jconfig.build_hmc(jconfig_tmlqcd.parse_input(_TRAJ_INPUT))

    def reference(u, key):
        u_ref, st_ref = j_hmc_trajectory(cfg, u, key)
        # the reference's draws, re-derived from its key (hmc/trajectory.py:96-126)
        k_mom, k_pf, k_acc = jax.random.split(key, 3)
        mom = jsu3.random_momenta(k_mom, u.shape[2:], jnp.complex64)
        eta = jrng.normal_spinor(jrng.fold(k_pf, 1001), (2, 4, 3) + JL.eo_site_shape)
        return u_ref, st_ref, mom, eta, jrng.uniform(k_acc)

    u_ref, st_ref, mom, eta, uni = jax.jit(reference)(u, jax.random.key(5))
    draws = Draws(bridge.gauge_from_numpy(np.asarray(mom), LAT),
                  [None, bridge.doublet_from_numpy(np.asarray(eta), LAT)], float(uni))
    u_out, st = hmc_trajectory(config.build_hmc(config_tmlqcd.parse_input(_TRAJ_INPUT)),
                               bridge.gauge_from_numpy(u, LAT), rng.Key(0), draws=draws)
    return st_ref, st, np.asarray(u_ref), u_out


def test_ndrat_trajectory_delta_h_matches_reference(trajectory_pair):
    st_ref, st, _, _ = trajectory_pair
    assert abs(st.h_old - float(st_ref.h_old)) < 1e-3
    assert abs(st.delta_h - float(st_ref.delta_h)) < 1e-3
    assert abs(float(st_ref.delta_h)) > 1e-2  # a real trajectory, not a null move


def test_ndrat_trajectory_plaquette_and_gauge_match_reference(trajectory_pair):
    st_ref, st, u_ref, u_out = trajectory_pair
    assert st.accepted == bool(st_ref.accepted)
    assert abs(st.plaquette - float(st_ref.plaquette)) < 1e-5
    assert float(np.max(np.abs(np.asarray(u_out) - u_ref))) < 1e-4


def test_ndrat_trajectory_iteration_counts_match_reference(trajectory_pair):
    """The multishift iterations of the acceptance solve and, summed over the
    five force evaluations, of the MD solves."""
    st_ref, st, _, _ = trajectory_pair
    assert st.acc_iterations == [int(i) for i in st_ref.acc_iterations]
    assert st.force_iterations == [int(i) for i in st_ref.force_iterations]
    assert st.acc_iterations[0] == 0 and st.force_iterations[0] == 0
    assert st.acc_iterations[1] > 10 and st.force_iterations[1] > 5 * 10
