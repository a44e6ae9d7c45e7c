"""The action of the reference's multi-device proof, `dryrun_multichip`'s
phase 2 (`__graft_entry__.py:165-194`, as dryrun(4) builds it: 4^4, GAUGE
beta 5.5; CLOVERDETRATIO kappa 0.138, c_sw 1.2, mu 0.05 over 0.25, chrono
2; NDRAT kappa 0.11, mubar 0.15, epsbar 0.09, order 3 on [1e-3, 4]; tau 0.4,
2MN (1, 1); every solve to 1e-5 in at most 80 iterations), one trajectory
of the port in one process against the reference on the CPU.

The port's action is `models.suites.dryrun_action`; the reference's is built
as the dryrun builds it and runs its jnp route (no Pallas interpret build).
The reference's draws are re-derived from its key and injected into the
port.  Tolerances, as for the port's other trajectories against the
reference (both sides run one f32 trajectory from the same draws in another
summation order): |ddH| <= 1e-3, |dplaq| <= 1e-5, max|dU| <= 1e-4; the
acceptance and every solver iteration count equal.  The same action on
(2, 2) ranks against one process: tests/test_torch_dist_traj.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmlqcd_tpu import rng as jrng
from tmlqcd_tpu import su3 as jsu3
from tmlqcd_tpu.hmc import (
    CloverDetRatioMonomial as JCloverDetRatio,
    GaugeMonomial as JGauge,
    HMCConfig as JHMCConfig,
    IntegratorConfig as JIntegratorConfig,
    Level as JLevel,
    NDRatMonomial as JNDRat,
    hmc_trajectory as j_hmc_trajectory,
)
from tmlqcd_tpu.lattice import Lattice as JLattice
from tmlqcd_tpu.ops.ndoublet import NDParams as JNDParams
from tmlqcd_tpu.ops.wilson import DiracParams as JDiracParams
from tmlqcd_tpu_torch import bridge, rng
from tmlqcd_tpu_torch.hmc import Draws, hmc_trajectory
from tmlqcd_tpu_torch.lattice import Lattice
from tmlqcd_tpu_torch.models.suites import dryrun_action

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


def _reference_action():
    """`dryrun_multichip`'s phase-2 HMCConfig, as __graft_entry__.py builds it."""
    kappa, csw = 0.138, 1.2
    return JHMCConfig(
        lat=JL,
        monomials=(
            JGauge(lat=JL, beta=5.5, timescale=0),
            JCloverDetRatio(lat=JL, params1=JDiracParams(kappa=kappa, mu=0.05, c_sw=csw),
                            params2=JDiracParams(kappa=kappa, mu=0.25, c_sw=csw), timescale=1,
                            acc_tol=1e-5, force_tol=1e-5, maxiter=80, chrono_n=2),
            JNDRat(lat=JL, params=JNDParams(kappa=0.11, mubar=0.15, epsbar=0.09), order=3,
                   s_min=1e-3, s_max=4.0, timescale=1, acc_tol=1e-5, force_tol=1e-5,
                   maxiter=80),
        ),
        integrator=JIntegratorConfig(tau=0.4, levels=(JLevel("2mn", 1), JLevel("2mn", 1))),
    )


@pytest.fixture(scope="module")
def trajectory_pair():
    # a weakly fluctuating start, so that the trajectory is a typical one
    # and not a hot start's first step
    u = bridge.numpy_smooth_su3(np.random.default_rng(83), (4,) + JL.site_shape)
    cfg = _reference_action()

    def reference(u, key):
        u_ref, st_ref = j_hmc_trajectory(cfg, u, key)
        # the reference's draws, re-derived from its key (hmc/trajectory.py:96-126)
        k_mom, k_pf, k_acc = jax.random.split(key, 3)
        mom = jsu3.random_momenta(k_mom, u.shape[2:], jnp.complex64)
        eta1 = jrng.normal_spinor(jrng.fold(k_pf, 1001), (4, 3) + JL.eo_site_shape)
        eta2 = jrng.normal_spinor(jrng.fold(k_pf, 1002), (2, 4, 3) + JL.eo_site_shape)
        return u_ref, st_ref, mom, eta1, eta2, jrng.uniform(k_acc)

    u_ref, st_ref, mom, eta1, eta2, uni = jax.jit(reference)(u, jax.random.key(7))
    draws = Draws(bridge.gauge_from_numpy(np.asarray(mom), LAT),
                  [None, bridge.spinor_from_numpy(np.asarray(eta1), LAT),
                   bridge.doublet_from_numpy(np.asarray(eta2), LAT)], float(uni))
    with torch.no_grad():
        u_out, st = hmc_trajectory(dryrun_action(LAT), bridge.gauge_from_numpy(u, LAT),
                                   rng.Key(0), draws=draws)
    return st_ref, st, np.asarray(u_ref), u_out


def test_dryrun_action_delta_h_matches_reference(trajectory_pair):
    st_ref, st, _, _ = trajectory_pair
    assert abs(st.h_old - float(st_ref.h_old)) < 1e-3
    assert abs(st.delta_h - float(st_ref.delta_h)) <= 1e-3
    assert np.isfinite(st.delta_h) and abs(float(st_ref.delta_h)) > 1e-3


def test_dryrun_action_plaquette_and_gauge_match_reference(trajectory_pair):
    st_ref, st, u_ref, u_out = trajectory_pair
    assert st.accepted == bool(st_ref.accepted)
    assert abs(st.plaquette - float(st_ref.plaquette)) <= 1e-5
    assert float(np.max(np.abs(np.asarray(u_out) - u_ref))) <= 1e-4


def test_dryrun_action_iteration_counts_match_reference(trajectory_pair):
    """The acceptance solves (CLOVERDETRATIO's CG from its chrono guess,
    NDRAT's multishift) and the force solves summed over the MD steps."""
    st_ref, st, _, _ = trajectory_pair
    assert st.acc_iterations == [int(i) for i in st_ref.acc_iterations]
    assert st.force_iterations == [int(i) for i in st_ref.force_iterations]
    assert st.force_iterations[1] > 0 and st.force_iterations[2] > 0
