"""One full twisted-clover trajectory of the port against the JAX reference
(tmlqcd_tpu) on the CPU, and the lowering of the clover sample input.

The action GAUGE + CLOVERTRLOG + CLOVERDET + CLOVERDETRATIO is lowered from
one input text by both packages' `build_hmc`; the reference's draws are
re-derived from its key and injected into the port, which runs its plain
path (CPU tensors).

Tolerances (4^4, steps (1,1,2), tol 1e-10): |ddH| <= 1e-3, |dplaq| <= 1e-5
and max|dU| <= 1e-4, as for the twisted-mass trajectory of
test_torch_hmc.py: both run the same f32 trajectory with the same draws in
another summation order (measured |ddH| 1.2e-5 at |H| ~ 1.5e4, |dplaq| 1e-8,
max|dU| 5.7e-7);
iteration counts are equal.
"""

import dataclasses
import os

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
    reference's clover trajectory takes far longer to compile than to run."""
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", False)


DIMS = (4, 4, 4, 4)
JL, LAT = JLattice(DIMS), Lattice(DIMS)
SAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "sample-input")


def _maxdiff(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


# ---------------------------------------------------------------------------
# one full clover trajectory with the reference's draws injected
# ---------------------------------------------------------------------------

_TRAJ_INPUT = """L = 4
T = 4
beta = 5.3
tau = 1.0
NumberOfTimescales = 3
BeginMonomial GAUGE
  Timescale = 0
  IntegrationSteps = 1
EndMonomial
BeginMonomial CLOVERTRLOG
  Timescale = 0
  kappa = 0.13
  2KappaMu = 0.0026
  CSW = 1.74
EndMonomial
BeginMonomial CLOVERDET
  Timescale = 1
  kappa = 0.13
  2KappaMu = 0.026
  CSW = 1.74
  AcceptancePrecision = 1e-20
  ForcePrecision = 1e-20
  MaxSolverIterations = 1000
  IntegrationSteps = 1
EndMonomial
BeginMonomial CLOVERDETRATIO
  Timescale = 2
  kappa = 0.13
  2KappaMu = 0.0026
  2KappaMu2 = 0.026
  CSW = 1.74
  AcceptancePrecision = 1e-20
  ForcePrecision = 1e-20
  MaxSolverIterations = 1000
  IntegrationSteps = 2
EndMonomial
"""


@pytest.fixture(scope="module")
def trajectory_pair():
    u = bridge.numpy_su3(np.random.default_rng(53), (4,) + JL.site_shape)
    cfg = jconfig.build_hmc(jconfig_tmlqcd.parse_input(_TRAJ_INPUT))

    def reference(u, key):
        u_ref, st_ref = j_hmc_trajectory(cfg, u, key)
        # the reference's draws, re-derived from its key (hmc/trajectory.py:96-126)
        k_mom, k_pf, k_acc = jax.random.split(key, 3)
        mom = jsu3.random_momenta(k_mom, u.shape[2:], jnp.complex64)
        etas = [jrng.normal_spinor(jrng.fold(k_pf, 1000 + i), (4, 3) + JL.eo_site_shape)
                for i in (2, 3)]
        return u_ref, st_ref, mom, etas, jrng.uniform(k_acc)

    u_ref, st_ref, mom, etas, uni = jax.jit(reference)(u, jax.random.key(4))
    draws = Draws(bridge.gauge_from_numpy(np.asarray(mom), LAT),
                  [None, None] + [bridge.spinor_from_numpy(np.asarray(e), LAT) for e in etas],
                  float(uni))
    u_out, st = hmc_trajectory(config.build_hmc(config_tmlqcd.parse_input(_TRAJ_INPUT)),
                               bridge.gauge_from_numpy(u, LAT), rng.Key(0), draws=draws)
    return st_ref, st, np.asarray(u_ref), u_out


def test_clover_trajectory_delta_h_matches_reference(trajectory_pair):
    st_ref, st, _, _ = trajectory_pair
    assert abs(st.h_old - float(st_ref.h_old)) < 1e-3
    assert abs(st.delta_h - float(st_ref.delta_h)) < 1e-3


def test_clover_trajectory_plaquette_and_gauge_match_reference(trajectory_pair):
    st_ref, st, u_ref, u_out = trajectory_pair
    assert st.accepted == bool(st_ref.accepted)
    assert abs(st.plaquette - float(st_ref.plaquette)) < 1e-5
    assert _maxdiff(u_out, u_ref) < 1e-4


def test_clover_trajectory_iteration_counts_match_reference(trajectory_pair):
    st_ref, st, _, _ = trajectory_pair
    assert st.acc_iterations == [int(i) for i in st_ref.acc_iterations]
    assert st.force_iterations == [int(i) for i in st_ref.force_iterations]
    assert st.acc_iterations[:2] == [0, 0] and st.force_iterations[:2] == [0, 0]
    assert st.force_iterations[2] > 0 and st.force_iterations[3] > 0



# ---------------------------------------------------------------------------
# input
# ---------------------------------------------------------------------------


def test_hmc6_lowers_to_the_reference_monomials():
    """hmc6 as shipped, ONLINE block included, builds the same lattice and
    monomial parameters in both packages."""
    with open(os.path.join(SAMPLES, "hmc6-nf2-clover-hasenbusch.input")) as f:
        text = f.read()
    cfg = config_tmlqcd.parse_input(text)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jconfig_tmlqcd.parse_input(text))
    assert [m.type for m in cfg.meas] == ["ONLINE"]
    ref = jconfig.build_hmc(jconfig_tmlqcd.parse_input(text))
    out = config.build_hmc(cfg)
    assert out.lat.dims == ref.lat.dims == (48, 24, 24, 24)
    assert [type(m).__name__ for m in out.monomials] == [type(m).__name__ for m in ref.monomials] \
        == ["GaugeMonomial", "CloverTrlogMonomial", "CloverDetMonomial", "CloverDetRatioMonomial"]
    for mo, mr in zip(out.monomials, ref.monomials):
        for field in ("timescale", "acc_tol", "force_tol", "maxiter", "solver", "chrono_n",
                      "beta", "c1", "name"):
            assert getattr(mo, field, None) == getattr(mr, field, None)
        for field in ("params", "params1", "params2"):
            if hasattr(mr, field):
                assert dataclasses.asdict(getattr(mo, field)) == dataclasses.asdict(getattr(mr, field))
    assert out.monomials[3].params1.c_sw == 1.74 and out.monomials[3].params2.mutld == 0.05
    assert out.integrator.tau == ref.integrator.tau
    assert [(lv.scheme, lv.steps) for lv in out.integrator.levels] == \
        [(lv.scheme, lv.steps) for lv in ref.integrator.levels]
