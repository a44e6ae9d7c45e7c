"""Parity of the PyTorch port's det-family heatbath and forces and of one
Nf=2 twisted-mass Hasenbusch trajectory with the JAX reference
(tmlqcd_tpu), on the CPU; the solvers, gauge action, input reader,
checkpoints and CLI are in tests/test_torch_hmc.py.

Inputs are drawn from seeded numpy generators (or, for the trajectory, are
the reference's own draws re-derived from its key) and handed to both
packages as numpy arrays.  The port runs its plain path (CPU tensors); the
reference runs its jnp path, as it does on the CPU.

Tolerances, each stated where it is used:
* forces: 1e-5 absolute on forces of O(1..10) — f32 operators, f64 sums;
  measured 6e-7 .. 2e-6.
* trajectory (4^4, steps (1,1,2), tol 1e-10): |ddH| <= 1e-3 and
  |dplaq| <= 1e-5.  Both run the same f32 trajectory with the same draws
  and differ by summation order only: measured |ddH| 4.1e-5 and |dplaq|
  9e-9, with |H| ~ 1.5e4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmlqcd_tpu import rng as jrng
from tmlqcd_tpu import su3 as jsu3
from tmlqcd_tpu.hmc import hmc_trajectory as j_hmc_trajectory
from tmlqcd_tpu.hmc import monomials as jmono
from tmlqcd_tpu.lattice import Lattice as JLattice
from tmlqcd_tpu.lattice import pack_gauge_eo as j_pack
from tmlqcd_tpu.models.suites import nf2_twisted_mass_hasenbusch as j_suite
from tmlqcd_tpu.ops import wilson as jw
from tmlqcd_tpu_torch import bridge, rng
from tmlqcd_tpu_torch.hmc import Draws, hmc_trajectory, monomials
from tmlqcd_tpu_torch.lattice import Lattice
from tmlqcd_tpu_torch.models.suites import nf2_twisted_mass_hasenbusch
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
LIGHT = dict(kappa=0.15, mu=0.03)
HEAVY = dict(kappa=0.15, mu=0.3)


def _maxdiff(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


@pytest.fixture(scope="module")
def gauge():
    u = bridge.numpy_su3(np.random.default_rng(20), (4,) + JL.site_shape)
    return u, bridge.gauge_from_numpy(u, LAT)


@pytest.fixture(scope="module")
def pseudofermion():
    return bridge.numpy_spinor(np.random.default_rng(21), (4, 3) + JL.eo_site_shape)


# ---------------------------------------------------------------------------
# forces on the same (U, phi); tolerance 1e-5 absolute (see module docstring)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def reference_forces(gauge, pseudofermion):
    """The reference's DET heatbath field and DET / DETRATIO forces on the
    jnp path, in one compiled program."""
    u, _ = gauge
    jp = jw.DiracParams(**LIGHT)
    det = jmono.DetMonomial(lat=JL, params=jp, acc_tol=1e-9, force_tol=1e-9)
    ratio = jmono.DetRatioMonomial(lat=JL, params1=jp, params2=jw.DiracParams(**HEAVY),
                                   acc_tol=1e-9, force_tol=1e-9)

    def forces(u, eta):
        phi = jw.q_hat(j_pack(u, JL), eta, jp, JL, jw.boundary_phases(jp, JL), -1.0)
        return phi, det.force(u, phi), ratio.force(u, eta)

    return tuple(np.asarray(x) for x in jax.jit(forces)(u, pseudofermion))


def test_det_heatbath_and_force_match_reference(gauge, pseudofermion, reference_forces):
    u, ut = gauge
    ref_phi, ref, _ = reference_forces
    tm = monomials.DetMonomial(lat=LAT, params=w.DiracParams(**LIGHT), acc_tol=1e-9,
                               force_tol=1e-9)
    phi2, s0 = tm.heatbath(ut, None, bridge.spinor_from_numpy(pseudofermion, LAT))
    assert _maxdiff(wf.from_split(phi2), ref_phi) < 1e-5
    assert abs(float(s0) - float(np.sum(np.abs(pseudofermion.astype(np.complex128)) ** 2))) < 1e-9
    out = tm.force(ut, wf.to_split(bridge.spinor_from_numpy(ref_phi, LAT)))
    assert float(np.max(np.abs(ref))) > 0.1
    assert _maxdiff(out, ref) < 1e-5


def test_detratio_force_matches_reference(gauge, pseudofermion, reference_forces):
    u, ut = gauge
    ref = reference_forces[2]
    tm = monomials.DetRatioMonomial(lat=LAT, params1=w.DiracParams(**LIGHT),
                                    params2=w.DiracParams(**HEAVY), acc_tol=1e-9,
                                    force_tol=1e-9)
    out = tm.force(ut, wf.to_split(bridge.spinor_from_numpy(pseudofermion, LAT)))
    assert float(np.max(np.abs(ref))) > 0.01
    assert _maxdiff(out, ref) < 1e-5


# ---------------------------------------------------------------------------
# one full trajectory with the reference's draws injected
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def trajectory_pair():
    kw = dict(beta=5.3, kappa=0.13, mu=0.01, mu_hasenbusch=0.1, tau=1.0, steps=(1, 1, 2),
              acc_tol=1e-10, force_tol=1e-10, maxiter=1000)
    u = bridge.numpy_su3(np.random.default_rng(23), (4,) + JL.site_shape)
    cfg = j_suite(JL, **kw)

    def reference(u, key):
        u_ref, st_ref = j_hmc_trajectory(cfg, u, key)
        # the reference's draws, re-derived from its key (hmc/trajectory.py:96-126)
        k_mom, k_pf, k_acc = jax.random.split(key, 3)
        mom = jsu3.random_momenta(k_mom, u.shape[2:], jnp.complex64)
        etas = [jrng.normal_spinor(jrng.fold(k_pf, 1000 + i), (4, 3) + JL.eo_site_shape)
                for i in (1, 2)]
        return u_ref, st_ref, mom, etas, jrng.uniform(k_acc)

    u_ref, st_ref, mom, etas, uni = jax.jit(reference)(u, jax.random.key(3))
    draws = Draws(bridge.gauge_from_numpy(np.asarray(mom), LAT),
                  [None] + [bridge.spinor_from_numpy(np.asarray(e), LAT) for e in etas],
                  float(uni))
    u_out, st = hmc_trajectory(nf2_twisted_mass_hasenbusch(LAT, **kw),
                               bridge.gauge_from_numpy(u, LAT), rng.Key(0), draws=draws)
    return st_ref, st, np.asarray(u_ref), u_out


def test_trajectory_delta_h_matches_reference(trajectory_pair):
    st_ref, st, _, _ = trajectory_pair
    assert abs(st.h_old - float(st_ref.h_old)) < 1e-3
    assert abs(st.delta_h - float(st_ref.delta_h)) < 1e-3


def test_trajectory_plaquette_and_gauge_match_reference(trajectory_pair):
    st_ref, st, u_ref, u_out = trajectory_pair
    assert st.accepted == bool(st_ref.accepted)
    assert abs(st.plaquette - float(st_ref.plaquette)) < 1e-5
    assert _maxdiff(u_out, u_ref) < 1e-4


def test_trajectory_iteration_counts_match_reference(trajectory_pair):
    st_ref, st, _, _ = trajectory_pair
    assert st.acc_iterations == [int(i) for i in st_ref.acc_iterations]
    assert st.force_iterations == [int(i) for i in st_ref.force_iterations]
    assert st.force_iterations[1] > 0 and st.force_iterations[2] > 0
