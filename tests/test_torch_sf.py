"""The port's Schrödinger functional (`ops/sf.py`, `SFGaugeMonomial`, the
momenta mask, SFCOUPLING) against the JAX reference and on its own, on the
CPU.

4^4 (T = L, as the SF takes it), random SU(3) gauges from numpy seeds.
Tolerances, each stated where it is used:
* action: 1e-10 relative in complex128 (the same f64 sums in a different
  order), 1e-5 in complex64 (f32 link products); dS/deta, a small
  difference of boundary sums of O(S), to the same bounds times |S| (in
  complex64 the two differ by 1.2e-4 relative at |dS/deta| ~ 1.2,
  |S| ~ 1e4); the normalisation k to 1e-12 (numpy f64 in both);
* the closed-form classical action 1e-12 and finite-difference dS/deta
  1e-7 relative (complex128), the reference's own bounds;
* the force: exactly zero on the frozen links, 1e-5 absolute against the
  reference's (complex64, forces of O(1..10)), and its directional
  derivative to 1e-6 of finite differences on the dynamical links
  (complex128);
* one masked trajectory with the reference's momenta and uniform injected
  (complex128): |ddH| <= 1e-5, MD endpoints to 1e-6, frozen links
  bit-equal to the start in both;
* sf_coupling.data: the reference's columns and number formats, k and S_sf
  to 1e-5 relative, dS/deta to 1e-5 |S| (complex64).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmlqcd_tpu import config as jconfig
from tmlqcd_tpu import config_tmlqcd as jconfig_tmlqcd
from tmlqcd_tpu import rng as jrng
from tmlqcd_tpu import su3 as jsu3
from tmlqcd_tpu.hmc import HMCConfig as JHMCConfig
from tmlqcd_tpu.hmc import IntegratorConfig as JIntegratorConfig
from tmlqcd_tpu.hmc import Level as JLevel
from tmlqcd_tpu.hmc import hmc_trajectory as j_hmc_trajectory
from tmlqcd_tpu.hmc.integrators import integrate as j_integrate
from tmlqcd_tpu.hmc.monomials import SFGaugeMonomial as JSFGaugeMonomial
from tmlqcd_tpu.lattice import Lattice as JLattice
from tmlqcd_tpu.meas import runner as jrunner
from tmlqcd_tpu.ops import sf as jsf
from tmlqcd_tpu_torch import bridge, config, config_tmlqcd, rng, su3
from tmlqcd_tpu_torch.hmc import Draws, HMCConfig, IntegratorConfig, Level, hmc_trajectory
from tmlqcd_tpu_torch.hmc.integrators import integrate
from tmlqcd_tpu_torch.hmc.monomials import SFGaugeMonomial
from tmlqcd_tpu_torch.lattice import Lattice
from tmlqcd_tpu_torch.meas import runner
from tmlqcd_tpu_torch.ops import sf

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
BETA = 6.0
C128 = (torch.complex128, jnp.complex128)


def _gauge(seed: int) -> np.ndarray:
    return bridge.numpy_su3(np.random.default_rng(seed), (4,) + LAT.site_shape)


@pytest.mark.parametrize("dtypes, rtol", [(C128, 1e-10), ((torch.complex64, jnp.complex64), 1e-5)])
def test_action_dsdeta_and_k_match_reference(dtypes, rtol):
    u = _gauge(11)
    ut = torch.as_tensor(u).to(dtypes[0])
    uj = jnp.asarray(u, dtypes[1])
    kw = dict(eta=0.2, nu=0.1, ct=0.9)
    s_ref, g_ref = (float(v) for v in jax.jit(lambda u: (
        jsf.sf_gauge_action(u, BETA, JL, **kw), jsf.sf_dS_deta(u, BETA, JL, **kw)))(uj))
    s = float(sf.sf_gauge_action(ut, BETA, LAT, **kw))
    assert abs(s - s_ref) <= rtol * abs(s_ref)
    # dS/deta is a small difference of O(S) boundary sums: relative to S
    g = float(sf.sf_dS_deta(ut, BETA, LAT, **kw))
    assert abs(g - g_ref) <= rtol * abs(s_ref)
    assert abs(sf.sf_coupling_normalization(LAT, 0.9)
               - jsf.sf_coupling_normalization(JL, 0.9)) <= 1e-12
    ph, ph_ref = sf.sf_phases(0.2, 0.1), jsf.sf_phases(jnp.float64(0.2), 0.1)
    for a, b in zip(ph, ph_ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-15)


def test_classical_action_closed_form_and_normalisation():
    """Only the temporal plaquettes of the abelian background contribute,
    with constant angles theta_j = (phi'_j - phi_j)/(L T); k = (6/beta)
    dS/deta at the classical solution, eta = 0, and the published
    12 L^2 [sin(2 gamma) + sin(gamma)] at T = L, c_t = 1."""
    eta = 0.3
    u = sf.sf_classical_background(LAT, eta, dtype=torch.complex128)
    s = float(sf.sf_gauge_action(u, BETA, LAT, eta))
    t_ext, el = LAT.dims[0], LAT.dims[1]
    vs = LAT.dims[1] * LAT.mf
    phi, phi_p = (p.numpy() for p in sf.sf_phases(eta))
    theta = (phi_p - phi) / (el * t_ext)
    s_cl = BETA * 3 * vs * t_ext * (1.0 - np.sum(np.cos(theta)) / 3.0)
    assert abs(s - s_cl) / s_cl < 1e-12
    u0 = sf.sf_classical_background(LAT, 0.0, dtype=torch.complex128)
    k = sf.sf_coupling_normalization(LAT)
    assert abs(k - 6.0 / BETA * float(sf.sf_dS_deta(u0, BETA, LAT, 0.0))) / k < 1e-10
    gamma = np.pi / (3.0 * el * t_ext)
    assert abs(k - 12.0 * el * el * (np.sin(2 * gamma) + np.sin(gamma))) < 1e-10


def test_dsdeta_matches_finite_difference():
    u = torch.as_tensor(_gauge(12)).to(torch.complex128)
    eta, eps, kw = 0.2, 1e-4, dict(nu=0.1, ct=0.9)
    g = float(sf.sf_dS_deta(u, BETA, LAT, eta, **kw))
    fd = (float(sf.sf_gauge_action(u, BETA, LAT, eta + eps, **kw))
          - float(sf.sf_gauge_action(u, BETA, LAT, eta - eps, **kw))) / (2 * eps)
    assert abs(g - fd) / abs(fd) < 1e-7


def test_force_frozen_dynamical_and_reference():
    u = _gauge(3)
    f = SFGaugeMonomial(lat=LAT, beta=BETA, eta=0.25).force(torch.as_tensor(u), None)
    assert float(torch.max(torch.abs(f[:, :, 1:4, 0]))) == 0.0
    f_ref = jax.jit(lambda x: JSFGaugeMonomial(lat=JL, beta=BETA, eta=0.25).force(x, None))(
        jnp.asarray(u))
    assert float(np.max(np.abs(f.numpy() - np.asarray(f_ref)))) <= 1e-5
    # directional derivative on the dynamical links, masked momenta (c128)
    u2 = torch.as_tensor(u).to(torch.complex128)
    mono = SFGaugeMonomial(lat=LAT, beta=BETA, eta=0.25)
    f2 = mono.force(u2, None)
    p = su3.random_momenta(rng.generator(rng.Key(9), "cpu"), (4,) + LAT.site_shape,
                           torch.complex128) * sf.sf_momenta_mask(LAT)
    eps = 1e-5
    sp = float(mono.action_info(su3.mul(su3.expm_ta(eps * p), u2), None)[0])
    sm = float(mono.action_info(su3.mul(su3.expm_ta(-eps * p), u2), None)[0])
    fd = (sp - sm) / (2 * eps)
    pred = float(torch.sum(torch.einsum("ij...,ji...->...", f2, p)).real)
    assert abs(fd - pred) / abs(fd) < 1e-6


def test_masked_trajectory_matches_reference():
    """One SFGAUGE trajectory (2MN, 12 steps, eta = 0.1) from the classical
    background with the reference's momenta and uniform injected: the same
    dH (|ddH| <= 1e-5 in complex128) and decision; the MD endpoint of both
    packages' `integrate` from those momenta equal to 1e-6, and its frozen
    links, like those of both trajectories' outputs, bit-equal to the
    start."""
    mono_ref = JSFGaugeMonomial(lat=JL, beta=BETA, eta=0.1)
    integ_ref = JIntegratorConfig(tau=1.0, levels=(JLevel("2mn", 12),))
    mask_ref = jsf.sf_momenta_mask(JL)
    cfg_ref = JHMCConfig(JL, (mono_ref,), integ_ref, momenta_mask=mask_ref)
    u0 = np.array(jsf.sf_classical_background(JL, 0.1, dtype=jnp.complex128))
    key = jax.random.key(5)

    def reference(u, key):
        u_out, st = j_hmc_trajectory(cfg_ref, u, key)
        # the reference's draws, re-derived from its key (hmc/trajectory.py:97-100)
        k_mom, _, k_acc = jax.random.split(key, 3)
        mom = jsu3.random_momenta(k_mom, u.shape[2:], u.dtype)
        u_md, _ = j_integrate(integ_ref, (mono_ref,), [None], u, mom * mask_ref,
                              freeze_mask=mask_ref)
        return u_out, st, mom, jrng.uniform(k_acc), u_md

    u_ref, st_ref, mom, uni, u_md_ref = jax.jit(reference)(jnp.asarray(u0), key)
    mono = SFGaugeMonomial(lat=LAT, beta=BETA, eta=0.1)
    mask = sf.sf_momenta_mask(LAT)
    cfg = HMCConfig(LAT, (mono,), IntegratorConfig(tau=1.0, levels=(Level("2mn", 12),)),
                    momenta_mask=mask)
    ut, pt = torch.as_tensor(u0), torch.as_tensor(np.array(mom))
    u_out, st = hmc_trajectory(cfg, ut, rng.Key(0), draws=Draws(pt, [None], float(uni)))
    assert abs(st.delta_h - float(st_ref.delta_h)) <= 1e-5
    assert st.accepted == bool(st_ref.accepted) and abs(st.delta_h) < 1.0
    u_md, _ = integrate(cfg.integrator, (mono,), [None], ut, pt * mask, freeze_mask=mask)
    assert float(np.max(np.abs(u_md.numpy() - np.asarray(u_md_ref)))) <= 1e-6
    frozen = u0[:, :, 1:4, 0]
    for out in (np.asarray(u_ref), u_out.numpy(), np.asarray(u_md_ref), u_md.numpy()):
        np.testing.assert_array_equal(out[:, :, 1:4, 0], frozen)
    assert float(np.max(np.abs(u_md.numpy() - u0))) > 1e-3  # the links did move


def test_masked_trajectory_complex64_matches_reference():
    """The masked trajectory of the test above in complex64 in both
    packages (beta = 8, as hmc4), the reference's complex64 momenta and
    uniform injected.  The MD endpoints agree to f32 rounding (5e-7), but
    dH does not to 1e-5: both evaluate H ~ 3.4e3 from f32 links and momenta
    whose roundings differ from step to step, and over the n = 12 steps of
    2MN each step's rounding (relative eps = 2^-24 of every term of H) can
    shift H_new by up to eps (|H_old| + |H_new|) in the same direction.  The
    bound is n eps (|H_old| + |H_new|) ~ 4.9e-3; measured 7.1e-4 to 8.1e-4
    (reference seeds 5-7, the port's dH lower each time).  The card's
    1.28e-3 at 8^4 against the CPU sits under the same bound there
    (H ~ 5.4e4: 7.7e-2), so it is f32 link evolution, not the card's route."""
    beta, n_md = 8.0, 12
    mono_ref = JSFGaugeMonomial(lat=JL, beta=beta, eta=0.1)
    integ_ref = JIntegratorConfig(tau=1.0, levels=(JLevel("2mn", n_md),))
    mask_ref = jsf.sf_momenta_mask(JL)
    cfg_ref = JHMCConfig(JL, (mono_ref,), integ_ref, momenta_mask=mask_ref)
    u0 = np.array(jsf.sf_classical_background(JL, 0.1, dtype=jnp.complex64))

    def reference(u, key):
        u_out, st = j_hmc_trajectory(cfg_ref, u, key)
        k_mom, _, k_acc = jax.random.split(key, 3)
        return u_out, st, jsu3.random_momenta(k_mom, u.shape[2:], u.dtype), jrng.uniform(k_acc)

    u_ref, st_ref, mom, uni = jax.jit(reference)(jnp.asarray(u0), jax.random.key(5))
    mask = sf.sf_momenta_mask(LAT)
    cfg = HMCConfig(LAT, (SFGaugeMonomial(lat=LAT, beta=beta, eta=0.1),),
                    IntegratorConfig(tau=1.0, levels=(Level("2mn", n_md),)), momenta_mask=mask)
    u_out, st = hmc_trajectory(cfg, torch.as_tensor(u0), rng.Key(0),
                               draws=Draws(torch.as_tensor(np.array(mom)), [None], float(uni)))
    assert u_out.dtype == torch.complex64
    bound = n_md * 2.0 ** -24 * (abs(st.h_old) + abs(st.h_new))
    assert abs(st.delta_h - float(st_ref.delta_h)) <= bound
    assert st.accepted == bool(st_ref.accepted)
    assert float(np.max(np.abs(u_out.numpy() - np.asarray(u_ref)))) <= 5e-6
    np.testing.assert_array_equal(u_out.numpy()[:, :, 1:4, 0], u0[:, :, 1:4, 0])


def test_hmc4_lowers_and_sfcoupling_writes_the_reference_columns(tmp_path):
    """hmc4 (cut to 4^4): SFGAUGE lowers to the reference's fields with the
    momenta mask set; SFCOUPLING writes sf_coupling.data in the reference's
    columns and formats (traj dS/deta k S_sf), numbers to 1e-5 relative."""
    with open("sample-input/hmc4-sf-coupling.input") as f:
        text = f.read().replace("L = 6", "L = 4").replace("T = 6", "T = 4")
    cfg, jcfg = config_tmlqcd.parse_input(text), jconfig_tmlqcd.parse_input(text)
    out, ref = config.build_hmc(cfg), jconfig.build_hmc(jcfg)
    (mo,), (mr,) = out.monomials, ref.monomials
    assert type(mo).__name__ == type(mr).__name__ == "SFGaugeMonomial"
    for field in ("beta", "eta", "nu", "ct", "timescale", "name"):
        assert getattr(mo, field) == getattr(mr, field)
    np.testing.assert_array_equal(out.momenta_mask.numpy(), np.asarray(ref.momenta_mask))
    assert float(out.momenta_mask[1:4, 0].abs().sum()) == 0.0
    assert [(lv.scheme, lv.steps) for lv in out.integrator.levels] == \
        [(lv.scheme, lv.steps) for lv in ref.integrator.levels]
    u = _gauge(13)
    for traj in (0, 1):
        runner.run_measurements(cfg, torch.as_tensor(u), LAT, traj, str(tmp_path), rng.Key(1))
    jdir = tmp_path / "ref"
    jdir.mkdir()
    for traj in (0, 1):
        jrunner.run_measurements(jcfg, jnp.asarray(u), JL, traj, str(jdir), jax.random.key(1))
    rows = [ln.split() for ln in (tmp_path / "sf_coupling.data").read_text().splitlines()]
    rows_ref = [ln.split() for ln in (jdir / "sf_coupling.data").read_text().splitlines()]
    assert len(rows) == len(rows_ref) == 2
    for a, b in zip(rows, rows_ref):
        assert a[0] == b[0] and [len(x) for x in a] == [len(x) for x in b]
        np.testing.assert_allclose([float(x) for x in a[2:]], [float(x) for x in b[2:]],
                                   rtol=1e-5)
        assert abs(float(a[1]) - float(b[1])) <= 1e-5 * float(b[3])
    assert dataclasses.asdict(cfg.meas[0]) == dataclasses.asdict(jcfg.meas[0])
