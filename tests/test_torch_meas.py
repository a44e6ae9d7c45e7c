"""Sources, online correlators, the measurement runner, the force monitor and
the reversibility check of the port against the JAX reference (tmlqcd_tpu),
on the CPU at 4^4.

The two packages draw different random numbers from the same seed, so every
comparison re-derives the reference's draws from its key and injects them
into the port (`t0=`, `source=`, `draws=`, `etas=`).

Tolerances: correlators are sums of |psi|^2 over 64 sites of an f32 solution
that agrees with the reference to ~7e-7 per entry, so they agree to 1e-6
relative (measured 5.6e-9 for C_PP, 9.6e-9 of max|C_PA| for C_PA); force norms to 1e-5 relative (forces agree to
1e-5 absolute, tests/test_torch_hmc.py); the reversibility |ddH| of both is
f32 noise on |H| ~ 1e4, bounded by 5e-2 absolute, and max|dU| by 1e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from tmlqcd_tpu import config as jconfig
from tmlqcd_tpu import config_tmlqcd as jconfig_tmlqcd
from tmlqcd_tpu import su3 as jsu3
from tmlqcd_tpu.hmc import trajectory as jtraj
from tmlqcd_tpu.hmc.monitor import monitor_forces as j_monitor_forces
from tmlqcd_tpu.lattice import Lattice as JLattice
from tmlqcd_tpu.meas import correlators as jcorr
from tmlqcd_tpu.meas import runner as jrunner
from tmlqcd_tpu.meas import sources as jsources
from tmlqcd_tpu_torch import bridge, config, config_tmlqcd, rng, utils
from tmlqcd_tpu_torch.hmc import Draws, reversibility_check
from tmlqcd_tpu_torch.hmc.monitor import monitor_forces
from tmlqcd_tpu_torch.lattice import Lattice
from tmlqcd_tpu_torch.meas import correlators, runner, sources
from tmlqcd_tpu_torch.ops import wilson as w

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
TP = w.DiracParams(kappa=0.13, mu=0.1)
TP_MEAS = w.DiracParams(kappa=0.13, mu=0.026 / 0.26)  # the ONLINE block of _MEAS_INPUT


@pytest.fixture(scope="module")
def gauge():
    u = bridge.numpy_su3(np.random.default_rng(50), (4,) + JL.site_shape)
    return u, bridge.gauge_from_numpy(u, LAT)


# ---------------------------------------------------------------------------
# sources
# ---------------------------------------------------------------------------


def test_point_source_matches_reference():
    for spin, col, site in ((0, 0, (0, 0, 0, 0)), (3, 2, (1, 2, 3, 1))):
        out = sources.point_source(LAT, spin, col, site, device="cpu")
        np.testing.assert_array_equal(bridge.to_numpy(out),
                                      np.asarray(jsources.point_source(JL, spin, col, site)))
        assert out.dtype == torch.complex64 and float(out.abs().sum()) == 1.0


def test_stochastic_sources_draw_from_their_key():
    key = rng.Key(9).fold(3)
    z2 = sources.z2_timeslice_source(LAT, 2, key, device="cpu")
    assert tuple(z2.shape) == (4, 3) + LAT.site_shape
    on = z2[:, :, 2]
    np.testing.assert_allclose(bridge.to_numpy(on.real.abs()), np.sqrt(0.5), rtol=1e-6)
    np.testing.assert_allclose(bridge.to_numpy(on.imag.abs()), np.sqrt(0.5), rtol=1e-6)
    assert float(z2.abs().sum()) == pytest.approx(float(on.abs().sum()))  # zero elsewhere
    assert abs(float(on.real.mean())) < 0.2  # 192 signs: 3 sigma is 0.15
    # a pure function of the key
    assert torch.equal(z2, sources.z2_timeslice_source(LAT, 2, key, device="cpu"))
    assert not torch.equal(z2, sources.z2_timeslice_source(LAT, 2, key.fold(1), device="cpu"))
    diluted = sources.z2_timeslice_source(LAT, 2, key, device="cpu", spin_dilute=1)
    assert torch.equal(diluted[1], z2[1]) and float(diluted[[0, 2, 3]].abs().sum()) == 0.0
    vol = sources.volume_source(LAT, key, device="cpu")
    np.testing.assert_allclose(bridge.to_numpy(vol.abs()), 1.0, rtol=1e-6)
    gau = sources.gaussian_timeslice_source(LAT, 1, key, device="cpu")
    assert float(gau[:, :, [0, 2, 3]].abs().sum()) == 0.0
    assert 0.7 < float((gau[:, :, 1].abs() ** 2).mean()) < 1.3  # <|eta|^2> = 1 over 768 draws
    assert 0 <= rng.randint(key, 0, 4) < 4 and rng.randint(key, 0, 4) == rng.randint(key, 0, 4)


# ---------------------------------------------------------------------------
# correlators
# ---------------------------------------------------------------------------


def test_correlator_contractions_match_reference():
    psi = bridge.numpy_spinor(np.random.default_rng(51), (4, 3) + JL.site_shape)
    pt = torch.as_tensor(psi)
    for t0 in (0, 3):
        np.testing.assert_allclose(bridge.to_numpy(correlators.pion_correlator(pt, LAT, t0)),
                                   np.asarray(jcorr.pion_correlator(jnp.asarray(psi), JL, t0)),
                                   rtol=1e-12)
        # C_PA is a sum of signed terms of O(1): absolute 1e-4 on f32 products
        np.testing.assert_allclose(bridge.to_numpy(correlators.pa_correlator(pt, LAT, t0)),
                                   np.asarray(jcorr.pa_correlator(jnp.asarray(psi), JL, t0)),
                                   atol=1e-4)
    c = np.cosh(0.4 * (np.arange(16) - 8))
    np.testing.assert_allclose(correlators.effective_mass(c), jcorr.effective_mass(c))
    assert np.nanmax(np.abs(correlators.effective_mass(c)[1:-1] - 0.4)) < 1e-8


_MEAS_INPUT = ("L = 4\nT = 4\nBeginMeasurement ONLINE\n Frequency = 2\n kappa = 0.13\n"
               " 2KappaMu = 0.026\n SolverPrecision = 1e-14\n MaxSolverIterations = 500\n"
               "EndMeasurement\n")
TRAJ = 3


@pytest.fixture(scope="module")
def online_pair(gauge, tmp_path_factory):
    """The reference's runner writes onlinemeas.000003 (one solve, one
    compile); its t0 and source are re-derived from its key
    (meas/runner.py:24, meas/correlators.py:92-96) and injected into the
    port's `online_measurement` and runner."""
    u, ut = gauge
    jdir, tdir = tmp_path_factory.mktemp("jax"), tmp_path_factory.mktemp("torch")
    key = jax.random.key(11)
    jrunner.run_measurements(jconfig_tmlqcd.parse_input(_MEAS_INPUT), jnp.asarray(u), JL, TRAJ,
                             str(jdir), key)
    mkey = jax.random.fold_in(jax.random.fold_in(key, TRAJ), 7000)
    t0 = int(jax.random.randint(mkey, (), 0, JL.dims[0]))
    src = jsources.z2_timeslice_source(JL, t0, jax.random.fold_in(mkey, 1), jnp.complex64)
    src = bridge.sources_from_numpy(np.asarray(src), LAT)
    ref = [ln.split() for ln in (jdir / "onlinemeas.000003").read_text().splitlines()]
    cpp, cpa = (np.array([float(c[k]) for c in ref]) for k in (3, 4))
    out = correlators.online_measurement(ut, TP_MEAS, LAT, rng.Key(0), t0=t0, tol=1e-7,
                                         maxiter=500, source=src)
    return dict(ref=ref, cpp=cpp, cpa=cpa, t0=t0, src=src, out=out, tdir=tdir)


def test_online_measurement_cpp_matches_reference(online_pair):
    out_pp, _, out_t0 = online_pair["out"]
    assert out_t0 == online_pair["t0"] and tuple(out_pp.shape) == (4,)
    assert out_pp.dtype == torch.float64
    assert bool((out_pp > 0).all()) and float(out_pp[0]) == float(out_pp.max())
    np.testing.assert_allclose(bridge.to_numpy(out_pp), online_pair["cpp"], rtol=1e-6)


def test_online_measurement_cpa_matches_reference(online_pair):
    cpa, out_pa = online_pair["cpa"], online_pair["out"][1]
    assert float(np.max(np.abs(cpa))) > 1e-3
    np.testing.assert_allclose(bridge.to_numpy(out_pa), cpa, atol=1e-6 * float(np.max(np.abs(cpa))))


def test_online_measurement_draws_its_own_source(gauge):
    _, ut = gauge
    a = correlators.online_measurement(ut, TP, LAT, rng.Key(5), tol=1e-6, maxiter=500)
    b = correlators.online_measurement(ut, TP, LAT, rng.Key(5), tol=1e-6, maxiter=500)
    assert a[2] == b[2] and torch.equal(a[0], b[0])  # reproducible from the key
    norm = correlators.pion_norm(ut, TP, LAT, rng.Key(5), tol=1e-6, maxiter=500)
    assert tuple(norm.shape) == (4,) and bool((norm > 0).all())


# ---------------------------------------------------------------------------
# runner
# ---------------------------------------------------------------------------

def test_onlinemeas_file_matches_reference(gauge, online_pair):
    """Same file name, line count and columns `1 1 t C_PP C_PA`; the numbers
    agree to 1e-6 relative (C_PP) and 1e-6 of max|C_PA| (the digits printed
    beyond f32 rounding differ, so the text is not compared byte by byte)."""
    _, ut = gauge
    cfg, tdir, ref = config_tmlqcd.parse_input(_MEAS_INPUT), online_pair["tdir"], online_pair["ref"]
    draws = {0: dict(t0=online_pair["t0"], source=online_pair["src"])}
    runner.run_measurements(cfg, ut, LAT, TRAJ, str(tdir), rng.Key(1), draws=draws)
    runner.run_measurements(cfg, ut, LAT, TRAJ + 1, str(tdir), rng.Key(1))
    assert [p.name for p in tdir.iterdir()] == ["onlinemeas.000003"]  # Frequency = 2
    out = [ln.split() for ln in (tdir / "onlinemeas.000003").read_text().splitlines()]
    assert len(out) == len(ref) == 4
    assert [c[:3] for c in out] == [c[:3] for c in ref] == [["1", "1", str(t)] for t in range(4)]
    pp = np.array([float(c[3]) for c in out])
    pa = np.array([float(c[4]) for c in out])
    np.testing.assert_allclose(pp, online_pair["cpp"], rtol=1e-6)
    np.testing.assert_allclose(pa, online_pair["cpa"],
                               atol=1e-6 * np.max(np.abs(online_pair["cpa"])))
    assert all(len(c[3]) == len("1.234567890123e-01") for c in out)  # %.12e


@pytest.mark.parametrize("ty", ["SFCOUPLINGX"])
def test_unported_measurements_raise(tmp_path, gauge, ty):
    """Every measurement type of the reference runs now (SFCOUPLING since
    slice 10: tests/test_torch_sf.py); a type that neither package knows
    raises ValueError naming it, in the runner and before the run starts."""
    cfg = config_tmlqcd.parse_input(f"L = 4\nT = 4\nBeginMeasurement {ty}\nEndMeasurement\n")
    with pytest.raises(ValueError, match=f"unknown measurement type '{ty}'"):
        runner.run_measurements(cfg, gauge[1], LAT, 0, str(tmp_path), rng.Key(1))
    with pytest.raises(ValueError, match=f"unknown measurement type '{ty}'"):
        config.build_hmc(cfg)


@pytest.mark.parametrize("ty, name, rows", [
    ("GRADIENTFLOW", "gradflow.000005", 2), ("POLYAKOV", "polyakov.data", 1),
    ("ORIENTEDPLAQUETTES", "oriented_plaquettes.data", 1),
    ("FIELDSTRENGTH", "field_strength.data", 1)])
def test_gauge_measurements_run(tmp_path, gauge, ty, name, rows):
    """The gauge measurements run on their Frequency (here 3: after
    trajectory 5, not after 6) and write their file; build_hmc lowers them
    (their numbers against the reference: tests/test_torch_offline.py)."""
    cfg = config_tmlqcd.parse_input(f"L = 4\nT = 4\nBeginMeasurement {ty}\n Frequency = 3\n"
                                    " Steps = 2\nEndMeasurement\n")
    for traj in (5, 6):
        runner.run_measurements(cfg, gauge[1], LAT, traj, str(tmp_path), rng.Key(1))
    assert [p.name for p in tmp_path.iterdir()] == [name]
    lines = [ln for ln in (tmp_path / name).read_text().splitlines() if not ln.startswith("#")]
    assert len(lines) == rows and all(np.isfinite(np.float64(ln.split())).all() for ln in lines)
    assert config.build_hmc(cfg).monomials[0].name == "gauge"


# ---------------------------------------------------------------------------
# force monitor, reversibility check, utils
# ---------------------------------------------------------------------------

_GAUGE = ("L = 4\nT = 4\nbeta = 5.3\nNumberOfTimescales = {n}\nTau = 0.5\n"
          "BeginMonomial GAUGE\n Timescale = 0\n IntegrationSteps = 2\nEndMonomial\n")
_DET = ("BeginMonomial DET\n Timescale = 1\n kappa = 0.13\n 2KappaMu = 0.026\n"
        " AcceptancePrecision = 1e-18\n ForcePrecision = 1e-18\n IntegrationSteps = 1\n"
        "EndMonomial\n")


@pytest.fixture(scope="module")
def hmc_configs():
    """(reference gauge-only, port gauge-only, port GAUGE + DET).  The
    comparison with the reference runs on the gauge monomial alone: the DET
    force is held against the reference in tests/test_torch_hmc.py, and
    compiling it again here would double this file's time."""
    g = _GAUGE.format(n=1)
    return (jconfig.build_hmc(jconfig_tmlqcd.parse_input(g)),
            config.build_hmc(config_tmlqcd.parse_input(g)),
            config.build_hmc(config_tmlqcd.parse_input(_GAUGE.format(n=2) + _DET)))


def test_monitor_forces_matches_reference(gauge, hmc_configs):
    u, ut = gauge
    jhmc, hmc, hmc_det = hmc_configs
    ref = j_monitor_forces(jhmc, jnp.asarray(u), jax.random.key(21))
    out = monitor_forces(hmc, ut, rng.Key(0))
    assert [(s.name, s.timescale) for s in out] == [(s.name, s.timescale) for s in ref]
    for a, b in zip(out, ref):
        assert b.norm_sq > 1.0
        assert a.norm_sq == pytest.approx(b.norm_sq, rel=1e-5)
        assert a.max_abs == pytest.approx(b.max_abs, rel=1e-5)
        assert a.rms == pytest.approx(b.rms, rel=1e-5)
    # with a fermion monomial: the statistics are those of its force at the
    # injected heatbath draw, and the key alone gives another draw
    eta = bridge.spinor_from_numpy(
        bridge.numpy_spinor(np.random.default_rng(52), (4, 3) + JL.eo_site_shape), LAT)
    det = hmc_det.monomials[1]
    stats = monitor_forces(hmc_det, ut, rng.Key(0), etas=[None, eta])
    f = det.force(ut, det.heatbath(ut, rng.Key(0), eta)[0])
    fro = (f.abs() ** 2).sum(dim=(0, 1))
    assert stats[0].norm_sq == out[0].norm_sq and stats[1].name == det.name
    assert stats[1].norm_sq == pytest.approx(float(fro.double().sum()), rel=1e-6)  # f32 squares
    assert stats[1].max_abs == pytest.approx(float(fro.max().sqrt()), rel=1e-6)
    assert stats[1].rms == pytest.approx((stats[1].norm_sq / (4 * 256)) ** 0.5, rel=1e-12)
    assert monitor_forces(hmc_det, ut, rng.Key(3))[1].norm_sq != stats[1].norm_sq


def test_reversibility_check_matches_reference(gauge, hmc_configs):
    u, ut = gauge
    jhmc, hmc, hmc_det = hmc_configs
    key = jax.random.key(22)
    ddh_ref, du_ref = jtraj.reversibility_check(jhmc, jnp.asarray(u), key)
    k_mom, _ = jax.random.split(key)
    mom = jsu3.random_momenta(k_mom, u.shape[2:], jnp.complex64)
    draws = Draws(bridge.gauge_from_numpy(np.asarray(mom), LAT), [None], 0.0)
    ddh, du = reversibility_check(hmc, ut, rng.Key(0), draws=draws)
    assert ddh < 5e-2 and float(ddh_ref) < 5e-2
    assert du < 1e-4 and float(du_ref) < 1e-4
    ddh2, du2 = reversibility_check(hmc_det, ut, rng.Key(4))  # its own draws, with a solve
    assert ddh2 < 5e-2 and du2 < 1e-4


def test_timer_and_debug_level(capsys):
    utils.set_debug_level(2)
    try:
        with utils.timer("block"):
            pass
        utils.debug_printf(3, "hidden")
        utils.debug_printf(1, "shown %d", 7)
    finally:
        utils.set_debug_level(1)
    with utils.timer("quiet"):
        pass
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2 and lines[0].startswith("# block: ") and lines[1] == "shown 7"
    assert utils.to_host(torch.ones(2)).tolist() == [1.0, 1.0]
