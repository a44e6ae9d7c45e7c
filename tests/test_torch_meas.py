"""Sources, correlator contractions, the online correlator's own draws and
the measurement runner of the port against the JAX reference (tmlqcd_tpu),
on the CPU at 4^4.  The online correlators and the runner's file against
the reference's, the force monitor and the reversibility check are in
tests/test_torch_meas_ref.py (each compiles a reference program, so they
have a file of at most 8 tests, which the test runner queues behind
tests/test_multirhs.py).

Tolerances: correlators are sums of |psi|^2 over 64 sites of an f32
solution; the contractions of one field agree to 1e-12 relative (C_PP) and
1e-4 absolute (C_PA, signed f32 products of O(1)).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from tmlqcd_tpu.lattice import Lattice as JLattice
from tmlqcd_tpu.meas import correlators as jcorr
from tmlqcd_tpu.meas import sources as jsources
from tmlqcd_tpu_torch import bridge, config, config_tmlqcd, rng, utils
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
# utils
# ---------------------------------------------------------------------------

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
