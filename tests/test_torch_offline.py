"""The port's remaining drivers and the embedding API against the JAX
reference (tmlqcd_tpu), on the CPU at 4^4: `cli.offline_measurement`
(whose files must carry the numbers of the reference's `run_measurements` on
the same gauge), `api.Session`, `cli.benchmark --cpu`, the native SciDAC
checksum, `dispatch.solve_mms` and `models.suites.nf2_wilson`.

Tolerances: the measurement files' numbers to 1e-5 (relative for t^2 E, the
flow's f32 steps in another order; absolute for the other gauge sums of
O(1..40)); checksums bit for bit; the session's inversion to a true
residual of 1e-6 (f32 CG stopped at 1e-8 of |b|).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmlqcd_tpu import config_tmlqcd as jconfig_tmlqcd
from tmlqcd_tpu import native as jnative
from tmlqcd_tpu.lattice import Lattice as JLattice
from tmlqcd_tpu.meas import runner as jrunner
from tmlqcd_tpu.models import suites as jsuites
from tmlqcd_tpu_torch import api, bridge, native, rng
from tmlqcd_tpu_torch.cli import benchmark, offline_measurement
from tmlqcd_tpu_torch.config import IntegratorSpec, MonomialSpec, OperatorSpec, RunConfig
from tmlqcd_tpu_torch.io.checkpoint import save_checkpoint
from tmlqcd_tpu_torch.lattice import Lattice
from tmlqcd_tpu_torch.meas.sources import point_source
from tmlqcd_tpu_torch.models import suites
from tmlqcd_tpu_torch.ops import wilson as w

torch.set_num_threads(1)

DIMS = (4, 4, 4, 4)
JL, LAT = JLattice(DIMS), Lattice(DIMS)

_MEAS = """L = 4
T = 4
Seed = 3
BeginMeasurement GRADIENTFLOW
  Frequency = 10
  StepSize = 0.02
  Steps = 3
EndMeasurement
BeginMeasurement POLYAKOV
  Frequency = 7
  Direction = 3
EndMeasurement
BeginMeasurement ORIENTEDPLAQUETTES
EndMeasurement
BeginMeasurement FIELDSTRENGTH
  Frequency = 2
EndMeasurement
"""


@pytest.fixture(scope="module", autouse=True)
def _quick_reference_compiles():
    """XLA's backend optimisations off while this module runs."""
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", False)


def _rows(path) -> list:
    with open(path) as f:
        return [ln.split() for ln in f if ln.strip() and not ln.startswith("#")]


def test_offline_measurement_matches_reference(tmp_path):
    """`cli.offline_measurement --cpu` on an ILDG checkpoint of trajectory 5
    forces every Frequency to 1 and writes the files of trajectory 4, which
    carry the numbers of the reference's `run_measurements` on the same
    gauge: same names, rows, columns and formats."""
    u_np = bridge.numpy_su3(np.random.default_rng(61), (4,) + JL.site_shape)
    conf = save_checkpoint(str(tmp_path / "confs"), bridge.gauge_from_numpy(u_np, LAT), 5, 3,
                           LAT, fmt="ildg")
    inp = tmp_path / "meas.input"
    inp.write_text(_MEAS)
    out, ref = tmp_path / "torch", tmp_path / "jax"
    assert offline_measurement.main(["-f", str(inp), "-c", conf, "-o", str(out), "--cpu"]) == 0
    jcfg = jconfig_tmlqcd.read_input(str(inp))
    jcfg = jcfg.__class__(**{**jcfg.__dict__, "meas": tuple(
        m.__class__(**{**m.__dict__, "frequency": 1}) for m in jcfg.meas)})
    os.makedirs(ref)
    jrunner.run_measurements(jcfg, jnp.asarray(u_np), JL, 4, str(ref), jax.random.key(3))
    names = ["field_strength.data", "gradflow.000004", "oriented_plaquettes.data",
             "polyakov.data"]
    assert sorted(os.listdir(out)) == sorted(os.listdir(ref)) == names
    for name in names:
        a, b = _rows(out / name), _rows(ref / name)
        assert len(a) == len(b) == (3 if name.startswith("gradflow") else 1)
        for ra, rb in zip(a, b):
            assert len(ra) == len(rb) and [len(x) for x in ra] == [len(x) for x in rb]
            if name.startswith("gradflow"):
                assert ra[0] == rb[0]
                np.testing.assert_allclose(np.float64(ra[1:]), np.float64(rb[1:]), rtol=1e-5)
            else:
                assert ra[0] == rb[0] == "00000004"
                np.testing.assert_allclose(np.float64(ra[1:]), np.float64(rb[1:]), atol=1e-5)
    assert _rows(out / "polyakov.data")[0][1] == "3"
    with open(out / "gradflow.000004") as f:
        assert f.readline() == "# t t2E_plaq t2E_clover\n"


def test_api_session_roundtrip(tmp_path):
    """init -> hot start -> one trajectory -> invert -> ILDG write / read
    (tests/test_aux.py::test_api_session_roundtrip on the port)."""
    cfg = RunConfig(beta=5.5, seed=3, monomials=(MonomialSpec(type="GAUGE"),),
                    integrator=IntegratorSpec(tau=0.5, steps=(4,)),
                    operators=(OperatorSpec(type="TMWILSON", kappa=0.12, two_kappa_mu=0.01,
                                            precision=1e-16, max_solver_iterations=1000),))
    s = api.init(cfg, device="cpu")
    s.hot_start()
    stats = s.run_hmc(1)
    assert len(stats) == 1 and s.trajectory == 1 and 0 < s.plaquette() < 1
    src = point_source(s.lat, 0, 0, device="cpu")
    x = s.invert(src)
    params = w.DiracParams(kappa=0.12, mu=0.01 / (2 * 0.12))
    r = w.d_full(s.gauge, x, params, s.lat) - src
    assert float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(src)) < 1e-6
    path = str(tmp_path / "conf.lime")
    s.write_gauge(path)
    s2 = api.init(cfg, device="cpu")
    s2.read_gauge(path)
    assert s2.trajectory == 1 and s2.plaquette() == s.plaquette()
    np.testing.assert_allclose(bridge.to_numpy(s2.gauge), bridge.to_numpy(s.gauge), atol=1e-7)
    s.write_gauge(str(tmp_path / "conf.npz"), fmt="npz")
    with np.load(tmp_path / "conf.npz") as f:
        np.testing.assert_array_equal(f["gauge"], bridge.to_numpy(s.gauge))
    s.finalize()
    assert s.gauge is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            api.init(cfg)


def test_native_checksum_matches_plain_and_reference():
    assert native.checksum_route() == "native"
    gen = np.random.default_rng(5)
    for nsites, site_bytes, rank0 in ((1, 1, 0), (257, 1152, 0), (1000, 96, 123456789)):
        data = gen.integers(0, 256, (nsites, site_bytes), dtype=np.uint8)
        out = native.scidac_checksum(data, rank0)
        assert out == native.scidac_checksum_plain(data, rank0)
        assert out == jnative.scidac_checksum(data, rank0) == jnative._checksum_numpy(data, rank0)
    # partial checksums of disjoint site ranges xor together
    a, b = native.scidac_checksum(data[:400], 7), native.scidac_checksum(data[400:], 407)
    assert native.scidac_checksum(data, 7) == (a[0] ^ b[0], a[1] ^ b[1])


def test_native_checksum_build_failure_is_reported(monkeypatch, tmp_path, capsys):
    """Without a compiler the checksum takes the plain route and one line on
    stderr says so."""
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_BUILD", str(tmp_path / "build"))
    monkeypatch.setenv("PATH", str(tmp_path))
    data = np.random.default_rng(6).integers(0, 256, (33, 24), dtype=np.uint8)
    assert native.scidac_checksum(data, 3) == native.scidac_checksum_plain(data, 3)
    assert native.checksum_route() == "plain"
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == 1 and "checksum.cpp" in err[0] and "plain" in err[0]


def test_benchmark_cli_cpu(capsys):
    assert benchmark.main(["--cpu", "--dims", "4", "4", "4", "8", "--apps", "1"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["route"] == "plain" and res["dims"] == {"LX": 4, "LY": 4, "LZ": 4, "T": 8}
    for name, nbytes in (("K1", 672), ("Qhat_pm", 2496)):
        row = res[name]
        assert row["bytes_per_site"] == nbytes and row["ms"] > 0 and row["gflops"] > 0
        assert "bound_ms" not in row  # the card's bound is not a CPU number
    assert "card" not in res
    if not torch.cuda.is_available():
        for main in (benchmark.main, offline_measurement.main):
            argv = [] if main is benchmark.main else ["-f", "x", "-c", "y"]
            with pytest.raises(RuntimeError, match="CUDA"):
                main(argv)


def test_solve_mms_and_nf2_wilson():
    """`dispatch.solve_mms` is one multishift CG; `suites.nf2_wilson` builds
    the reference's config 2."""
    from tmlqcd_tpu_torch.ops import wilson_fast as wf
    from tmlqcd_tpu_torch.solvers.dispatch import solve_mms

    u = bridge.gauge_from_numpy(bridge.numpy_su3(np.random.default_rng(8),
                                                 (4,) + LAT.site_shape), LAT)
    params = w.DiracParams(kappa=0.13, mu=0.1)
    fg = wf.make_fast_gauge(u, params, LAT)
    op = wf.q_hat_pm_operator(fg, params, LAT)
    b2 = wf.to_split(rng.normal_spinor(rng.Key(1), (4, 3) + LAT.eo_site_shape, "cpu"))
    shifts = np.array([0.01, 0.1, 1.0])
    xs, iters, rsq = solve_mms(op, b2, shifts, tol=1e-7, maxiter=500)
    assert xs.shape == (3,) + b2.shape and 0 < iters < 500
    for k, sigma in enumerate(shifts):
        r = op(xs[k]) + sigma * xs[k] - b2
        assert float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b2)) < 1e-5
    out = suites.nf2_wilson(LAT, beta=5.6, kappa=0.15, gauge_steps=2, fermion_steps=5)
    ref = jsuites.nf2_wilson(JL, beta=5.6, kappa=0.15, gauge_steps=2, fermion_steps=5)
    assert [type(m).__name__ for m in out.monomials] == [type(m).__name__ for m in ref.monomials]
    det, jdet = out.monomials[1], ref.monomials[1]
    assert (det.params.kappa, det.params.mu, det.timescale, det.acc_tol, det.force_tol,
            det.maxiter) == (jdet.params.kappa, jdet.params.mu, jdet.timescale, jdet.acc_tol,
                             jdet.force_tol, jdet.maxiter)
    assert [(lv.scheme, lv.steps) for lv in out.integrator.levels] == \
        [(lv.scheme, lv.steps) for lv in ref.integrator.levels]
