"""Parity of the PyTorch port's solvers, gauge force, input reader,
checkpoints and CLI with the JAX reference (tmlqcd_tpu), on the CPU; the
det-family forces and the trajectory are in tests/test_torch_hmc_traj.py.

Inputs are drawn from seeded numpy generators and handed to both packages
as numpy arrays.  The port runs its plain path (CPU tensors); the
reference runs its jnp path, as it does on the CPU.

Tolerances, each stated where it is used:
* CG: same iteration count (both stop at |r|^2 <= tol^2 |b|^2 with f64
  norms on f32 fields); solutions agree to 2e-6 (f32 rounding of O(1)
  entries over ~30 iterations).
* gauge force: 1e-5 absolute on forces of O(1..10) — f32 operators, f64
  sums.
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
from tmlqcd_tpu.hmc import integrators as jint
from tmlqcd_tpu.io import checkpoint as jckpt
from tmlqcd_tpu.lattice import Lattice as JLattice
from tmlqcd_tpu.lattice import pack_gauge_eo as j_pack
from tmlqcd_tpu.ops import wilson as jw
from tmlqcd_tpu.solvers import chrono as jchrono
from tmlqcd_tpu.solvers.cg import cg as j_cg
from tmlqcd_tpu_torch import bridge, config, config_tmlqcd
from tmlqcd_tpu_torch.hmc import integrators
from tmlqcd_tpu_torch.io import checkpoint
from tmlqcd_tpu_torch.lattice import Lattice
from tmlqcd_tpu_torch.ops import gauge_action as ga
from tmlqcd_tpu_torch.ops import wilson as w
from tmlqcd_tpu_torch.ops import wilson_fast as wf
from tmlqcd_tpu_torch.solvers import chrono, dispatch
from tmlqcd_tpu_torch.solvers.cg import cg, cg_info

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _quick_reference_compiles():
    """XLA's backend optimisations off while this module runs: the
    reference's programs here take far longer to compile than to run."""
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", False)


# the reference's gauge_action module is shadowed by a function of the same
# name in tmlqcd_tpu.ops
import importlib  # noqa: E402

jga = importlib.import_module("tmlqcd_tpu.ops.gauge_action")

DIMS = (4, 4, 4, 4)
JL, LAT = JLattice(DIMS), Lattice(DIMS)
SAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "sample-input")
LIGHT = dict(kappa=0.15, mu=0.03)


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
# solvers
# ---------------------------------------------------------------------------


def test_cg_matches_reference(gauge, pseudofermion):
    u, ut = gauge
    jp, tp = jw.DiracParams(**LIGHT), w.DiracParams(**LIGHT)
    ueo, ph = j_pack(u, JL), jw.boundary_phases(jp, JL)
    # the operator jitted on its own: cg traces it at each call site, and a
    # jitted function serves those from its trace cache
    qpm = jax.jit(lambda x: jw.q_hat_pm(ueo, x, jp, JL, ph))
    ref = jax.jit(lambda b: j_cg(qpm, b, tol=1e-8, maxiter=500))(pseudofermion)
    fg = wf.make_fast_gauge(ut, tp, LAT)
    out = cg(lambda x: wf.q_hat_pm_fast(fg, x, tp, LAT),
             wf.to_split(bridge.spinor_from_numpy(pseudofermion, LAT)), tol=1e-8, maxiter=500)
    assert out.iterations == int(ref.iterations)
    assert 10 < out.iterations < 500
    assert _maxdiff(wf.from_split(out.x), ref.x) < 2e-6


def test_cg_info_and_solver_dispatch(gauge, pseudofermion):
    """cg_info's true residual meets the reference's own bound
    (tests/test_round2.py:139); the dispatch seam routes registered names and
    the reference's own (bicgstab here) and refuses unknown ones."""
    _, ut = gauge
    tp = w.DiracParams(**LIGHT)
    fg = wf.make_fast_gauge(ut, tp, LAT)
    b = wf.to_split(bridge.spinor_from_numpy(pseudofermion, LAT))
    mv = lambda x: wf.q_hat_pm_fast(fg, x, tp, LAT)  # noqa: E731
    res, true_rsq = cg_info(mv, b, tol=1e-6, maxiter=400)
    assert float(true_rsq) < 10.0 * float(res.residual_sq) + 1e-10
    calls = []

    def probe(matvec, rhs, tol, maxiter, **kw):
        calls.append(tol)
        return dispatch.SOLVERS["cg"](matvec, rhs, tol, maxiter, **kw)

    dispatch.register_solver("Probe", probe)
    try:
        x, iters, _ = dispatch.solve_degenerate(mv, b, solver="PROBE", tol=1e-6, maxiter=400)
    finally:
        dispatch.SOLVERS.pop("probe")
    assert calls == [1e-6] and iters == res.iterations
    assert torch.equal(x, res.x)
    x, iters, _ = dispatch.solve_degenerate(mv, b, solver="bicgstab", tol=1e-6, maxiter=400)
    assert 0 < iters < 400
    assert float(torch.linalg.vector_norm(mv(x) - b) / torch.linalg.vector_norm(b)) < 5e-6
    with pytest.raises(ValueError):
        dispatch.solve_degenerate(mv, b, solver="no-such-solver")


def test_chrono_guess_matches_reference():
    g = np.random.default_rng(22)
    shape = (6, 5)
    weights = g.uniform(0.5, 2.0, shape).astype(np.float32)
    fields = g.standard_normal((3,) + shape).astype(np.float32)
    b = g.standard_normal(shape).astype(np.float32)
    ref = jchrono.chrono_guess(jchrono.ChronoHistory(jnp.asarray(fields), jnp.asarray(2)),
                               lambda x: x * weights, jnp.asarray(b))
    hist = bridge.chrono_from_numpy(fields, 2)
    out = chrono.chrono_guess(hist, lambda x: x * torch.as_tensor(weights), torch.as_tensor(b))
    assert _maxdiff(out, ref) < 1e-5
    pushed = chrono.chrono_push(hist, torch.as_tensor(b))
    assert pushed.count == 3
    np.testing.assert_array_equal(pushed.fields[0].numpy(), b)
    np.testing.assert_array_equal(pushed.fields[1:].numpy(), fields[:2])


def test_expand_schedule_matches_reference():
    for levels in ((jint.Level("2mn", 2), jint.Level("2mn", 2), jint.Level("2mn", 5)),
                   (jint.Level("leapfrog", 3), jint.Level("2mnposition", 2))):
        jcfg = jint.IntegratorConfig(tau=1.0, levels=levels)
        tcfg = integrators.IntegratorConfig(
            tau=1.0, levels=tuple(integrators.Level(lv.scheme, lv.steps) for lv in levels))
        ts = tuple(range(len(levels))) + (0,)
        for a, b in zip(jint._expand_schedule(jcfg, ts), integrators._expand_schedule(tcfg, ts)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("c1", [0.0, -1.0 / 12.0], ids=["wilson", "tlsym"])
def test_gauge_force_and_action_match_reference(gauge, c1):
    u, ut = gauge
    f_ref, s_ref, plaq_ref, rect_ref = jax.jit(lambda u: (
        jga.gauge_force(u, 5.3, JL, c1), jga.gauge_action(u, 5.3, JL, c1),
        jga.plaquette(u, JL), jga.rectangle(u, JL)))(u)
    assert _maxdiff(ga.gauge_force(ut, 5.3, LAT, c1), f_ref) < 1e-5
    assert abs(float(ga.gauge_action(ut, 5.3, LAT, c1)) - float(s_ref)) < 1e-9 * abs(float(s_ref))
    assert abs(float(ga.plaquette(ut, LAT)) - float(plaq_ref)) < 1e-7
    assert abs(float(ga.rectangle(ut, LAT)) - float(rect_ref)) < 1e-7


# ---------------------------------------------------------------------------
# input, build, checkpoints, CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(os.listdir(SAMPLES)))
def test_sample_inputs_parse_like_reference(name):
    path = os.path.join(SAMPLES, name)
    ref = dataclasses.asdict(jconfig_tmlqcd.read_input(path))
    out = dataclasses.asdict(config_tmlqcd.read_input(path))
    assert out == ref


def test_hmc2_lowers_to_the_reference_monomials():
    """hmc2 as shipped, ONLINE block included, builds the same lattice and
    monomial parameters in both packages."""
    with open(os.path.join(SAMPLES, "hmc2-nf2-tm-hasenbusch.input")) as f:
        text = f.read()
    cfg = config_tmlqcd.parse_input(text)
    assert [m.type for m in cfg.meas] == ["ONLINE"]
    ref = jconfig.build_hmc(jconfig_tmlqcd.parse_input(text))
    out = config.build_hmc(cfg)
    assert out.lat.dims == ref.lat.dims == (32, 16, 16, 16)
    assert [type(m).__name__ for m in out.monomials] == [type(m).__name__ for m in ref.monomials]
    for mo, mr in zip(out.monomials, ref.monomials):
        for field in ("timescale", "acc_tol", "force_tol", "maxiter", "solver", "chrono_n",
                      "beta", "c1"):
            assert getattr(mo, field, None) == getattr(mr, field, None)
        for field in ("params", "params1", "params2"):
            if hasattr(mr, field):
                assert dataclasses.asdict(getattr(mo, field)) == dataclasses.asdict(getattr(mr, field))
    assert out.integrator.tau == ref.integrator.tau
    assert [(lv.scheme, lv.steps) for lv in out.integrator.levels] == \
        [(lv.scheme, lv.steps) for lv in ref.integrator.levels]


@pytest.mark.parametrize("what, text", [
    ("measurement type 'SFCOUPLINGX'",
     "BeginMeasurement SFCOUPLINGX\n Frequency = 1\nEndMeasurement\n"),
    ("monomial type 'SFGAUGEX'", "BeginMonomial SFGAUGEX\nEndMonomial\n"),
])
def test_unported_features_raise(what, text):
    """Every monomial and measurement of the reference lowers now (SFGAUGE
    and SFCOUPLING since slice 10: `test_ported_features_lower`); a type
    that neither package knows raises ValueError naming it, as the
    reference's `build_monomial` does for a monomial."""
    cfg = config_tmlqcd.parse_input(text)
    with pytest.raises(ValueError, match=f"unknown {what}"):
        config.build_hmc(cfg)
    if "monomial" in what:
        with pytest.raises(ValueError, match=f"unknown {what}"):
            jconfig.build_hmc(jconfig_tmlqcd.parse_input(text))


@pytest.mark.parametrize("what, text", [
    ("NDPOLY", "BeginMonomial NDPOLY\n kappa = 0.1\n CSW = 1.0\n 2Kappamubar = 0.1\n"
               " 2Kappaepsbar = 0.12\n DegreeOfRational = 40\n StildeMin = 0.02\n"
               " StildeMax = 4.5\n AcceptancePrecision = 1e-16\n MaxSolverIterations = 700\n"
               "EndMonomial\n"),
    ("ORIENTEDPLAQUETTES", "BeginMeasurement ORIENTEDPLAQUETTES\n Frequency = 1\nEndMeasurement\n"),
    ("POLYAKOV", "BeginMeasurement POLYAKOV\n Frequency = 1\nEndMeasurement\n"),
    ("GRADIENTFLOW", "BeginMeasurement GRADIENTFLOW\n Frequency = 1\nEndMeasurement\n"),
    ("SFCOUPLING", "BeginMeasurement SFCOUPLING\n Frequency = 1\nEndMeasurement\n"),
    ("SFGAUGE", "BeginMonomial SFGAUGE\n Eta = 0.15\nEndMonomial\n"),
])
def test_ported_features_lower(what, text):
    """What earlier slices refused now lowers: NDPOLY to the reference's
    NDPolyMonomial fields (degree = max(DegreeOfRational, 32)), the gauge
    measurements into the run config."""
    cfg = config_tmlqcd.parse_input(text)
    out = config.build_hmc(cfg)
    if what == "NDPOLY":
        mo = out.monomials[0]
        mr = jconfig.build_hmc(jconfig_tmlqcd.parse_input(text)).monomials[0]
        assert type(mo).__name__ == type(mr).__name__ == "NDPolyMonomial"
        for field in ("degree", "s_min", "s_max", "timescale", "heatbath_tol", "maxiter", "name"):
            assert getattr(mo, field) == getattr(mr, field)
        assert dataclasses.asdict(mo.params) == dataclasses.asdict(mr.params)
        assert mo.degree == 40 and mo.params.c_sw == 1.0 and mo.coeffs.shape == (41,)
    elif what == "SFGAUGE":
        # the SF monomial and its momenta mask (tests/test_torch_sf.py runs them)
        mo = out.monomials[0]
        assert type(mo).__name__ == "SFGaugeMonomial" and mo.eta == 0.15
        assert float(out.momenta_mask[1:4, 0].abs().sum()) == 0.0
        assert float(out.momenta_mask[0].min()) == 1.0
    else:
        assert [m.type for m in cfg.meas] == [what] and out.monomials[0].name == "gauge"


@pytest.mark.parametrize("procs", ["NrXProcs = 2\n", "NrZProcs = 2\n",
                                   "NrTProcs = 2\nNrXProcs = 2\n"])
def test_unported_decompositions_raise_reference_error(procs, tmp_path):
    """NrTProcs / NrYProcs build the slab mesh (tests/test_torch_shard_hmc.py);
    NrXProcs / NrZProcs > 1 raise the reference's ValueError where
    `cli.hmc` builds the mesh (`mesh_from_procs`), in both packages."""
    from tmlqcd_tpu import parallel as jparallel
    from tmlqcd_tpu_torch.cli import hmc as cli_hmc

    text = "L = 4\nT = 4\n" + procs
    jcfg = jconfig_tmlqcd.parse_input(text)
    with pytest.raises(ValueError, match="unsupported: this framework decomposes"):
        jparallel.mesh_from_procs(jcfg.nr_procs, jcfg.lat)
    path = tmp_path / "procs.input"
    path.write_text(text)
    with pytest.raises(ValueError, match="unsupported: this framework decomposes"):
        cli_hmc.main(["-f", str(path), "-o", str(tmp_path / "run"), "--cpu"])


def test_checkpoints_cross_read(tmp_path, gauge):
    u, ut = gauge
    p_ref = jckpt.save_checkpoint(str(tmp_path / "jax"), jnp.asarray(u), 7, 44, JL,
                                  plaquette=0.5)
    arr, traj, seed = checkpoint.load_checkpoint(p_ref, LAT)
    np.testing.assert_array_equal(arr, u)
    assert (traj, seed) == (7, 44)
    p_out = checkpoint.save_checkpoint(str(tmp_path / "torch"), ut, 9, 45, LAT, plaquette=0.5)
    arr, traj, seed = jckpt.load_checkpoint(p_out, JL)
    np.testing.assert_array_equal(arr, u)
    assert (traj, seed) == (9, 45)
    info_ref = jckpt.latest_checkpoint(str(tmp_path / "torch"))
    info = checkpoint.latest_checkpoint(str(tmp_path / "jax"))
    assert (info_ref.trajectory, info.trajectory) == (9, 7)
    with pytest.raises(ValueError, match="unknown checkpoint format"):
        checkpoint.save_checkpoint(str(tmp_path / "torch"), ut, 10, 45, LAT, fmt="hdf5")


def test_cli_runs_on_cpu_and_requires_cuda_otherwise(tmp_path):
    from tmlqcd_tpu_torch.cli import hmc as cli

    inp = tmp_path / "in.input"
    inp.write_text("L = 4\nT = 4\nMeasurements = 2\nNSave = 1\nSeed = 5\nbeta = 5.3\n"
                   "NumberOfTimescales = 2\n"
                   "BeginMonomial GAUGE\n Timescale = 0\n IntegrationSteps = 1\nEndMonomial\n"
                   "BeginMonomial DET\n Timescale = 1\n kappa = 0.13\n 2KappaMu = 0.026\n"
                   " AcceptancePrecision = 1e-16\n ForcePrecision = 1e-14\n"
                   " IntegrationSteps = 1\nEndMonomial\n")
    run = tmp_path / "run"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["-f", str(inp), "-o", str(run)])
    assert cli.main(["-f", str(inp), "-o", str(run), "--cpu"]) == 0
    lines = (run / "output.data").read_text().splitlines()
    assert len(lines) == 2
    for ln in lines:
        cols = ln.split()
        assert len(cols) == 9  # traj plaq rect dH exp(-dH) acc seconds + 2 monomials' iterations
        assert 0.0 < float(cols[1]) < 1.0 and np.isfinite(float(cols[3]))
    assert sorted(os.listdir(run)) == ["conf.000001.npz", "conf.000002.npz", "nstore_counter",
                                       "output.data"]
    arr, traj, seed = jckpt.load_checkpoint(str(run / "conf.000002.npz"), JL)
    assert (traj, seed, arr.shape) == (2, 5, (3, 3, 4) + JL.site_shape)
