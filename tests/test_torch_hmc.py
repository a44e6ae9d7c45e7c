"""Parity of the PyTorch port's solvers, forces, trajectory, input reader,
checkpoints and CLI with the JAX reference (tmlqcd_tpu), on the CPU.

Inputs are drawn from seeded numpy generators (or, for the trajectory, are
the reference's own draws re-derived from its key) and handed to both
packages as numpy arrays.  The port runs its plain path (CPU tensors); the
reference runs its jnp path, as it does on the CPU.

Tolerances, each stated where it is used:
* CG: same iteration count (both stop at |r|^2 <= tol^2 |b|^2 with f64
  norms on f32 fields); solutions agree to 2e-6 (f32 rounding of O(1)
  entries over ~30 iterations).
* forces: 1e-5 absolute on forces of O(1..10) — f32 operators, f64 sums;
  measured 6e-7 .. 2e-6.
* trajectory (4^4, steps (1,1,2), tol 1e-10): |ddH| <= 1e-3 and
  |dplaq| <= 1e-5.  Both run the same f32 trajectory with the same draws
  and differ by summation order only: measured |ddH| 4.1e-5 and |dplaq|
  9e-9, with |H| ~ 1.5e4.
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
from tmlqcd_tpu.hmc import integrators as jint
from tmlqcd_tpu.hmc import monomials as jmono
from tmlqcd_tpu.io import checkpoint as jckpt
from tmlqcd_tpu.lattice import Lattice as JLattice
from tmlqcd_tpu.lattice import pack_gauge_eo as j_pack
from tmlqcd_tpu.models.suites import nf2_twisted_mass_hasenbusch as j_suite
from tmlqcd_tpu.ops import wilson as jw
from tmlqcd_tpu.solvers import chrono as jchrono
from tmlqcd_tpu.solvers.cg import cg as j_cg
from tmlqcd_tpu_torch import bridge, config, config_tmlqcd, rng
from tmlqcd_tpu_torch.hmc import Draws, hmc_trajectory, integrators, monomials
from tmlqcd_tpu_torch.io import checkpoint
from tmlqcd_tpu_torch.lattice import Lattice
from tmlqcd_tpu_torch.models.suites import nf2_twisted_mass_hasenbusch
from tmlqcd_tpu_torch.ops import gauge_action as ga
from tmlqcd_tpu_torch.ops import wilson as w
from tmlqcd_tpu_torch.ops import wilson_fast as wf
from tmlqcd_tpu_torch.solvers import chrono, dispatch
from tmlqcd_tpu_torch.solvers.cg import cg, cg_info

torch.set_num_threads(1)

# the reference's gauge_action module is shadowed by a function of the same
# name in tmlqcd_tpu.ops
import importlib  # noqa: E402

jga = importlib.import_module("tmlqcd_tpu.ops.gauge_action")

DIMS = (4, 4, 4, 4)
JL, LAT = JLattice(DIMS), Lattice(DIMS)
SAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "sample-input")
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
# solvers
# ---------------------------------------------------------------------------


def test_cg_matches_reference(gauge, pseudofermion):
    u, ut = gauge
    jp, tp = jw.DiracParams(**LIGHT), w.DiracParams(**LIGHT)
    ueo, ph = j_pack(u, JL), jw.boundary_phases(jp, JL)
    ref = jax.jit(lambda b: j_cg(lambda x: jw.q_hat_pm(ueo, x, jp, JL, ph), b, tol=1e-8,
                                 maxiter=500))(pseudofermion)
    fg = wf.make_fast_gauge(ut, tp, LAT)
    out = cg(lambda x: wf.q_hat_pm_fast(fg, x, tp, LAT),
             wf.to_split(bridge.spinor_from_numpy(pseudofermion, LAT)), tol=1e-8, maxiter=500)
    assert out.iterations == int(ref.iterations)
    assert 10 < out.iterations < 500
    assert _maxdiff(wf.from_split(out.x), ref.x) < 2e-6


def test_cg_info_and_solver_dispatch(gauge, pseudofermion):
    """cg_info's true residual meets the reference's own bound
    (tests/test_round2.py:139); the dispatch seam routes registered names and
    names what is not ported."""
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
    with pytest.raises(NotImplementedError, match="not yet ported"):
        dispatch.solve_degenerate(mv, b, solver="bicgstab")
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
    """hmc2 without its ONLINE block builds the same lattice and monomial
    parameters in both packages; with it, the port names what it lacks."""
    with open(os.path.join(SAMPLES, "hmc2-nf2-tm-hasenbusch.input")) as f:
        text = f.read()
    with pytest.raises(NotImplementedError, match="measurement"):
        config.build_hmc(config_tmlqcd.parse_input(text))
    text = text[: text.index("BeginMeasurement")]
    ref = jconfig.build_hmc(jconfig_tmlqcd.parse_input(text))
    out = config.build_hmc(config_tmlqcd.parse_input(text))
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
    ("CLOVERDET", "BeginMonomial CLOVERDET\n kappa = 0.1\nEndMonomial\n"),
    ("NrTProcs", "NrTProcs = 2\n"),
    ("NrYProcs", "NrYProcs = 2\n"),
    ("ReversibilityCheck", "ReversibilityCheck = yes\n"),
    ("DebugLevel", "DebugLevel = 2\n"),
    ("ildg", None),
])
def test_unported_features_raise(what, text):
    if text is None:  # the checkpoint format is set on the RunConfig, not in the input
        cfg = dataclasses.replace(config_tmlqcd.parse_input(""), checkpoint_format=what)
    else:
        cfg = config_tmlqcd.parse_input(text)
    with pytest.raises(NotImplementedError, match=f"(?i){what}.*not yet ported"):
        config.build_hmc(cfg)


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
    with pytest.raises(NotImplementedError):
        checkpoint.save_checkpoint(str(tmp_path / "torch"), ut, 10, 45, LAT, fmt="ildg")


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
