"""CG, the chronological guess and the gauge force of the PyTorch port
against the JAX reference's programs (tmlqcd_tpu), and its CLI run, on the
CPU: the cases of tests/test_torch_hmc.py that take seconds each, in a file
of at most 8 tests, which the test runner queues behind
tests/test_multirhs.py.  The gauge and the pseudofermion are those of
tests/test_torch_hmc.py (its fixtures, imported).

Inputs are drawn from seeded numpy generators and handed to both packages
as numpy arrays.  The port runs its plain path (CPU tensors); the
reference runs its jnp path, as it does on the CPU.

Tolerances, each stated where it is used:
* CG: same iteration count (both stop at |r|^2 <= tol^2 |b|^2 with f64
  norms on f32 fields); solutions agree to 2e-6 (f32 rounding of O(1)
  entries over ~30 iterations).
* gauge force: 1e-5 absolute on forces of O(1..10) — f32 operators, f64
  sums; the staple force of each action 2e-6 of its largest entry (up to
  ~80 for DBW2), the finite difference 1e-6 relative in complex128.
"""

import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_hmc import (  # noqa: F401  (fixtures, the autouse one too)
    DIMS,
    JL,
    LAT,
    LIGHT,
    _quick_reference_compiles,
    gauge,
    pseudofermion,
)
from tmlqcd_tpu.io import checkpoint as jckpt
from tmlqcd_tpu.lattice import Lattice as JLattice
from tmlqcd_tpu.lattice import pack_gauge_eo as j_pack
from tmlqcd_tpu.ops import wilson as jw
from tmlqcd_tpu.solvers import chrono as jchrono
from tmlqcd_tpu.solvers.cg import cg as j_cg
from tmlqcd_tpu_torch import bridge, su3
from tmlqcd_tpu_torch.config import GAUGE_ACTIONS
from tmlqcd_tpu_torch.lattice import Lattice
from tmlqcd_tpu_torch.ops import gauge_action as ga
from tmlqcd_tpu_torch.ops import wilson as w
from tmlqcd_tpu_torch.ops import wilson_fast as wf
from tmlqcd_tpu_torch.solvers import chrono
from tmlqcd_tpu_torch.solvers.cg import cg

torch.set_num_threads(1)

# the reference's gauge_action module is shadowed by a function of the same
# name in tmlqcd_tpu.ops
jga = importlib.import_module("tmlqcd_tpu.ops.gauge_action")


def _maxdiff(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


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



@pytest.mark.parametrize("dims", [DIMS, (4, 6, 8, 10)], ids=["4x4x4x4", "4x6x8x10"])
def test_staple_gauge_force_matches_autograd_reference_and_finite_difference(dims):
    """The staple force (`gauge_force_plain`, the kernel's arithmetic) for
    each gauge action against the autograd oracle `gauge_force_ad` and the
    reference's `gauge_force`, to 2e-6 of the largest entry (f32 sums of
    O(beta c0) staples: ~2e-7 measured); on the uneven lattice every axis
    wraps at another extent.  Then, in complex128, the force on one link
    against the finite difference of `gauge_action` along a momentum on
    that link alone (tlSym)."""
    jl, lat = JLattice(dims), Lattice(dims)
    u = bridge.numpy_su3(np.random.default_rng(23), (4,) + jl.site_shape)
    ut = bridge.gauge_from_numpy(u, lat)
    refs = jax.jit(lambda u: {name: jga.gauge_force(u, 5.3, jl, c1)
                              for name, c1 in GAUGE_ACTIONS.items()})(u)
    for name, c1 in GAUGE_ACTIONS.items():
        f = ga.gauge_force_plain(ut, 5.3, lat, c1)
        scale = float(f.abs().max())
        assert _maxdiff(f, ga.gauge_force_ad(ut, 5.3, lat, c1)) < 2e-6 * scale, name
        assert _maxdiff(f, refs[name]) < 2e-6 * scale, name

    u128, c1 = ut.to(torch.complex128), GAUGE_ACTIONS["tlsym"]
    h = np.random.default_rng(24).standard_normal((3, 3)) * (1 + 1j)
    p = torch.zeros_like(u128)
    p[:, :, 2, 1, 2, 5] = torch.as_tensor(h - h.conj().T - np.trace(h - h.conj().T) / 3 * np.eye(3))
    eps = 1e-5
    s = [float(ga.gauge_action(su3.mul(su3.expm_ta(e * p), u128), 5.3, lat, c1))
         for e in (eps, -eps)]
    fd = (s[0] - s[1]) / (2 * eps)
    pred = float(torch.einsum("ij...,ji...->", ga.gauge_force_plain(u128, 5.3, lat, c1), p).real)
    assert abs(fd - pred) < 1e-6 * abs(fd)


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
