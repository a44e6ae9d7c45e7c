"""The harness on the CPU at 4^4, with the program's plain routes.

* A configuration, a traffic mix and a per-layer metric added as new files
  plus new BENCHMARK.json entries in another tree (`--root`) run without a
  change to the harness.
* Faults planted in the timed path (a step that returns its state
  unchanged, a trajectory that returns its input links while it reports
  an accepted one, half of the batch left out, an answer altered where it
  is produced) make `correct` false under the cells' own limits; the harness's
  look for a card is skipped (`--cpu`), the rest of the run is whole.
* The benchmark's modules load no jax, jaxlib, flax or tmlqcd_tpu, and the
  reference loads nothing of the program.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from conftest import QB, ROOT

import run  # noqa: E402

def _run(tree, workload, seconds, trace=0, seed=3):
    env = dict(os.environ, PYTHONHASHSEED="0")
    cmd = [sys.executable, os.path.join(QB, "run.py"), "--workload", workload, "--seed",
           str(seed), "--seconds", str(seconds), "--trace", str(trace), "--root", str(tree),
           "--cpu"]
    out = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=600,
                         cwd=str(tree))
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1]), out.stderr


def test_added_files_run_without_a_harness_change(tree):
    res, err = _run(tree, "mini.prop2", 1.0)
    assert res["correct"] and res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"setup_s", "s_per_prop"}
    assert list(res)[-1] == "check" and set(res["check"]) == {"resid"}
    assert err.strip().splitlines()[-1].startswith("check resid ")
    res, _ = _run(tree, "mini.prop2", 1.0, trace=1, seed=4)
    assert res["correct"]
    # the untraced window's units; the traced window's follow in `attempted`
    assert 1 <= res["metrics"]["units_done"]["value"] < res["attempted"]
    assert {"cg_iters.prop", "ms_per_iter.prop", "idle_pct.prop"} <= set(res["metrics"])
    assert res["device"]["window_s"] > 0 and "breakdown" in res


def test_no_card_no_result(tree):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, os.path.join(QB, "run.py"), "--workload",
                          "mini.prop2", "--seed", "1", "--seconds", "1", "--trace", "0",
                          "--root", str(tree)], capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def _in_process(tree, workload, seconds, capsys, seed=5):
    rc = run.main(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
                   "--root", str(tree), "--cpu"])
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _half_batch(orig):
    def solve(u, bs, *a, **k):
        res = orig(u, bs, *a, **k)
        res.x[bs.shape[0] // 2:] = 0
        return res
    return solve


def _altered(orig):
    def solve(u, bs, *a, **k):
        res = orig(u, bs, *a, **k)
        res.x[0, 0, 0, 0, 0, 0] += 1.0
        return res
    return solve


def _unchanged(orig):
    def solve(u, bs, *a, **k):
        res = orig(u, bs, *a, **k)
        res.x = bs.clone()
        return res
    return solve


@pytest.mark.parametrize("cell", ["b40.24.prop12", "ca211.53.24.prop12"])
@pytest.mark.parametrize("fault", [None, _half_batch, _altered, _unchanged])
def test_propagator_faults_fail(tree, cell, fault, monkeypatch, capsys):
    from tmlqcd_tpu_torch import inverter

    if fault is not None:
        monkeypatch.setattr(inverter, "invert_eo_rhs", fault(inverter.invert_eo_rhs))
    res = _in_process(tree, cell, 12.0 if cell.startswith("ca211") else 5.0, capsys)
    assert res["correct"] is (fault is None)


def _integrate_unchanged(orig):
    def integrate(cfg, monomials, aux, u, p, chrono=None, freeze_mask=None):
        return u, p, chrono, [0] * len(monomials)
    return integrate


def _integrate_altered(orig):
    def integrate(*a, **k):
        u, p, ch, its = orig(*a, **k)
        u = u.clone()
        u[:, :, 0, 0, 0, 0] = u[:, :, 1, 0, 0, 0]
        return u, p, ch, its
    return integrate


def _input_returned_on_accept(orig):
    def hmc_trajectory(cfg, u, key, chrono=None, draws=None):
        u_out, stats, ch = orig(cfg, u, key, chrono, draws=draws)
        return u, stats, ch
    return hmc_trajectory


@pytest.mark.parametrize("fault", [None, _integrate_unchanged, _integrate_altered,
                                   _input_returned_on_accept])
def test_trajectory_faults_fail(tree, fault, monkeypatch, capsys):
    from tmlqcd_tpu_torch import hmc
    from tmlqcd_tpu_torch.hmc import trajectory

    if fault is _input_returned_on_accept:
        monkeypatch.setattr(hmc, "hmc_trajectory", fault(hmc.hmc_trajectory))
    elif fault is not None:
        monkeypatch.setattr(trajectory, "integrate", fault(trajectory.integrate))
    res = _in_process(tree, "b40.24.hmc", 14.0, capsys)
    assert res["correct"] is (fault is None)


def test_imports_stay_clear():
    code = ("import sys, glob, os, importlib.util; sys.path[:0] = [%r, %r]\n"
            "import reference.ops, reference.hmc\n"
            "assert not [m for m in sys.modules if m.split('.')[0] == 'tmlqcd_tpu_torch'], 'ref'\n"
            "import run, workload, fields, devtrace, yardstick, calibrate\n"
            "for p in glob.glob(os.path.join(%r, 'metrics', '*.py')):\n"
            "    s = importlib.util.spec_from_file_location('m', p)\n"
            "    s.loader.exec_module(importlib.util.module_from_spec(s))\n"
            "import tmlqcd_tpu_torch.config, tmlqcd_tpu_torch.inverter, tmlqcd_tpu_torch.hmc\n"
            "print(run.forbidden_modules())\n") % (QB, ROOT, QB)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"
    assert run.forbidden_modules.__code__ is not None
    sys.modules.setdefault("tmlqcd_tpu.fake", object())
    try:
        assert run.forbidden_modules() == ["tmlqcd_tpu"]
    finally:
        del sys.modules["tmlqcd_tpu.fake"]
