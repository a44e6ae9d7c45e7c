"""`spantrace`: the program's spans joined to the device trace.

* On synthetic kineto-like events: `devtrace.reduce` reads the same window,
  busy time, kernels, device operations and idle gaps with and without the
  program's spans; the spans' self device seconds and the unattributed ones
  add up to the kernels' seconds; each device interval and idle gap goes to
  the innermost span that launched it; each span reading is None where its
  span is absent.
* On a real torch.profiler profile (CPU) of a batched inversion, and from the
  command line on the cells cut to 4^4: the spans are found and counted.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from conftest import QB

import devtrace  # noqa: E402
import spantrace  # noqa: E402

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


class Ev:
    """The parts of a torch KinetoEvent that the reductions read."""

    def __init__(self, name, t0, t1, dev=False, ua=False, corr=0, linked=0, thread=1):
        self._v = (name, t0, t1, CUDA if dev else CPU, ua, corr, linked, thread)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]

    def is_user_annotation(self):
        return self._v[4]

    def correlation_id(self):
        return self._v[5]

    def linked_correlation_id(self):
        return self._v[6]

    def start_thread_id(self):
        return self._v[7]


class Prof:
    def __init__(self, events):
        events = list(events)
        kineto = type("K", (), {"events": lambda self: events})()
        self.profiler = type("P", (), {"kineto_results": kineto})()


def kernel(name, t0, t1, corr, linked, launch_at):
    """A device interval and its runtime launch (same correlation id)."""
    return [Ev(name, t0, t1, dev=True, corr=corr, linked=linked),
            Ev("cudaLaunchKernel", launch_at, launch_at + 2, corr=corr)]


# one unit [0, 1000): tmlqcd.cg [100, 800) holds an operator application
# [150, 300) and a stopping test [400, 450); a kernel is launched by a torch
# op in the CG's own work, one from the operator span itself (as a ctypes
# launch is), a copy by the stopping test's read, one more by the CG, and
# one by an op outside every span; a backward op on the autograd engine's
# thread (2, which opens no span) launches one while the CG waits in it.
# Torch ops' and launches' correlation ids overlap, as on the card.
SPANS = [Ev("tmlqcd.cg", 100, 800, corr=10), Ev("tmlqcd.cg.matvec", 150, 300, corr=11),
         Ev("tmlqcd.cg.sync", 400, 450, corr=12)]
OTHERS = (
    [Ev("qcdbench.unit", 0, 1000, ua=True, corr=1), Ev("qcdbench.unit", 1, 998, dev=True, ua=True),
     Ev("aten::add", 110, 125, corr=20), Ev("aten::_local_scalar_dense", 410, 445, corr=21),
     Ev("aten::sum", 500, 515, corr=22), Ev("aten::mul", 900, 910, corr=23),
     Ev("MulBackward0", 610, 640, corr=24, thread=2),
     Ev("Activity Buffer Request", 0, 5, corr=10)]
    + kernel("add_kernel", 130, 160, 11, 20, 112)
    + kernel("void (anonymous namespace)::hopping_rhs_kernel<2, true, true, float>(x)",
             200, 260, 12, 11, 180)
    + [Ev("Memcpy DtoH (Device -> Pinned)", 460, 470, dev=True, corr=13, linked=21),
       Ev("cudaMemcpyAsync", 412, 440, corr=13)]
    + kernel("reduce_kernel", 520, 600, 14, 22, 505)
    + kernel("mul_kernel", 920, 950, 15, 23, 902)
    + kernel("mul_backward_kernel", 650, 700, 16, 24, 615))


def test_reduce_is_unchanged_by_the_spans():
    with_spans = devtrace.reduce(Prof(SPANS + OTHERS), 1)
    without = devtrace.reduce(Prof(OTHERS), 1)
    for field in ("window_s", "busy_s", "kernels", "device_ops", "idle_gaps"):
        assert getattr(with_spans, field) == getattr(without, field), field


def test_device_seconds_go_to_the_launching_span():
    sp = spantrace.join(Prof(SPANS + OTHERS), 1)
    kernels_s = sum(v[1] for v in devtrace.reduce(Prof(SPANS + OTHERS), 1).kernels.values())
    self_s = sum(s["device_self_s"] for s in sp.spans.values())
    assert self_s + sp.unattributed_s == pytest.approx(kernels_s) == pytest.approx(sp.device_s)
    s = sp.spans
    assert s["tmlqcd.cg"]["device_self_s"] == pytest.approx((30 + 80 + 50) * 1e-9)
    assert s["tmlqcd.cg.matvec"]["device_s"] == pytest.approx(60e-9)
    assert s["tmlqcd.cg.sync"]["device_s"] == pytest.approx(10e-9)
    assert s["tmlqcd.cg"]["device_s"] == pytest.approx(230e-9)
    assert sp.unattributed_s == pytest.approx(30e-9)
    assert s["tmlqcd.cg"]["n"] == 1 and s["tmlqcd.cg"]["host_s"] == pytest.approx(700e-9)
    assert s["tmlqcd.cg"]["host_self_s"] == pytest.approx((700 - 150 - 50) * 1e-9)
    assert sp.launch_lag_us == [pytest.approx(0.015), pytest.approx(0.020)]


def test_a_user_ranges_device_copy_is_no_work():
    copy = [Ev("someone.range", 120, 700, ua=True, corr=30),
            Ev("someone.range", 130, 600, dev=True, ua=True)]
    a, b = spantrace.join(Prof(SPANS + OTHERS + copy), 1), spantrace.join(Prof(SPANS + OTHERS), 1)
    assert a.spans == b.spans and a.device_s == b.device_s and a.idle_spans == b.idle_spans


def test_idle_gaps_go_to_the_span_the_device_waited_for():
    sp = spantrace.join(Prof(SPANS + OTHERS), 1)
    trace = devtrace.reduce(Prof(SPANS + OTHERS), 1)
    got = dict(sp.idle_spans)
    # [0, 130), [470, 520) and [600, 650) wait on the CG's own kernels (the
    # last on its backward pass), [160, 200) on the operator, [260, 460) on
    # the stopping test's copy, [700, 920) on a launch outside every span,
    # [950, 1000) on nothing
    assert got == pytest.approx({"tmlqcd.cg": 230e-9, "tmlqcd.cg.matvec": 40e-9,
                                 "tmlqcd.cg.sync": 200e-9,
                                 spantrace.OUTSIDE: 220e-9 + 50e-9})
    assert sum(got.values()) == pytest.approx(trace.window_s - trace.busy_s)
    assert sp.spans["tmlqcd.cg"]["idle_s"] == pytest.approx(470e-9)


def test_readings_none_without_their_span():
    bare = spantrace.join(Prof(OTHERS), 1)
    assert bare.spans == {} and bare.unattributed_s == pytest.approx(bare.device_s)
    for name, read in spantrace.READINGS.items():
        assert read(bare, 100, 1e-6) is None, name
    sp = spantrace.join(Prof(SPANS + OTHERS), 1)
    got = {name: read(sp, 2, 1e-6) for name, read in spantrace.READINGS.items()}
    assert got["gauge_force_ms.hmc"] is None and got["drift_ms.hmc"] is None
    assert got["cg_ms_per_iter.hmc"] == pytest.approx(1e3 * 230e-9 / 2)
    assert got["operator_ms_per_iter.prop"] == pytest.approx(1e3 * 60e-9 / 2)
    assert got["glue_ms_per_iter.prop"] == pytest.approx(1e3 * 160e-9 / 2)
    assert got["solver_idle_pct.prop"] == pytest.approx(100 * 470e-9 / 1e-6)


def test_a_real_profile_of_the_port():
    from torch.profiler import ProfilerActivity, profile, record_function

    from tmlqcd_tpu_torch import rng
    from tmlqcd_tpu_torch.inverter import invert_eo_rhs
    from tmlqcd_tpu_torch.lattice import Lattice
    from tmlqcd_tpu_torch.ops.wilson import DiracParams

    lat = Lattice((4, 4, 4, 4))
    u = rng.random_su3_field(rng.Key(3), lat, torch.device("cpu"))
    bs = torch.zeros((2, 4, 3, 4, 4, 16), dtype=torch.complex64)
    bs[0, 0, 0, 0, 0, 0] = bs[1, 1, 2, 1, 2, 3] = 1.0
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            with record_function("qcdbench.unit"):
                res = invert_eo_rhs(u, bs, DiracParams(kappa=0.16, mu=0.004), lat, tol=1e-4)
    sp = spantrace.join(prof, 2)
    s = sp.spans
    assert s["tmlqcd.invert"]["n"] == s["tmlqcd.cg"]["n"] == 2
    assert s["tmlqcd.cg.matvec"]["n"] == 2 * (res.iterations + 1)
    assert 0 < s["tmlqcd.cg.matvec"]["host_s"] < s["tmlqcd.cg"]["host_s"]
    assert s["tmlqcd.cg"]["host_self_s"] < s["tmlqcd.cg"]["host_s"] < s["tmlqcd.invert"]["host_s"]
    assert sp.device_s == 0.0 and sp.idle_spans == [[spantrace.OUTSIDE, pytest.approx(
        devtrace.reduce(prof, 2).window_s)]]


def test_command_line(tree):
    """A propagator cell at 4^4 (a traced trajectory takes a minute on the CPU;
    `tests/test_torch_spans.py` counts its spans)."""
    out = subprocess.run([sys.executable, os.path.join(QB, "spantrace.py"), "--workload",
                          "mini.prop2", "--seed", "5", "--seconds", "1", "--root", str(tree),
                          "--cpu"], capture_output=True, text=True, timeout=600, cwd=str(tree))
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(res["readings"]) == {n for n in spantrace.READINGS if n.endswith(".prop")}
    assert res["units"] >= 1 and res["cg_iters"] >= res["units"]
    s = res["spans"]
    assert s["tmlqcd.invert"]["n"] == s["tmlqcd.cg"]["n"] == res["units"]
    assert s["tmlqcd.cg.matvec"]["n"] == res["cg_iters"] + res["units"]
