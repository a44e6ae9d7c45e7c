"""The program's spans joined to the device trace of one torch.profiler
profile, on the profiler's own clock, and the readings of the span metrics.

    python3 qcdbench/spantrace.py --workload NAME --seed N --seconds S

sets the cell up and warms it as `run.py` does, runs one window of S seconds
under torch.profiler, and prints one JSON line: the traced window as
`devtrace.reduce` gives it, the spans (`join`), the readings of `READINGS`
for the cell, and a check of the clocks.  It compares nothing with the
reference (`run.py` does).

The spans are the program's `tmlqcd.*` ranges (`tmlqcd_tpu_torch/utils.py`
`span`), function-scope ranges on the host, with no copy on the device's
timeline.  `join` reads the window and the device intervals that
`devtrace.reduce` reads: from the first to the last counted unit's span, each
device event that starts in it, cut at its end.  A device interval belongs
to the innermost span that held its launch.  The interval's linked
correlation id names the host op that was innermost when the launch began:
a torch op, or the span itself where a kernel is launched from Python
(ctypes) inside it.  That op's start, on the host's clock, lies in the spans
that were open then on its thread (on the thread that runs the units, for
an op of a thread that opens no span, such as the autograd engine's).  An
interval launched in no span is unattributed.
Each span name carries, over the window:

    n                         instances that started in it
    host_s, host_self_s       their host seconds, and those outside child spans
    device_s, device_self_s   device seconds of the intervals they hold, and
                              of those outside child spans
    idle_s                    idle seconds (below) inside them

An idle gap of the device belongs to the span that launched the interval
ending it, the work the device waited for; the gap after the window's last
interval to nothing (`OUTSIDE`).  The device's timeline and the host's are
joined by correlation, not by time: on an H100 (torch 2.11, CUDA 12.8) a
kernel's start read up to 9.2 ms before the start of its own launch
(`launch_lag_us`: the least and the median of a kernel's start minus its
runtime launch's), so a gap's midpoint does not say where the host was.
"""

from __future__ import annotations

import bisect
import dataclasses
import re

UNIT_SPAN = "qcdbench.unit"
PREFIX = "tmlqcd."
OUTSIDE = "outside any span"
# CUDA API calls (cudaLaunchKernel, cudaLaunchCooperativeKernel,
# cuLaunchKernel, cudaMemcpyAsync, ...): the host side of a launch
_API = re.compile(r"cu(da)?[A-Z]")
_KEYS = ("n", "host_s", "host_self_s", "device_s", "device_self_s", "idle_s")


@dataclasses.dataclass
class Spans:
    spans: dict  # name -> {key of _KEYS: value}
    unattributed_s: float  # device seconds launched in no span
    device_s: float  # all device seconds of the window (devtrace's kernels summed)
    idle_spans: list  # [[innermost span or OUTSIDE, idle seconds]], most first
    launch_lag_us: list  # [least, median] kernel start minus launch start; [] if none

    def get(self, name: str, key: str) -> float | None:
        s = self.spans.get(name)
        return None if s is None else s[key]


def join(prof, n_units: int) -> Spans:
    """`join_events` of a finished torch.profiler profile."""
    return join_events(list(prof.profiler.kineto_results.events()), n_units)


def join_events(events, n_units: int) -> Spans:
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    units, dev, spans, ops, launches = [], [], [], {}, {}
    for e in events:
        name, t0, t1 = e.name(), e.start_ns(), e.end_ns()
        if e.device_type() == cuda:
            if not e.is_user_annotation():  # a user range's copy is no device work
                dev.append((t0, t1, e.linked_correlation_id(), e.correlation_id()))
        elif name == UNIT_SPAN:
            units.append((t0, t1, e.start_thread_id()))
        elif _API.match(name):
            launches[e.correlation_id()] = t0
        elif " " not in name:  # the profiler's own records have spaces
            si = None
            if name.startswith(PREFIX):
                si = len(spans)
                spans.append((t0, t1, name, e.start_thread_id()))
            ops[e.correlation_id()] = (t0, e.start_thread_id(), si)
    units.sort()
    if len(units) < n_units or n_units == 0:
        raise RuntimeError(f"the trace holds {len(units)} unit spans for {n_units} units")
    w0, w1 = units[0][0], units[n_units - 1][1]

    parent, innermost = _tree(spans, home=units[0][2])
    names = [s[2] for s in spans]
    out = {}

    def entry(name):
        return out.setdefault(name, dict.fromkeys(_KEYS, 0))

    child_s = [0] * len(spans)
    for i, (t0, t1, _, _) in enumerate(spans):
        if parent[i] >= 0:
            child_s[parent[i]] += t1 - t0
    for i, (t0, t1, name, _) in enumerate(spans):
        if w0 <= t0 < w1:
            s = entry(name)
            s["n"] += 1
            s["host_s"] += (t1 - t0) * 1e-9
            s["host_self_s"] += (t1 - t0 - child_s[i]) * 1e-9

    def owner(linked) -> int:
        op = ops.get(linked)
        if op is None:
            return -1
        t_op, thread, si = op
        return si if si is not None else innermost(thread, t_op)

    def charge(i, seconds, key, self_key=None):
        """seconds to span i's name (self) and to each name above it once."""
        if self_key:
            entry(names[i])[self_key] += seconds
        seen = set()
        while i >= 0:
            if names[i] not in seen:
                seen.add(names[i])
                entry(names[i])[key] += seconds
            i = parent[i]

    window = sorted((t0, min(t1, w1), owner(lk), corr) for t0, t1, lk, corr in dev
                    if w0 <= t0 < w1)
    unattributed = total = 0.0
    lags = []
    for t0, t1, i, corr in window:
        d = (t1 - t0) * 1e-9
        total += d
        if i < 0:
            unattributed += d
        else:
            charge(i, d, "device_s", "device_self_s")
        if corr in launches:
            lags.append((t0 - launches[corr]) * 1e-3)

    idle = {}

    def wait(i, seconds):
        label = names[i] if i >= 0 else OUTSIDE
        idle[label] = idle.get(label, 0.0) + seconds
        if i >= 0:
            charge(i, seconds, "idle_s")

    cur1 = w0
    for t0, t1, i, _ in window:
        if t0 > cur1:
            wait(i, (t0 - cur1) * 1e-9)
        cur1 = max(cur1, t1)
    if cur1 < w1:
        wait(-1, (w1 - cur1) * 1e-9)

    lags.sort()
    return Spans(spans=out, unattributed_s=unattributed, device_s=total,
                 idle_spans=sorted(([k, v] for k, v in idle.items()), key=lambda kv: -kv[1]),
                 launch_lag_us=[lags[0], lags[len(lags) // 2]] if lags else [])


def _tree(spans, home):
    """(parent index of each span, -1 at the top; innermost(thread, t): the
    index of the innermost span of that thread open at host time t, or -1).
    The spans of one thread nest: they are context managers.  A thread that
    opens no span works for the `home` thread, which runs the units: the
    autograd engine runs a backward pass on a device thread of its own while
    the caller waits in `torch.autograd.grad` inside its span.  Its ops are
    placed in `home`'s spans."""
    parent = [-1] * len(spans)
    by_thread = {}
    for i, s in enumerate(spans):
        by_thread.setdefault(s[3], []).append(i)
    tables = {}
    for thread, idx in by_thread.items():
        idx.sort(key=lambda i: (spans[i][0], -spans[i][1]))
        ts, owners, stack = [], [], []

        def close_until(t):
            while stack and spans[stack[-1]][1] <= t:
                end = spans[stack.pop()][1]
                ts.append(end)
                owners.append(stack[-1] if stack else -1)

        for i in idx:
            close_until(spans[i][0])
            parent[i] = stack[-1] if stack else -1
            stack.append(i)
            ts.append(spans[i][0])
            owners.append(i)
        close_until(float("inf"))
        tables[thread] = (ts, owners)

    def innermost(thread, t) -> int:
        ts, owners = tables.get(thread) or tables.get(home, ((), ()))
        j = bisect.bisect_right(ts, t) - 1
        return owners[j] if j >= 0 else -1

    return parent, innermost


def _per_instance_ms(sp: Spans, name: str):
    n, s = sp.get(name, "n"), sp.get(name, "device_s")
    return 1e3 * s / n if n else None


def _per_iteration_ms(sp: Spans, name: str, key: str, iters: int):
    s = sp.get(name, key)
    return 1e3 * s / iters if s is not None and iters else None


# the span metrics: name -> reading(spans, CG iterations of the window's
# units, window seconds), None where its span is absent
READINGS = {
    # inclusive device ms of one gauge force / one drift
    "gauge_force_ms.hmc": lambda sp, iters, window_s: _per_instance_ms(sp, "tmlqcd.force.gauge"),
    "drift_ms.hmc": lambda sp, iters, window_s: _per_instance_ms(sp, "tmlqcd.drift"),
    # device ms an iteration of the solves: the whole CG; its operator
    # applications; its own vector work (the CG without them and its syncs)
    "cg_ms_per_iter.hmc":
        lambda sp, iters, window_s: _per_iteration_ms(sp, "tmlqcd.cg", "device_s", iters),
    "operator_ms_per_iter.prop":
        lambda sp, iters, window_s: _per_iteration_ms(sp, "tmlqcd.cg.matvec", "device_s", iters),
    "glue_ms_per_iter.prop":
        lambda sp, iters, window_s: _per_iteration_ms(sp, "tmlqcd.cg", "device_self_s", iters),
    # share of the window in which the device waited on the CG
    "solver_idle_pct.prop": lambda sp, iters, window_s: (
        None if sp.get("tmlqcd.cg", "idle_s") is None or window_s <= 0
        else 100.0 * sp.get("tmlqcd.cg", "idle_s") / window_s),
}
SUFFIX = {"trajectories": ".hmc", "propagators": ".prop"}


def main(argv=None) -> int:
    import argparse
    import json
    import os
    import subprocess
    import sys

    here = os.path.dirname(os.path.abspath(__file__))
    for p in (os.path.dirname(here), here):
        if p not in sys.path:
            sys.path.insert(0, p)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--root", default=os.path.dirname(here))
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    import devtrace
    import run
    import workload

    with open(os.path.join(args.root, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    cell = {w["name"]: w for w in bench["workloads"]}[args.workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(os.path.join(args.root, conf["file"])) as fh:
        cfg = json.load(fh)
    cfg["_path"] = os.path.join(args.root, conf["file"])
    with open(os.path.join(args.root, bench["paths"][0], "traffic",
                           cell["traffic"] + ".json")) as fh:
        traffic = json.load(fh)
    if args.cpu:
        device, kind = torch.device("cpu"), "cpu"
    else:
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
        kind = smi.stdout.strip() or torch.cuda.get_device_name(device)
    torch.backends.cuda.matmul.allow_tf32 = False

    w = workload.make(traffic["kind"], cfg, traffic, args.seed, device, run.log)
    w.warm_up()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        records, _, _, _ = run.window(w, args.seconds, 0, run.counters())
    if not records:
        run.log("no unit completed inside the window")
        return 4
    trace = devtrace.reduce(prof, len(records))
    sp = join(prof, len(records))
    prof = None
    iters = sum(r["cg_iters"] for r in records)
    suffix = SUFFIX[traffic["kind"]]
    readings = {name: f(sp, iters, trace.window_s) for name, f in READINGS.items()
                if name.endswith(suffix)}
    print(json.dumps({
        "workload": args.workload, "device": kind, "units": len(records), "cg_iters": iters,
        "window_s": trace.window_s, "busy_s": trace.busy_s,
        "idle_pct": 100.0 * (1.0 - trace.busy_s / trace.window_s),
        "kernels_s": sum(v[1] for v in trace.kernels.values()),
        "readings": readings, "unattributed_s": sp.unattributed_s, "device_s": sp.device_s,
        "spans": dict(sorted(sp.spans.items(), key=lambda kv: -kv[1]["device_s"])),
        "idle_spans": sp.idle_spans, "launch_lag_us": sp.launch_lag_us,
        "device_ops": trace.device_ops, "idle_gaps": trace.idle_gaps}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
