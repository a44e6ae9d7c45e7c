"""Reduction of one torch.profiler session to what the per-layer metrics
read: the traced window (from the first to the last counted unit's span),
the device's busy time in it (the union of every device interval: kernels,
copies, sets), each kernel's count and device seconds, and the breakdown
(the device operations that took most time; idle gaps summed by what the
host was doing at their midpoint: the innermost aten op, else the outermost,
else plain Python)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

UNIT_SPAN = "qcdbench.unit"


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: dict  # name -> [count, seconds]
    device_ops: list  # [[name, seconds]] most time first, at most 10
    idle_gaps: list  # [[host activity, seconds]] most time first, at most 10

    def kernel(self, name: str) -> tuple[int, float]:
        """(launches, device seconds) of the kernels whose name holds `name`
        as a whole word (`hopping_kernel` is not `hopping_schur_kernel`)."""
        n, s = 0, 0.0
        for k, (c, sec) in self.kernels.items():
            if kernel_name(k) == name:
                n, s = n + c, s + sec
        return n, s


def kernel_name(full: str) -> str:
    """The bare function name of a demangled kernel name:
    "void (anonymous namespace)::hopping_rhs_kernel<2, true>(float const*, ...)"
    -> "hopping_rhs_kernel"."""
    head = full.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0].split()
    return head[-1].split("::")[-1] if head else full


def _events(prof):
    """(name, is_device, start_ns, end_ns) of every event."""
    cuda = torch.autograd.DeviceType.CUDA
    try:
        for e in prof.profiler.kineto_results.events():
            yield e.name(), e.device_type() == cuda, e.start_ns(), e.end_ns()
    except AttributeError:
        for e in prof.events():
            yield (e.name, e.device_type == cuda, int(e.time_range.start * 1000),
                   int(e.time_range.end * 1000))


def reduce(prof, n_units: int) -> Trace:
    spans, dev, host = [], [], []
    for name, is_dev, t0, t1 in _events(prof):
        if is_dev:
            if name != UNIT_SPAN:  # the span's copy on the device's timeline
                dev.append((t0, t1, name))
        elif name == UNIT_SPAN:
            spans.append((t0, t1))
        elif name.startswith("aten::"):
            host.append((t0, t1, name))
    spans.sort()
    if len(spans) < n_units or n_units == 0:
        raise RuntimeError(f"the trace holds {len(spans)} unit spans for {n_units} units")
    w0, w1 = spans[0][0], spans[n_units - 1][1]

    dev = [d for d in dev if d[0] >= w0 and d[0] < w1]
    kernels: dict = {}
    for t0, t1, name in dev:
        k = kernels.setdefault(name, [0, 0.0])
        k[0] += 1
        k[1] += (min(t1, w1) - t0) * 1e-9
    iv = np.array(sorted((t0, min(t1, w1)) for t0, t1, _ in dev), dtype=np.int64).reshape(-1, 2)
    busy, gaps = 0, []
    if len(iv):
        cur0, cur1 = iv[0]
        if cur0 > w0:
            gaps.append((w0, cur0))
        for a, b in iv[1:]:
            if a > cur1:
                busy += cur1 - cur0
                gaps.append((cur1, a))
                cur0, cur1 = a, b
            else:
                cur1 = max(cur1, b)
        busy += cur1 - cur0
        if cur1 < w1:
            gaps.append((cur1, w1))
    else:
        gaps.append((w0, w1))

    idle = _label_gaps(gaps, host)
    top = sorted(([k[:160], v[1]] for k, v in kernels.items()), key=lambda kv: -kv[1])[:10]
    return Trace(window_s=(w1 - w0) * 1e-9, busy_s=busy * 1e-9, kernels=kernels,
                 device_ops=top, idle_gaps=idle)


def _label_gaps(gaps, host) -> list:
    if not gaps:
        return []
    host.sort()
    starts = np.array([h[0] for h in host], dtype=np.int64)
    ends = np.array([h[1] for h in host], dtype=np.int64)
    # outermost ops: those not inside the previous outermost one
    outer, last_end = [], -1
    for i, (t0, t1, _) in enumerate(host):
        if t0 >= last_end:
            outer.append(i)
            last_end = t1
    o_starts = starts[outer] if outer else np.zeros(0, dtype=np.int64)
    sums: dict = {}
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        label = "python (no aten op)"
        i = int(np.searchsorted(starts, mid, side="right")) - 1
        if i >= 0 and ends[i] >= mid:
            label = host[i][2]
        else:
            j = int(np.searchsorted(o_starts, mid, side="right")) - 1
            if j >= 0 and ends[outer[j]] >= mid:
                label = host[outer[j]][2] + " (outer)"
        sums[label] = sums.get(label, 0.0) + (g1 - g0) * 1e-9
    return sorted(([k, v] for k, v in sums.items()), key=lambda kv: -kv[1])[:10]
