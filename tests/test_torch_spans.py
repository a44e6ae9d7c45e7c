"""The port's spans (`utils.span`) at 4^4 on the CPU: which a B40.24-style
trajectory (GAUGE + DET + DETRATIO, 2MN on three timescales) and a 2-column
batched inversion open, how they nest and how often; that under
torch.profiler they are function-scope ranges, not user annotations (which
leave a copy of themselves on a CUDA device's timeline); and that with no
profiler a span enters no record range at all.

The inversion runs under torch.profiler itself.  The trajectory runs under a
recorder that stands in for it (`recorded`): the profiler records each of the
trajectory's ~600,000 torch ops on the CPU, which takes seconds."""

from __future__ import annotations

import collections
import contextlib
import itertools

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tmlqcd_tpu_torch import rng, utils
from tmlqcd_tpu_torch.config import IntegratorSpec, MonomialSpec, RunConfig, build_hmc
from tmlqcd_tpu_torch.hmc import chrono_states, hmc_trajectory
from tmlqcd_tpu_torch.hmc.integrators import _expand_schedule
from tmlqcd_tpu_torch.inverter import invert_eo_rhs
from tmlqcd_tpu_torch.lattice import Lattice
from tmlqcd_tpu_torch.ops.wilson import DiracParams
from tmlqcd_tpu_torch.solvers.cg import cg

DIMS = (4, 4, 4, 4)
KAPPA = 0.160856


def _hmc():
    mono = (MonomialSpec(type="GAUGE", timescale=0),
            MonomialSpec(type="DET", timescale=1, kappa=KAPPA, two_kappa_mu=0.0128685,
                         acceptance_precision=1e-6, force_precision=1e-3),
            MonomialSpec(type="DETRATIO", timescale=2, kappa=KAPPA, two_kappa_mu=0.00128685,
                         two_kappa_mu2=0.0128685, acceptance_precision=1e-6,
                         force_precision=1e-3))
    return build_hmc(RunConfig(t=4, lx=4, ly=4, lz=4, beta=3.9, gauge_action="tlsym",
                               monomials=mono,
                               integrator=IntegratorSpec(tau=0.5, steps=(1, 1, 1),
                                                         types=("2MN",) * 3)))


def _spans(prof) -> list:
    """(start, end, name) of every `tmlqcd.*` range, in start order."""
    out = [(e.start_ns(), e.end_ns(), e.name(), e.is_user_annotation())
           for e in prof.profiler.kineto_results.events() if e.name().startswith("tmlqcd.")]
    assert out, "no span in the trace"
    assert not any(ua for *_, ua in out), "a span is a user annotation"  # no device copy
    return sorted(s[:3] for s in out)


def _parents(spans) -> list:
    """(name, name of the innermost enclosing span or None) for each span."""
    out, stack = [], []
    for t0, t1, name in spans:
        while stack and stack[-1][1] <= t0:
            stack.pop()
        out.append((name, stack[-1][2] if stack else None))
        stack.append((t0, t1, name))
    return out


def _tops(spans) -> list:
    """(name, name of the outermost span holding it, or its own) of each span."""
    out, top_end, top = [], -1, None
    for t0, t1, name in spans:
        if t0 >= top_end:
            top_end, top = t1, name
        out.append((name, top))
    return out


@contextlib.contextmanager
def recorded():
    """`utils.span` as under a profiler, each range recorded as (enter tick,
    exit tick, name) in the list it yields."""
    spans, tick = [], itertools.count()

    @contextlib.contextmanager
    def record_range(name):
        t0 = next(tick)
        yield
        spans.append((t0, next(tick), name))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(utils, "_profiler_enabled", lambda: True)
        mp.setattr(utils, "_RecordFunctionFast", record_range)
        yield spans
    spans.sort()


@pytest.fixture(scope="module")
def traced_trajectory():
    cfg = _hmc()
    u = rng.random_su3_field(rng.Key(5), Lattice(DIMS), torch.device("cpu"))
    with recorded() as spans, torch.no_grad():
        _, st, _ = hmc_trajectory(cfg, u, rng.Key(7), chrono_states(cfg, u.device))
    return cfg, st, spans


@pytest.fixture(scope="module")
def traced_inversion():
    lat = Lattice(DIMS)
    u = rng.random_su3_field(rng.Key(3), lat, torch.device("cpu"))
    bs = torch.zeros((2, 4, 3, 4, 4, 16), dtype=torch.complex64)
    bs[0, 0, 0, 0, 0, 0] = bs[1, 1, 2, 1, 2, 3] = 1.0
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = invert_eo_rhs(u, bs, DiracParams(kappa=KAPPA, mu=0.004), lat, tol=1e-4)
    return res, _spans(prof)


HMC_PARENTS = {
    "tmlqcd.hmc.heatbath": {None}, "tmlqcd.hmc.md": {None}, "tmlqcd.hmc.accept": {None},
    "tmlqcd.force.gauge": {"tmlqcd.hmc.md"}, "tmlqcd.force.det": {"tmlqcd.hmc.md"},
    "tmlqcd.force.detratio": {"tmlqcd.hmc.md"}, "tmlqcd.drift": {"tmlqcd.hmc.md"},
    "tmlqcd.cg": {"tmlqcd.hmc.heatbath", "tmlqcd.hmc.accept", "tmlqcd.force.det",
                  "tmlqcd.force.detratio"},
    "tmlqcd.cg.matvec": {"tmlqcd.cg"}, "tmlqcd.cg.sync": {"tmlqcd.cg"},
}
INVERT_PARENTS = {
    "tmlqcd.invert": {None}, "tmlqcd.invert.pack": {"tmlqcd.invert"},
    "tmlqcd.invert.prologue": {"tmlqcd.invert"}, "tmlqcd.cg": {"tmlqcd.invert"},
    "tmlqcd.invert.epilogue": {"tmlqcd.invert"}, "tmlqcd.invert.unpack": {"tmlqcd.invert"},
    "tmlqcd.cg.matvec": {"tmlqcd.cg"}, "tmlqcd.cg.sync": {"tmlqcd.cg"},
}


@pytest.mark.parametrize("which", ["trajectory", "inversion"])
def test_spans_open_and_nest(which, traced_trajectory, traced_inversion):
    spans = traced_trajectory[2] if which == "trajectory" else traced_inversion[1]
    want = HMC_PARENTS if which == "trajectory" else INVERT_PARENTS
    pairs = _parents(spans)
    assert {name for name, _ in pairs} == set(want)
    for name, parent in pairs:
        assert parent in want[name], (name, parent)


def test_force_and_drift_spans_follow_the_schedule(traced_trajectory):
    cfg, _, spans = traced_trajectory
    kick_rows, drift_dts = _expand_schedule(cfg.integrator,
                                            tuple(m.timescale for m in cfg.monomials))
    kc, dd = kick_rows.astype(np.float32), drift_dts.astype(np.float32)
    n = collections.Counter(name for _, _, name in spans)
    for i, m in enumerate(cfg.monomials):
        assert n[f"tmlqcd.force.{m.name}"] == int(np.count_nonzero(kc[:, i])) > 0
    assert n["tmlqcd.drift"] == int(np.count_nonzero(dd)) > 0
    assert n["tmlqcd.hmc.heatbath"] == n["tmlqcd.hmc.md"] == n["tmlqcd.hmc.accept"] == 1


def test_matvec_spans_count_iterations_and_residuals(traced_trajectory, traced_inversion):
    """One operator span an iteration, plus the solve's first residual; one
    sync span per stopping test (the last one ends the loop)."""
    res, spans = traced_inversion
    n = collections.Counter(name for _, _, name in spans)
    assert n["tmlqcd.cg"] == 1 and res.iterations > 0
    assert n["tmlqcd.cg.matvec"] == n["tmlqcd.cg.sync"] == res.iterations + 1
    names = [name for _, _, name in spans if name.startswith("tmlqcd.invert.") or name == "tmlqcd.cg"]
    order = [nm for i, nm in enumerate(names) if nm not in names[:i]]
    assert order == ["tmlqcd.invert.pack", "tmlqcd.invert.prologue", "tmlqcd.cg",
                     "tmlqcd.invert.epilogue", "tmlqcd.invert.unpack"]

    # the trajectory's statistics count the solves of MD and acceptance,
    # not the heatbath's
    _, st, spans = traced_trajectory
    n = collections.Counter(name for name, top in _tops(spans) if top != "tmlqcd.hmc.heatbath")
    iters = sum(st.acc_iterations) + sum(st.force_iterations)
    assert iters > 0 and n["tmlqcd.cg"] > 0
    assert n["tmlqcd.cg.matvec"] == n["tmlqcd.cg.sync"] == iters + n["tmlqcd.cg"]


def test_no_profiler_enters_no_record_range(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a record range was entered with no profiler running")

    monkeypatch.setattr(utils, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert utils.span("tmlqcd.a") is utils.span("tmlqcd.b")
    b = torch.ones(6, dtype=torch.float64)
    res = cg(lambda v: 2.0 * v, b, tol=1e-12)
    assert res.iterations == 1 and torch.allclose(res.x, 0.5 * b)
    with utils.timer("tmlqcd.block", level=9):
        pass
