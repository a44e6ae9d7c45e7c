"""Runtime utilities: leveled debug logging, wall timers, host copies, and
the program's spans on torch.profiler's timeline.

Port of `tmlqcd_tpu/utils.py` (`set_debug_level`, `debug_printf`, `timer`,
`to_host`).  The reference's profiler-trace and compile-cache helpers are
machinery of its own platform and have no counterpart here; `span` takes
their place.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch
from torch._C._autograd import _profiler_enabled
from torch._C._profiler import _RecordFunctionFast

__all__ = ["set_debug_level", "debug_printf", "span", "timer", "to_host"]

_DEBUG_LEVEL = int(os.environ.get("TMLQCD_TORCH_DEBUG", "1"))


def set_debug_level(level: int) -> None:
    """The DebugLevel input key."""
    global _DEBUG_LEVEL
    _DEBUG_LEVEL = int(level)


def debug_printf(level: int, fmt: str, *args) -> None:
    """Print when the configured level is >= `level`."""
    if _DEBUG_LEVEL >= level:
        print(fmt % args if args else fmt, flush=True)


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A named range of the program (`tmlqcd.<layer>...`) on torch.profiler's
    timeline, for `with span(name):`.

    With no profiler running it is one shared no-op context and costs a flag
    read.  Under a profiler it is a record range of function scope: the trace
    lists it among the host ops on the kernels' clock, and each kernel launched
    inside it is linked to it (or to a torch op inside it) by correlation id.
    Unlike `torch.profiler.record_function`, a user annotation, it leaves no
    copy of itself on the device's timeline, so a device trace's busy time
    holds kernels, copies and sets alone.  Whoever holds the profiler keeps the
    trace (`export_chrome_trace` shows the spans as host ops)."""
    if not _profiler_enabled():
        return _NO_SPAN
    return _RecordFunctionFast(name)


@contextlib.contextmanager
def timer(label: str, level: int = 2):
    """Wall-clock a block and print at the given debug level; under a profiler
    the block is also the span `label`.  CUDA work is asynchronous: the caller
    synchronises inside the block for device work to be attributed to it."""
    t0 = time.perf_counter()
    with span(label):
        yield
    debug_printf(level, "# %s: %.3f s", label, time.perf_counter() - t0)


def to_host(x) -> np.ndarray:
    """Tensor (any device) or array -> numpy."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
