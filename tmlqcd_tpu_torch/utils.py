"""Runtime utilities: leveled debug logging, wall timers, host copies.

Port of `tmlqcd_tpu/utils.py` (`set_debug_level`, `debug_printf`, `timer`,
`to_host`).  The reference's profiler-trace and compile-cache helpers are
machinery of its own platform and have no counterpart here.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

__all__ = ["set_debug_level", "debug_printf", "timer", "to_host"]

_DEBUG_LEVEL = int(os.environ.get("TMLQCD_TORCH_DEBUG", "1"))


def set_debug_level(level: int) -> None:
    """The DebugLevel input key."""
    global _DEBUG_LEVEL
    _DEBUG_LEVEL = int(level)


def debug_printf(level: int, fmt: str, *args) -> None:
    """Print when the configured level is >= `level`."""
    if _DEBUG_LEVEL >= level:
        print(fmt % args if args else fmt, flush=True)


@contextlib.contextmanager
def timer(label: str, level: int = 2):
    """Wall-clock a block and print at the given debug level.  CUDA work is
    asynchronous: the caller synchronises inside the block for device work to
    be attributed to it."""
    t0 = time.perf_counter()
    yield
    debug_printf(level, "# %s: %.3f s", label, time.perf_counter() - t0)


def to_host(x) -> np.ndarray:
    """Tensor (any device) or array -> numpy."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
