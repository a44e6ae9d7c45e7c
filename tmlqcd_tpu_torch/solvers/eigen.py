"""Extremal eigenvalue estimation for hermitian positive operators.

Port of `tmlqcd_tpu/solvers/eigen.py`: the bounds that fix the rational
approximation interval [s_min, s_max] to the spectrum of Q^2.

- `lambda_max`: power iteration on A.
- `lambda_min`: inverse power iteration, each step one CG solve — accurate
  near the low edge, where the rational approximation must hold tightest.

Both return f64 Rayleigh quotients as Python floats; callers should widen
the interval by a safety factor.  The start vectors are complex gaussian
fields of `shape` drawn from `key`, or `v0` where the caller supplies one
(complex, of `shape`); with `split=True` they are handed to `matvec` in the
split f32 layout [2, *shape], which is what the kernel operators take.  The
device of the draws is a required keyword.
"""

from __future__ import annotations

from typing import Callable

import torch

from tmlqcd_tpu_torch import rng
from tmlqcd_tpu_torch.solvers.cg import _dot_re, _norm_sq, _real, cg

__all__ = ["lambda_max", "lambda_min", "spectral_bounds"]


def _start(key: rng.Key, shape: tuple, device, split: bool, v0=None) -> torch.Tensor:
    v = rng.normal_spinor(key, shape, device) if v0 is None else v0
    return torch.stack([v.real, v.imag]) if split else v


def _normalised(v: torch.Tensor) -> torch.Tensor:
    return v / torch.sqrt(_norm_sq(v)).to(_real(v).dtype)


def _rayleigh(matvec: Callable, v: torch.Tensor) -> float:
    return float(_dot_re(v, matvec(v)) / _norm_sq(v))


def lambda_max(matvec: Callable, shape: tuple, key: rng.Key, *, device, iters: int = 50,
               split: bool = False, v0=None) -> float:
    """Largest eigenvalue of hermitian positive A by power iteration."""
    v = _start(key, shape, device, split, v0)
    for _ in range(iters):
        v = _normalised(matvec(v))
    return _rayleigh(matvec, v)


def lambda_min(matvec: Callable, shape: tuple, key: rng.Key, *, device, iters: int = 10,
               cg_tol: float = 1e-6, cg_maxiter: int = 2000, split: bool = False,
               v0=None) -> float:
    """Smallest eigenvalue by inverse power iteration (CG solves)."""
    v = _normalised(_start(key, shape, device, split, v0))
    for _ in range(iters):
        v = _normalised(cg(matvec, v, tol=cg_tol, maxiter=cg_maxiter).x)
    return _rayleigh(matvec, v)


def spectral_bounds(matvec: Callable, shape: tuple, key: rng.Key, *, device,
                    safety: float = 1.3, split: bool = False) -> tuple[float, float]:
    """(s_min, s_max) bracketing spec(A), padded by `safety` on both ends —
    feed to `solvers.rational.rational_invsqrt`."""
    lmax = lambda_max(matvec, shape, key.fold(0), device=device, split=split)
    lmin = lambda_min(matvec, shape, key.fold(1), device=device, split=split)
    return lmin / safety, lmax * safety
