"""Conjugate gradient for hermitian positive-definite operators.

Port of `tmlqcd_tpu/solvers/cg.py` (`cg`, `cg_info`).  The reference's
`lax.while_loop` is a Python loop here; the stopping test reads the f64
residual on the host each iteration.  Dot products accumulate in f64 while
the fields stay f32 (or complex64); stopping is |r|^2 <= tol^2 |b|^2
(rel_prec) or |r|^2 <= tol^2, so the iteration count matches the reference.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

__all__ = ["cg", "cg_info", "CGResult"]


class CGResult(NamedTuple):
    x: torch.Tensor
    iterations: int
    residual_sq: torch.Tensor


def _real(v: torch.Tensor) -> torch.Tensor:
    return torch.view_as_real(v) if v.is_complex() else v


def _norm_sq(v: torch.Tensor) -> torch.Tensor:
    """|v|^2 with f64 accumulation (complex or split-real fields)."""
    return torch.sum(_real(v).double() ** 2)


def _dot_re(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Re<a, b> with f64 accumulation."""
    return torch.sum(_real(a).double() * _real(b).double())


def cg(matvec: Callable[[torch.Tensor], torch.Tensor], b: torch.Tensor,
       x0: torch.Tensor | None = None, tol: float = 1e-9, maxiter: int = 1000,
       rel_prec: bool = True) -> CGResult:
    """Solve A x = b for hermitian positive-definite A, at most `maxiter`
    iterations."""
    x = torch.zeros_like(b) if x0 is None else x0
    b_sq = _norm_sq(b)
    target = float(tol) ** 2 * (b_sq if rel_prec else 1.0)
    r = b - matvec(x)
    rs = _norm_sq(r)
    p = r
    k = 0
    fdtype = _real(b).dtype
    while k < maxiter and bool(rs > target):
        ap = matvec(p)
        alpha = (rs / _dot_re(p, ap)).to(fdtype)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = _norm_sq(r)
        beta = (rs_new / rs).to(fdtype)
        p = r + beta * p
        rs = rs_new
        k += 1
    return CGResult(x=x, iterations=k, residual_sq=rs)


def cg_info(matvec: Callable[[torch.Tensor], torch.Tensor], b: torch.Tensor,
            **kwargs) -> tuple[CGResult, torch.Tensor]:
    """cg + the true residual |b - A x|^2 recomputed from the solution."""
    res = cg(matvec, b, **kwargs)
    return res, _norm_sq(b - matvec(res.x))
