"""Conjugate gradient for hermitian positive-definite operators.

Port of `tmlqcd_tpu/solvers/cg.py` (`cg`, `cg_rhs`, `cg_info`).  The reference's
`lax.while_loop` is a Python loop here; the stopping test reads the f64
residual on the host each iteration.  Dot products accumulate in f64 while
the fields stay f32 (or complex64); stopping is |r|^2 <= tol^2 |b|^2
(rel_prec) or |r|^2 <= tol^2, so the iteration count matches the reference.
On the ranks of a distributed run every dot and norm is a global sum
(`comm.global_sum`), so every rank takes the same branch of every stopping
test; the multishift and mixed solvers reduce through the same functions.

Spans (`utils.span`, under a profiler): `tmlqcd.cg` over each solve of `cg`
and `cg_rhs`, `tmlqcd.cg.matvec` over each operator application and
`tmlqcd.cg.sync` over each stopping test's host read; what `tmlqcd.cg` holds
outside the two is the solver's own vector work.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from tmlqcd_tpu_torch.comm import global_sum
from tmlqcd_tpu_torch.utils import span

__all__ = ["cg", "cg_rhs", "cg_info", "CGResult"]


class CGResult(NamedTuple):
    x: torch.Tensor
    iterations: int
    residual_sq: torch.Tensor


def _real(v: torch.Tensor) -> torch.Tensor:
    return torch.view_as_real(v) if v.is_complex() else v


def _norm_sq(v: torch.Tensor) -> torch.Tensor:
    """|v|^2 with f64 accumulation (complex or split-real fields)."""
    return global_sum(torch.sum(_real(v).double() ** 2))


def _dot_re(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Re<a, b> with f64 accumulation."""
    return global_sum(torch.sum(_real(a).double() * _real(b).double()))


def _spanned(matvec: Callable[[torch.Tensor], torch.Tensor]):
    """matvec, each application the span `tmlqcd.cg.matvec`."""
    def mv(v: torch.Tensor) -> torch.Tensor:
        with span("tmlqcd.cg.matvec"):
            return matvec(v)
    return mv


def _holds(test: torch.Tensor) -> bool:
    """The host's read of a stopping test, the span `tmlqcd.cg.sync`."""
    with span("tmlqcd.cg.sync"):
        return bool(test)


def cg(matvec: Callable[[torch.Tensor], torch.Tensor], b: torch.Tensor,
       x0: torch.Tensor | None = None, tol: float = 1e-9, maxiter: int = 1000,
       rel_prec: bool = True) -> CGResult:
    """Solve A x = b for hermitian positive-definite A, at most `maxiter`
    iterations."""
    with span("tmlqcd.cg"):
        matvec = _spanned(matvec)
        x = torch.zeros_like(b) if x0 is None else x0
        b_sq = _norm_sq(b)
        target = float(tol) ** 2 * (b_sq if rel_prec else 1.0)
        r = b - matvec(x)
        rs = _norm_sq(r)
        p = r
        k = 0
        fdtype = _real(b).dtype
        while k < maxiter and _holds(rs > target):
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


def cg_rhs(matvec: Callable[[torch.Tensor], torch.Tensor], b: torch.Tensor, rhs_axis: int,
           x0: torch.Tensor | None = None, tol: float = 1e-9, maxiter: int = 1000,
           rel_prec: bool = True) -> CGResult:
    """Simultaneous CG over the right-hand sides stacked along `rhs_axis` of
    b: independent Krylov recurrences on one shared, batched matvec.

    Each side has its own alpha, beta and stopping test.  A converged side
    freezes (alpha = beta = 0 under the `live` mask: its x and r stay
    bit-for-bit as they were) while the others iterate.  Reductions run in
    f64 over every axis but `rhs_axis`.  `residual_sq` has shape [R];
    `iterations` is the maximum over the sides.  One host sync per
    iteration, the `any(rs > target)` stopping test."""
    axes = tuple(i for i in range(b.ndim) if i != rhs_axis)
    bshape = tuple(b.shape[rhs_axis] if i == rhs_axis else 1 for i in range(b.ndim))
    if b.is_complex():
        raise TypeError("cg_rhs takes split (real) fields")
    fdtype = b.dtype

    def nsq(v):
        return global_sum(torch.sum(v.double() ** 2, dim=axes))

    def dot_re(a, c):
        return global_sum(torch.sum(a.double() * c.double(), dim=axes))

    with span("tmlqcd.cg"):
        matvec = _spanned(matvec)
        x = torch.zeros_like(b) if x0 is None else x0
        b_sq = nsq(b)
        target = float(tol) ** 2 * (b_sq if rel_prec else torch.ones_like(b_sq))
        r = b - matvec(x)
        rs = nsq(r)
        p = r
        zero = torch.zeros_like(rs)
        tiny = torch.full_like(rs, 1e-300)
        k = 0
        live = rs > target
        while k < maxiter and _holds(live.any()):
            ap = matvec(p)
            alpha = torch.where(live, rs / torch.maximum(dot_re(p, ap), tiny), zero)
            a32 = alpha.to(fdtype).reshape(bshape)
            x = x + a32 * p
            r = r - a32 * ap
            rs_new = nsq(r)
            beta = torch.where(live, rs_new / torch.maximum(rs, tiny), zero)
            p = r + beta.to(fdtype).reshape(bshape) * p
            rs = torch.where(live, rs_new, rs)
            live = rs > target
            k += 1
        return CGResult(x=x, iterations=k, residual_sq=rs)


def cg_info(matvec: Callable[[torch.Tensor], torch.Tensor], b: torch.Tensor,
            **kwargs) -> tuple[CGResult, torch.Tensor]:
    """cg + the true residual |b - A x|^2 recomputed from the solution."""
    res = cg(matvec, b, **kwargs)
    return res, _norm_sq(b - _spanned(matvec)(res.x))
