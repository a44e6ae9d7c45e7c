"""Mixed-precision CG, two variants.

Port of `tmlqcd_tpu/solvers/mixed_cg.py` (`mixed_cg`, `rg_mixed_cg`,
`MixedCGResult`):

* `mixed_cg` — an outer defect correction on the high operator around an
  inner CG on the low operator that restarts from zero (reference:
  solver/mixed_cg_her.c).
* `rg_mixed_cg` — reliable-update mixed CG: one CG iteration stream on the
  low operator whose accumulated correction is folded into the high iterate,
  with the true residual recomputed, whenever the iterated residual has
  fallen by `delta` (in |r|^2) since the last replacement; the search
  direction survives the replacement (reference: solver/rg_mixed_cg_her.c).

The two levels differ in their operators, not in their fields: both run on
split f32 fields with f64 reductions (`cg._norm_sq`, `cg._dot_re`), and the
caller passes the high and the low operator as callables, as in the
reference.  On the production path the low operator runs the hopping kernel
on the bf16 gauge copy (`wilson_fast.sloppy_gauge`); without `matvec_lo` the
high operator serves both levels.  The reference's `lax.cond` between
replacement and update is a Python `if` on the host value of the new
residual, which the stopping test reads anyway: one host sync per iteration,
two on an iteration that replaces the residual.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from tmlqcd_tpu_torch.solvers.cg import _dot_re, _norm_sq, _real, cg

__all__ = ["mixed_cg", "rg_mixed_cg", "MixedCGResult"]


class MixedCGResult(NamedTuple):
    x: torch.Tensor
    outer_iterations: int
    inner_iterations: int
    residual_sq: torch.Tensor


def mixed_cg(matvec_hi: Callable[[torch.Tensor], torch.Tensor], b: torch.Tensor,
             matvec_lo: Callable[[torch.Tensor], torch.Tensor] | None = None,
             x0: torch.Tensor | None = None, tol: float = 1e-9, inner_tol: float = 1e-2,
             max_outer: int = 50, max_inner: int = 500,
             rel_prec: bool = True) -> MixedCGResult:
    """Defect-correction mixed CG: repeat { solve A_lo d = r with an inner CG
    from zero to `inner_tol` relative; x += d; r = b - A_hi x } until
    |r|^2 <= tol^2 |b|^2 (rel_prec) or `max_outer` corrections.  The residual
    of one correction is the next one's right-hand side (the reference
    recomputes it; the two are the same numbers)."""
    if matvec_lo is None:
        matvec_lo = matvec_hi
    x = torch.zeros_like(b) if x0 is None else x0
    target = float(tol) ** 2 * (float(_norm_sq(b)) if rel_prec else 1.0)
    r = b - matvec_hi(x)
    rs = _norm_sq(r)
    k = inner = 0
    while float(rs) > target and k < max_outer:
        d = cg(matvec_lo, r, tol=inner_tol, maxiter=max_inner, rel_prec=True)
        x = x + d.x
        r = b - matvec_hi(x)
        rs = _norm_sq(r)
        k += 1
        inner += d.iterations
    return MixedCGResult(x=x, outer_iterations=k, inner_iterations=inner, residual_sq=rs)


def rg_mixed_cg(matvec_hi: Callable[[torch.Tensor], torch.Tensor], b: torch.Tensor,
                matvec_lo: Callable[[torch.Tensor], torch.Tensor] | None = None,
                x0: torch.Tensor | None = None, tol: float = 1e-9, delta: float = 0.01,
                maxiter: int = 2000, rel_prec: bool = True) -> MixedCGResult:
    """Reliable-update mixed CG: CG on the defect system A_lo d = r; when the
    iterated |r|^2 falls below `delta` times its value at the last
    replacement, x += d, r = b - A_hi x (the true residual), d = 0, and the
    search direction is kept.  `outer_iterations` counts the replacements,
    `inner_iterations` the low-operator iterations; `residual_sq` is the true
    residual of the returned x."""
    if matvec_lo is None:
        matvec_lo = matvec_hi
    x = torch.zeros_like(b) if x0 is None else x0
    fdtype = _real(b).dtype
    target = float(tol) ** 2 * (float(_norm_sq(b)) if rel_prec else 1.0)
    r = b - matvec_hi(x)
    rs_dev = _norm_sq(r)
    rs = rs_repl = float(rs_dev)
    d = torch.zeros_like(b)
    p = r
    k = n_repl = 0
    while rs > target and k < maxiter:
        ap = matvec_lo(p)
        alpha = (rs_dev / _dot_re(p, ap)).to(fdtype)
        d = d + alpha * p
        r = r - alpha * ap
        rs_new_dev = _norm_sq(r)
        beta = (rs_new_dev / rs_dev).to(fdtype)
        rs_new = float(rs_new_dev)
        if rs_new < delta * rs_repl:
            x = x + d
            r = b - matvec_hi(x)
            rs_new_dev = _norm_sq(r)
            rs_new = rs_repl = float(rs_new_dev)
            d = torch.zeros_like(d)
            n_repl += 1
        p = r + beta * p
        rs_dev, rs = rs_new_dev, rs_new
        k += 1
    x = x + d
    return MixedCGResult(x=x, outer_iterations=n_repl, inner_iterations=k,
                         residual_sq=_norm_sq(b - matvec_hi(x)))
