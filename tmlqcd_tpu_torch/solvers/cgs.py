"""Conjugate Gradient Squared for general (non-hermitian) operators on split
fields.

Port of `tmlqcd_tpu/solvers/cgs.py` (`cgs`, `CGSResult`; reference:
solver/cgs_real.c).  Fields are split f32 [2, ...]; rho and alpha are
complex128 tensors on the fields' device (`krylov.cdot`), rounded to
complex64 where they scale a field.  One host sync per iteration, the
stopping test.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from tmlqcd_tpu_torch.solvers.cg import _norm_sq
from tmlqcd_tpu_torch.solvers.krylov import _target, cdot, cscale

__all__ = ["cgs", "CGSResult"]


class CGSResult(NamedTuple):
    x: torch.Tensor
    iterations: int
    residual_sq: torch.Tensor


def cgs(matvec: Callable[[torch.Tensor], torch.Tensor], b: torch.Tensor,
        x0: torch.Tensor | None = None, tol: float = 1e-9, maxiter: int = 2000,
        rel_prec: bool = True) -> CGSResult:
    """Sonneveld CGS: two matvecs per iteration, one shadow vector."""
    x = torch.zeros_like(b) if x0 is None else x0
    target = _target(b, tol, rel_prec)
    r = b - matvec(x)
    rhat = u = p = r
    rho = cdot(rhat, r)
    rs = _norm_sq(r)
    k = 0
    while float(rs) > target and k < maxiter:
        v = matvec(p)
        alpha = rho / cdot(rhat, v)
        q = u - cscale(alpha, v)
        uq = u + q
        x = x + cscale(alpha, uq)
        r = r - cscale(alpha, matvec(uq))
        rho_new = cdot(rhat, r)
        beta = rho_new / rho
        u = r + cscale(beta, q)
        p = u + cscale(beta, q + cscale(beta, p))
        rho = rho_new
        rs = _norm_sq(r)
        k += 1
    return CGSResult(x=x, iterations=k, residual_sq=rs)
