"""BiCGstab for general (non-hermitian) operators on split fields.

Port of `tmlqcd_tpu/solvers/bicgstab.py` (`bicgstab`, `BiCGResult`;
reference: solver/bicgstab_complex.c).  Fields are split f32 [2, ...]; the
scalars rho, alpha and omega are complex128 tensors on the fields' device
(`krylov.cdot`, f64 accumulation), rounded to complex64 where they scale a
field.  One host sync per iteration, the stopping test.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from tmlqcd_tpu_torch.solvers.cg import _norm_sq
from tmlqcd_tpu_torch.solvers.krylov import _target, cdot, cscale

__all__ = ["bicgstab", "BiCGResult"]


class BiCGResult(NamedTuple):
    x: torch.Tensor
    iterations: int
    residual_sq: torch.Tensor


def bicgstab(matvec: Callable[[torch.Tensor], torch.Tensor], b: torch.Tensor,
             x0: torch.Tensor | None = None, tol: float = 1e-9, maxiter: int = 2000,
             rel_prec: bool = True) -> BiCGResult:
    """Solve M x = b with the shadow residual rhat = r0."""
    x = torch.zeros_like(b) if x0 is None else x0
    target = _target(b, tol, rel_prec)
    r = b - matvec(x)
    rhat = r
    p = v = torch.zeros_like(b)
    one = torch.ones((), dtype=torch.complex128, device=b.device)
    rho = alpha = omega = one
    rs = _norm_sq(r)
    k = 0
    while float(rs) > target and k < maxiter:
        rho_new = cdot(rhat, r)
        beta = (rho_new / rho) * (alpha / omega)
        p = r + cscale(beta, p - cscale(omega, v))
        v = matvec(p)
        alpha = rho_new / cdot(rhat, v)
        s = r - cscale(alpha, v)
        t = matvec(s)
        omega = cdot(t, s) / _norm_sq(t).to(torch.complex128)
        x = x + cscale(alpha, p) + cscale(omega, s)
        r = s - cscale(omega, t)
        rho = rho_new
        rs = _norm_sq(r)
        k += 1
    return BiCGResult(x=x, iterations=k, residual_sq=rs)
