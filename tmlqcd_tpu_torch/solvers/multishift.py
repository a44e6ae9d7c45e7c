"""Multi-shift conjugate gradient: solve (A + sigma_k) x_k = b for all shifts
from a single Krylov space.

Port of `tmlqcd_tpu/solvers/multishift.py` — required by the rational (RHMC)
monomials, where the partial-fraction poles of the rational approximation
are the shifts.  The shifted iterates and search directions carry an extra
leading "shift" axis and update as one batched expression each.

The reference's `lax.while_loop` is a Python loop here.  The zeta / alpha /
beta recurrences (Jegerlehner, hep-lat/9612014) run in f64 on the host,
`_norm_sq` and `_dot_re` accumulate in f64 on the device, the field updates
stay in the field's dtype.  One host sync per iteration: <p, A p> and the
new |r|^2 come back together; the base-system alpha that the residual update
needs in between is formed on the device from the same two numbers, so the
host and the device round it alike.  Stopping is on the base (sigma = 0)
residual, which bounds every shifted residual for sigma >= 0, so the
iteration count matches the reference on the same input.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from tmlqcd_tpu_torch.solvers.cg import _dot_re, _norm_sq, _real

__all__ = ["cg_multishift", "MultishiftResult"]


class MultishiftResult(NamedTuple):
    x: torch.Tensor  # [n_shifts, ...field]
    iterations: int
    residual_sq: float  # base-system |r|^2


def cg_multishift(matvec: Callable[[torch.Tensor], torch.Tensor], b: torch.Tensor, shifts,
                  tol: float = 1e-9, maxiter: int = 1000,
                  rel_prec: bool = True) -> MultishiftResult:
    """Shifted CG.  `shifts` (all >= 0) are passed explicitly; the base
    system sigma = 0 is implied and not returned.  `b` is a complex or a
    split (real) field."""
    shifts = np.asarray(shifts, np.float64)
    ns = shifts.shape[0]
    fdt = _real(b).dtype
    bshape = (ns,) + (1,) * b.ndim

    rs = float(_norm_sq(b))
    target = float(tol) ** 2 * (rs if rel_prec else 1.0)

    x = torch.zeros((ns,) + tuple(b.shape), dtype=b.dtype, device=b.device)
    p_s = b.unsqueeze(0).repeat(bshape)
    r = b
    p = b
    zeta = np.ones(ns)
    zeta_prev = np.ones(ns)
    alpha_prev, beta_prev = 1.0, 0.0
    rs_dev = torch.tensor(rs, dtype=torch.float64, device=b.device)
    k = 0
    while rs > target and k < maxiter:
        ap = matvec(p)
        pap_dev = _dot_re(p, ap)
        r = r - (rs_dev / pap_dev).to(fdt) * ap
        rs_new_dev = _norm_sq(r)
        pap, rs_new = torch.stack([pap_dev, rs_new_dev]).tolist()  # the one sync

        alpha = rs / pap  # base-system alpha (x += alpha p)
        # zeta_{n+1} = zeta_n zeta_{n-1} alpha_{n-1} /
        #     (alpha_n beta_{n-1} (zeta_{n-1} - zeta_n)
        #      + alpha_{n-1} zeta_{n-1} (1 + sigma alpha_n))
        denom = (alpha * beta_prev * (zeta_prev - zeta)
                 + alpha_prev * zeta_prev * (1.0 + shifts * alpha))
        safe = np.abs(denom) > 0
        zeta_next = np.where(safe, zeta * zeta_prev * alpha_prev / np.where(safe, denom, 1.0), 0.0)
        z_safe = np.where(zeta == 0, 1.0, zeta)
        alpha_s = alpha * zeta_next / z_safe
        beta = rs_new / rs
        beta_s = beta * (zeta_next / z_safe) ** 2

        coef = torch.tensor(np.stack([alpha_s, zeta_next, beta_s]), dtype=fdt,
                            device=b.device).reshape((3,) + bshape)
        x = x + coef[0] * p_s
        p = r + beta * p
        p_s = coef[1] * r.unsqueeze(0) + coef[2] * p_s

        zeta_prev, zeta = zeta, zeta_next
        alpha_prev, beta_prev = alpha, beta
        rs, rs_dev = rs_new, rs_new_dev
        k += 1
    return MultishiftResult(x=x, iterations=k, residual_sq=rs)
