"""Chebyshev polynomial approximation of functions of a hermitian positive
operator, applied by the Clenshaw recursion.

Port of `tmlqcd_tpu/solvers/chebyshev.py` (reference:
chebyshev_polynomial_nd.c, Ptilde_nd.c).  The coefficients come from
Gauss-Chebyshev quadrature in numpy f64 (the same arithmetic, so the same
bits, as the reference); `chebyshev_apply` runs the recursion on tensors.
Its coefficients are real, so it runs unchanged on split (re/im-plane)
fields, and autograd through it gives the PHMC force.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

__all__ = ["chebyshev_coeffs", "chebyshev_apply", "chebyshev_eval"]


def chebyshev_coeffs(fun: Callable, degree: int, lo: float, hi: float) -> np.ndarray:
    """Chebyshev expansion coefficients c_k of fun on [lo, hi]:
    fun(x) ~ sum_k' c_k T_k(t), t = (2x - hi - lo)/(hi - lo), the k = 0 term
    with weight 1/2."""
    n = degree + 1
    j = np.arange(n)
    t = np.cos(np.pi * (j + 0.5) / n)  # Gauss-Chebyshev nodes
    x = 0.5 * (hi - lo) * t + 0.5 * (hi + lo)
    f = fun(x)
    c = np.empty(n)
    for k in range(n):
        c[k] = (2.0 / n) * np.sum(f * np.cos(np.pi * k * (j + 0.5) / n))
    return c


def chebyshev_eval(coeffs: np.ndarray, x, lo: float, hi: float):
    """Evaluation at scalars or arrays (numpy f64), for error measurement."""
    t = (2.0 * np.asarray(x, np.float64) - hi - lo) / (hi - lo)
    b1 = np.zeros_like(t)
    b2 = np.zeros_like(t)
    for c in coeffs[:0:-1]:
        b1, b2 = 2.0 * t * b1 - b2 + c, b1
    return t * b1 - b2 + 0.5 * coeffs[0]


def chebyshev_apply(matvec: Callable, coeffs: np.ndarray, x: torch.Tensor, lo: float,
                    hi: float) -> torch.Tensor:
    """fun(A) x by Clenshaw with the affine map t(A) = (2A - (hi+lo))/(hi-lo).
    Under autograd the recursion keeps every step's operator applications
    (degree + 1 of them) for the backward pass; the reference checkpoints
    each step instead, which the port's NDPOLY at 16^3x32 does not need
    (PERF.md section 6 gives its peak memory)."""
    a = 2.0 / (hi - lo)
    b = -(hi + lo) / (hi - lo)
    b1 = torch.zeros_like(x)
    b2 = torch.zeros_like(x)
    for c in coeffs[:0:-1]:
        b1, b2 = 2.0 * (a * matvec(b1) + b * b1) - b2 + float(c) * x, b1
    return a * matvec(b1) + b * b1 - b2 + float(0.5 * coeffs[0]) * x
