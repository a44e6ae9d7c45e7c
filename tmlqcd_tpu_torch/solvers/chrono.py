"""Chronological solver guess: the initial guess from the solutions of the
previous MD steps.

Port of `tmlqcd_tpu/solvers/chrono.py` (reference: chrono_guess.c).  The
history is a fixed-size stack [n, ...field]; the guess minimises
|A x0 - b| over real combinations of the history (normal equations
G c = r with G_ij = Re<A v_i, A v_j>, r_i = Re<A v_i, b>, solved in f64 with
a relative ridge).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from tmlqcd_tpu_torch.comm import global_sum

__all__ = ["ChronoHistory", "chrono_init", "chrono_guess", "chrono_push"]


class ChronoHistory(NamedTuple):
    fields: torch.Tensor  # [n, ...field] past solutions, most recent first
    count: int  # number of valid entries


def chrono_init(n: int, shape: tuple, dtype, device) -> ChronoHistory:
    """Empty history of capacity n."""
    return ChronoHistory(torch.zeros((n,) + tuple(shape), dtype=dtype, device=device), 0)


def _rdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Re<a, b>, f64-accumulated, for complex and split-real fields."""
    if a.is_complex():
        a, b = torch.view_as_real(a), torch.view_as_real(b)
    return global_sum(torch.sum(a.double() * b.double()))


def _solve_spd_small(g: torch.Tensor, r: torch.Tensor, n: int) -> torch.Tensor:
    """Unrolled Cholesky solve of the tiny SPD normal equations."""
    lo = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = g[i, j]
            for k in range(j):
                s = s - lo[i][k] * lo[j][k]
            lo[i][j] = torch.sqrt(torch.clamp(s, min=1e-300)) if i == j else s / lo[j][j]
    y = [None] * n
    for i in range(n):
        s = r[i]
        for k in range(i):
            s = s - lo[i][k] * y[k]
        y[i] = s / lo[i][i]
    c = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - lo[k][i] * c[k]
        c[i] = s / lo[i][i]
    return torch.stack(c)


def chrono_guess(hist: ChronoHistory, matvec: Callable, b: torch.Tensor) -> torch.Tensor:
    """x0 = sum_i c_i v_i with real c = argmin |A x0 - b|^2."""
    n = hist.fields.shape[0]
    if n == 0:
        return torch.zeros_like(b)
    av = [matvec(hist.fields[i]) for i in range(n)]
    g = torch.zeros((n, n), dtype=torch.float64, device=b.device)
    r = torch.zeros((n,), dtype=torch.float64, device=b.device)
    for i in range(n):
        r[i] = _rdot(av[i], b)
        for j in range(i, n):
            gij = _rdot(av[i], av[j])
            g[i, j] = gij
            g[j, i] = gij
    valid = torch.arange(n, device=b.device) < hist.count
    gm = torch.where(valid[:, None] & valid[None, :], g, 0.0)
    ridge = 1e-10 * torch.trace(gm) / n + 1e-30
    gm = gm + torch.where(valid, ridge, 1.0) * torch.eye(n, dtype=g.dtype, device=g.device)
    c = _solve_spd_small(gm, torch.where(valid, r, 0.0), n)
    c = torch.where(valid, c, 0.0).to(b.dtype)
    return sum(c[i] * hist.fields[i] for i in range(n))


def chrono_push(hist: ChronoHistory, x: torch.Tensor) -> ChronoHistory:
    """Insert the newest solution at slot 0."""
    fields = torch.roll(hist.fields, 1, 0)
    fields[0] = x
    n = hist.fields.shape[0]
    return ChronoHistory(fields, min(hist.count + 1, n))
