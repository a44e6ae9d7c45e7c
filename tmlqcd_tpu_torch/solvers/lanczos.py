"""Hermitian Lanczos with full reorthogonalisation: Ritz pairs of a
matrix-free hermitian operator.

Port of `tmlqcd_tpu/solvers/lanczos.py` (reference: solver/eigenvalues.c,
solver/jdher.c).  The three-term recurrence and the reorthogonalisation run
on the fields' device with f64 dots and norms; the small tridiagonal
eigenproblem is solved on the host in numpy f64, as in the reference.  Two
Gram-Schmidt passes against the whole basis keep f32 Lanczos free of ghost
copies of converged Ritz values.  Setup-grade code: it runs once per gauge
configuration (the overlap's deflation subspace), a Python loop of
operator applications with two host reads (alpha, beta) per step.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

__all__ = ["lanczos_herm", "lowest_eigenpairs", "RitzPairs"]


class RitzPairs(NamedTuple):
    values: np.ndarray  # [k] Ritz values, ascending
    vectors: torch.Tensor  # [k, *field_shape] Ritz vectors (unit norm)
    residuals: np.ndarray  # [k] |A v - theta v| per pair


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """<a, b> (conjugate-linear in a) as a complex128 scalar on the device."""
    return torch.vdot(a.reshape(-1).to(torch.complex128), b.reshape(-1).to(torch.complex128))


def _norm(a: torch.Tensor) -> torch.Tensor:
    """|a| with f64 accumulation, a 0-dim f64 tensor on the device."""
    return torch.linalg.vector_norm(a.reshape(-1).to(torch.complex128))


def lanczos_herm(matvec: Callable, v0: torch.Tensor, steps: int,
                 reorth: bool = True) -> tuple[np.ndarray, np.ndarray, torch.Tensor]:
    """`steps` Lanczos iterations on hermitian A from the start vector v0
    (complex).  Returns (alphas [m], betas [m-1], basis V [m, *shape]) with
    m <= steps: the loop stops early on breakdown (an invariant subspace).
    Full reorthogonalisation when `reorth` (always use it below f64)."""
    rdt = v0.real.dtype
    v = v0 / _norm(v0).to(rdt)
    basis = [v]
    alphas: list[float] = []
    betas: list[float] = []
    prev = None
    beta_prev = 0.0
    for _ in range(steps):
        w = matvec(v)
        alpha = float(_dot(v, w).real)
        alphas.append(alpha)
        w = w - alpha * v
        if prev is not None:
            w = w - beta_prev * prev
        if reorth:
            # two passes of Gram-Schmidt against the basis ("twice is enough")
            for _pass in range(2):
                for b in basis:
                    w = w - _dot(b, w).to(w.dtype) * b
        beta = float(_norm(w))
        if beta < 1e-12 * (abs(alphas[0]) + 1.0):
            break  # invariant subspace found
        betas.append(beta)
        prev, beta_prev = v, beta
        v = (w / beta).to(v0.dtype)
        basis.append(v)
    m = len(alphas)
    return (np.asarray(alphas, np.float64), np.asarray(betas[:m - 1], np.float64),
            torch.stack(basis[:m]))


def ritz_rotation(alphas: np.ndarray, betas: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Eigenvalues and eigenvectors of the Lanczos tridiagonal (host f64)."""
    if betas.size:
        return np.linalg.eigh(np.diag(alphas) + np.diag(betas, 1) + np.diag(betas, -1))
    return alphas.copy(), np.eye(len(alphas))


def ritz_vectors(s: np.ndarray, basis: torch.Tensor) -> torch.Tensor:
    """y_i = sum_j s[j, i] v_j for the columns of s [m, k]: [k, *shape]."""
    coeff = torch.as_tensor(s.T, device=basis.device).to(basis.dtype)
    return torch.tensordot(coeff, basis, dims=1)


def lowest_eigenpairs(matvec: Callable, v0: torch.Tensor, n_ev: int, steps: int | None = None,
                      by_magnitude: bool = False) -> RitzPairs:
    """The n_ev lowest Ritz pairs of hermitian A (lowest |theta| when
    `by_magnitude`).  steps defaults to max(4 n_ev, 40)."""
    if steps is None:
        steps = max(4 * n_ev, 40)
    alphas, betas, basis = lanczos_herm(matvec, v0, steps)
    theta, s = ritz_rotation(alphas, betas)
    order = np.argsort(np.abs(theta)) if by_magnitude else np.argsort(theta)
    take = order[:n_ev]
    vecs = ritz_vectors(s[:, take], basis)
    vals, res, out = [], [], []
    for i in range(len(take)):
        vi = vecs[i]
        vi = vi / _norm(vi).to(vi.real.dtype)
        wi = matvec(vi)
        th = float(_dot(vi, wi).real)
        vals.append(th)
        res.append(float(_norm(wi - th * vi)))
        out.append(vi)
    return RitzPairs(np.asarray(vals), torch.stack(out), np.asarray(res))
