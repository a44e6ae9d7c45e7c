"""eigCG / incremental eigCG: CG that harvests approximate low eigenpairs
from its own iteration at no extra operator cost, and deflates later
right-hand sides with them.

Port of `tmlqcd_tpu/solvers/eigcg.py` (`eigcg`, `EigCGResult`,
`DeflationBasis`, `incr_eigcg_solve`; reference: solver/eigcg.c and the
incremental eigCG solver, Stathopoulos & Orginos, arXiv:0707.0131).

* CG's residuals are scaled Lanczos vectors of A, and the Lanczos
  tridiagonal comes from the CG scalars: T[k,k] = 1/alpha_k +
  beta_{k-1}/alpha_{k-1}, T[k,k+1] = -sqrt(beta_k)/alpha_k.
* A window of m normalised residuals is kept; when full it restarts thick
  with the nev lowest Ritz vectors of T_m and of T_{m-1}, orthonormalised
  and rediagonalised: 2 nev vectors remain, and the next Lanczos vector
  couples to them through the old off-diagonal times the last row of the
  basis change.  The CG recurrence itself is untouched.

Fields are split f32 [2, ...] (one field of the kernel operators); the small
tridiagonal bookkeeping and the projected matrix H = U^+ A U stay numpy f64
/ complex128 on the host, as in the reference.  One host read per CG
iteration (<p, A p> and the new |r|^2 together); the window rotation is one
tensordot of the stacked window.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from tmlqcd_tpu_torch.solvers.cg import _dot_re, _norm_sq
from tmlqcd_tpu_torch.solvers.krylov import cdot, cscale

__all__ = ["eigcg", "EigCGResult", "DeflationBasis", "incr_eigcg_solve"]


def _rotate(coeffs: np.ndarray, vectors: list) -> list:
    """[sum_i coeffs[i, j] vectors[i] for each column j] for real f64
    coefficients (rounded to the fields' f32) and split fields."""
    stack = torch.stack(vectors)  # [n, 2, ...]
    c = torch.as_tensor(np.ascontiguousarray(coeffs.T), device=stack.device).to(stack.dtype)
    return list(torch.tensordot(c, stack, 1).unbind(0))


def _combine(coeffs: np.ndarray, vectors: list) -> torch.Tensor:
    """sum_i coeffs[i] vectors[i] for complex128 coefficients (rounded to
    complex64) and split fields."""
    stack = torch.stack(vectors)  # [n, 2, ...]
    c = torch.as_tensor(coeffs, device=stack.device)
    cr, ci = c.real.to(stack.dtype), c.imag.to(stack.dtype)
    re = torch.tensordot(cr, stack[:, 0], 1) - torch.tensordot(ci, stack[:, 1], 1)
    im = torch.tensordot(cr, stack[:, 1], 1) + torch.tensordot(ci, stack[:, 0], 1)
    return torch.stack([re, im])


def _dots(vectors: list, b2: torch.Tensor) -> np.ndarray:
    """[<v_i, b>] complex128 on the host, one read."""
    return torch.stack([cdot(v, b2) for v in vectors]).cpu().numpy()


@dataclasses.dataclass
class EigCGResult:
    x: torch.Tensor
    iterations: int
    residual_sq: float
    ritz_vectors: list  # harvested approximate low eigenvectors of A (unit norm)
    ritz_values: np.ndarray


@dataclasses.dataclass
class DeflationBasis:
    """Accumulated orthonormal low-mode basis U (split fields) with the
    projected operator H = U^+ A U, built exactly with one operator call per
    accepted vector."""

    vectors: list
    h: np.ndarray  # [n, n] hermitian, complex128

    @classmethod
    def empty(cls) -> "DeflationBasis":
        return cls(vectors=[], h=np.zeros((0, 0), np.complex128))

    def galerkin_x0(self, b2: torch.Tensor) -> Optional[torch.Tensor]:
        """x0 = U H^{-1} U^+ b, the deflated start of the next right-hand side."""
        if not self.vectors:
            return None
        y = np.linalg.solve(self.h, _dots(self.vectors, b2))
        return _combine(y, self.vectors)

    def extend(self, matvec: Callable, candidates: list, max_vectors: int) -> None:
        """Orthonormalise the candidates against U (modified Gram-Schmidt,
        twice) and append them with their exact rows of H until
        `max_vectors`; a candidate left with norm below 1e-8 is dropped."""
        for v in candidates:
            if len(self.vectors) >= max_vectors:
                return
            w = v
            for _ in range(2):
                for u in self.vectors:
                    w = w - cscale(cdot(u, w), u)
            nn = float(torch.sqrt(_norm_sq(w)))
            if nn < 1e-8:
                continue  # linearly dependent on the basis
            w = w / nn
            aw = matvec(w)
            row = _dots(self.vectors + [w], aw)  # U^+ A w and <w, A w>
            n = len(self.vectors)
            h = np.zeros((n + 1, n + 1), np.complex128)
            h[:n, :n] = self.h
            h[:n, n] = row[:n]
            h[n, :n] = row[:n].conj()
            h[n, n] = row[n]
            self.h = h
            self.vectors.append(w)


def eigcg(matvec: Callable, b2: torch.Tensor, nev: int = 4, m: int = 24, tol: float = 1e-8,
          maxiter: int = 1000, x0: Optional[torch.Tensor] = None,
          rel_prec: bool = True) -> EigCGResult:
    """One eigCG solve of A x = b (A hermitian positive definite, b2 split):
    the plain CG trajectory plus windowed Ritz harvesting.  Returns the
    solution and up to 2 nev approximate low eigenpairs of A."""
    if m < 2 * nev + 2:
        raise ValueError(f"window m = {m} must exceed 2 nev + 1 = {2 * nev + 1}")
    fdtype = b2.dtype
    x = torch.zeros_like(b2) if x0 is None else x0
    r = b2 - matvec(x) if x0 is not None else b2
    p = r
    rsq = float(_norm_sq(r))
    target = tol * tol * (float(_norm_sq(b2)) if rel_prec else 1.0)

    window: list = []
    t = np.zeros((m, m), np.float64)
    k = 0  # current window size
    alpha_prev, beta_prev = 1.0, 0.0
    harvested: list = []
    theta_out = np.zeros(0)
    it = 0
    while it < maxiter and rsq > target:
        window.append(r / float(np.float32(np.sqrt(rsq))))
        k += 1
        ap = matvec(p)
        pap_dev = _dot_re(p, ap)
        alpha_dev = rsq / pap_dev
        x = x + alpha_dev.to(fdtype) * p
        r_new = r - alpha_dev.to(fdtype) * ap
        pap, rsq_new = torch.stack([pap_dev, _norm_sq(r_new)]).tolist()
        alpha = rsq / pap
        t[k - 1, k - 1] = 1.0 / alpha + beta_prev / alpha_prev
        beta = rsq_new / rsq
        if k < m:
            t[k - 1, k] = t[k, k - 1] = -np.sqrt(beta) / alpha
        if k == m:
            # thick restart: the nev lowest Ritz vectors of T_m and T_{m-1}
            tm = t[:m, :m]
            _, y1 = np.linalg.eigh(tm)
            _, y2 = np.linalg.eigh(tm[: m - 1, : m - 1])
            y2p = np.zeros((m, nev))
            y2p[: m - 1] = y2[:, :nev]
            q, _ = np.linalg.qr(np.concatenate([y1[:, :nev], y2p], axis=1))
            theta, z = np.linalg.eigh(q.T @ tm @ q)
            qz = q @ z  # [m, 2 nev]
            nkeep = qz.shape[1]
            window = _rotate(qz, window)
            # the next Lanczos vector couples to the restarted block through
            # the old subdiagonal -sqrt(beta)/alpha and the last row of qz
            tmv = -np.sqrt(beta) / alpha
            t.fill(0.0)
            t[:nkeep, :nkeep] = np.diag(theta)
            t[nkeep, :nkeep] = tmv * qz[m - 1]
            t[:nkeep, nkeep] = t[nkeep, :nkeep]
            k = nkeep
            theta_out = theta
            harvested = list(window)
        r, rsq = r_new, rsq_new
        p = r + float(np.float32(beta)) * p  # beta rounded to f32, as the fields
        alpha_prev, beta_prev = alpha, beta
        it += 1

    if not harvested and k > 1:
        # a short solve that never filled the window: harvest what exists
        w1, y1 = np.linalg.eigh(t[:k, :k])
        take = min(nev, k)
        theta_out = w1[:take]
        harvested = _rotate(y1[:, :take], window[:k])
    return EigCGResult(x=x, iterations=it, residual_sq=rsq, ritz_vectors=harvested,
                       ritz_values=np.asarray(theta_out))


def incr_eigcg_solve(matvec: Callable, bs: list, nev: int = 4, m: int = 24,
                     max_vectors: int = 32, tol: float = 1e-8, maxiter: int = 1000,
                     basis: Optional[DeflationBasis] = None):
    """Incremental eigCG over a sequence of right-hand sides: each solve
    starts from the Galerkin projection on the accumulated basis and adds
    its harvested Ritz vectors to it.  Returns (solutions, iteration counts,
    basis); pass `basis` back to keep accumulating across calls."""
    if basis is None:
        basis = DeflationBasis.empty()
    xs, iters = [], []
    for b2 in bs:
        res = eigcg(matvec, b2, nev=nev, m=m, tol=tol, maxiter=maxiter,
                    x0=basis.galerkin_x0(b2))
        xs.append(res.x)
        iters.append(res.iterations)
        if len(basis.vectors) < max_vectors and res.ritz_vectors:
            basis.extend(matvec, res.ritz_vectors[: 2 * nev], max_vectors)
    return xs, iters, basis
