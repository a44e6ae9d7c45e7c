"""Non-hermitian Krylov solvers on split fields: FGMRES(m), GCR(m) and MR,
for solving M x = b directly and as the outer solver around the deflation
preconditioner.

Port of `tmlqcd_tpu/solvers/krylov.py` (`fgmres`, `gcr`, `mr`,
`KrylovResult`; reference: solver/fgmres.c, gcr.c, mr.c).  Fields are split
f32 [2, ...] (re/im leading); the complex inner products come from the two
planes with f64 accumulation (`cdot`), and the Arnoldi / Hessenberg and
orthogonalisation scalars are complex128 tensors on the fields' device,
rounded to complex64 where they scale a field (`cscale`), as the reference
casts them.  An inner step of FGMRES or GCR reads nothing back to the host;
a restart cycle reads the (m+1) x m Hessenberg matrix (FGMRES, for the
least-squares solve in numpy f64) and its final residual norm.  MR reads its
residual once per iteration for the stopping test.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from tmlqcd_tpu_torch.solvers.cg import _norm_sq

__all__ = ["fgmres", "gcr", "mr", "KrylovResult", "cdot", "cscale"]


class KrylovResult(NamedTuple):
    x: torch.Tensor
    iterations: int
    residual_sq: torch.Tensor


def cdot(a2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """<a, b> = sum conj(a) b of split fields [2, ...]: Re = sum(a_r b_r +
    a_i b_i), Im = sum(a_r b_i - a_i b_r), f64 accumulation; a complex128
    scalar tensor."""
    ar, ai, br, bi = a2[0].double(), a2[1].double(), b2[0].double(), b2[1].double()
    return torch.complex(torch.sum(ar * br + ai * bi), torch.sum(ar * bi - ai * br))


def cscale(c: torch.Tensor, v2: torch.Tensor) -> torch.Tensor:
    """c v for a complex scalar tensor c (its parts rounded to the field's
    precision) and a split field v."""
    cr, ci = c.real.to(v2.dtype), c.imag.to(v2.dtype)
    return torch.stack([cr * v2[0] - ci * v2[1], cr * v2[1] + ci * v2[0]])


def _target(b: torch.Tensor, tol: float, rel_prec: bool) -> float:
    return float(tol) ** 2 * (float(_norm_sq(b)) if rel_prec else 1.0)


def fgmres(matvec: Callable[[torch.Tensor], torch.Tensor], b: torch.Tensor,
           x0: torch.Tensor | None = None,
           precond: Callable[[torch.Tensor], torch.Tensor] | None = None, tol: float = 1e-9,
           restart: int = 20, max_restarts: int = 50, rel_prec: bool = True) -> KrylovResult:
    """Flexible GMRES with restarts (gmres is the precond=None case).  A cycle
    runs `restart` Arnoldi steps with modified Gram-Schmidt, solves
    min |beta e1 - H y| and keeps the new iterate only if it lowers the true
    residual; `iterations` counts cycles."""
    x = torch.zeros_like(b) if x0 is None else x0
    if precond is None:
        precond = lambda v: v  # noqa: E731
    m = restart
    target = _target(b, tol, rel_prec)
    r = b - matvec(x)
    rs = _norm_sq(r)
    it = 0
    while float(rs) > target and it < max_restarts:
        beta = torch.sqrt(rs)
        vs = [r / beta.to(b.dtype)]
        zs = []
        h = torch.zeros((m + 1, m), dtype=torch.complex128, device=b.device)
        for j in range(m):
            z = precond(vs[j])
            w = matvec(z)
            for i in range(j + 1):  # modified Gram-Schmidt
                hij = cdot(vs[i], w)
                w = w - cscale(hij, vs[i])
                h[i, j] = hij
            hn = torch.sqrt(_norm_sq(w))
            h[j + 1, j] = hn
            vs.append(w / torch.clamp(hn, min=1e-300).to(b.dtype))
            zs.append(z)
        # least squares min |beta e1 - H y| on the host (one read of H)
        hb = torch.cat([h.reshape(-1), beta.to(torch.complex128).reshape(1)]).cpu().numpy()
        e1 = np.zeros(m + 1, np.complex128)
        e1[0] = hb[-1]
        y = np.linalg.lstsq(hb[:-1].reshape(m + 1, m), e1, rcond=None)[0]
        yt = torch.as_tensor(y, device=b.device)
        zst = torch.stack(zs)  # [m, 2, ...]
        yr, yi = yt.real.to(b.dtype), yt.imag.to(b.dtype)
        dx = torch.stack([torch.tensordot(yr, zst[:, 0], 1) - torch.tensordot(yi, zst[:, 1], 1),
                          torch.tensordot(yr, zst[:, 1], 1) + torch.tensordot(yi, zst[:, 0], 1)])
        x_new = x + dx
        r_new = b - matvec(x_new)
        rs_new = _norm_sq(r_new)
        it += 1
        if not float(rs_new) < float(rs):
            break  # no progress: keep x, as the reference does
        x, r, rs = x_new, r_new, rs_new
    return KrylovResult(x=x, iterations=it, residual_sq=rs)


def gcr(matvec: Callable[[torch.Tensor], torch.Tensor], b: torch.Tensor,
        x0: torch.Tensor | None = None,
        precond: Callable[[torch.Tensor], torch.Tensor] | None = None, tol: float = 1e-9,
        restart: int = 20, max_restarts: int = 50, rel_prec: bool = True) -> KrylovResult:
    """Restarted flexible GCR (the outer solver of DFLGCR).  A cycle runs
    `restart` steps on the recursive residual, each direction orthogonalised
    against the cycle's earlier A p_i; the next cycle starts from the true
    residual; `iterations` counts cycles."""
    x = torch.zeros_like(b) if x0 is None else x0
    if precond is None:
        precond = lambda v: v  # noqa: E731
    m = restart
    target = _target(b, tol, rel_prec)
    r = b - matvec(x)
    rs = _norm_sq(r)
    it = 0
    while float(rs) > target and it < max_restarts:
        if it > 0:
            r = b - matvec(x)
        xc, rc, ps, aps = x, r, [], []
        for j in range(m):
            p = precond(rc)
            ap = matvec(p)
            for i in range(j):
                bij = cdot(aps[i], ap)
                p = p - cscale(bij, ps[i])
                ap = ap - cscale(bij, aps[i])
            inv = (1.0 / torch.clamp(torch.sqrt(_norm_sq(ap)), min=1e-300)).to(b.dtype)
            p, ap = p * inv, ap * inv
            alpha = cdot(ap, rc)
            xc = xc + cscale(alpha, p)
            rc = rc - cscale(alpha, ap)
            ps.append(p)
            aps.append(ap)
        rs_new = _norm_sq(rc)
        it += 1
        if not float(rs_new) < float(rs):
            break
        x, rs = xc, rs_new
    return KrylovResult(x=x, iterations=it, residual_sq=rs)


def mr(matvec: Callable[[torch.Tensor], torch.Tensor], b: torch.Tensor,
       x0: torch.Tensor | None = None, tol: float = 1e-9, maxiter: int = 1000,
       omega: float = 1.0, rel_prec: bool = True) -> KrylovResult:
    """Minimal residual iteration: alpha = omega <A r, r> / |A r|^2."""
    x = torch.zeros_like(b) if x0 is None else x0
    target = _target(b, tol, rel_prec)
    r = b - matvec(x)
    rs = _norm_sq(r)
    k = 0
    while float(rs) > target and k < maxiter:
        ar = matvec(r)
        alpha = omega * cdot(ar, r) / torch.clamp(_norm_sq(ar), min=1e-300)
        x = x + cscale(alpha, r)
        r = r - cscale(alpha, ar)
        rs = _norm_sq(r)
        k += 1
    return KrylovResult(x=x, iterations=k, residual_sq=rs)
