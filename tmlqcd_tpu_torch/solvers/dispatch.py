"""Solver dispatch: the one seam where solvers plug in.

Port of `tmlqcd_tpu/solvers/dispatch.py` (reference: monomial_solve.c
`solve_degenerate`).  Every route of the reference is carried: cg, mixedcg,
rgmixedcg, bicgstab, cgs, fgmres / gmres, gcr, mr, and dfl / dflfgmres /
dflgcr (FGMRES / GCR preconditioned by the deflation V-cycle; they need
`deflation_setup=`).  The mixed solvers take their low operator as
`matvec_lo=` (none: the high operator serves both levels).  Additional
backends register with `register_solver`.  `solve_mms` is the multishift
seam (reference: solve_mms_tm / solve_mms_nd) on `cg_multishift`.
"""

from __future__ import annotations

from typing import Callable

__all__ = ["solve_degenerate", "solve_mms", "register_solver", "SOLVERS"]


def _cg(matvec, b, tol, maxiter, **kw):
    from tmlqcd_tpu_torch.solvers.cg import cg

    r = cg(matvec, b, tol=tol, maxiter=maxiter, x0=kw.get("x0"))
    return r.x, r.iterations, r.residual_sq


def _mixedcg(matvec, b, tol, maxiter, **kw):
    from tmlqcd_tpu_torch.solvers.mixed_cg import mixed_cg

    r = mixed_cg(matvec, b, matvec_lo=kw.get("matvec_lo"), x0=kw.get("x0"), tol=tol,
                 inner_tol=kw.get("inner_tol", 1e-2), max_inner=maxiter)
    return r.x, r.inner_iterations, r.residual_sq


def _rgmixedcg(matvec, b, tol, maxiter, **kw):
    from tmlqcd_tpu_torch.solvers.mixed_cg import rg_mixed_cg

    r = rg_mixed_cg(matvec, b, matvec_lo=kw.get("matvec_lo"), x0=kw.get("x0"), tol=tol,
                    delta=kw.get("delta", 0.01), maxiter=maxiter)
    return r.x, r.inner_iterations, r.residual_sq


def _bicgstab(matvec, b, tol, maxiter, **kw):
    from tmlqcd_tpu_torch.solvers.bicgstab import bicgstab

    r = bicgstab(matvec, b, tol=tol, maxiter=maxiter)
    return r.x, r.iterations, r.residual_sq


def _cgs(matvec, b, tol, maxiter, **kw):
    from tmlqcd_tpu_torch.solvers.cgs import cgs

    r = cgs(matvec, b, tol=tol, maxiter=maxiter, x0=kw.get("x0"))
    return r.x, r.iterations, r.residual_sq


def _fgmres(matvec, b, tol, maxiter, **kw):
    from tmlqcd_tpu_torch.solvers.krylov import fgmres

    restart = kw.get("restart", 20)
    r = fgmres(matvec, b, tol=tol, restart=restart, max_restarts=max(maxiter // restart, 1),
               precond=kw.get("precond"))
    return r.x, r.iterations, r.residual_sq


def _gcr(matvec, b, tol, maxiter, **kw):
    from tmlqcd_tpu_torch.solvers.krylov import gcr

    restart = kw.get("restart", 20)
    r = gcr(matvec, b, tol=tol, restart=restart, max_restarts=max(maxiter // restart, 1),
            precond=kw.get("precond"))
    return r.x, r.iterations, r.residual_sq


def _mr(matvec, b, tol, maxiter, **kw):
    from tmlqcd_tpu_torch.solvers.krylov import mr

    r = mr(matvec, b, tol=tol, maxiter=maxiter)
    return r.x, r.iterations, r.residual_sq


def _deflated(outer: Callable, name: str) -> Callable:
    """`outer` (_fgmres or _gcr) preconditioned by the deflation V-cycle of
    kw['deflation_setup']."""

    def route(matvec, b, tol, maxiter, **kw):
        from tmlqcd_tpu_torch.solvers.deflation import vcycle

        setup = kw.get("deflation_setup")
        if setup is None:
            raise ValueError(f"solver {name!r} needs deflation_setup=...")
        return outer(matvec, b, tol, maxiter, precond=lambda r: vcycle(setup, matvec, r),
                     restart=kw.get("restart", 20))

    return route


SOLVERS: dict[str, Callable] = {
    "cg": _cg,
    "mixedcg": _mixedcg,
    "rgmixedcg": _rgmixedcg,
    "bicgstab": _bicgstab,
    "cgs": _cgs,
    "fgmres": _fgmres,
    "gmres": _fgmres,
    "gcr": _gcr,
    "mr": _mr,
    "dfl": _deflated(_fgmres, "dfl"),
    "dflfgmres": _deflated(_fgmres, "dflfgmres"),
    "dflgcr": _deflated(_gcr, "dflgcr"),
}


def register_solver(name: str, fn: Callable) -> None:
    """Plug in a solver backend under the input-file name `name`."""
    SOLVERS[name.lower()] = fn


def solve_degenerate(matvec, b, solver: str = "cg", tol: float = 1e-10,
                     maxiter: int = 5000, **kw):
    """(x, iterations, |r|^2) of A x = b."""
    try:
        fn = SOLVERS[solver.lower()]
    except KeyError:
        raise ValueError(f"unknown solver {solver!r}; have {sorted(SOLVERS)}") from None
    return fn(matvec, b, tol, maxiter, **kw)


def solve_mms(matvec, b, shifts, tol: float = 1e-10, maxiter: int = 5000):
    """(x [n_shifts, ...], iterations, base-system |r|^2) of the shifted
    systems (A + shift_k) x_k = b, by one multishift CG (reference:
    solve_mms_tm / solve_mms_nd)."""
    from tmlqcd_tpu_torch.solvers.multishift import cg_multishift

    r = cg_multishift(matvec, b, shifts, tol=tol, maxiter=maxiter)
    return r.x, r.iterations, r.residual_sq
