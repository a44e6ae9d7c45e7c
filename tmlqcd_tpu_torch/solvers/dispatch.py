"""Solver dispatch: the one seam where solvers plug in.

Port of `tmlqcd_tpu/solvers/dispatch.py` (reference: monomial_solve.c
`solve_degenerate`).  Only the `cg` route is ported; the other names the
reference knows raise `NotImplementedError` until their slice lands.
Additional backends register with `register_solver`.
"""

from __future__ import annotations

from typing import Callable

__all__ = ["solve_degenerate", "register_solver", "SOLVERS"]

_NOT_YET_PORTED = ("mixedcg", "rgmixedcg", "bicgstab", "cgs", "fgmres", "gmres", "gcr",
                   "mr", "dfl", "dflfgmres", "dflgcr")


def _cg(matvec, b, tol, maxiter, **kw):
    from tmlqcd_tpu_torch.solvers.cg import cg

    r = cg(matvec, b, tol=tol, maxiter=maxiter, x0=kw.get("x0"))
    return r.x, r.iterations, r.residual_sq


SOLVERS: dict[str, Callable] = {"cg": _cg}


def register_solver(name: str, fn: Callable) -> None:
    """Plug in a solver backend under the input-file name `name`."""
    SOLVERS[name.lower()] = fn


def solve_degenerate(matvec, b, solver: str = "cg", tol: float = 1e-10,
                     maxiter: int = 5000, **kw):
    """(x, iterations, |r|^2) of A x = b."""
    name = solver.lower()
    if name in SOLVERS:
        return SOLVERS[name](matvec, b, tol, maxiter, **kw)
    if name in _NOT_YET_PORTED:
        raise NotImplementedError(f"solver {solver!r} is not yet ported to tmlqcd_tpu_torch")
    raise ValueError(f"unknown solver {solver!r}; have {sorted(SOLVERS)}")
