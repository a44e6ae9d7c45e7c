"""Propagator inversion: solve M x = b on the full lattice through even/odd
Schur preconditioning and CG on the normal equations.

Port of `tmlqcd_tpu/inverter.py` (`InvertResult`, `invert_eo` and
`invert_clover_eo` with `cg` and `fastcg`, `invert_eo_rhs` with and without
clover, `invert_doublet_eo` with and without clover).  For the twisted-mass Wilson operator M (2-kappa normalisation),
M_eo = -kappa H_eo:

    1. bhat = b_o - M_oe M_ee^{-1} b_e
    2. solve Qhat_pm x_o = Qhat_- g5 bhat        (CG)
    3. x_e  = M_ee^{-1} (b_e - M_eo x_o)

and the same for the twisted-clover operator with M_pp = 1 + T_pp + i mutld
gamma5 on both parities: M_ee^{-1} is then the per-site block inverse, fused
into the hop that precedes it as the kernel's clov_inv epilogue.

Routing: every Dirac application runs on split f32 fields through
`ops/wilson_fast` — the hand-written kernel for CUDA tensors, its plain
version for CPU tensors — for `cg` as for `fastcg`, where the reference runs
its complex jnp operator for `cg`.  The batched solve runs its Schur prologue
and epilogue on the multi-RHS kernel too.  Sources and solutions are
full-lattice spinors [4, 3, T, X, Y*Z].

The non-degenerate doublet system M_nd x = b (`invert_doublet_eo`, sources
and solutions [2 flavour, 4, 3, T, X, Y*Z]) takes the same three steps with
the flavour-2x2 diagonal of `ops/ndoublet.py` (or its clover form) and the
hermitian Q_nd = gamma5 tau1 Mhat_nd: Mhat x = bhat <=> Q_nd^2 x = Q_nd
(gamma5 tau1 bhat).  Every hop of it is one multi-RHS kernel call with
flavour as the R axis.
"""

from __future__ import annotations

import dataclasses

import torch

from tmlqcd_tpu_torch.gamma import gamma5_split
from tmlqcd_tpu_torch.lattice import EVEN, ODD, Lattice, eo_pack, eo_unpack
from tmlqcd_tpu_torch.ops import wilson_fast as wf
from tmlqcd_tpu_torch.ops.wilson import DiracParams
from tmlqcd_tpu_torch.solvers.cg import cg, cg_rhs

__all__ = ["InvertResult", "invert_eo", "invert_clover_eo", "invert_eo_rhs",
           "invert_doublet_eo", "SOLVERS", "check_solver"]

SOLVERS = ("cg", "fastcg")
_NOT_YET_PORTED = ("mixedcg", "fastmixed", "dflfgmres", "dflgcr", "dfl", "increigcg")


@dataclasses.dataclass
class InvertResult:
    x: torch.Tensor  # full-lattice solution [4,3,T,X,Mf] (or [R,4,3,T,X,Mf])
    iterations: int
    residual_sq: torch.Tensor  # normal-equation residual of the odd solve ([R] when batched)


def check_solver(solver: str) -> None:
    """Raise for a solver name the inverter does not carry."""
    name = solver.lower()
    if name in SOLVERS:
        return
    if name in _NOT_YET_PORTED:
        raise NotImplementedError(f"solver {solver!r} is not yet ported to tmlqcd_tpu_torch")
    raise ValueError(f"unknown solver {solver!r}; have {sorted(SOLVERS)}")


def _schur_solve(u, b_e2, b_o2, params, lat, tol, maxiter, r_axis):
    """Steps 1-3 on split even/odd sources; r_axis None (one source) or 3."""
    fg = wf.make_fast_gauge(u, params, lat)
    kappa, mutld = float(params.kappa), float(params.mutld)

    # bhat = b_o + kappa H_oe Mee^{-1} b_e
    bhat = b_o2 + kappa * wf.hop_fast(fg, wf.mee_inv_split(b_e2, mutld, +1.0), ODD, lat,
                                      r_axis=r_axis)
    rhs = wf.q_hat_fast(fg, gamma5_split(bhat), params, lat, -1.0, r_axis=r_axis)
    mv = lambda x2: wf.q_hat_pm_fast(fg, x2, params, lat, r_axis=r_axis)  # noqa: E731
    if r_axis is None:
        res = cg(mv, rhs, tol=tol, maxiter=maxiter)
    else:
        res = cg_rhs(mv, rhs, rhs_axis=r_axis, tol=tol, maxiter=maxiter)
    # x_e = Mee^{-1} (b_e + kappa H_eo x_o): the diagonal is linear, so it is
    # applied to b_e on its own and fused into the hop's epilogue for x_o
    x_e = wf.mee_inv_split(b_e2, mutld, +1.0) + kappa * wf.hop_fast(
        fg, res.x, EVEN, lat, ("mee_inv", mutld, +1.0), r_axis=r_axis)
    return x_e, res


def _schur_solve_clover(u, b_e2, b_o2, params, lat, tol, maxiter, r_axis):
    """Steps 1-3 with the clover diagonal.  M_ee^{-1} b_e has no hop in front
    of it, so it is the plain block matvec; the hop of the epilogue and the
    Qsw_- of the prologue carry their blocks in the clover epilogues."""
    fc = wf.make_fast_clover(u, params, lat)
    kappa = float(params.kappa)
    minv_be = wf.blocks_apply_flat(fc.mee_inv_p, b_e2, r_axis)

    # bhat = b_o + kappa H_oe Mee^{-1} b_e
    bhat = b_o2 + kappa * wf.hop_fast(fc.fg, minv_be, ODD, lat, r_axis=r_axis)
    rhs = wf.q_hat_clover_fast(fc, gamma5_split(bhat), params, lat, -1.0, r_axis=r_axis)
    mv = lambda x2: wf.q_hat_pm_clover_fast(fc, x2, params, lat, r_axis=r_axis)  # noqa: E731
    if r_axis is None:
        res = cg(mv, rhs, tol=tol, maxiter=maxiter)
    else:
        res = cg_rhs(mv, rhs, rhs_axis=r_axis, tol=tol, maxiter=maxiter)
    # x_e = Mee^{-1} (b_e + kappa H_eo x_o), the block inverse of the second
    # term fused into the hop
    x_e = minv_be + kappa * wf.hop_fast(fc.fg, res.x, EVEN, lat, ("clov_inv",), r_axis=r_axis,
                                        blocks=fc.mee_inv_p)
    return x_e, res


def invert_eo(u: torch.Tensor, b: torch.Tensor, params: DiracParams, lat: Lattice,
              tol: float = 1e-10, maxiter: int = 5000, solver: str = "cg") -> InvertResult:
    """Solve M(params) x = b (full lattice) for the twisted-mass Wilson
    operator; `params.c_sw` is not read (`invert_clover_eo` is the clover
    solve).  solver: 'cg' | 'fastcg' (the same route here)."""
    return _invert_one(_schur_solve, u, b, params, lat, tol, maxiter, solver)


def invert_clover_eo(u: torch.Tensor, b: torch.Tensor, params: DiracParams, lat: Lattice,
                     tol: float = 1e-10, maxiter: int = 5000, solver: str = "cg") -> InvertResult:
    """Twisted-clover inversion: the Schur pipeline of `invert_eo` with the
    clover M_ee / M_oo blocks.  solver: 'cg' | 'fastcg' (the same route
    here, split f32 fields on K1 with the clover epilogues)."""
    return _invert_one(_schur_solve_clover, u, b, params, lat, tol, maxiter, solver)


def _invert_one(schur, u, b, params, lat, tol, maxiter, solver) -> InvertResult:
    check_solver(solver)
    with torch.no_grad():
        b_e, b_o = eo_pack(b, lat)
        x_e2, res = schur(u, wf.to_split(b_e), wf.to_split(b_o), params, lat, tol, maxiter, None)
        x = eo_unpack(wf.from_split(x_e2), wf.from_split(res.x), lat)
    return InvertResult(x=x.to(b.dtype), iterations=res.iterations, residual_sq=res.residual_sq)


def invert_eo_rhs(u: torch.Tensor, bs: torch.Tensor, params: DiracParams, lat: Lattice,
                  tol: float = 1e-10, maxiter: int = 5000) -> InvertResult:
    """Batched propagator inversion: solve M x_r = b_r for all R sources at
    once — the Schur pipeline of `invert_eo` with the odd solve as ONE
    batched CG (`cg_rhs`) on the multi-RHS operator, which reads the gauge
    once for the whole batch.

    bs: [R, 4, 3, T, X, Mf] complex; `params.c_sw != 0` selects the clover
    pipeline.  Returns x [R, 4, 3, T, X, Mf]; `residual_sq` is per side [R],
    `iterations` the maximum over sides."""
    schur = _schur_solve_clover if params.c_sw != 0.0 else _schur_solve
    with torch.no_grad():
        b_e, b_o = eo_pack(bs, lat)
        x_e2, res = schur(u, wf.to_split_rhs(b_e), wf.to_split_rhs(b_o), params, lat,
                          tol, maxiter, 3)
        x = eo_unpack(wf.from_split_rhs(x_e2), wf.from_split_rhs(res.x), lat)
    return InvertResult(x=x.to(bs.dtype), iterations=res.iterations, residual_sq=res.residual_sq)


def invert_doublet_eo(u: torch.Tensor, b: torch.Tensor, params, lat: Lattice,
                      tol: float = 1e-10, maxiter: int = 5000) -> InvertResult:
    """Solve the non-degenerate doublet system M_nd x = b for a flavour
    doublet source b [2, 4, 3, T, X, Y*Z] (the DBTMWILSON operator;
    `params.c_sw != 0` selects the clover doublet, DBCLOVER).  params:
    `ops.ndoublet.NDParams`.  Split f32 fields on K1-R (doublet axis) for
    CUDA tensors, the plain version for CPU tensors."""
    kappa = float(params.kappa)
    with torch.no_grad():
        b_e, b_o = eo_pack(b, lat)  # the flavour axis rides along as a batch axis
        b_e2, b_o2 = wf.to_split(b_e), wf.to_split(b_o)
        if params.c_sw != 0.0:
            fc = wf.make_fast_clover_nd(u, params, lat)
            fg = fc.fg
            mee_inv = lambda c2: wf._mee_inv_nd_apply_split(  # noqa: E731
                fc.minv_a, fc.minv_b, fc.minv_e, fc.epsbar_t, c2)
            qnd = lambda c2: wf.q_nd_clover_fast(fc, c2, params, lat)  # noqa: E731
        else:
            fg = wf.make_fast_gauge(u, params.wilson, lat)
            mee_inv = lambda c2: wf._mee_inv_nd_split(  # noqa: E731
                c2, params.mubar_t, params.epsbar_t, +1.0)
            qnd = lambda c2: wf.q_nd_fast(fg, c2, params, lat)  # noqa: E731

        bhat = b_o2 + kappa * wf._hop_nd(fg, mee_inv(b_e2), ODD, lat)
        rhs = qnd(wf._gamma5_nd(wf._tau1_split(bhat)))
        res = cg(lambda c2: qnd(qnd(c2)), rhs, tol=tol, maxiter=maxiter)
        x_e2 = mee_inv(b_e2 + kappa * wf._hop_nd(fg, res.x, EVEN, lat))
        x = eo_unpack(wf.from_split(x_e2), wf.from_split(res.x), lat)
    return InvertResult(x=x.to(b.dtype), iterations=res.iterations, residual_sq=res.residual_sq)
