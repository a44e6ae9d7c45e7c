"""Propagator inversion: solve M x = b on the full lattice through even/odd
Schur preconditioning and CG on the normal equations.

Port of `tmlqcd_tpu/inverter.py` (`InvertResult`, `make_deflation_setup`,
`invert_eo`, `invert_eo_increigcg`, `invert_clover_eo`, `invert_eo_rhs` with
and without clover, `invert_doublet_eo` with and without clover).  For the
twisted-mass Wilson operator M (2-kappa normalisation), M_eo = -kappa H_eo:

    1. bhat = b_o - M_oe M_ee^{-1} b_e
    2. solve Qhat_pm x_o = Qhat_- g5 bhat        (CG, mixed CG, eigCG)
       or Mhat x_o = bhat                        (deflated FGMRES / GCR)
    3. x_e  = M_ee^{-1} (b_e - M_eo x_o)

and the same for the twisted-clover operator with M_pp = 1 + T_pp + i mutld
gamma5 on both parities: M_ee^{-1} is then the per-site block inverse, fused
into the hop that precedes it as the kernel's clov_inv epilogue.

Solvers of `invert_eo` (the reference's branches):
  cg, fastcg    CG on Qhat_pm
  mixedcg       defect-correction mixed CG, the same operator at both levels
  fastmixed     mixed CG whose inner solves run on the bf16 gauge copy (K1-B)
  dflfgmres, dfl, dflgcr
                FGMRES / GCR(5) on the unsquared Mhat, preconditioned by the
                2-level deflation V-cycle (`make_deflation_setup`, built once
                per gauge and operator; its setup runs K1-R on 8 vectors)
and `invert_clover_eo`: cg, fastcg, mixedcg.  Any other solver name the
inverter accepts (bicgstab, cgs, gmres, fgmres, gcr, mr, rgmixedcg,
increigcg) has no branch there: as in the reference, the solve is CG, and the
inverter prints so.  `invert_eo_increigcg` is the sequence-of-sources solve
with incremental eigCG deflation.

Domain decomposition (`mesh=`, a `parallel.Mesh`): the CG-family solves of
`invert_eo` (cg, fastcg, mixedcg, fastmixed and the latter's bf16 low
operator), of `invert_clover_eo` (cg, fastcg, mixedcg) and the batched CG of
`invert_eo_rhs` (its R axis on the multi-RHS slab kernels) run on the
sharded operators, as the reference routes them under an active mesh
(reference inverter.py:131-145, :196-218, :319-323); the Schur prologue and
epilogue, the deflated solvers and increigcg stay on the whole-lattice
kernels.

Routing: every Dirac application runs on split f32 fields through
`ops/wilson_fast` — the hand-written kernel for CUDA tensors, its plain
version for CPU tensors — for `cg` as for `fastcg`, where the reference runs
its complex jnp operator for `cg`, `mixedcg`, the deflated solvers and
eigCG.  The batched solve runs its Schur prologue and epilogue on the
multi-RHS kernel too.  Sources and solutions are full-lattice spinors
[4, 3, T, X, Y*Z].

The non-degenerate doublet system M_nd x = b (`invert_doublet_eo`, sources
and solutions [2 flavour, 4, 3, T, X, Y*Z]) takes the same three steps with
the flavour-2x2 diagonal of `ops/ndoublet.py` (or its clover form) and the
hermitian Q_nd = gamma5 tau1 Mhat_nd: Mhat x = bhat <=> Q_nd^2 x = Q_nd
(gamma5 tau1 bhat).  Every hop of it is one multi-RHS kernel call with
flavour as the R axis.

Spans (`utils.span`, under a profiler) of `invert_eo`, `invert_clover_eo`
and `invert_eo_rhs`: `tmlqcd.invert` over the call; inside it
`tmlqcd.invert.pack` (even/odd split, split fields), `.prologue` (the fast
gauge or clover set-up, bhat, and the CG's right-hand side, which a single
twisted-mass source makes beside its solver), the solver's own spans
(`solvers/cg.py`), `.epilogue` (x_e) and `.unpack`.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from tmlqcd_tpu_torch import rng
from tmlqcd_tpu_torch.gamma import gamma5_split
from tmlqcd_tpu_torch.lattice import EVEN, ODD, Lattice, eo_pack, eo_unpack
from tmlqcd_tpu_torch.ops import split_diag as sd
from tmlqcd_tpu_torch.ops import wilson_fast as wf
from tmlqcd_tpu_torch.ops.wilson import DiracParams
from tmlqcd_tpu_torch.solvers.cg import cg, cg_rhs
from tmlqcd_tpu_torch.solvers.mixed_cg import mixed_cg
from tmlqcd_tpu_torch.utils import span

__all__ = ["InvertResult", "make_deflation_setup", "invert_eo", "invert_eo_increigcg",
           "invert_clover_eo", "invert_eo_rhs", "invert_doublet_eo", "SOLVERS",
           "check_solver"]

# every solver name the inverter takes; those without a branch of their own
# in `invert_eo` / `invert_clover_eo` run CG there, as in the reference
SOLVERS = ("cg", "fastcg", "mixedcg", "rgmixedcg", "fastmixed", "bicgstab", "cgs", "gmres",
           "fgmres", "gcr", "mr", "dfl", "dflfgmres", "dflgcr", "increigcg")
_DEFLATED = ("dflfgmres", "dflgcr", "dfl")


@dataclasses.dataclass
class InvertResult:
    x: torch.Tensor  # full-lattice solution [4,3,T,X,Mf] (or [R,4,3,T,X,Mf])
    iterations: int
    residual_sq: torch.Tensor  # normal-equation residual of the odd solve ([R] when batched)


def check_solver(solver: str) -> None:
    """Raise for a solver name the inverter does not carry."""
    if solver.lower() not in SOLVERS:
        raise ValueError(f"unknown solver {solver!r}; have {sorted(SOLVERS)}")


def _cg_stands_in(solver: str, where: str) -> None:
    """The reference's `else` branch: a carried solver without a branch of
    its own in `where` runs CG; say so."""
    print(f"[invert] {where}: solver {solver!r} has no branch here; CG runs, as in the "
          f"reference", flush=True)


class _Solved(NamedTuple):
    """The odd solve: split solution, iterations, residual."""

    x: torch.Tensor
    iterations: int
    residual_sq: torch.Tensor


def make_deflation_setup(u: torch.Tensor, params: DiracParams, lat: Lattice,
                         n_vectors: int = 8, blocks: tuple[int, int, int] = (2, 2, 2),
                         key: rng.Key | None = None, v0=None, **kw):
    """The 2-level deflation setup of Mhat(params), built once per gauge and
    operator and reused across sources (`invert_eo(solver='dflfgmres',
    deflation_setup=...)`).  The subspace vectors are drawn from `key`
    (default rng.Key(4242)) on the gauge's device, or injected (`v0`); every
    batched application of Mhat in the setup is one K1-R pair."""
    from tmlqcd_tpu_torch.solvers.deflation import setup_deflation

    fg = wf.make_fast_gauge(u, params, lat)
    mvb = lambda x2: wf.m_hat_fast(fg, x2, params, lat, +1.0, r_axis=3)  # noqa: E731
    with torch.no_grad():
        return setup_deflation(mvb, (4, 3) + lat.eo_site_shape,
                               rng.Key(4242) if key is None else key, device=u.device,
                               n_vectors=n_vectors, blocks=blocks, v0=v0, **kw)


def _odd_solve(fg, bhat, params, lat, tol, maxiter, solver, deflation_setup, u, mesh=None):
    """Step 2 of `invert_eo` for one source: the reference's branches."""
    if solver in _DEFLATED:
        # flexible Krylov on the unsquared Mhat, short cycles: the V-cycle
        # converges in a few iterations and a cycle cannot stop early
        from tmlqcd_tpu_torch.solvers.deflation import vcycle
        from tmlqcd_tpu_torch.solvers.krylov import fgmres, gcr

        mv = lambda x2: wf.m_hat_fast(fg, x2, params, lat, +1.0)  # noqa: E731
        setup = deflation_setup if deflation_setup is not None else make_deflation_setup(
            u, params, lat)
        kry = gcr if solver == "dflgcr" else fgmres
        restart = 5
        res = kry(mv, bhat, precond=lambda r: vcycle(setup, mv, r), tol=tol, restart=restart,
                  max_restarts=max(maxiter // restart, 1))
        return _Solved(res.x, res.iterations, res.residual_sq)
    rhs = wf.q_hat_fast(fg, gamma5_split(bhat), params, lat, -1.0)
    mv = wf.q_hat_pm_operator(fg, params, lat, mesh)
    if solver in ("mixedcg", "fastmixed"):
        mv_lo = None
        if solver == "fastmixed":
            mv_lo = wf.q_hat_pm_operator(wf.sloppy_gauge(fg), params, lat, mesh)
        res = mixed_cg(mv, rhs, matvec_lo=mv_lo, tol=tol, max_inner=maxiter)
        return _Solved(res.x, res.inner_iterations, res.residual_sq)
    if solver not in ("cg", "fastcg"):
        _cg_stands_in(solver, "invert_eo")
    res = cg(mv, rhs, tol=tol, maxiter=maxiter)
    return _Solved(res.x, res.iterations, res.residual_sq)


def _schur_solve(u, b_e2, b_o2, params, lat, tol, maxiter, r_axis, solver="cg",
                 deflation_setup=None, mesh=None):
    """Steps 1-3 on split even/odd sources; r_axis None (one source, any
    solver) or 3 (a batch, batched CG)."""
    kappa, mutld = float(params.kappa), float(params.mutld)
    with span("tmlqcd.invert.prologue"):
        fg = wf.make_fast_gauge(u, params, lat)
        # bhat = b_o + kappa H_oe Mee^{-1} b_e
        bhat = b_o2 + kappa * wf.hop_fast(fg, wf.mee_inv_split(b_e2, mutld, +1.0), ODD, lat,
                                          r_axis=r_axis)
        if r_axis is not None:
            rhs = wf.q_hat_fast(fg, gamma5_split(bhat), params, lat, -1.0, r_axis=r_axis)
    if r_axis is None:
        res = _odd_solve(fg, bhat, params, lat, tol, maxiter, solver, deflation_setup, u, mesh)
    else:
        res = cg_rhs(wf.q_hat_pm_operator(fg, params, lat, mesh, r_axis), rhs,
                     rhs_axis=r_axis, tol=tol, maxiter=maxiter)
    # x_e = Mee^{-1} (b_e + kappa H_eo x_o): the diagonal is linear, so it is
    # applied to b_e on its own and fused into the hop's epilogue for x_o
    with span("tmlqcd.invert.epilogue"):
        x_e = wf.mee_inv_split(b_e2, mutld, +1.0) + kappa * wf.hop_fast(
            fg, res.x, EVEN, lat, ("mee_inv", mutld, +1.0), r_axis=r_axis)
    return x_e, res


def _schur_solve_clover(u, b_e2, b_o2, params, lat, tol, maxiter, r_axis, solver="cg",
                        mesh=None):
    """Steps 1-3 with the clover diagonal.  M_ee^{-1} b_e has no hop in front
    of it, so it is the plain block matvec; the hop of the epilogue and the
    Qsw_- of the prologue carry their blocks in the clover epilogues.
    solver (one source): cg, fastcg, mixedcg (the same operator at both
    levels, as in the reference); any other runs CG."""
    kappa = float(params.kappa)
    with span("tmlqcd.invert.prologue"):
        fc = wf.make_fast_clover(u, params, lat)
        minv_be = wf.blocks_apply_flat(fc.mee_inv_p, b_e2, r_axis)
        # bhat = b_o + kappa H_oe Mee^{-1} b_e
        bhat = b_o2 + kappa * wf.hop_fast(fc.fg, minv_be, ODD, lat, r_axis=r_axis)
        rhs = wf.q_hat_clover_fast(fc, gamma5_split(bhat), params, lat, -1.0, r_axis=r_axis)
    mv = wf.q_hat_pm_clover_operator(fc, params, lat, mesh, r_axis)
    if r_axis is None and solver == "mixedcg":
        mres = mixed_cg(mv, rhs, tol=tol, max_inner=maxiter)
        res = _Solved(mres.x, mres.inner_iterations, mres.residual_sq)
    elif r_axis is None:
        if solver not in ("cg", "fastcg"):
            _cg_stands_in(solver, "invert_clover_eo")
        res = cg(mv, rhs, tol=tol, maxiter=maxiter)
    else:
        res = cg_rhs(mv, rhs, rhs_axis=r_axis, tol=tol, maxiter=maxiter)
    # x_e = Mee^{-1} (b_e + kappa H_eo x_o), the block inverse of the second
    # term fused into the hop
    with span("tmlqcd.invert.epilogue"):
        x_e = minv_be + kappa * wf.hop_fast(fc.fg, res.x, EVEN, lat, ("clov_inv",),
                                            r_axis=r_axis, blocks=fc.mee_inv_p)
    return x_e, res


def invert_eo(u: torch.Tensor, b: torch.Tensor, params: DiracParams, lat: Lattice,
              tol: float = 1e-10, maxiter: int = 5000, solver: str = "cg",
              deflation_setup=None, mesh=None) -> InvertResult:
    """Solve M(params) x = b (full lattice) for the twisted-mass Wilson
    operator; `params.c_sw` is not read (`invert_clover_eo` is the clover
    solve).  solver: see the module docstring; the deflated solvers take
    `deflation_setup` (built here when None).  For the mixed solvers
    `iterations` counts the inner iterations, for the deflated ones the
    restart cycles, as in the reference.  `mesh`: the CG-family solve on the
    sharded operator."""
    return _invert_one(_schur_solve, u, b, params, lat, tol, maxiter, solver,
                       deflation_setup=deflation_setup, mesh=mesh)


def invert_clover_eo(u: torch.Tensor, b: torch.Tensor, params: DiracParams, lat: Lattice,
                     tol: float = 1e-10, maxiter: int = 5000, solver: str = "cg",
                     mesh=None) -> InvertResult:
    """Twisted-clover inversion: the Schur pipeline of `invert_eo` with the
    clover M_ee / M_oo blocks, split f32 fields on K1 with the clover
    epilogues.  solver: 'cg' | 'fastcg' | 'mixedcg'; any other carried name
    runs CG.  `mesh`: the solve on the sharded operator."""
    return _invert_one(_schur_solve_clover, u, b, params, lat, tol, maxiter, solver, mesh=mesh)


def _invert_one(schur, u, b, params, lat, tol, maxiter, solver, **kw) -> InvertResult:
    check_solver(solver)
    with torch.no_grad(), span("tmlqcd.invert"):
        with span("tmlqcd.invert.pack"):
            b_e, b_o = eo_pack(b, lat)
            b_e2, b_o2 = wf.to_split(b_e), wf.to_split(b_o)
        x_e2, res = schur(u, b_e2, b_o2, params, lat, tol, maxiter, None, solver.lower(), **kw)
        with span("tmlqcd.invert.unpack"):
            x = eo_unpack(wf.from_split(x_e2), wf.from_split(res.x), lat)
    return InvertResult(x=x.to(b.dtype), iterations=res.iterations, residual_sq=res.residual_sq)


def invert_eo_increigcg(u: torch.Tensor, bs: list, params: DiracParams, lat: Lattice,
                        tol: float = 1e-10, maxiter: int = 5000, nev: int = 6, m: int = 30,
                        max_vectors: int = 48) -> list:
    """Sequence-of-sources inversion with incremental eigCG deflation: each
    odd solve of Qhat_pm harvests approximate low modes at no extra operator
    cost, and later sources start from the Galerkin projection on the
    accumulated basis.  Returns one InvertResult per source of `bs`."""
    from tmlqcd_tpu_torch.solvers.eigcg import DeflationBasis, eigcg

    kappa, mutld = float(params.kappa), float(params.mutld)
    basis = DeflationBasis.empty()
    outs = []
    with torch.no_grad():
        fg = wf.make_fast_gauge(u, params, lat)
        mv = lambda x2: wf.q_hat_pm_fast(fg, x2, params, lat)  # noqa: E731
        for b in bs:
            b_e, b_o = eo_pack(b, lat)
            b_e2, b_o2 = wf.to_split(b_e), wf.to_split(b_o)
            bhat = b_o2 + kappa * wf.hop_fast(fg, wf.mee_inv_split(b_e2, mutld, +1.0), ODD, lat)
            rhs = wf.q_hat_fast(fg, gamma5_split(bhat), params, lat, -1.0)
            res = eigcg(mv, rhs, nev=nev, m=m, tol=tol, maxiter=maxiter,
                        x0=basis.galerkin_x0(rhs))
            if len(basis.vectors) < max_vectors and res.ritz_vectors:
                basis.extend(mv, res.ritz_vectors[: 2 * nev], max_vectors)
            x_e2 = wf.mee_inv_split(b_e2, mutld, +1.0) + kappa * wf.hop_fast(
                fg, res.x, EVEN, lat, ("mee_inv", mutld, +1.0))
            x = eo_unpack(wf.from_split(x_e2), wf.from_split(res.x), lat)
            outs.append(InvertResult(x=x.to(b.dtype), iterations=res.iterations,
                                     residual_sq=torch.tensor(res.residual_sq,
                                                              dtype=torch.float64)))
    return outs


def invert_eo_rhs(u: torch.Tensor, bs: torch.Tensor, params: DiracParams, lat: Lattice,
                  tol: float = 1e-10, maxiter: int = 5000, mesh=None) -> InvertResult:
    """Batched propagator inversion: solve M x_r = b_r for all R sources at
    once — the Schur pipeline of `invert_eo` with the odd solve as ONE
    batched CG (`cg_rhs`) on the multi-RHS operator, which reads the gauge
    once for the whole batch.

    bs: [R, 4, 3, T, X, Mf] complex; `params.c_sw != 0` selects the clover
    pipeline.  Returns x [R, 4, 3, T, X, Mf]; `residual_sq` is per side [R],
    `iterations` the maximum over sides.  `mesh`: the batched CG on the
    multi-RHS slab kernels."""
    schur = _schur_solve_clover if params.c_sw != 0.0 else _schur_solve
    with torch.no_grad(), span("tmlqcd.invert"):
        with span("tmlqcd.invert.pack"):
            b_e, b_o = eo_pack(bs, lat)
            b_e2, b_o2 = wf.to_split_rhs(b_e), wf.to_split_rhs(b_o)
        x_e2, res = schur(u, b_e2, b_o2, params, lat, tol, maxiter, 3, mesh=mesh)
        with span("tmlqcd.invert.unpack"):
            x = eo_unpack(wf.from_split_rhs(x_e2), wf.from_split_rhs(res.x), lat)
    return InvertResult(x=x.to(bs.dtype), iterations=res.iterations, residual_sq=res.residual_sq)


def invert_doublet_eo(u: torch.Tensor, b: torch.Tensor, params, lat: Lattice,
                      tol: float = 1e-10, maxiter: int = 5000) -> InvertResult:
    """Solve the non-degenerate doublet system M_nd x = b for a flavour
    doublet source b [2, 4, 3, T, X, Y*Z] (the DBTMWILSON operator;
    `params.c_sw != 0` selects the clover doublet, DBCLOVER).  params:
    `ops.ndoublet.NDParams`.  Split f32 fields: on CUDA tensors the CG
    operator Q_nd^2 and the right-hand side's Q_nd are one K1-SD launch
    each, the prologue's and epilogue's single hops K1-R-D; CPU tensors take
    the plain versions."""
    kappa = float(params.kappa)
    with torch.no_grad():
        b_e, b_o = eo_pack(b, lat)  # the flavour axis rides along as a batch axis
        b_e2, b_o2 = wf.to_split(b_e), wf.to_split(b_o)
        if params.c_sw != 0.0:
            fc = wf.make_fast_clover_nd(u, params, lat)
            fg = fc.fg
            mee_inv = lambda c2: sd.mee_inv_nd_apply_split(  # noqa: E731
                fc.minv_a, fc.minv_b, fc.minv_e, fc.epsbar_t, c2)
            qnd = lambda c2: wf.q_nd_clover_fast(fc, c2, params, lat)  # noqa: E731
            qnd_sq = lambda c2: wf.q_nd_sq_clover_fast(fc, c2, params, lat)  # noqa: E731
        else:
            fg = wf.make_fast_gauge(u, params.wilson, lat)
            mee_inv = lambda c2: sd.mee_inv_nd_split(  # noqa: E731
                c2, params.mubar_t, params.epsbar_t, +1.0)
            qnd = lambda c2: wf.q_nd_fast(fg, c2, params, lat)  # noqa: E731
            qnd_sq = lambda c2: wf.q_nd_sq_fast(fg, c2, params, lat)  # noqa: E731

        bhat = b_o2 + kappa * wf._hop_nd(fg, mee_inv(b_e2), ODD, lat)
        rhs = qnd(sd.gamma5_nd(sd.tau1_split(bhat)))
        res = cg(qnd_sq, rhs, tol=tol, maxiter=maxiter)
        x_e2 = mee_inv(b_e2 + kappa * wf._hop_nd(fg, res.x, EVEN, lat))
        x = eo_unpack(wf.from_split(x_e2), wf.from_split(res.x), lat)
    return InvertResult(x=x.to(b.dtype), iterations=res.iterations, residual_sq=res.residual_sq)
