"""Inexact deflation / 2-level multigrid preconditioner (Luscher-style).

Port of `tmlqcd_tpu/solvers/deflation.py` (`DeflationSetup`,
`setup_deflation`, `vcycle`, `deflated_fgmres`; reference: block.c,
generate_dfl_subspace.c, little_D.c, solver/dfl_projector.c):

  * Setup: Ns near-kernel vectors from smoothed inverse iteration (10 MR
    steps on the batch of all Ns vectors, renormalised, `inv_iters` times),
    chopped over a (bt, bx, bm) block grid of the site axes and
    orthonormalised block by block -> subspace dimension n = Ns * n_blocks.
    The little operator A[(i,b),(j,b')] = <chi_b v_i, M chi_b' v_j> is formed
    densely, one batched operator call of n_blocks vectors per j, and
    inverted once per gauge in complex64 (`torch.linalg.inv`).
  * Apply (`vcycle`): coarse correction c = V A^{-1} V^+ r with one step of
    iterative refinement, then `smooth_iters` MR steps on r - M c.
  * `deflated_fgmres`: FGMRES with the V-cycle as its flexible
    preconditioner (DFLFGMRES; DFLGCR is the same with GCR).

Layouts: the subspace vectors are complex64 [Ns, 4, 3, T, X, M] and the block
algebra (restriction, prolongation, the block Gram-Schmidt) is reshapes and
einsums on them.  The operators take split f32 fields: `matvec_batch` a
batch [2, 4, 3, R, T, X, M] (the multi-RHS kernel K1-R on the device), the
V-cycle's `matvec` one field [2, 4, 3, T, X, M], which is what the outer
Krylov solver iterates on.  The V-cycle reads nothing back to the host: its
MR smoother masks its updates once the residual is below tolerance instead
of stopping.

The starting vectors are drawn from an `rng.Key` on an explicit device, or
injected (`v0`), which is how the tests hand the setup the reference's draws.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from tmlqcd_tpu_torch import rng
from tmlqcd_tpu_torch.ops.dslash_cuda import merge_c, split_c
from tmlqcd_tpu_torch.solvers.cg import _norm_sq
from tmlqcd_tpu_torch.solvers.krylov import cdot, cscale, fgmres

__all__ = ["DeflationSetup", "setup_deflation", "vcycle", "deflated_fgmres"]


@dataclasses.dataclass
class DeflationSetup:
    v: torch.Tensor  # [Ns, 4, 3, T, X, M] complex64, block-orthonormal
    blocks: tuple[int, int, int]  # (nbt, nbx, nbm) block counts
    a_inv: torch.Tensor  # dense inverse of the little operator [n, n], complex64
    a: torch.Tensor  # the little operator [n, n], complex64 (refinement)
    smooth_iters: int = 4


def _to_batch(vs: torch.Tensor) -> torch.Tensor:
    """complex [R, 4, 3, T, X, M] -> split f32 [2, 4, 3, R, T, X, M]."""
    return torch.movedim(split_c(vs).to(torch.float32), 1, 3).contiguous()


def _from_batch(x2: torch.Tensor) -> torch.Tensor:
    """split [2, 4, 3, R, T, X, M] -> complex [R, 4, 3, T, X, M]."""
    return merge_c(torch.movedim(x2, 3, 1))


def _block_view(x: torch.Tensor, blocks) -> torch.Tensor:
    """[.., T, X, M] -> [.., nbt, bt, nbx, bx, nbm, bm]."""
    nbt, nbx, nbm = blocks
    t, xx, m = x.shape[-3:]
    for n, ext in zip(blocks, (t, xx, m)):
        if ext % n:
            raise ValueError(f"block counts {tuple(blocks)} do not divide the sites {(t, xx, m)}")
    return x.reshape(x.shape[:-3] + (nbt, t // nbt, nbx, xx // nbx, nbm, m // nbm))


def _restrict(v: torch.Tensor, x: torch.Tensor, blocks) -> torch.Tensor:
    """w[.., i, b] = <chi_b v_i, x>: x [.., 4, 3, T, X, M] -> [.., Ns * nb]
    (i major, blocks t-major and m-minor)."""
    vb = _block_view(v, blocks)  # [Ns, 4, 3, nbt, bt, nbx, bx, nbm, bm]
    xb = _block_view(x, blocks)
    w = torch.einsum("iskTtXxMm,...skTtXxMm->...iTXM", vb.conj(), xb)
    return w.reshape(x.shape[:-5] + (-1,))


def _prolong(v: torch.Tensor, w: torch.Tensor, blocks) -> torch.Tensor:
    """x = sum_{i, b} w[i, b] chi_b v_i for w [Ns, nb]."""
    nbt, nbx, nbm = blocks
    vb = _block_view(v, blocks)
    wf = w.reshape(v.shape[0], nbt, nbx, nbm).to(v.dtype)
    return torch.einsum("iskTtXxMm,iTXM->skTtXxMm", vb, wf).reshape(v.shape[1:])


def _block_orthonormalize(v: torch.Tensor, blocks) -> torch.Tensor:
    """Gram-Schmidt of the Ns vectors within every block (reference:
    block_orthonormalize), so the chopped basis is orthonormal."""
    vb = _block_view(v, blocks)  # [Ns, 4, 3, nbt, bt, nbx, bx, nbm, bm]
    axes = (0, 1, 3, 5, 7)
    outs = []
    for i in range(v.shape[0]):
        cur = vb[i]
        for prev in outs:
            cur = cur - torch.sum(prev.conj() * cur, dim=axes, keepdim=True) * prev
        nrm = torch.sqrt(torch.sum(cur.abs() ** 2, dim=axes, keepdim=True))
        outs.append(cur / torch.clamp(nrm, min=1e-30))
    return torch.stack(outs).reshape(v.shape)


def _mr_batch(matvec_batch: Callable, b: torch.Tensor, iters: int) -> torch.Tensor:
    """`iters` minimal-residual steps from zero on each vector of the batch
    b [R, 4, 3, T, X, M], one batched operator call per step and each
    vector's own alpha = <Ar, r> / |Ar|^2."""
    dims = tuple(range(1, b.ndim))
    x = torch.zeros_like(b)
    r = b
    for _ in range(iters):
        ar = _from_batch(matvec_batch(_to_batch(r)))
        den = torch.sum(ar.abs() ** 2, dim=dims, keepdim=True)
        alpha = torch.sum(ar.conj() * r, dim=dims, keepdim=True) / torch.clamp(den, min=1e-30)
        x = x + alpha * r
        r = r - alpha * ar
    return x


def _block_masks(blocks, device) -> torch.Tensor:
    """[nb, nbt, 1, nbx, 1, nbm, 1] one-hot block selectors, b t-major and
    m-minor as in `_restrict`."""
    nbt, nbx, nbm = blocks
    nb = nbt * nbx * nbm
    return torch.eye(nb, device=device).reshape(nb, nbt, 1, nbx, 1, nbm, 1)


def _coarse_inverse(a: torch.Tensor) -> torch.Tensor:
    """Dense complex64 inverse of the little operator (n = Ns * nb is
    O(100)); `vcycle` refines its solutions once against `a`."""
    return torch.linalg.inv(a.to(torch.complex64))


def setup_deflation(matvec_batch: Callable, shape: tuple, key: rng.Key | None = None, *,
                    device, n_vectors: int = 8, blocks: tuple[int, int, int] = (2, 2, 2),
                    inv_iters: int = 3, smooth_iters: int = 4,
                    v0: torch.Tensor | None = None) -> DeflationSetup:
    """Build the subspace and the little operator of M (the e/o-preconditioned
    Mhat; reference: generate_dfl_subspace + little_D).

    matvec_batch: M on a split batch [2, 4, 3, R, T, X, M]; shape: one
    vector's complex shape (4, 3, T, X, M).  The Ns = `n_vectors` starting
    vectors are complex gaussian fields drawn from `key` on `device`, or `v0`
    [Ns, *shape] complex where the caller supplies them."""
    ns = n_vectors
    if v0 is None:
        if key is None:
            raise ValueError("setup_deflation draws its starting vectors from `key`, or takes v0")
        vs = rng.normal_spinor(key, (ns,) + tuple(shape), device)
    else:
        vs = v0.to(device=device, dtype=torch.complex64)
        if tuple(vs.shape) != (ns,) + tuple(shape):
            raise ValueError(f"v0 has shape {tuple(vs.shape)}, expected {(ns,) + tuple(shape)}")
    dims = tuple(range(1, vs.ndim))
    for _ in range(inv_iters):
        vs = _mr_batch(matvec_batch, vs, 10)
        nrm = torch.sqrt(torch.sum(vs.abs() ** 2, dim=dims, keepdim=True))
        vs = vs / torch.clamp(nrm, min=1e-30)
    vs = _block_orthonormalize(vs, blocks)

    nb = blocks[0] * blocks[1] * blocks[2]
    masks = _block_masks(blocks, vs.device)
    cols = []
    for j in range(ns):
        # the nb chopped copies chi_b' v_j as one batched operator call
        chopped = (_block_view(vs[j], blocks)[None] * masks[:, None, None]).reshape(
            (nb,) + vs.shape[1:])
        cols.append(_restrict(vs, _from_batch(matvec_batch(_to_batch(chopped))), blocks))
    a = torch.cat(cols, dim=0).T  # [n, n]: column (j, b') = V^+ M chi_b' v_j
    return DeflationSetup(v=vs, blocks=tuple(blocks), a_inv=_coarse_inverse(a),
                          a=a.to(torch.complex64), smooth_iters=smooth_iters)


def _mr_smooth(matvec: Callable, b2: torch.Tensor, iters: int, tol: float) -> torch.Tensor:
    """`krylov.mr(matvec, b2, tol=tol, maxiter=iters).x` without host reads:
    once |r|^2 <= tol^2 |b|^2 the update is masked to zero, which leaves x
    where the stopping test would have left it."""
    target = tol * tol * _norm_sq(b2)
    x = torch.zeros_like(b2)
    r = b2
    zero = torch.zeros((), dtype=torch.complex128, device=b2.device)
    for _ in range(iters):
        ar = matvec(r)
        alpha = cdot(ar, r) / torch.clamp(_norm_sq(ar), min=1e-300)
        alpha = torch.where(_norm_sq(r) > target, alpha, zero)
        x = x + cscale(alpha, r)
        r = r - cscale(alpha, ar)
    return x


def vcycle(setup: DeflationSetup, matvec: Callable, r2: torch.Tensor) -> torch.Tensor:
    """One 2-level cycle on a split residual r2 [2, 4, 3, T, X, M]: coarse
    correction with one step of iterative refinement of the coarse solve,
    then MR smoothing of what remains (reference: dfl_projector.c as the
    DFLFGMRES preconditioner)."""
    ns = setup.v.shape[0]
    w = _restrict(setup.v, merge_c(r2), setup.blocks).to(setup.a_inv.dtype)
    cw = setup.a_inv @ w
    # the little operator is built from near-kernel vectors, so cond(A)
    # grows toward light masses; one refinement step restores the coarse
    # solve to f32 residual level for one more pair of small matvecs
    cw = cw + setup.a_inv @ (w - setup.a @ cw)
    c = split_c(_prolong(setup.v, cw.reshape(ns, -1), setup.blocks)).to(r2.dtype)
    if setup.smooth_iters > 0:
        c = c + _mr_smooth(matvec, r2 - matvec(c), setup.smooth_iters, 1e-6)
    return c


def deflated_fgmres(matvec: Callable, b2: torch.Tensor, setup: DeflationSetup, **kw):
    """FGMRES preconditioned by the deflation V-cycle (DFLFGMRES)."""
    return fgmres(matvec, b2, precond=lambda r: vcycle(setup, matvec, r), **kw)
