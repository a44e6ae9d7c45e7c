"""Split-complex (f32 re/im) twisted-mass and twisted-clover operators on
the hopping kernel — the production path of the port.

Port of the single-device parts of `tmlqcd_tpu/ops/wilson_fast.py`.  Every
Dirac application goes through `dslash_cuda.hopping_split` (K1), which runs
the CUDA kernel for CUDA tensors and its plain version for CPU tensors; the
Schur complement is exactly two K1 calls with the diagonals fused into the
epilogues — for the clover operator the per-site block matvecs with
M_ee^{-1} and M_oo (`FastClover`, epilogues clov_inv and clov_mhat).  The
force surrogates `q_hat_diff` and `q_hat_clover_diff` run on `HoppingDiff`,
whose backward is K2 plus the adjoint hop on K1; the clover blocks enter the
latter as differentiable inputs.

Not ported yet: the sharded (`_shard`) operators, the bf16 `sloppy` gauge
copy and the non-degenerate doublet operators.

Layout: psi [2, 4, 3, T, X, M] f32; gauge as FastGauge (pre-gathered split
links of both parities, phases folded).  A batch of R right-hand sides is
[2, 4, 3, R, T, X, M] (`to_split_rhs`); the operators take it with an explicit
`r_axis=3` and then run the multi-RHS kernel `dslash_cuda.hopping_split_rhs`
(K1-R), which reads the gauge once for the whole batch.
"""

from __future__ import annotations

import dataclasses

import torch

from tmlqcd_tpu_torch.gamma import gamma5_split
from tmlqcd_tpu_torch.lattice import EVEN, ODD, Lattice, pack_gauge_eo
from tmlqcd_tpu_torch.ops import clover as cl
from tmlqcd_tpu_torch.ops import dslash_cuda as dc
from tmlqcd_tpu_torch.ops.wilson import DiracParams, boundary_phases

__all__ = [
    "FastGauge",
    "make_fast_gauge",
    "to_split",
    "from_split",
    "to_split_rhs",
    "from_split_rhs",
    "hop_fast",
    "m_hat_fast",
    "q_hat_fast",
    "q_hat_pm_fast",
    "mee_split",
    "mee_inv_split",
    "split_gauge_pair",
    "q_hat_diff",
    "dot_re_f64_split",
    "FastClover",
    "make_fast_clover",
    "fast_clover_from",
    "fast_gauge_from_pair",
    "split_clover_blocks",
    "m_hat_clover_fast",
    "q_hat_clover_fast",
    "q_hat_pm_clover_fast",
    "split_clover_pair",
    "q_hat_clover_diff",
]


@dataclasses.dataclass(frozen=True)
class FastGauge:
    """Pre-gathered split gauge: ug[p] f32 [2, 8, 3, 3, T, X, M] for each
    output parity p, or the 12-real copy [2, 8, 2, 3, T, X, M] when gcomp
    (row-2 constants from `dslash_cuda.gauge_corr`) is set."""

    ug_even: torch.Tensor
    ug_odd: torch.Tensor
    gcomp: tuple | None = None


def make_fast_gauge(u: torch.Tensor, params: DiracParams, lat: Lattice,
                    compress: bool = True) -> FastGauge:
    """Full gauge [3,3,4,T,X,Mf] complex -> FastGauge, once per gauge update.
    compress=True (the default, as on the reference's production path) keeps
    only the first two link rows: 384 instead of 576 B/site of gauge."""
    ph = boundary_phases(params, lat)
    with torch.no_grad():
        ug = dc.gauge_copy(pack_gauge_eo(u, lat), lat, ph)
        ug_e = dc.split_c(ug[EVEN]).to(torch.float32)
        ug_o = dc.split_c(ug[ODD]).to(torch.float32)
    if compress:
        return FastGauge(dc.compress_ug(ug_e), dc.compress_ug(ug_o), dc.gauge_corr(ph))
    return FastGauge(ug_e.contiguous(), ug_o.contiguous())


def to_split(psi: torch.Tensor) -> torch.Tensor:
    return dc.split_c(psi).to(torch.float32)


def from_split(psi2: torch.Tensor) -> torch.Tensor:
    return dc.merge_c(psi2)


def to_split_rhs(psis: torch.Tensor) -> torch.Tensor:
    """Batch of complex spinors [R, 4, 3, T, X, M] -> the multi-RHS split
    layout [2, 4, 3, R, T, X, M] (R inside the spin/colour axes, the sites
    stay minor-most), contiguous."""
    return torch.movedim(dc.split_c(psis).to(torch.float32), 1, 3).contiguous()


def from_split_rhs(psi2: torch.Tensor) -> torch.Tensor:
    """[2, 4, 3, R, T, X, M] -> complex [R, 4, 3, T, X, M]."""
    return dc.merge_c(torch.movedim(psi2, 3, 1))


def hop_fast(fg: FastGauge, psi2: torch.Tensor, p: int, lat: Lattice, epi: tuple = ("none",),
             psi_o=None, r_axis: int | None = None, blocks=None) -> torch.Tensor:
    """epilogue(H_{p,1-p} psi2) on parity-p sites: K1, or K1-R when `r_axis`
    names the batch axis of psi2."""
    ug = fg.ug_even if p == EVEN else fg.ug_odd
    if r_axis is None:
        return dc.hopping_split(ug, psi2, p, lat, epi=epi, psi_o=psi_o, gcomp=fg.gcomp,
                                blocks=blocks)
    return dc.hopping_split_rhs(ug, psi2, p, lat, epi=epi, psi_o=psi_o, gcomp=fg.gcomp,
                                r_axis=r_axis, blocks=blocks)


def m_hat_fast(fg: FastGauge, psi2_o: torch.Tensor, params: DiracParams, lat: Lattice,
               sign: float = +1.0, g5: bool = False, r_axis: int | None = None) -> torch.Tensor:
    """Mhat(+-) on odd sites, split layout: two K1 calls, the Mee^{-1}
    diagonal and the Mee psi - k^2 H tmp assembly (plus the optional gamma5
    of Qhat) fused into their epilogues.  With `r_axis` set, psi2_o is a
    batch along that axis and the two calls are K1-R."""
    tmp = hop_fast(fg, psi2_o, EVEN, lat, ("mee_inv", float(params.mutld), float(sign)),
                   r_axis=r_axis)
    return hop_fast(fg, tmp, ODD, lat,
                    ("mhat", float(params.mutld), float(sign), float(params.kappa * params.kappa),
                     bool(g5)),
                    psi_o=psi2_o, r_axis=r_axis)


def q_hat_fast(fg: FastGauge, psi2_o: torch.Tensor, params: DiracParams, lat: Lattice,
               sign: float = +1.0, r_axis: int | None = None) -> torch.Tensor:
    return m_hat_fast(fg, psi2_o, params, lat, sign, g5=True, r_axis=r_axis)


def q_hat_pm_fast(fg: FastGauge, psi2_o: torch.Tensor, params: DiracParams,
                  lat: Lattice, r_axis: int | None = None) -> torch.Tensor:
    """Qhat_pm on split fields — the CG operator (four K1 or K1-R calls)."""
    return q_hat_fast(fg, q_hat_fast(fg, psi2_o, params, lat, +1.0, r_axis), params, lat, -1.0,
                      r_axis)


# ---------------------------------------------------------------------------
# differentiable operator for the MD forces
# ---------------------------------------------------------------------------


def split_gauge_pair(u: torch.Tensor, params: DiracParams, lat: Lattice):
    """Differentiable 18-real (ug_e, ug_o) split copies as functions of the
    full complex gauge field (autograd flows through gauge_copy)."""
    ug = dc.gauge_copy(pack_gauge_eo(u, lat), lat, boundary_phases(params, lat))
    return dc.split_c(ug[EVEN]).to(torch.float32), dc.split_c(ug[ODD]).to(torch.float32)


def mee_split(psi2, mutld: float, sign: float):
    """(1 + i sign mutld gamma5) psi."""
    g = gamma5_split(psi2)
    return psi2 + (sign * mutld) * torch.stack([-g[1], g[0]])


def mee_inv_split(psi2, mutld: float, sign: float):
    """(1 - i sign mutld gamma5) psi / (1 + mutld^2)."""
    g = gamma5_split(psi2)
    return (psi2 - (sign * mutld) * torch.stack([-g[1], g[0]])) * (1.0 / (1.0 + mutld * mutld))


def q_hat_diff(ug_e: torch.Tensor, ug_o: torch.Tensor, psi2_o: torch.Tensor,
               params: DiracParams, lat: Lattice, sign: float = +1.0) -> torch.Tensor:
    """Qhat(+-) on split fields with HoppingDiff hops — differentiable with
    respect to (ug_e, ug_o) and psi."""
    k2 = params.kappa * params.kappa
    tmp = dc.HoppingDiff.apply(ug_e, ug_o, psi2_o, EVEN, lat)
    tmp = mee_inv_split(tmp, params.mutld, sign)
    tmp = dc.HoppingDiff.apply(ug_o, ug_e, tmp, ODD, lat)
    return gamma5_split(mee_split(psi2_o, params.mutld, sign) - k2 * tmp)


def dot_re_f64_split(a2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Re<a, b> of split arrays = an f64-accumulated real dot."""
    return torch.sum(a2.double() * b2.double())


# ---------------------------------------------------------------------------
# twisted clover: materialised blocks streamed into the kernel epilogues
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FastClover:
    """Pre-gathered gauge plus materialised clover blocks (split f32):
    moo_p / moo_m = the M_oo(+-) blocks of the odd sites, mee_inv_p /
    mee_inv_m = the M_ee(+-)^{-1} blocks of the even sites, each in the
    kernels' flattened layout [2, 72, T, X, M] (`dslash_cuda.blk_flatten`).
    Built once per gauge field."""

    fg: FastGauge
    moo_p: torch.Tensor
    moo_m: torch.Tensor
    mee_inv_p: torch.Tensor
    mee_inv_m: torch.Tensor


def _split_blocks(x: torch.Tensor) -> torch.Tensor:
    return dc.split_c(x).to(torch.float32)


def make_fast_clover(u: torch.Tensor, params: DiracParams, lat: Lattice) -> FastClover:
    """Full gauge -> FastClover, once per gauge update.  kappa and c_sw fix
    the clover term, mutld the four block fields."""
    with torch.no_grad():
        sw_e, sw_o = cl.sw_blocks_eo(u, params.kappa, params.c_sw, lat)
    return fast_clover_from(make_fast_gauge(u, params, lat), sw_e, sw_o, params.mutld)


def fast_clover_from(fg: FastGauge, sw_e: torch.Tensor, sw_o: torch.Tensor,
                     mutld: float) -> FastClover:
    """FastClover of one mutld from a gauge copy and the packed clover term
    (sw_e, sw_o) that were built already: operators which share kappa, c_sw
    and the boundary phases and differ in mu share both."""
    with torch.no_grad():
        sw_e, sw_o = sw_e.detach(), sw_o.detach()
        flat = lambda x: dc.blk_flatten(_split_blocks(x))  # noqa: E731
        return FastClover(
            fg=fg,
            moo_p=flat(cl.mee_blocks(sw_o, mutld, +1.0)),
            moo_m=flat(cl.mee_blocks(sw_o, mutld, -1.0)),
            mee_inv_p=flat(cl.mee_inv_blocks(sw_e, mutld, +1.0)),
            mee_inv_m=flat(cl.mee_inv_blocks(sw_e, mutld, -1.0)),
        )


def fast_gauge_from_pair(ug_e: torch.Tensor, ug_o: torch.Tensor, params: DiracParams,
                         lat: Lattice) -> FastGauge:
    """The 12-real FastGauge of `make_fast_gauge` from the 18-real split pair
    of `split_gauge_pair` (detached), when that pair exists already."""
    return FastGauge(dc.compress_ug(ug_e.detach()), dc.compress_ug(ug_o.detach()),
                     dc.gauge_corr(boundary_phases(params, lat)))


def _blocks_apply_split(blk2: torch.Tensor, psi2: torch.Tensor) -> torch.Tensor:
    """Split-complex chirality-block matvec: blk2 [2,2,2,2,3,3,*sites],
    psi2 [2,4,3,*sites] -> [2,4,3,*sites].  Plain tensor arithmetic: it
    carries the gradient with respect to the blocks in the force surrogate."""
    br, bi = blk2[0], blk2[1]  # [2, 2, 2, 3, 3, *sites]
    ext = (2, 2, 3) + tuple(psi2.shape[3:])
    pr, pi = psi2[0].reshape(ext), psi2[1].reshape(ext)  # [b, s', c', *sites]
    # out[b, s, c] = sum_{s', c'} blk[b, s, s', c, c'] psi[b, s', c']
    xr, xi = pr[:, None, :, None], pi[:, None, :, None]
    re = (br * xr - bi * xi).sum(dim=(2, 4))
    im = (br * xi + bi * xr).sum(dim=(2, 4))
    return torch.stack([re, im]).reshape(psi2.shape)


def blocks_apply_flat(blk: torch.Tensor, psi2: torch.Tensor,
                      r_axis: int | None = None) -> torch.Tensor:
    """Flattened blocks [2, 72, T, X, M] on a split spinor, or on a batch
    with its R axis at `r_axis` = 3 (the blocks broadcast over it): the block
    matvec where no hop stands next to it to carry it as an epilogue."""
    blk2 = dc.blk_unflatten(blk)
    if r_axis is not None:
        if r_axis != 3:
            raise NotImplementedError(f"r_axis = {r_axis}: only the batch axis 3 is ported")
        blk2 = blk2.unsqueeze(6)
    return _blocks_apply_split(blk2, psi2).contiguous()


def m_hat_clover_fast(fc: FastClover, psi2_o: torch.Tensor, params: DiracParams, lat: Lattice,
                      sign: float = +1.0, g5: bool = False,
                      r_axis: int | None = None) -> torch.Tensor:
    """Clover Schur complement on split fields, M_oo(+-) psi - k^2 H_oe
    M_ee(+-)^{-1} H_eo psi: two K1 calls (K1-R with `r_axis`), both block
    applications fused into their epilogues.  The sign of mu picks the block
    fields, not a kernel argument."""
    mee_inv = fc.mee_inv_p if sign > 0 else fc.mee_inv_m
    moo = fc.moo_p if sign > 0 else fc.moo_m
    tmp = hop_fast(fc.fg, psi2_o, EVEN, lat, ("clov_inv",), r_axis=r_axis, blocks=mee_inv)
    return hop_fast(fc.fg, tmp, ODD, lat,
                    ("clov_mhat", float(params.kappa * params.kappa), bool(g5)),
                    psi_o=psi2_o, r_axis=r_axis, blocks=moo)


def q_hat_clover_fast(fc: FastClover, psi2_o: torch.Tensor, params: DiracParams, lat: Lattice,
                      sign: float = +1.0, r_axis: int | None = None) -> torch.Tensor:
    return m_hat_clover_fast(fc, psi2_o, params, lat, sign, g5=True, r_axis=r_axis)


def q_hat_pm_clover_fast(fc: FastClover, psi2_o: torch.Tensor, params: DiracParams,
                         lat: Lattice, r_axis: int | None = None) -> torch.Tensor:
    """Qsw_pm on split fields — the CG operator (four K1 or K1-R calls)."""
    return q_hat_clover_fast(fc, q_hat_clover_fast(fc, psi2_o, params, lat, +1.0, r_axis),
                             params, lat, -1.0, r_axis)


def split_clover_blocks(sw_e, sw_o, mutld: float, sign: float = +1.0):
    """Differentiable split (moo, mee_inv) blocks [2,2,2,2,3,3,T,X,M] of one
    operator from the packed clover term."""
    return (_split_blocks(cl.mee_blocks(sw_o, mutld, sign)),
            _split_blocks(cl.mee_inv_blocks(sw_e, mutld, sign)))


def split_clover_pair(u: torch.Tensor, params: DiracParams, lat: Lattice, sign: float = +1.0):
    """Differentiable (ug_e, ug_o, moo_blocks, mee_inv_blocks) split tensors
    as functions of the full gauge field (for the clover force surrogates)."""
    ug_e, ug_o = split_gauge_pair(u, params, lat)
    sw_e, sw_o = cl.sw_blocks_eo(u, params.kappa, params.c_sw, lat)
    return (ug_e, ug_o) + split_clover_blocks(sw_e, sw_o, params.mutld, sign)


def q_hat_clover_diff(ug_e: torch.Tensor, ug_o: torch.Tensor, moo_blk2: torch.Tensor,
                      mee_inv_blk2: torch.Tensor, psi2_o: torch.Tensor, params: DiracParams,
                      lat: Lattice) -> torch.Tensor:
    """Qsw(+) on split fields, differentiable with respect to (ug_e, ug_o,
    moo_blk2, mee_inv_blk2): the hops run on HoppingDiff (K1 forward, K2 +
    adjoint K1 backward); the blocks enter as differentiable inputs, so the
    clover-term force comes from autograd through sw_blocks / mee_blocks /
    mee_inv_blocks."""
    k2 = params.kappa * params.kappa
    tmp = dc.HoppingDiff.apply(ug_e, ug_o, psi2_o, EVEN, lat)
    tmp = _blocks_apply_split(mee_inv_blk2, tmp)
    tmp = dc.HoppingDiff.apply(ug_o, ug_e, tmp.contiguous(), ODD, lat)
    return gamma5_split(_blocks_apply_split(moo_blk2, psi2_o) - k2 * tmp)
