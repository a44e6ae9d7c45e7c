"""Split-complex (f32 re/im) twisted-mass and twisted-clover operators on
the hopping kernel — the production path of the port.

Port of the single-device parts of `tmlqcd_tpu/ops/wilson_fast.py`.  Every
Dirac application goes through the hopping kernel, which runs on the card
for CUDA tensors and as its plain version for CPU tensors.  The Schur
complement is two hops with the diagonals fused into the epilogues — for the
clover operator the per-site block matvecs with M_ee^{-1} and M_oo
(`FastClover`, epilogues clov_inv and clov_mhat); `m_hat_fast`,
`q_hat_pm_fast` and their clover forms run them (two for Mhat, four for
Qhat_pm) in one launch of `dslash_cuda.hopping_schur` (K1-S), bit for bit
the K1 launches they replace (`dslash_cuda.hopping_split`, which single
hops such as the inverter's prologue still use).  The
force surrogates `q_hat_diff` and `q_hat_clover_diff` run on `HoppingDiff`,
whose backward is K2 plus the adjoint hop on K1; the clover blocks enter the
latter as differentiable inputs.

The non-degenerate doublet operators (`q_nd_fast`, `q_nd_sq_fast` and the
clover forms) run in one launch of `dslash_cuda.hopping_schur_nd` (K1-SD):
each hop takes both flavours on one read of the gauge, with the
flavour-mixing diagonals M_ee^{-1} and M_oo fused into its epilogues (for
the clover doublet the materialised flavour-2x2 block fields of
`FastCloverND`); on the twisted-mass doublet bit for bit the K1-R-D launches
(`_hop_nd`, K1-R on `r_axis=1`) and torch diagonals they replace, which the
inverter's single hops and the mesh operators still use.  The force
surrogates `q_nd_diff` and `q_nd_clover_diff` run `HoppingDiff` flavour by
flavour.

The sloppy gauge copy (`make_fast_gauge(sloppy=True)`, `sloppy_gauge`,
`make_fast_clover(sloppy=True)`) holds the links in bf16: the f32 copy cast
to bf16 (round to nearest even) before row 2 is dropped, as in the
reference, stored with re/im innermost so that a kernel reads both parts of
an element in one load.  Every operator above runs on it unchanged; K1 and
K1-S read it as bf16 and compute in f32 (K1-B).  The clover blocks stay f32.  The mixed-precision
solvers use it for their low operator.

The domain-decomposed operators (`*_shard`, reference wilson_fast.py:183-320)
take a `parallel.Mesh` and run every hop through `dslash_cuda.hopping_shard`:
the slab kernels K3-I and K4 over the mesh's (t, y) slabs, all on one
device, with the halos moved by device-local copies.  The diagonals (twisted
mass, clover blocks, the doublet's flavour mixing) are applied outside the
kernels, as in the reference's `_m_hat_clover_fast_shard`: the slab kernels
carry no epilogue.  The results equal the unsharded operators'.

On one rank of a distributed run (`lat` a slab's lattice that carries its
`parallel.Mesh`) there is no whole lattice: every operator above — the
heatbath's Q, the Schur prologue and epilogue, the y = Qhat_+ x of a force,
the doublet's Q_nd — takes its sharded form on that mesh (the hop is
`dslash_cuda.hopping_rank`: KH-P, the exchange, K3-I / K4), and
`HoppingDiff` runs the rank hop forward and K2-S backward.  The whole-lattice
kernels K1, K1-S and K1-SD never run there.

Layout: psi [2, 4, 3, T, X, M] f32; gauge as FastGauge (pre-gathered split
links of both parities, phases folded).  A batch of R right-hand sides is
[2, 4, 3, R, T, X, M] (`to_split_rhs`); the operators take it with an explicit
`r_axis=3` and then run the multi-RHS kernel `dslash_cuda.hopping_split_rhs`
(K1-R), which reads the gauge once for the whole batch.  A flavour doublet
is [2(re/im), 2(flavour), 4, 3, T, X, M] (`to_split` of [2, 4, 3, T, X, M]).
"""

from __future__ import annotations

import dataclasses

import torch

from tmlqcd_tpu_torch.comm import global_sum
from tmlqcd_tpu_torch.gamma import gamma5_split
from tmlqcd_tpu_torch.lattice import EVEN, ODD, Lattice, pack_gauge_eo
from tmlqcd_tpu_torch.ops import clover as cl
from tmlqcd_tpu_torch.ops import dslash_cuda as dc
from tmlqcd_tpu_torch.ops import split_diag as sd
from tmlqcd_tpu_torch.ops.wilson import DiracParams, boundary_phases

__all__ = [
    "FastGauge",
    "make_fast_gauge",
    "sloppy_gauge",
    "sloppy_clover",
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
    "q_nd_fast",
    "q_nd_sq_fast",
    "q_nd_diff",
    "FastCloverND",
    "make_fast_clover_nd",
    "fast_clover_nd_from",
    "q_nd_clover_fast",
    "q_nd_sq_clover_fast",
    "split_clover_nd_pair",
    "q_nd_clover_diff",
    "hop_shard",
    "m_hat_fast_shard",
    "q_hat_pm_fast_shard",
    "q_hat_pm_clover_fast_shard",
    "q_nd_fast_shard",
    "q_nd_sq_fast_shard",
    "q_nd_clover_fast_shard",
    "q_nd_sq_clover_fast_shard",
    "q_hat_pm_operator",
    "q_hat_pm_clover_operator",
]


@dataclasses.dataclass(frozen=True)
class FastGauge:
    """Pre-gathered split gauge: ug[p] f32 (or bf16, the sloppy copy, with
    re/im innermost in memory) [2, 8, 3, 3, T, X, M] for each output parity
    p, or the 12-real copy [2, 8, 2, 3, T, X, M] when gcomp (row-2 constants
    from `dslash_cuda.gauge_corr`) is set."""

    ug_even: torch.Tensor
    ug_odd: torch.Tensor
    gcomp: tuple | None = None


def make_fast_gauge(u: torch.Tensor, params: DiracParams, lat: Lattice,
                    compress: bool = True, sloppy: bool = False) -> FastGauge:
    """Full gauge [3,3,4,T,X,Mf] complex -> FastGauge, once per gauge update.
    compress=True (the default, as on the reference's production path) keeps
    only the first two link rows: 384 instead of 576 B/site of gauge.
    sloppy=True stores the links in bf16 (192 or 288 B/site), the f32 copy
    rounded to nearest even before row 2 is dropped."""
    ph = boundary_phases(params, lat)
    with torch.no_grad():
        ug = dc.gauge_copy(pack_gauge_eo(u, lat), lat, ph)
        ug_e = dc.split_c(ug[EVEN]).to(torch.float32)
        ug_o = dc.split_c(ug[ODD]).to(torch.float32)
    if compress:
        fg = FastGauge(dc.compress_ug(ug_e), dc.compress_ug(ug_o), dc.gauge_corr(ph))
    else:
        fg = FastGauge(ug_e.contiguous(), ug_o.contiguous())
    return sloppy_gauge(fg) if sloppy else fg


def _bf16_links(ug: torch.Tensor) -> torch.Tensor:
    """ug [2, 8, rows, 3, T, X, M] cast to bf16 and stored with re/im
    innermost ([8, rows, 3, T, X, M, 2] in memory), returned as a view of the
    same shape and bits: a kernel reads an element's re and im as one
    __nv_bfloat162 (hopping_common.cuh, load_link)."""
    return ug.to(torch.bfloat16).movedim(0, -1).contiguous().movedim(-1, 0)


def sloppy_gauge(fg: FastGauge) -> FastGauge:
    """The bf16 copy of an f32 FastGauge, bit for bit the one
    `make_fast_gauge(..., sloppy=True)` builds from the same gauge (dropping
    row 2 and rounding commute); re/im innermost in memory (`_bf16_links`)."""
    return FastGauge(_bf16_links(fg.ug_even), _bf16_links(fg.ug_odd), fg.gcomp)


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
    names the batch axis of psi2 (on a rank's slab the rank hop, epilogue
    none)."""
    if lat.mesh is not None:
        if epi != ("none",):
            raise NotImplementedError("a fused epilogue on a rank's slab is not ported: the "
                                      "sharded operators apply their diagonals outside the hop")
        return hop_shard(fg, psi2, p, lat, lat.mesh, r_axis)
    ug = fg.ug_even if p == EVEN else fg.ug_odd
    if r_axis is None:
        return dc.hopping_split(ug, psi2, p, lat, epi=epi, psi_o=psi_o, gcomp=fg.gcomp,
                                blocks=blocks)
    return dc.hopping_split_rhs(ug, psi2, p, lat, epi=epi, psi_o=psi_o, gcomp=fg.gcomp,
                                r_axis=r_axis, blocks=blocks)


def _tm_stage(params: DiracParams, sign: float, g5: bool) -> tuple:
    """One twisted-mass Schur application as a K1-S stage: Mee^{-1} after the
    even hop, Mee psi - k^2 H tmp (and gamma5) after the odd one."""
    mutld, k2 = float(params.mutld), float(params.kappa * params.kappa)
    return (("mee_inv", mutld, float(sign)), ("mhat", mutld, float(sign), k2, bool(g5)), None,
            None)


def m_hat_fast(fg: FastGauge, psi2_o: torch.Tensor, params: DiracParams, lat: Lattice,
               sign: float = +1.0, g5: bool = False, r_axis: int | None = None) -> torch.Tensor:
    """Mhat(+-) on odd sites, split layout: the two hops with the Mee^{-1}
    diagonal and the Mee psi - k^2 H tmp assembly (plus the optional gamma5
    of Qhat) fused into their epilogues, in one K1-S launch.  With `r_axis`
    set, psi2_o is a batch along that axis and the two hops are K1-R calls."""
    if lat.mesh is not None:
        return m_hat_fast_shard(fg, psi2_o, params, lat, lat.mesh, sign, g5, r_axis)
    stage = _tm_stage(params, sign, g5)
    if r_axis is None:
        return dc.hopping_schur(fg.ug_even, fg.ug_odd, psi2_o, lat, (stage,), fg.gcomp)
    tmp = hop_fast(fg, psi2_o, EVEN, lat, stage[0], r_axis=r_axis)
    return hop_fast(fg, tmp, ODD, lat, stage[1], psi_o=psi2_o, r_axis=r_axis)


def q_hat_fast(fg: FastGauge, psi2_o: torch.Tensor, params: DiracParams, lat: Lattice,
               sign: float = +1.0, r_axis: int | None = None) -> torch.Tensor:
    return m_hat_fast(fg, psi2_o, params, lat, sign, g5=True, r_axis=r_axis)


def q_hat_pm_fast(fg: FastGauge, psi2_o: torch.Tensor, params: DiracParams,
                  lat: Lattice, r_axis: int | None = None) -> torch.Tensor:
    """Qhat_pm on split fields — the CG operator: its four hops in one K1-S
    launch, or four K1-R calls on a batch along `r_axis`."""
    if lat.mesh is not None:
        return q_hat_pm_fast_shard(fg, psi2_o, params, lat, lat.mesh, r_axis)
    if r_axis is None:
        return dc.hopping_schur(fg.ug_even, fg.ug_odd, psi2_o, lat,
                                (_tm_stage(params, +1.0, True), _tm_stage(params, -1.0, True)),
                                fg.gcomp)
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
    """Re<a, b> of split arrays = an f64-accumulated real dot (over the
    ranks of a distributed run, differentiable)."""
    return global_sum(torch.sum(a2.double() * b2.double()))


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


def make_fast_clover(u: torch.Tensor, params: DiracParams, lat: Lattice,
                     sloppy: bool = False) -> FastClover:
    """Full gauge -> FastClover, once per gauge update.  kappa and c_sw fix
    the clover term, mutld the four block fields.  sloppy=True: the gauge
    copy in bf16, the blocks f32."""
    with torch.no_grad():
        sw_e, sw_o = cl.sw_blocks_eo(u, params.kappa, params.c_sw, lat)
    return fast_clover_from(make_fast_gauge(u, params, lat, sloppy=sloppy), sw_e, sw_o,
                            params.mutld)


def sloppy_clover(fc: FastClover) -> FastClover:
    """`fc` on the bf16 copy of its gauge (`sloppy_gauge`); the blocks are
    shared and stay f32."""
    return dataclasses.replace(fc, fg=sloppy_gauge(fc.fg))


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


def blocks_apply_flat(blk: torch.Tensor, psi2: torch.Tensor,
                      r_axis: int | None = None) -> torch.Tensor:
    """Flattened blocks [2, 72, T, X, M] on a split spinor, or on a batch
    with its R axis at `r_axis` = 3 (the blocks broadcast over it): the block
    matvec where no hop stands next to it to carry it as an epilogue."""
    blk2 = dc.blk_unflatten(blk)
    if r_axis is not None:
        if r_axis != 3:
            raise ValueError(f"r_axis = {r_axis}: blocks_apply_flat takes the batch axis 3 "
                             "only; the flavour-2x2 blocks of a doublet are applied by "
                             "split_diag.mee_nd_apply_split / mee_inv_nd_apply_split")
        blk2 = blk2.unsqueeze(6)
    return sd.blocks_apply_split(blk2, psi2).contiguous()


def _clover_stage(fc: FastClover, params: DiracParams, sign: float, g5: bool) -> tuple:
    """One clover Schur application as a K1-S stage: the M_ee(+-)^{-1} blocks
    after the even hop, M_oo(+-) psi - k^2 H tmp (and gamma5) after the odd
    one.  The sign of mu picks the block fields, not a kernel argument."""
    mee_inv = fc.mee_inv_p if sign > 0 else fc.mee_inv_m
    moo = fc.moo_p if sign > 0 else fc.moo_m
    return (("clov_inv",), ("clov_mhat", float(params.kappa * params.kappa), bool(g5)), mee_inv,
            moo)


def m_hat_clover_fast(fc: FastClover, psi2_o: torch.Tensor, params: DiracParams, lat: Lattice,
                      sign: float = +1.0, g5: bool = False,
                      r_axis: int | None = None) -> torch.Tensor:
    """Clover Schur complement on split fields, M_oo(+-) psi - k^2 H_oe
    M_ee(+-)^{-1} H_eo psi: the two hops with both block applications fused
    into their epilogues, in one K1-S launch (two K1-R calls with
    `r_axis`)."""
    if lat.mesh is not None:
        return _m_hat_clover_fast_shard(fc, psi2_o, params, lat, lat.mesh, sign, g5, r_axis)
    stage = _clover_stage(fc, params, sign, g5)
    if r_axis is None:
        return dc.hopping_schur(fc.fg.ug_even, fc.fg.ug_odd, psi2_o, lat, (stage,), fc.fg.gcomp)
    epi_e, epi_o, mee_inv, moo = stage
    tmp = hop_fast(fc.fg, psi2_o, EVEN, lat, epi_e, r_axis=r_axis, blocks=mee_inv)
    return hop_fast(fc.fg, tmp, ODD, lat, epi_o, psi_o=psi2_o, r_axis=r_axis, blocks=moo)


def q_hat_clover_fast(fc: FastClover, psi2_o: torch.Tensor, params: DiracParams, lat: Lattice,
                      sign: float = +1.0, r_axis: int | None = None) -> torch.Tensor:
    return m_hat_clover_fast(fc, psi2_o, params, lat, sign, g5=True, r_axis=r_axis)


def q_hat_pm_clover_fast(fc: FastClover, psi2_o: torch.Tensor, params: DiracParams,
                         lat: Lattice, r_axis: int | None = None) -> torch.Tensor:
    """Qsw_pm on split fields — the CG operator: its four hops in one K1-S
    launch, or four K1-R calls on a batch along `r_axis`."""
    if lat.mesh is not None:
        return q_hat_pm_clover_fast_shard(fc, psi2_o, params, lat, lat.mesh, r_axis)
    if r_axis is None:
        return dc.hopping_schur(fc.fg.ug_even, fc.fg.ug_odd, psi2_o, lat,
                                (_clover_stage(fc, params, +1.0, True),
                                 _clover_stage(fc, params, -1.0, True)), fc.fg.gcomp)
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
    tmp = sd.blocks_apply_split(mee_inv_blk2, tmp)
    tmp = dc.HoppingDiff.apply(ug_o, ug_e, tmp.contiguous(), ODD, lat)
    return gamma5_split(sd.blocks_apply_split(moo_blk2, psi2_o) - k2 * tmp)


# ---------------------------------------------------------------------------
# non-degenerate doublet: flavour is the R axis of the multi-RHS kernel
# ---------------------------------------------------------------------------


def _hop_nd(fg: FastGauge, chi2: torch.Tensor, p: int, lat: Lattice) -> torch.Tensor:
    """Doublet hopping as ONE multi-RHS call with flavour as the R axis
    (K1-R-D, `r_axis=1`): the gauge is read once for both flavours.  The
    inverter's single hops around its solve."""
    return hop_fast(fg, chi2.contiguous(), p, lat, r_axis=1)


def _nd_stage(params, fc: FastCloverND | None = None) -> tuple:
    """One Q_nd application as a K1-SD stage: Mee_nd^-1 after the even hop,
    gamma5 tau1 (Mee_nd chi - k2 H tmp) after the odd one; with `fc` the
    clover doublet's flavour-2x2 block forms."""
    k2 = params.kappa * params.kappa
    if fc is None:
        return (("nd_mee_inv", params.mubar_t, params.epsbar_t),
                ("nd_mhat", params.mubar_t, params.epsbar_t, k2), None, None)
    return (("nd_clov_inv", fc.epsbar_t), ("nd_clov_mhat", fc.epsbar_t, k2),
            (fc.minv_a, fc.minv_b, fc.minv_e), (fc.moo_u, fc.moo_d))


def q_nd_fast(fg: FastGauge, chi2: torch.Tensor, params, lat: Lattice) -> torch.Tensor:
    """Q_nd = gamma5 tau1 Mhat_nd on split doublets [2, 2, 4, 3, T, X, M]
    in one K1-SD launch; params: `ops.ndoublet.NDParams`."""
    if lat.mesh is not None:
        return q_nd_fast_shard(fg, chi2, params, lat, lat.mesh)
    return dc.hopping_schur_nd(fg.ug_even, fg.ug_odd, chi2.contiguous(), lat, _nd_stage(params),
                               fg.gcomp)


def q_nd_sq_fast(fg: FastGauge, chi2: torch.Tensor, params, lat: Lattice) -> torch.Tensor:
    """Q_nd^2: the multishift-CG operator of the NDRAT monomial, its four
    hops in one K1-SD launch."""
    if lat.mesh is not None:
        return q_nd_sq_fast_shard(fg, chi2, params, lat, lat.mesh)
    return dc.hopping_schur_nd(fg.ug_even, fg.ug_odd, chi2.contiguous(), lat, _nd_stage(params),
                               fg.gcomp, square=True)


def _hop_nd_diff(ug_e: torch.Tensor, ug_o: torch.Tensor, c2: torch.Tensor, p: int,
                 lat: Lattice) -> torch.Tensor:
    """The doublet hop on HoppingDiff, flavour by flavour (K1 forward, K2 +
    adjoint K1 backward)."""
    ug_p, ug_q = (ug_e, ug_o) if p == EVEN else (ug_o, ug_e)
    return torch.stack([dc.HoppingDiff.apply(ug_p, ug_q, c2[:, f].contiguous(), p, lat)
                        for f in range(2)], dim=1)


def q_nd_diff(ug_e: torch.Tensor, ug_o: torch.Tensor, chi2: torch.Tensor, params,
              lat: Lattice) -> torch.Tensor:
    """Q_nd on split doublets with HoppingDiff hops — differentiable with
    respect to (ug_e, ug_o), for the NDRAT force surrogate."""
    k2 = params.kappa * params.kappa
    tmp = _hop_nd_diff(ug_e, ug_o, chi2, EVEN, lat)
    tmp = sd.mee_inv_nd_split(tmp, params.mubar_t, params.epsbar_t, +1.0)
    tmp = _hop_nd_diff(ug_e, ug_o, tmp, ODD, lat)
    m = sd.mee_nd_split(chi2, params.mubar_t, params.epsbar_t, +1.0) - k2 * tmp
    return sd.gamma5_nd(sd.tau1_split(m))


# ---------------------------------------------------------------------------
# clover non-degenerate doublet: materialised flavour-2x2 blocks
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FastCloverND:
    """Pre-gathered gauge plus materialised ND clover blocks (split f32,
    [2, 2, 2, 2, 3, 3, T, X, M]): moo_u / moo_d = the flavour-diagonal
    M_oo(+-mubar) blocks of the odd sites; (minv_a, minv_b, minv_e) = the
    flavour-2x2 M_ee^{-1} = [[A, -eps E], [-eps E, B]] of the even sites.
    Built once per gauge field."""

    fg: FastGauge
    moo_u: torch.Tensor
    moo_d: torch.Tensor
    minv_a: torch.Tensor
    minv_b: torch.Tensor
    minv_e: torch.Tensor
    epsbar_t: float


def _nd_clover_block_tuple(sw_e: torch.Tensor, sw_o: torch.Tensor, params) -> tuple:
    """(moo_u, moo_d, minv_a, minv_b, minv_e) split-f32 ND clover blocks from
    the packed clover term — the one function shared by the solve operator
    and the force surrogate, so the sign of eps and the block order cannot
    drift apart between the two.  Differentiable in (sw_e, sw_o)."""
    a, b, e = cl.mee_inv_nd_blocks(sw_e, params.mubar_t, params.epsbar_t, +1.0)
    return (_split_blocks(cl.mee_blocks(sw_o, params.mubar_t, +1.0)),
            _split_blocks(cl.mee_blocks(sw_o, params.mubar_t, -1.0)),
            _split_blocks(a), _split_blocks(b), _split_blocks(e))


def fast_clover_nd_from(fg: FastGauge, sw_e: torch.Tensor, sw_o: torch.Tensor,
                        params) -> FastCloverND:
    """FastCloverND from a gauge copy and the packed clover term that were
    built already (detached)."""
    with torch.no_grad():
        blocks = _nd_clover_block_tuple(sw_e.detach(), sw_o.detach(), params)
    return FastCloverND(fg, *blocks, epsbar_t=params.epsbar_t)


def make_fast_clover_nd(u: torch.Tensor, params, lat: Lattice) -> FastCloverND:
    """Full gauge -> FastCloverND, once per gauge update; params:
    `ops.ndoublet.NDParams` with c_sw != 0."""
    with torch.no_grad():
        sw_e, sw_o = cl.sw_blocks_eo(u, params.kappa, params.c_sw, lat)
    return fast_clover_nd_from(make_fast_gauge(u, params.wilson, lat), sw_e, sw_o, params)


def q_nd_clover_fast(fc: FastCloverND, chi2: torch.Tensor, params, lat: Lattice) -> torch.Tensor:
    """Q_nd^sw = gamma5 tau1 Mhat_nd^sw on split doublets in one K1-SD
    launch, the flavour-2x2 clover blocks applied in its epilogues."""
    if lat.mesh is not None:
        return q_nd_clover_fast_shard(fc, chi2, params, lat, lat.mesh)
    return dc.hopping_schur_nd(fc.fg.ug_even, fc.fg.ug_odd, chi2.contiguous(), lat,
                               _nd_stage(params, fc), fc.fg.gcomp)


def q_nd_sq_clover_fast(fc: FastCloverND, chi2: torch.Tensor, params,
                        lat: Lattice) -> torch.Tensor:
    """(Q_nd^sw)^2, its four hops in one K1-SD launch."""
    if lat.mesh is not None:
        return q_nd_sq_clover_fast_shard(fc, chi2, params, lat, lat.mesh)
    return dc.hopping_schur_nd(fc.fg.ug_even, fc.fg.ug_odd, chi2.contiguous(), lat,
                               _nd_stage(params, fc), fc.fg.gcomp, square=True)


def split_clover_nd_pair(u: torch.Tensor, params, lat: Lattice) -> tuple:
    """Differentiable (ug_e, ug_o, moo_u, moo_d, minv_a, minv_b, minv_e)
    split tensors as functions of the full gauge field — the non-degenerate
    analogue of `split_clover_pair`, for the NDCLOVERRAT force surrogate."""
    ug_e, ug_o = split_gauge_pair(u, params.wilson, lat)
    sw_e, sw_o = cl.sw_blocks_eo(u, params.kappa, params.c_sw, lat)
    return (ug_e, ug_o) + _nd_clover_block_tuple(sw_e, sw_o, params)


def q_nd_clover_diff(ug_e: torch.Tensor, ug_o: torch.Tensor, moo_u: torch.Tensor,
                     moo_d: torch.Tensor, minv_a: torch.Tensor, minv_b: torch.Tensor,
                     minv_e: torch.Tensor, chi2: torch.Tensor, params,
                     lat: Lattice) -> torch.Tensor:
    """Q_nd^sw on split doublets, differentiable with respect to the gauge
    copies (HoppingDiff: K1 forward, K2 + adjoint K1 backward) and the
    materialised clover blocks (autograd through sw_blocks / mee_blocks /
    mee_inv_nd_blocks)."""
    k2 = params.kappa * params.kappa
    eps = params.epsbar_t
    tmp = _hop_nd_diff(ug_e, ug_o, chi2, EVEN, lat)
    tmp = sd.mee_inv_nd_apply_split(minv_a, minv_b, minv_e, eps, tmp)
    tmp = _hop_nd_diff(ug_e, ug_o, tmp, ODD, lat)
    m = sd.mee_nd_apply_split(moo_u, moo_d, eps, chi2) - k2 * tmp
    return sd.gamma5_nd(sd.tau1_split(m))


# ---------------------------------------------------------------------------
# domain-decomposed operators: every hop on the slab kernels of a Mesh
# ---------------------------------------------------------------------------


def hop_shard(fg: FastGauge, psi2: torch.Tensor, p: int, lat: Lattice, mesh,
              r_axis: int | None = None) -> torch.Tensor:
    """H_{p,1-p} psi2 on parity-p sites through `dslash_cuda.hopping_shard`
    (K3-I and K4 on the slabs of `mesh`; K3, or K1-T on t slabs alone,
    without the mesh's overlap)."""
    ug = fg.ug_even if p == EVEN else fg.ug_odd
    return dc.hopping_shard(ug, psi2, p, lat, mesh, fg.gcomp, r_axis)


def m_hat_fast_shard(fg: FastGauge, psi2_o: torch.Tensor, params: DiracParams, lat: Lattice,
                     mesh, sign: float = +1.0, g5: bool = False,
                     r_axis: int | None = None) -> torch.Tensor:
    """Mhat(+-) with both hops on the slab kernels and the twisted-mass
    diagonals applied between and after them (reference :183)."""
    tmp = mee_inv_split(hop_shard(fg, psi2_o, EVEN, lat, mesh, r_axis), params.mutld, sign)
    tmp = hop_shard(fg, tmp, ODD, lat, mesh, r_axis)
    out = mee_split(psi2_o, params.mutld, sign) - (params.kappa * params.kappa) * tmp
    return gamma5_split(out) if g5 else out


def q_hat_pm_fast_shard(fg: FastGauge, psi2_o: torch.Tensor, params: DiracParams,
                        lat: Lattice, mesh, r_axis: int | None = None) -> torch.Tensor:
    """Qhat_pm on the slab kernels: the CG operator under a mesh (four
    sharded hops; a batch along `r_axis` = 3 runs the multi-RHS slab kernels)."""
    tmp = m_hat_fast_shard(fg, psi2_o, params, lat, mesh, +1.0, True, r_axis)
    return m_hat_fast_shard(fg, tmp, params, lat, mesh, -1.0, True, r_axis)


def _m_hat_clover_fast_shard(fc: FastClover, psi2_o: torch.Tensor, params: DiracParams,
                             lat: Lattice, mesh, sign: float = +1.0, g5: bool = False,
                             r_axis: int | None = None) -> torch.Tensor:
    """The clover Schur complement with both hops on the slab kernels; the
    site-local block matvecs run outside them (reference :225)."""
    mee_inv = fc.mee_inv_p if sign > 0 else fc.mee_inv_m
    moo = fc.moo_p if sign > 0 else fc.moo_m
    tmp = blocks_apply_flat(mee_inv, hop_shard(fc.fg, psi2_o, EVEN, lat, mesh, r_axis), r_axis)
    tmp = hop_shard(fc.fg, tmp, ODD, lat, mesh, r_axis)
    out = blocks_apply_flat(moo, psi2_o, r_axis) - (params.kappa * params.kappa) * tmp
    return gamma5_split(out) if g5 else out


def q_hat_pm_clover_fast_shard(fc: FastClover, psi2_o: torch.Tensor, params: DiracParams,
                               lat: Lattice, mesh, r_axis: int | None = None) -> torch.Tensor:
    """Qsw_pm on the slab kernels (reference :248)."""
    tmp = _m_hat_clover_fast_shard(fc, psi2_o, params, lat, mesh, +1.0, True, r_axis)
    return _m_hat_clover_fast_shard(fc, tmp, params, lat, mesh, -1.0, True, r_axis)


def q_hat_pm_operator(fg: FastGauge, params: DiracParams, lat: Lattice, mesh=None,
                      r_axis: int | None = None):
    """Qhat_pm as a callable on split fields (a batch along `r_axis`): the
    whole-lattice kernels, or the sharded operator over `mesh`."""
    if mesh is not None:
        return lambda x2: q_hat_pm_fast_shard(fg, x2, params, lat, mesh, r_axis=r_axis)
    return lambda x2: q_hat_pm_fast(fg, x2, params, lat, r_axis)


def q_hat_pm_clover_operator(fc: FastClover, params: DiracParams, lat: Lattice, mesh=None,
                             r_axis: int | None = None):
    """Qsw_pm as a callable on split fields, as `q_hat_pm_operator`."""
    if mesh is not None:
        return lambda x2: q_hat_pm_clover_fast_shard(fc, x2, params, lat, mesh, r_axis=r_axis)
    return lambda x2: q_hat_pm_clover_fast(fc, x2, params, lat, r_axis)


def _hop_nd_shard(fg: FastGauge, chi2: torch.Tensor, p: int, lat: Lattice, mesh) -> torch.Tensor:
    """The doublet hop as one multi-RHS slab launch per variant, flavour the
    R axis (`r_axis=1`): the gauge read once for both flavours, both in one
    halo exchange (reference :262)."""
    return hop_shard(fg, chi2.contiguous(), p, lat, mesh, 1)


def q_nd_fast_shard(fg: FastGauge, chi2: torch.Tensor, params, lat: Lattice,
                    mesh) -> torch.Tensor:
    """Q_nd on the slab kernels; the flavour-mixing diagonals are
    elementwise (reference :276)."""
    tmp = _hop_nd_shard(fg, chi2, EVEN, lat, mesh)
    tmp = sd.mee_inv_nd_split(tmp, params.mubar_t, params.epsbar_t, +1.0)
    tmp = _hop_nd_shard(fg, tmp, ODD, lat, mesh)
    m = (sd.mee_nd_split(chi2, params.mubar_t, params.epsbar_t, +1.0)
         - (params.kappa * params.kappa) * tmp)
    return sd.gamma5_nd(sd.tau1_split(m))


def q_nd_sq_fast_shard(fg: FastGauge, chi2: torch.Tensor, params, lat: Lattice,
                       mesh) -> torch.Tensor:
    return q_nd_fast_shard(fg, q_nd_fast_shard(fg, chi2, params, lat, mesh), params, lat, mesh)


def q_nd_clover_fast_shard(fc: FastCloverND, chi2: torch.Tensor, params, lat: Lattice,
                           mesh) -> torch.Tensor:
    """Q_nd^sw on the slab kernels (reference :297)."""
    tmp = _hop_nd_shard(fc.fg, chi2, EVEN, lat, mesh)
    tmp = sd.mee_inv_nd_apply_split(fc.minv_a, fc.minv_b, fc.minv_e, fc.epsbar_t, tmp)
    tmp = _hop_nd_shard(fc.fg, tmp, ODD, lat, mesh)
    m = (sd.mee_nd_apply_split(fc.moo_u, fc.moo_d, fc.epsbar_t, chi2)
         - (params.kappa * params.kappa) * tmp)
    return sd.gamma5_nd(sd.tau1_split(m))


def q_nd_sq_clover_fast_shard(fc: FastCloverND, chi2: torch.Tensor, params, lat: Lattice,
                              mesh) -> torch.Tensor:
    return q_nd_clover_fast_shard(fc, q_nd_clover_fast_shard(fc, chi2, params, lat, mesh),
                                  params, lat, mesh)
