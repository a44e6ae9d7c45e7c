"""Split-complex (f32 re/im) twisted-mass operators on the hopping kernel —
the production path of the port.

Port of the single-device parts of `tmlqcd_tpu/ops/wilson_fast.py`.  Every
Dirac application goes through `dslash_cuda.hopping_split` (K1), which runs
the CUDA kernel for CUDA tensors and its plain version for CPU tensors; the
Schur complement is exactly two K1 calls with the diagonals fused into the
epilogues.  The force surrogate `q_hat_diff` runs on `HoppingDiff`, whose
backward is K2 plus the adjoint hop on K1.

Layout: psi [2, 4, 3, T, X, M] f32; gauge as FastGauge (pre-gathered split
links of both parities, phases folded).
"""

from __future__ import annotations

import dataclasses

import torch

from tmlqcd_tpu_torch.gamma import gamma5_split
from tmlqcd_tpu_torch.lattice import EVEN, ODD, Lattice, pack_gauge_eo
from tmlqcd_tpu_torch.ops import dslash_cuda as dc
from tmlqcd_tpu_torch.ops.wilson import DiracParams, boundary_phases

__all__ = [
    "FastGauge",
    "make_fast_gauge",
    "to_split",
    "from_split",
    "m_hat_fast",
    "q_hat_fast",
    "q_hat_pm_fast",
    "split_gauge_pair",
    "q_hat_diff",
    "dot_re_f64_split",
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


def m_hat_fast(fg: FastGauge, psi2_o: torch.Tensor, params: DiracParams, lat: Lattice,
               sign: float = +1.0, g5: bool = False) -> torch.Tensor:
    """Mhat(+-) on odd sites, split layout: two K1 calls, the Mee^{-1}
    diagonal and the Mee psi - k^2 H tmp assembly (plus the optional gamma5
    of Qhat) fused into their epilogues."""
    tmp = dc.hopping_split(fg.ug_even, psi2_o, EVEN, lat,
                           epi=("mee_inv", float(params.mutld), float(sign)), gcomp=fg.gcomp)
    return dc.hopping_split(
        fg.ug_odd, tmp, ODD, lat,
        epi=("mhat", float(params.mutld), float(sign), float(params.kappa * params.kappa),
             bool(g5)),
        psi_o=psi2_o, gcomp=fg.gcomp)


def q_hat_fast(fg: FastGauge, psi2_o: torch.Tensor, params: DiracParams, lat: Lattice,
               sign: float = +1.0) -> torch.Tensor:
    return m_hat_fast(fg, psi2_o, params, lat, sign, g5=True)


def q_hat_pm_fast(fg: FastGauge, psi2_o: torch.Tensor, params: DiracParams,
                  lat: Lattice) -> torch.Tensor:
    """Qhat_pm on split fields — the CG operator (four K1 calls)."""
    return q_hat_fast(fg, q_hat_fast(fg, psi2_o, params, lat, +1.0), params, lat, -1.0)


# ---------------------------------------------------------------------------
# differentiable operator for the MD forces
# ---------------------------------------------------------------------------


def split_gauge_pair(u: torch.Tensor, params: DiracParams, lat: Lattice):
    """Differentiable 18-real (ug_e, ug_o) split copies as functions of the
    full complex gauge field (autograd flows through gauge_copy)."""
    ug = dc.gauge_copy(pack_gauge_eo(u, lat), lat, boundary_phases(params, lat))
    return dc.split_c(ug[EVEN]).to(torch.float32), dc.split_c(ug[ODD]).to(torch.float32)


def _mee_split(psi2, mutld: float, sign: float):
    """(1 + i sign mutld gamma5) psi."""
    g = gamma5_split(psi2)
    return psi2 + (sign * mutld) * torch.stack([-g[1], g[0]])


def _mee_inv_split(psi2, mutld: float, sign: float):
    g = gamma5_split(psi2)
    return (psi2 - (sign * mutld) * torch.stack([-g[1], g[0]])) * (1.0 / (1.0 + mutld * mutld))


def q_hat_diff(ug_e: torch.Tensor, ug_o: torch.Tensor, psi2_o: torch.Tensor,
               params: DiracParams, lat: Lattice, sign: float = +1.0) -> torch.Tensor:
    """Qhat(+-) on split fields with HoppingDiff hops — differentiable with
    respect to (ug_e, ug_o) and psi."""
    k2 = params.kappa * params.kappa
    tmp = dc.HoppingDiff.apply(ug_e, ug_o, psi2_o, EVEN, lat)
    tmp = _mee_inv_split(tmp, params.mutld, sign)
    tmp = dc.HoppingDiff.apply(ug_o, ug_e, tmp, ODD, lat)
    return gamma5_split(_mee_split(psi2_o, params.mutld, sign) - k2 * tmp)


def dot_re_f64_split(a2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Re<a, b> of split arrays = an f64-accumulated real dot."""
    return torch.sum(a2.double() * b2.double())
