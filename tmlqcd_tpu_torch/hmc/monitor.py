"""Force monitoring: per-monomial force norms for timescale tuning.

Port of `tmlqcd_tpu/hmc/monitor.py`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tmlqcd_tpu_torch import rng
from tmlqcd_tpu_torch.comm import global_max, global_sum

__all__ = ["ForceStats", "monitor_forces"]


class ForceStats(NamedTuple):
    name: str
    timescale: int
    norm_sq: float  # sum over links of |F|_F^2
    max_abs: float  # max link Frobenius norm
    rms: float


def monitor_forces(cfg, u: torch.Tensor, key: rng.Key, etas=None) -> list[ForceStats]:
    """Evaluate every monomial's force at U with fresh pseudofermion
    heatbaths (purpose 5000 + monomial index) and report aggregate norms.
    `etas` injects one heatbath draw per monomial instead."""
    out = []
    n_links = 4 * cfg.lat.global_volume
    for i, m in enumerate(cfg.monomials):
        aux, _ = m.heatbath(u, key.fold(5000 + i), None if etas is None else etas[i])
        f = m.force(u, aux)
        fro_sq = torch.sum(f.real ** 2 + f.imag ** 2, dim=(0, 1))  # per link
        norm_sq = float(global_sum(torch.sum(fro_sq.double())))
        out.append(ForceStats(name=m.name, timescale=m.timescale, norm_sq=norm_sq,
                              max_abs=float(torch.sqrt(global_max(torch.max(fro_sq)))),
                              rms=float((norm_sq / n_links) ** 0.5)))
    return out
