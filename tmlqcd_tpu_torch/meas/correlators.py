"""Online meson correlators: stochastic-source <PP> and <PA> time correlators
measured inside the HMC loop.

Port of `tmlqcd_tpu/meas/correlators.py`.  With a stochastic timeslice source
eta at t0 and psi = M^{-1} eta,

    C_PP(t) = sum_x |psi(x, t0 + t)|^2
    C_PA(t) = sum_x Im[psi^+ gamma0 gamma5 psi](x, t0 + t)

(gamma0 gamma5 is anti-hermitian, so the bilinear is purely imaginary and the
correlator is its imaginary part).  The propagator is one `invert_eo` solve.
"""

from __future__ import annotations

import numpy as np
import torch

from tmlqcd_tpu_torch import rng
from tmlqcd_tpu_torch.gamma import GAMMA, GAMMA5
from tmlqcd_tpu_torch.inverter import invert_eo
from tmlqcd_tpu_torch.lattice import Lattice
from tmlqcd_tpu_torch.meas.sources import volume_source, z2_timeslice_source
from tmlqcd_tpu_torch.ops.wilson import DiracParams, spin_apply

__all__ = ["pion_correlator", "pa_correlator", "online_measurement", "effective_mass",
           "pion_norm"]


def pion_correlator(psi: torch.Tensor, lat: Lattice, t0: int = 0) -> torch.Tensor:
    """C_PP(t) [T] f64 from a propagator solve psi = M^{-1} eta, shifted so
    that index 0 is the source timeslice."""
    dens = torch.sum(psi.real.double() ** 2 + psi.imag.double() ** 2, dim=(0, 1, 3, 4))
    return torch.roll(dens, -t0)


def pa_correlator(psi: torch.Tensor, lat: Lattice, t0: int = 0) -> torch.Tensor:
    """C_PA0(t) [T] f64: gamma0 gamma5 inserted at the sink, imaginary part."""
    g0g5 = torch.as_tensor(GAMMA[0] @ GAMMA5, dtype=psi.dtype, device=psi.device)
    gpsi = spin_apply(g0g5, psi)
    corr = torch.sum((torch.conj_physical(psi) * gpsi).imag.double(), dim=(0, 1, 3, 4))
    return torch.roll(corr, -t0)


def online_measurement(u: torch.Tensor, params: DiracParams, lat: Lattice, key: rng.Key,
                       t0: int | None = None, tol: float = 1e-10, maxiter: int = 5000,
                       source: torch.Tensor | None = None):
    """One online measurement: random-timeslice Z2 source -> invert ->
    (C_PP [T], C_PA [T], t0), normalised by the spatial volume.

    `t0` and `source` inject the timeslice and the source instead of drawing
    them from `key` (purposes 0 and 1); the parity tests feed the reference's
    draws this way."""
    if t0 is None:
        t0 = rng.randint(key.fold(0), 0, lat.dims[0])
    src = (source if source is not None
           else z2_timeslice_source(lat, t0, key.fold(1), device=u.device))
    res = invert_eo(u, src, params, lat, tol=tol, maxiter=maxiter)
    norm = 1.0 / (lat.volume / lat.dims[0])
    return pion_correlator(res.x, lat, t0) * norm, pa_correlator(res.x, lat, t0) * norm, t0


def pion_norm(u: torch.Tensor, params: DiracParams, lat: Lattice, key: rng.Key,
              tol: float = 1e-10, maxiter: int = 5000,
              source: torch.Tensor | None = None) -> torch.Tensor:
    """Per-timeslice pion norm from a volume Z2 source (the PIONNORM
    measurement): one solve, normalised by the spatial volume.  C(t) [T] f64."""
    src = source if source is not None else volume_source(lat, key, device=u.device)
    res = invert_eo(u, src, params, lat, tol=tol, maxiter=maxiter)
    return pion_correlator(res.x, lat, 0) / (lat.volume / lat.dims[0])


def effective_mass(corr) -> np.ndarray:
    """Cosh effective mass am_eff(t) solving
    C(t-1)/C(t+1) = cosh(m(t-1-T/2))/cosh(m(t+1-T/2)) by bisection."""
    corr = np.asarray(corr, np.float64)
    t_ext = len(corr)
    half = t_ext // 2
    out = np.full(t_ext, np.nan)
    for t in range(1, t_ext - 1):
        ratio = corr[t - 1] / corr[t + 1] if corr[t + 1] != 0 else np.nan
        if not np.isfinite(ratio) or ratio <= 1.0:
            continue
        lo, hi = 1e-8, 10.0

        def f(m, t=t, ratio=ratio):
            return np.cosh(m * (t - 1 - half)) / np.cosh(m * (t + 1 - half)) - ratio

        if f(lo) * f(hi) > 0:
            continue
        for _ in range(100):
            mid = 0.5 * (lo + hi)
            if f(lo) * f(mid) <= 0:
                hi = mid
            else:
                lo = mid
        out[t] = 0.5 * (lo + hi)
    return out
