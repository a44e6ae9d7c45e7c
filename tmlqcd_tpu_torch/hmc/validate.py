"""On-init action validation: check that every rational or polynomial
monomial's approximation interval [s_min, s_max] brackets the spectrum of
its squared operator on the starting gauge configuration.

Port of `tmlqcd_tpu/hmc/validate.py`.  A mis-bracketed interval silently
spoils the exactness of the rational heatbath (and the polynomial's
approximation), so the spectrum of Q^2 is estimated
(`solvers.eigen.spectral_bounds`: power and inverse iteration) and a
violation is reported.  The operator is the monomial's own solve operator
(`q2_operator`): the kernel path for a gauge field on a CUDA device, the
plain path on the CPU.  For a polynomial monomial (NDPOLY) the maximal
relative error of its polynomial on [s_min, s_max] is printed too.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tmlqcd_tpu_torch import rng
from tmlqcd_tpu_torch.solvers.eigen import spectral_bounds

__all__ = ["IntervalCheck", "check_rational_intervals"]


class IntervalCheck(NamedTuple):
    name: str
    s_min: float
    s_max: float
    lambda_min: float
    lambda_max: float
    ok: bool


def check_rational_intervals(hmc_cfg, u: torch.Tensor, key: rng.Key | None = None,
                             strict: bool = False, verbose: bool = True) -> list[IntervalCheck]:
    """Estimate spec(Q^2) for every rational or polynomial monomial (each
    carries an approximation interval) and compare it with [s_min, s_max].
    strict=True raises on a violation; otherwise a warning is printed.  Run
    once per job, after the starting configuration is loaded."""
    if key is None:
        key = rng.Key(97)
    out: list[IntervalCheck] = []
    for i, m in enumerate(getattr(hmc_cfg, "monomials", hmc_cfg)):
        if not (hasattr(m, "s_min") and hasattr(m, "s_max") and hasattr(m, "q2_operator")):
            continue
        with torch.no_grad():
            mv, shape = m.q2_operator(u)
            lmin, lmax = spectral_bounds(mv, shape, key.fold(i), device=u.device, safety=1.0,
                                         split=True)
        ok = (m.s_min <= lmin) and (lmax <= m.s_max)
        if verbose and hasattr(m, "max_rel_err"):
            print(f"[validate] {m.name}: polynomial degree {m.degree}, max relative error "
                  f"{m.max_rel_err:.3e} of P(x) x^(1/4) on [{m.s_min:.3e}, {m.s_max:.3e}]",
                  flush=True)
        out.append(IntervalCheck(m.name, m.s_min, m.s_max, lmin, lmax, ok))
        if not ok:
            msg = (f"monomial {m.name}: spec(Q^2) ~ [{lmin:.3e}, {lmax:.3e}] NOT bracketed by "
                   f"[StildeMin, StildeMax] = [{m.s_min:.3e}, {m.s_max:.3e}] — the rational or "
                   f"polynomial approximation is invalid there")
            if strict:
                raise ValueError(msg)
            print(f"[validate] WARNING: {msg}", flush=True)
        elif verbose:
            print(f"[validate] {m.name}: spec(Q^2) ~ [{lmin:.3e}, {lmax:.3e}] within "
                  f"[{m.s_min:.3e}, {m.s_max:.3e}] ok", flush=True)
    return out
