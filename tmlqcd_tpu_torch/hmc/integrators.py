"""Multi-timescale symplectic MD integrators: leapfrog, 2MN (Omelyan) and
2MNPOSITION, recursively nested.

Port of `tmlqcd_tpu/hmc/integrators.py`.  `_expand_schedule` is the
reference's (numpy, unchanged): it flattens the recursion into S+1
per-monomial kick-coefficient rows interleaved with S drifts.  `integrate`
walks that schedule in a plain Python loop: a force is computed only where
its coefficient is non-zero (the reference's `lax.cond`), and each
monomial's force-solve iterations are summed.

Force convention: momenta P traceless anti-hermitian, E = |P|^2, drift
dU/dt = P U, force F = TA(U (dS/dU)^T); H is conserved with dP/dt = F/2,
the 1/2 absorbed into the kick.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tmlqcd_tpu_torch import su3
from tmlqcd_tpu_torch.utils import span

__all__ = ["Level", "IntegratorConfig", "integrate"]

LAMBDA_2MN = 0.1931833275037836


@dataclasses.dataclass(frozen=True)
class Level:
    """One timescale: scheme 'leapfrog' | '2mn' | '2mnposition', n_steps."""

    scheme: str = "2mn"
    steps: int = 1

    def __post_init__(self):
        if self.scheme not in ("leapfrog", "2mn", "2mnposition"):
            raise ValueError(f"unknown scheme {self.scheme}")


@dataclasses.dataclass(frozen=True)
class IntegratorConfig:
    """tau: trajectory length; levels[0] = finest timescale."""

    tau: float
    levels: tuple[Level, ...]


def _expand_schedule(cfg: IntegratorConfig, timescales) -> tuple:
    """Symbolically execute the recursive multi-timescale scheme into a FLAT
    static schedule: (kick_coeffs [S+1, nm] f64, drift_dts [S+1] f64) with
    drift_dts[-1] == 0.  Copied from the reference unchanged."""
    nm = len(timescales)
    events: list = []  # ('kick', lvl, coeff) | ('drift', dt)

    def rec_level(lvl: int, t: float):
        n = cfg.levels[lvl].steps
        dt = t / n
        scheme = cfg.levels[lvl].scheme
        lam = LAMBDA_2MN
        if scheme == "leapfrog":
            kicks = np.full(n + 1, dt)
            kicks[0] = kicks[-1] = 0.5 * dt
            items = []
            for i, c in enumerate(kicks):
                items.append(("k", float(c)))
                if i < n:
                    items.append(("a", dt))
        elif scheme == "2mn":
            kicks = np.empty(2 * n + 1)
            kicks[0::2] = 2.0 * lam * dt
            kicks[1::2] = (1.0 - 2.0 * lam) * dt
            kicks[0] = kicks[-1] = lam * dt
            items = []
            for i, c in enumerate(kicks):
                items.append(("k", float(c)))
                if i < 2 * n:
                    items.append(("a", 0.5 * dt))
        else:  # 2mnposition: the position version starts/ends with a drift
            advs = np.empty(2 * n + 1)
            advs[0::2] = 2.0 * lam * dt
            advs[1::2] = (1.0 - 2.0 * lam) * dt
            advs[0] = advs[-1] = lam * dt
            items = []
            for i, a in enumerate(advs):
                items.append(("a", float(a)))
                if i < 2 * n:
                    items.append(("k", 0.5 * dt))
        for kind, val in items:
            if kind == "k":
                events.append(("kick", lvl, val))
            elif lvl == 0:
                events.append(("drift", val))
            else:
                rec_level(lvl - 1, val)

    rec_level(len(cfg.levels) - 1, cfg.tau)

    kick_rows: list = []
    drift_dts: list = []
    cur = np.zeros(nm)
    for ev in events:
        if ev[0] == "kick":
            _, lvl, c = ev
            for i, ts in enumerate(timescales):
                if ts == lvl:
                    cur[i] += c
        else:
            _, dt = ev
            if not cur.any() and drift_dts:
                # empty timescale: no kick between two drifts — merge them
                drift_dts[-1] += dt
            else:
                kick_rows.append(cur)
                drift_dts.append(dt)
                cur = np.zeros(nm)
    kick_rows.append(cur)
    drift_dts.append(0.0)
    return np.stack(kick_rows), np.asarray(drift_dts)


def integrate(cfg: IntegratorConfig, monomials, aux_list, u, p, chrono=None,
              freeze_mask=None):
    """Run one MD trajectory of length cfg.tau.

    `chrono` (optional): per-monomial ChronoHistory (or None) entries; kicks
    then call `force_chrono` so every force solve starts from the
    chronological guess, and the return is (u', p', chrono',
    force_iterations[n_monomials]).  Without it the return is (u', p').

    `freeze_mask` (optional, [4,T,X,Y*Z] 0/1): the links where it is 0 are
    the Schrödinger functional's frozen dofs; each drift restores them bit
    for bit after the SU(3) projection (the masked momenta keep them fixed
    up to the projection's rounding, the restore removes even that).

    Under a profiler each force call is the span `tmlqcd.force.<monomial
    name>` and each drift, restore included, `tmlqcd.drift` (`utils.span`)."""
    for m in monomials:
        if m.timescale >= len(cfg.levels):
            raise ValueError(f"monomial {m.name} on timescale {m.timescale} but only "
                             f"{len(cfg.levels)} integrator levels configured")
    nm = len(monomials)
    kick_rows, drift_dts = _expand_schedule(cfg, tuple(m.timescale for m in monomials))
    # f32 coefficients, as the reference rounds them
    kc = kick_rows.astype(np.float32)
    dd = drift_dts.astype(np.float32)
    frozen = None if freeze_mask is None else freeze_mask.to(u.device) == 0.0
    ch = list(chrono) if chrono is not None else [None] * nm
    its = [0] * nm
    force_spans = [f"tmlqcd.force.{m.name}" for m in monomials]
    for row, dt in zip(kc, dd):
        f = None
        for i, m in enumerate(monomials):
            c = float(row[i])
            if c == 0.0:
                continue
            with span(force_spans[i]):
                if ch[i] is not None and hasattr(m, "force_chrono"):
                    fi, ch[i], ki = m.force_chrono(u, aux_list[i], ch[i])
                    its[i] += int(ki)
                elif hasattr(m, "force_info"):
                    # solver-backed forces without chrono (the multishift
                    # solves of the rational monomials start from zero)
                    fi, ki = m.force_info(u, aux_list[i])
                    its[i] += int(ki)
                else:
                    fi = m.force(u, aux_list[i])
            f = c * fi if f is None else f + c * fi
        if f is not None:
            p = p + 0.5 * f
        if dt != 0.0:
            with span("tmlqcd.drift"):
                unew = su3.project_su3(su3.mul(su3.expm_ta(float(dt) * p), u))
                u = unew if frozen is None else torch.where(frozen, u, unew)
    if chrono is not None:
        return u, p, tuple(ch), its
    return u, p
