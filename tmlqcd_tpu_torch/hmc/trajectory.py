"""One HMC trajectory: momentum heatbath, pseudofermion heatbaths, MD
integration, Metropolis accept/reject.

Port of `tmlqcd_tpu/hmc/trajectory.py`.  The Metropolis select, and the
chrono reset on reject, are a plain `if`.  Random draws come from `rng.Key`
purposes (0: momenta, 1: heatbaths, folded with 1000 + monomial index, 2:
the Metropolis uniform); `draws=` injects them instead, which is how the
parity tests feed the reference's draws to the port.  Under a profiler the
three phases are the spans `tmlqcd.hmc.heatbath`, `tmlqcd.hmc.md` and
`tmlqcd.hmc.accept` (`utils.span`).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import torch

from tmlqcd_tpu_torch import rng, su3
from tmlqcd_tpu_torch.comm import global_max
from tmlqcd_tpu_torch.hmc.integrators import IntegratorConfig, integrate
from tmlqcd_tpu_torch.ops.gauge_action import plaquette
from tmlqcd_tpu_torch.utils import span

__all__ = ["HMCConfig", "Draws", "TrajectoryStats", "hmc_trajectory", "chrono_states",
           "reversibility_check"]


@dataclasses.dataclass(frozen=True)
class HMCConfig:
    """Lattice + action (monomial tuple) + integrator, and the (t, y) slab
    mesh (`parallel.Mesh`) that the solving monomials were built with, or
    None.  `momenta_mask` (optional [4,T,X,Y*Z] 0/1, the Schrödinger
    functional's `ops.sf.sf_momenta_mask`) is multiplied into the momenta
    after the heatbath and freezes the links where it is 0 at every drift;
    None = all links dynamical."""

    lat: object
    monomials: tuple
    integrator: IntegratorConfig
    mesh: object = None
    momenta_mask: object = None


class Draws(NamedTuple):
    """Externally supplied random draws of one trajectory: momenta
    [3,3,4,T,X,Mf] complex, one complex eta [4,3,T,X,M] per monomial (None
    for monomials without a pseudofermion) and the Metropolis uniform."""

    momenta: torch.Tensor
    etas: Sequence
    uniform: float


class TrajectoryStats(NamedTuple):
    """Per-trajectory observables (the output.data columns)."""

    plaquette: float
    delta_h: float
    exp_mdh: float
    accepted: bool
    h_old: float
    h_new: float
    acc_iterations: list  # per monomial (0 where no solve)
    force_iterations: list  # per monomial, summed over the MD force solves


def chrono_states(cfg: HMCConfig, device) -> tuple:
    """Per-monomial empty chronological-guess histories (None where the
    monomial has none)."""
    return tuple(m.chrono_init_state(device) if hasattr(m, "chrono_init_state") else None
                 for m in cfg.monomials)


def _masked(cfg: HMCConfig, p: torch.Tensor) -> torch.Tensor:
    """The momenta with the frozen dofs zeroed (no kinetic term, no drift)."""
    return p if cfg.momenta_mask is None else p * cfg.momenta_mask.to(p.device)


def hmc_trajectory(cfg: HMCConfig, u: torch.Tensor, key: rng.Key, chrono=None,
                   draws: Draws | None = None):
    """(U, key) -> (U', TrajectoryStats), or (U', stats, chrono') when the
    caller carries `chrono` across trajectories (reset to empty on reject)."""
    device = u.device
    k_mom, k_pf, k_acc = key.fold(0), key.fold(1), key.fold(2)
    with span("tmlqcd.hmc.heatbath"):
        p = _masked(cfg, draws.momenta if draws is not None
                    else rng.random_momenta(k_mom, u.shape[2:], device, lat=cfg.lat))
        aux_list = []
        s_old = torch.zeros((), dtype=torch.float64, device=device)
        for i, m in enumerate(cfg.monomials):
            eta = draws.etas[i] if draws is not None else None
            aux, s0 = m.heatbath(u, k_pf.fold(1000 + i), eta)
            aux_list.append(aux)
            s_old = s_old + s0
        h_old = su3.kinetic_energy(p) + s_old

    ch0 = chrono_states(cfg, device) if chrono is None else chrono
    with span("tmlqcd.hmc.md"):
        u_new, p_new, ch, force_iters = integrate(cfg.integrator, cfg.monomials, aux_list, u, p,
                                                  chrono=ch0, freeze_mask=cfg.momenta_mask)

    with span("tmlqcd.hmc.accept"):
        s_new = torch.zeros((), dtype=torch.float64, device=device)
        iters = []
        for i, m in enumerate(cfg.monomials):
            s_i, it_i = m.action_info(u_new, aux_list[i], ch[i])
            s_new = s_new + s_i
            iters.append(int(it_i))
        h_new = su3.kinetic_energy(p_new) + s_new

        dh = h_new - h_old
        exp_mdh = torch.exp(-dh)
        uni = draws.uniform if draws is not None else rng.uniform(k_acc, device)
        accept = bool(torch.tensor(float(uni), dtype=torch.float32).double() < exp_mdh.cpu())
        u_out = u_new if accept else u

        stats = TrajectoryStats(
            plaquette=float(plaquette(u_out, cfg.lat)),
            delta_h=float(dh),
            exp_mdh=float(exp_mdh),
            accepted=accept,
            h_old=float(h_old),
            h_new=float(h_new),
            acc_iterations=iters,
            force_iterations=list(force_iters),
        )
    if chrono is not None:
        return u_out, stats, (ch if accept else chrono_states(cfg, device))
    return u_out, stats


def reversibility_check(cfg: HMCConfig, u: torch.Tensor, key: rng.Key,
                        draws: Draws | None = None):
    """Integrate forward, flip the momenta, integrate back; returns |ddH| and
    the largest deviation of the gauge field from its start (the
    ReversibilityCheck input key).  Draws as in `hmc_trajectory` (purposes 0
    and 1; the uniform is not used)."""
    device = u.device
    k_mom, k_pf = key.fold(0), key.fold(1)
    p = _masked(cfg, draws.momenta if draws is not None
                else rng.random_momenta(k_mom, u.shape[2:], device, lat=cfg.lat))
    aux_list = []
    s_old = torch.zeros((), dtype=torch.float64, device=device)
    for i, m in enumerate(cfg.monomials):
        aux, s0 = m.heatbath(u, k_pf.fold(1000 + i), draws.etas[i] if draws is not None else None)
        aux_list.append(aux)
        s_old = s_old + s0
    h_old = su3.kinetic_energy(p) + s_old

    u1, p1 = integrate(cfg.integrator, cfg.monomials, aux_list, u, p,
                       freeze_mask=cfg.momenta_mask)
    u2, p2 = integrate(cfg.integrator, cfg.monomials, aux_list, u1, -p1,
                       freeze_mask=cfg.momenta_mask)

    s_back = torch.zeros((), dtype=torch.float64, device=device)
    for i, m in enumerate(cfg.monomials):
        s_back = s_back + m.action_info(u2, aux_list[i])[0]
    h_back = su3.kinetic_energy(p2) + s_back
    return float(torch.abs(h_back - h_old)), float(global_max(torch.max(torch.abs(u2 - u))))
