"""Wilson (gradient) flow with Luscher's 3-stage Runge-Kutta integrator,
the energy densities E(t) and the t0 scale.

Port of `tmlqcd_tpu/meas/gradient_flow.py` (reference:
meas/gradient_flow.c).  Flow equation (Luscher, arXiv:1006.4518):
V' = Z(V) V, with the generator Z(V) = gauge_force(V, beta = 3) of this
package's force convention (see `_z`).  RK3:

    W0 = V
    W1 = exp(1/4 Z0) W0
    W2 = exp(8/9 Z1 - 17/36 Z0) W1
    V' = exp(3/4 Z2 - 8/9 Z1 + 17/36 Z0) W2,   Zi = eps Z(Wi)

The reference's `lax.scan` over the steps is a Python loop; the energies of
every step stay on the device until the flow ends.  On one rank's slab of a
distributed run the flow's shifts cross the ranks (`lattice.shift_full`)
and the energies are sums over the ranks (`comm.global_sum`) divided by the
global volume.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tmlqcd_tpu_torch import su3
from tmlqcd_tpu_torch.comm import global_max, global_sum
from tmlqcd_tpu_torch.lattice import Lattice
from tmlqcd_tpu_torch.ops.clover import field_strength
from tmlqcd_tpu_torch.ops.gauge_action import gauge_force, plaquette_field

__all__ = ["wilson_flow_step", "wilson_flow", "wilson_flow_adaptive", "energy_plaq",
           "energy_clover", "t0_scale", "FlowResult"]


def _z(v: torch.Tensor, lat: Lattice) -> torch.Tensor:
    """Flow generator Z(V) = +gauge_force(V, beta=3).

    Sign: F = TA(U dS/dU^T) satisfies dS/d_eps = tr(F P) along dU = eps P U,
    and tr(A B) is negative-definite on antihermitian matrices, so F itself
    is the descent direction: dS/dt = tr(F F) < 0.  The beta = 3
    normalisation is calibrated against the exact linearised decay
    exp(-t phat^2) of a transverse plane wave (with this package's
    ta_project and single-counted mu < nu plaquette sum the generator on an
    abelian mode is -(beta/3) phat^2 theta);
    tests/test_torch_gauge_obs.py::test_flow_free_field_decay pins it to 2 %.
    """
    return gauge_force(v, 3.0, lat, 0.0)


def wilson_flow_step(v: torch.Tensor, eps: float, lat: Lattice) -> torch.Tensor:
    """One RK3 step of flow time eps."""
    z0 = eps * _z(v, lat)
    w1 = su3.mul(su3.expm_ta(0.25 * z0), v)
    z1 = eps * _z(w1, lat)
    w2 = su3.mul(su3.expm_ta((8.0 / 9.0) * z1 - (17.0 / 36.0) * z0), w1)
    z2 = eps * _z(w2, lat)
    v3 = su3.mul(su3.expm_ta(0.75 * z2 - (8.0 / 9.0) * z1 + (17.0 / 36.0) * z0), w2)
    return su3.project_su3(v3)


def energy_plaq(v: torch.Tensor, lat: Lattice) -> torch.Tensor:
    """Plaquette discretisation E = 2 sum_{mu<nu} Re tr(1 - P_munu) / V (f64)."""
    acc = torch.zeros((), dtype=torch.float64, device=v.device)
    for mu in range(4):
        for nu in range(mu + 1, 4):
            acc = acc + torch.sum((3.0 - su3.re_trace(plaquette_field(v, mu, nu, lat))).double())
    return 2.0 * global_sum(acc) / lat.global_volume


def energy_clover(v: torch.Tensor, lat: Lattice) -> torch.Tensor:
    """Clover discretisation E = sum_{mu<nu} tr(G G) / V (f64); for
    hermitian G, tr(G G) = sum |G_ij|^2."""
    acc = torch.zeros((), dtype=torch.float64, device=v.device)
    for g in field_strength(v, lat):
        acc = acc + torch.sum(g.real.double() ** 2 + g.imag.double() ** 2)
    return global_sum(acc) / lat.global_volume


class FlowResult(NamedTuple):
    times: torch.Tensor  # [n] flow times (f64)
    t2e_plaq: torch.Tensor  # [n] t^2 E_plaq(t)
    t2e_clover: torch.Tensor  # [n] t^2 E_clover(t)
    v: torch.Tensor  # the flowed field at the final time


def wilson_flow(v: torch.Tensor, lat: Lattice, eps: float = 0.02,
                n_steps: int = 50) -> FlowResult:
    """Flow to t = eps * n_steps, recording t^2 E(t) after every step (the
    GRADIENTFLOW measurement)."""
    times, e_p, e_c = [], [], []
    for i in range(n_steps):
        v = wilson_flow_step(v, eps, lat)
        t = (i + 1.0) * eps
        times.append(t)
        e_p.append(t * t * energy_plaq(v, lat))
        e_c.append(t * t * energy_clover(v, lat))
    f64 = dict(dtype=torch.float64, device=v.device)
    return FlowResult(times=torch.tensor(times, **f64),
                      t2e_plaq=torch.stack(e_p) if e_p else torch.zeros(0, **f64),
                      t2e_clover=torch.stack(e_c) if e_c else torch.zeros(0, **f64), v=v)


def t0_scale(times, t2e, target: float = 0.3) -> float:
    """t0: the flow time where t^2 E(t) = target, by linear interpolation
    (nan when the flow never reaches it)."""
    times = np.asarray(times)
    vals = np.asarray(t2e)
    above = np.nonzero(vals >= target)[0]
    if len(above) == 0:
        return float("nan")
    i = above[0]
    if i == 0:
        return float(times[0])
    t1, t2 = times[i - 1], times[i]
    v1, v2 = vals[i - 1], vals[i]
    return float(t1 + (target - v1) * (t2 - t1) / (v2 - v1))


def wilson_flow_adaptive(v: torch.Tensor, lat: Lattice, t_max: float, eps0: float = 0.01,
                         tol: float = 1e-6, max_steps: int = 2000):
    """Adaptive-step Wilson flow by step doubling: one eps step against two
    eps/2 steps, max|U1 - U2| as the local error estimate; a step is taken
    when the error is below `tol`, and eps adapts by the order-3 rule (safety
    0.9, factor within [0.2, 2]).  Returns (flowed field, times, t^2 E_plaq)
    as numpy arrays for the last two."""
    t, eps = 0.0, float(eps0)
    times, t2e = [], []
    for _ in range(max_steps):
        if t >= t_max:
            break
        eps = min(eps, t_max - t)
        u1 = wilson_flow_step(v, eps, lat)
        u2 = wilson_flow_step(wilson_flow_step(v, eps / 2.0, lat), eps / 2.0, lat)
        err = float(global_max(torch.max(torch.abs(u1 - u2))))
        if err < tol or eps <= 1e-6:
            v = u2
            t += eps
            times.append(t)
            t2e.append(t * t * float(energy_plaq(v, lat)))
        eps = eps * min(2.0, max(0.2, 0.9 * (tol / max(err, 1e-300)) ** (1.0 / 3.0)))
    return v, np.asarray(times), np.asarray(t2e)
