"""Gauge action, plaquette/rectangle observables and the MD gauge force.

Port of `tmlqcd_tpu/ops/gauge_action.py`:

    S_g = beta * sum_x [ c0 * sum_{mu<nu} (1 - Re tr P_munu / 3)
                       + c1 * sum_{mu!=nu} (1 - Re tr R_munu / 3) ],  c0 = 1 - 8 c1.

Gradient convention: `ta_force_from_grad` expects the reference's (JAX's)
convention dS = Re sum(G dU).  PyTorch's `.grad` of a real loss with respect
to a complex leaf is the complex CONJUGATE of that G, so callers pass
`grad.conj()` (see `gauge_force` and `hmc/monomials.py`).

Layout: gauge u [3, 3, 4 mu, T, X, Y*Z].
"""

from __future__ import annotations

import torch

from tmlqcd_tpu_torch import su3
from tmlqcd_tpu_torch.comm import global_sum
from tmlqcd_tpu_torch.lattice import Lattice, shift_full

__all__ = [
    "plaquette_field",
    "plaquette",
    "rectangle",
    "gauge_action",
    "staple_sum",
    "gauge_force",
    "ta_force_from_grad",
    "torch_grad_to_jax",
]


def plaquette_field(u: torch.Tensor, mu: int, nu: int, lat: Lattice) -> torch.Tensor:
    """P_munu(x) = U_mu(x) U_nu(x+mu) U_mu(x+nu)^+ U_nu(x)^+ as [3,3,T,X,Mf]."""
    umu, unu = u[:, :, mu], u[:, :, nu]
    v = su3.mul(umu, shift_full(unu, mu, +1, lat))
    w = su3.mul(unu, shift_full(umu, nu, +1, lat))
    return su3.mul(v, su3.adj(w))


def rectangle_field(u: torch.Tensor, mu: int, nu: int, lat: Lattice) -> torch.Tensor:
    """1x2 rectangle R_munu(x): two steps in mu, one in nu."""
    umu, unu = u[:, :, mu], u[:, :, nu]
    unu_2mu = shift_full(shift_full(unu, mu, +1, lat), mu, +1, lat)
    top = su3.mul(su3.mul(umu, shift_full(umu, mu, +1, lat)), unu_2mu)
    umu_nu = shift_full(umu, nu, +1, lat)
    bottom = su3.mul(su3.mul(unu, umu_nu), shift_full(umu_nu, mu, +1, lat))
    return su3.mul(top, su3.adj(bottom))


def _plaq_sum(u: torch.Tensor, lat: Lattice) -> torch.Tensor:
    acc = torch.zeros((), dtype=torch.float64, device=u.device)
    for mu in range(4):
        for nu in range(mu + 1, 4):
            acc = acc + torch.sum(su3.re_trace(plaquette_field(u, mu, nu, lat)).double())
    return global_sum(acc)


def _rect_sum(u: torch.Tensor, lat: Lattice) -> torch.Tensor:
    acc = torch.zeros((), dtype=torch.float64, device=u.device)
    for mu in range(4):
        for nu in range(4):
            if nu != mu:
                acc = acc + torch.sum(su3.re_trace(rectangle_field(u, mu, nu, lat)).double())
    return global_sum(acc)


def plaquette(u: torch.Tensor, lat: Lattice) -> torch.Tensor:
    """Average plaquette <Re tr P / 3> (f64 accumulation)."""
    return _plaq_sum(u, lat) / (6.0 * 3.0 * lat.global_volume)


def rectangle(u: torch.Tensor, lat: Lattice) -> torch.Tensor:
    """Average 1x2 rectangle <Re tr R / 3> over the 12 oriented planes."""
    return _rect_sum(u, lat) / (12.0 * 3.0 * lat.global_volume)


def gauge_action(u: torch.Tensor, beta: float, lat: Lattice, c1: float = 0.0) -> torch.Tensor:
    """S_g[U], per-site traces upcast to f64 before the volume sum."""
    c0 = 1.0 - 8.0 * c1
    s = c0 * (6.0 * lat.global_volume - _plaq_sum(u, lat) / 3.0)
    if c1 != 0.0:
        s = s + c1 * (12.0 * lat.global_volume - _rect_sum(u, lat) / 3.0)
    return beta * s


def ta_force_from_grad(u: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Algebra-valued MD force F = TA(U G^T) from the raw gradient G of a
    real action in the dS = Re sum(G dU) convention (the reference's).
    Transpose = swap of the two leading colour axes, no conjugation."""
    return su3.ta_project(su3.mul(u, g.transpose(0, 1)))


def torch_grad_to_jax(g: torch.Tensor) -> torch.Tensor:
    """PyTorch's gradient of a real loss w.r.t. a complex leaf is the
    conjugate of the dS = Re sum(G dU) gradient; this converts it."""
    return torch.conj_physical(g)


def staple_sum(u: torch.Tensor, mu: int, lat: Lattice) -> torch.Tensor:
    """A_mu(x) = sum_{nu != mu} [forward + backward staple], so that the six
    plaquettes holding U_mu(x) sum to Re tr[U_mu(x) A_mu(x)]."""
    umu = u[:, :, mu]
    acc = None
    for nu in range(4):
        if nu == mu:
            continue
        unu = u[:, :, nu]
        unu_pmu = shift_full(unu, mu, +1, lat)
        fwd = su3.mul(su3.mul(unu_pmu, su3.adj(shift_full(umu, nu, +1, lat))), su3.adj(unu))
        bwd = shift_full(su3.mul(su3.mul(su3.adj(unu_pmu), su3.adj(umu)), unu), nu, -1, lat)
        term = fwd + bwd
        acc = term if acc is None else acc + term
    return acc


def gauge_force(u: torch.Tensor, beta: float, lat: Lattice, c1: float = 0.0) -> torch.Tensor:
    """MD gauge force, plaquette part summed from staples:
    F_mu(x) = -(beta c0 / 3) TA(U_mu(x) A_mu(x)); the rectangle part (c1 != 0)
    by autograd of the rectangle action."""
    c0 = 1.0 - 8.0 * c1
    scale = -(beta * c0) / 3.0
    f = torch.stack([su3.ta_project(scale * su3.mul(u[:, :, mu], staple_sum(u, mu, lat)))
                     for mu in range(4)], dim=2)
    if c1 != 0.0:
        with torch.enable_grad():
            uu = u.detach().requires_grad_(True)
            s = beta * c1 * (12.0 * lat.global_volume - _rect_sum(uu, lat) / 3.0)
            (g,) = torch.autograd.grad(s, uu)
        f = f + ta_force_from_grad(u, torch_grad_to_jax(g))
    return f
