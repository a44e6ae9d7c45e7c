"""Gauge action, plaquette/rectangle observables and the MD gauge force.

Port of `tmlqcd_tpu/ops/gauge_action.py`:

    S_g = beta * sum_x [ c0 * sum_{mu<nu} (1 - Re tr P_munu / 3)
                       + c1 * sum_{mu!=nu} (1 - Re tr R_munu / 3) ],  c0 = 1 - 8 c1.

Gradient convention: `ta_force_from_grad` expects the reference's (JAX's)
convention dS = Re sum(G dU).  PyTorch's `.grad` of a real loss with respect
to a complex leaf is the complex CONJUGATE of that G, so callers pass
`grad.conj()` (see `gauge_force_ad` and `hmc/monomials.py`).

Layout: gauge u [3, 3, 4 mu, T, X, Y*Z].
"""

from __future__ import annotations

import torch

from tmlqcd_tpu_torch import su3
from tmlqcd_tpu_torch.comm import global_sum
from tmlqcd_tpu_torch.lattice import Lattice, shift_full
from tmlqcd_tpu_torch.ops import dslash_cuda

__all__ = [
    "plaquette_field",
    "plaquette",
    "rectangle",
    "gauge_action",
    "gauge_force",
    "gauge_force_plain",
    "gauge_force_ad",
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


def gauge_force_plain(u: torch.Tensor, beta: float, lat: Lattice, c1: float = 0.0) -> torch.Tensor:
    """Plain version of the gauge-force kernel (`dslash_cuda.gauge_force_cuda`),
    the same staples on whole fields:

        F_mu(x) = TA(U_mu(x) [-(beta c0/3) A_mu(x) - (beta c1/3) R_mu(x)])

    A_mu the 6 plaquette staples, R_mu the 18 rectangle staples (1x2 and 2x1,
    both orientations, in each plane), so that the loops holding U_mu(x) sum
    to Re tr[U_mu(x) A] and Re tr[U_mu(x) R].  Grouped for few shifts (each
    one crosses the ranks on a distributed slab): with S the forward staple
    U_nu(x+mu) U_mu(x+nu)^+ U_nu(x)^+ or the backward one (a staple at
    x - nu, shifted), the rectangles of a plane are

        [U_mu S](x+mu) S(x) + S(x) [S U_mu](x-mu)       (2x1, each S)
        U_nu(x+mu) S_fwd(x+nu) U_nu(x)^+,  [U_nu(x+mu)^+ S_bwd U_nu](x-nu)   (1x2)

    3 shifts a plane for the plaquettes, 6 more for the rectangles."""
    gauge_force_plain.calls += 1
    c0 = 1.0 - 8.0 * c1
    cp, cr = -(beta * c0) / 3.0, -(beta * c1) / 3.0
    forces = []
    for mu in range(4):
        umu = u[:, :, mu]
        plaq = rect = None
        for nu in range(4):
            if nu == mu:
                continue
            unu = u[:, :, nu]
            unu_pmu = shift_full(unu, mu, +1, lat)
            fwd = su3.mul(su3.mul(unu_pmu, su3.adj(shift_full(umu, nu, +1, lat))), su3.adj(unu))
            bwd = shift_full(su3.mul(su3.mul(su3.adj(unu_pmu), su3.adj(umu)), unu), nu, -1, lat)
            term = fwd + bwd
            plaq = term if plaq is None else plaq + term
            if c1 == 0.0:
                continue
            term = (su3.mul(su3.mul(unu_pmu, shift_full(fwd, nu, +1, lat)), su3.adj(unu))
                    + shift_full(su3.mul(su3.mul(su3.adj(unu_pmu), bwd), unu), nu, -1, lat))
            for s in (fwd, bwd):
                term = (term + su3.mul(shift_full(su3.mul(umu, s), mu, +1, lat), s)
                        + su3.mul(s, shift_full(su3.mul(s, umu), mu, -1, lat)))
            rect = term if rect is None else rect + term
        acc = cp * plaq if rect is None else cp * plaq + cr * rect
        forces.append(su3.ta_project(su3.mul(umu, acc)))
    return torch.stack(forces, dim=2)


gauge_force_plain.calls = 0


def gauge_force_ad(u: torch.Tensor, beta: float, lat: Lattice, c1: float = 0.0) -> torch.Tensor:
    """F = TA(U G^T), G the autograd gradient of `gauge_action`: the oracle
    of the staple forces (the reference's `gauge_force_ad`)."""
    with torch.enable_grad():
        uu = u.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(gauge_action(uu, beta, lat, c1), uu)
    return ta_force_from_grad(u, torch_grad_to_jax(g))


def gauge_force(u: torch.Tensor, beta: float, lat: Lattice, c1: float = 0.0) -> torch.Tensor:
    """MD gauge force (`gauge_force_plain`'s formula).  A CUDA tensor of a
    whole lattice launches the kernel (`dslash_cuda.gauge_force_cuda`); a CPU
    tensor, or a slab of a distributed mesh (its shifts cross ranks), takes
    the plain version."""
    if u.device.type == "cuda" and lat.mesh is None:
        return dslash_cuda.gauge_force_cuda(u.resolve_conj().contiguous(), beta, c1, lat)
    return gauge_force_plain(u, beta, lat, c1)
