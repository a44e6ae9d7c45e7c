"""Gauge observables: Polyakov loops, oriented plaquettes, the clover
topological charge and the field-strength record.

Port of `tmlqcd_tpu/meas/gauge_obs.py` (reference: polyakov_loop.c,
meas/oriented_plaquettes.c, measure_clover_field_strength_observables.c).
Volume sums accumulate in f64.  Layout: gauge u [3, 3, 4 mu, T, X, Y*Z].
"""

from __future__ import annotations

import math

import torch

from tmlqcd_tpu_torch import su3
from tmlqcd_tpu_torch.lattice import Lattice
from tmlqcd_tpu_torch.ops.clover import PLANES, field_strength
from tmlqcd_tpu_torch.ops.gauge_action import plaquette_field

__all__ = [
    "polyakov_loop",
    "oriented_plaquettes",
    "topological_charge",
    "field_strength_observables",
]


def polyakov_loop(u: torch.Tensor, lat: Lattice, direction: int = 0) -> torch.Tensor:
    """Volume-averaged Polyakov loop <(1/3) tr prod U_dir(x)> along
    `direction` (complex128 scalar): the ordered product of the link slices
    along that axis, taken as a running product."""
    links = u[:, :, direction]
    if direction >= 2:
        # y and z share the flattened minor axis: expose them
        t, x, y, z = lat.dims
        links = links.reshape(3, 3, t, x, y, z)
    axis = {0: 2, 1: 3, 2: 4, 3: 5}[direction]
    prod = None
    for i in range(links.shape[axis]):
        s = links.select(axis, i)
        prod = s if prod is None else su3.mul(prod, s)
    return torch.mean((su3.trace(prod) / 3.0).to(torch.complex128))


def oriented_plaquettes(u: torch.Tensor, lat: Lattice) -> torch.Tensor:
    """Per-plane plaquette averages [6] in plane order (01, 02, 03, 12, 13,
    23), f64."""
    vals = [torch.mean(su3.re_trace(plaquette_field(u, mu, nu, lat)).double()) / 3.0
            for mu in range(4) for nu in range(mu + 1, 4)]
    return torch.stack(vals)


def topological_charge(u: torch.Tensor, lat: Lattice) -> torch.Tensor:
    """Field-theoretic topological charge from the clover field strength,

        Q = 1/(32 pi^2) sum_x eps_{mu nu rho sigma} tr[G_munu G_rhosigma]
          = 1/(4 pi^2) sum_x Re tr[G_01 G_23 - G_02 G_13 + G_03 G_12]

    (unsmoothed; near-integer after gradient flow).  f64 scalar."""
    gs = field_strength(u, lat)
    index = {pl: k for k, pl in enumerate(PLANES)}
    q = torch.zeros((), dtype=torch.float64, device=u.device)
    for a, b, sign in (((0, 1), (2, 3), +1.0), ((0, 2), (1, 3), -1.0),
                       ((0, 3), (1, 2), +1.0)):
        tr = su3.trace(su3.mul(gs[index[a]], gs[index[b]]))
        q = q + sign * torch.sum(tr.real.double())
    return q / (4.0 * math.pi**2)


def field_strength_observables(u: torch.Tensor, lat: Lattice):
    """(E_plaq, E_clover, Q): the gauge energy density in both
    discretisations and the clover topological charge at flow time zero."""
    from tmlqcd_tpu_torch.meas.gradient_flow import energy_clover, energy_plaq

    return energy_plaq(u, lat), energy_clover(u, lat), topological_charge(u, lat)
