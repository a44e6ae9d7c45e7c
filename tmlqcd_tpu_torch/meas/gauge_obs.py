"""Gauge observables: Polyakov loops, oriented plaquettes, the clover
topological charge and the field-strength record.

Port of `tmlqcd_tpu/meas/gauge_obs.py` (reference: polyakov_loop.c,
meas/oriented_plaquettes.c, measure_clover_field_strength_observables.c).
Volume sums accumulate in f64.  Layout: gauge u [3, 3, 4 mu, T, X, Y*Z].

On one rank's slab of a distributed run (`lat` carries the mesh) the sums
go through `comm.global_sum` over the global volume, and every rank returns
the whole lattice's value.  The Polyakov loop along a cut axis (t, or y) is
a product that does not commute: each rank multiplies its slab's slices
in order, the ranks gather these partial products (`comm.all_gather`, one
[3, 3, ...] per rank, a slice's size), and each multiplies its line's
partials in global order; the product is never summed or reduced.  Its
factors are associated otherwise than in one process, so it equals one
process's to the field's rounding, not bit for bit.
"""

from __future__ import annotations

import math

import torch

from tmlqcd_tpu_torch import su3
from tmlqcd_tpu_torch.comm import all_gather, global_sum
from tmlqcd_tpu_torch.lattice import Lattice
from tmlqcd_tpu_torch.ops.clover import PLANES, field_strength
from tmlqcd_tpu_torch.ops.gauge_action import plaquette_field

__all__ = [
    "polyakov_loop",
    "oriented_plaquettes",
    "topological_charge",
    "field_strength_observables",
]


def _ordered_product(links: torch.Tensor, axis: int) -> torch.Tensor:
    """The product of the [3, 3] slices of `links` [3, 3, ...] along `axis`
    in the axis's order, as a running product -> [3, 3, ...] without it."""
    prod = None
    for i in range(links.shape[axis]):
        s = links.select(axis, i)
        prod = s if prod is None else su3.mul(prod, s)
    return prod


def _line_product(prod: torch.Tensor, axis: int, lat: Lattice) -> tuple[torch.Tensor, bool]:
    """The whole lines' product along `axis` (2: t, 4: y) from this slab's
    partial product `prod` [3, 3, ...]: the partials of every rank are
    gathered (`comm.all_gather`), those of this rank's line picked out and
    multiplied in their order along the axis; and whether this rank sums
    the lines (the first rank of its line, so each line counts once)."""
    mesh = lat.mesh
    cut = None if mesh is None else {2: ("t", mesh.t), 4: ("y", mesh.y)}.get(axis)
    if cut is None or cut[1] == 1:
        return prod, True
    i, j = mesh.coords
    parts = all_gather(prod.contiguous())
    line = ([parts[k * mesh.y + j] for k in range(mesh.t)] if cut[0] == "t"
            else [parts[i * mesh.y + k] for k in range(mesh.y)])
    return _ordered_product(torch.stack(line, dim=2), 2), (i if cut[0] == "t" else j) == 0


def polyakov_loop(u: torch.Tensor, lat: Lattice, direction: int = 0) -> torch.Tensor:
    """Volume-averaged Polyakov loop <(1/3) tr prod U_dir(x)> along
    `direction` (complex128 scalar): the ordered product of the link slices
    along that axis, taken as a running product (on a slab, the slab's
    partial product, then the line's partials in order)."""
    t, x, y, z = lat.dims
    axis = direction + 2
    prod = _ordered_product(u[:, :, direction].reshape(3, 3, t, x, y, z), axis)
    prod, counts = _line_product(prod, axis, lat)
    tr = (su3.trace(prod) / 3.0).to(torch.complex128)
    part = torch.stack([tr.real.sum(), tr.imag.sum()]) if counts else torch.zeros(
        2, dtype=torch.float64, device=u.device)
    re, im = global_sum(part) / (lat.global_volume // lat.global_dims[direction])
    return torch.complex(re, im)


def oriented_plaquettes(u: torch.Tensor, lat: Lattice) -> torch.Tensor:
    """Per-plane plaquette averages [6] in plane order (01, 02, 03, 12, 13,
    23), f64."""
    vals = [torch.sum(su3.re_trace(plaquette_field(u, mu, nu, lat)).double())
            for mu in range(4) for nu in range(mu + 1, 4)]
    return global_sum(torch.stack(vals)) / lat.global_volume / 3.0


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
    return global_sum(q) / (4.0 * math.pi**2)


def field_strength_observables(u: torch.Tensor, lat: Lattice):
    """(E_plaq, E_clover, Q): the gauge energy density in both
    discretisations and the clover topological charge at flow time zero."""
    from tmlqcd_tpu_torch.meas.gradient_flow import energy_clover, energy_plaq

    return energy_plaq(u, lat), energy_clover(u, lat), topological_charge(u, lat)
