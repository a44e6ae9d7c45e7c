"""Lattice geometry: dimensions, even/odd packing, neighbour shifts.

Port of `tmlqcd_tpu/lattice.py`.  Fields keep the reference's
structure-of-arrays layout (spin/colour axes leading, site axes trailing, the
last two site axes flattened):

    spinor  (packed e/o): [4 spin, 3 colour, T, X, M]    M  = Y * Z/2
    spinor  (full)      : [4, 3, T, X, Mf]               Mf = Y * Z
    gauge   (full)      : [3, 3, 4 mu, T, X, Mf]
    gauge   (packed)    : [2 parity, 3, 3, 4, T, X, M]

Even/odd packing: site parity p = (t+x+y+z) % 2; a parity-p field stores, at
flat site m = y*(Z/2) + k, the value at z = 2k + s with slot
s = (t+x+y+p) % 2.  Shifts in t/x/y map parity p <-> 1-p at the same k (plain
rolls; a roll by Z/2 on the flat axis for y); shifts in z select between k and
k+-1 with a wrap inside the y-block (two rolls + masks, see `hop_packed`).

One rank's slab of a distributed run is a `Lattice` of the slab's dims that
carries its `parallel.Mesh` (`mesh.local(lat)`): the shapes are the slab's,
`global_dims` / `global_volume` the whole lattice's, and every shift along
t or y crosses ranks through `comm.dist_roll` while that mesh is the
process's decomposition (`comm.require`; the z wrap stays inside a
y-row, so inside the slab; the masks read local coordinates, which give the
global parity since T_loc and Y_loc are even).
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

from tmlqcd_tpu_torch.comm import dist_roll, require

__all__ = [
    "Lattice",
    "EVEN",
    "ODD",
    "shift_full",
    "hop_packed",
    "eo_pack",
    "eo_unpack",
    "pack_gauge_eo",
]

EVEN = 0
ODD = 1

# site axes are always the LAST THREE: (T, X, M)
_AXT, _AXX, _AXM = -3, -2, -1


@dataclasses.dataclass(frozen=True)
class Lattice:
    """Static lattice metadata; dims = (T, X, Y, Z), Z even.  `mesh`: the
    distributed `parallel.Mesh` whose (t, y) slab of the lattice this is,
    or None for a whole lattice; a slab is made only while its mesh is the
    process's decomposition (`comm.require`)."""

    dims: tuple[int, int, int, int]
    mesh: object = None

    def __post_init__(self):
        if len(self.dims) != 4:
            raise ValueError(f"dims must be (T,X,Y,Z), got {self.dims}")
        if self.dims[3] % 2 != 0:
            raise ValueError("Z extent must be even for even/odd packing")
        if self.mesh is not None:
            require(self.mesh)

    @property
    def volume(self) -> int:
        """Sites held here (the slab's on a rank)."""
        return int(np.prod(self.dims))

    @property
    def global_dims(self) -> tuple[int, int, int, int]:
        """The whole lattice's (T, X, Y, Z): lengths with a physical meaning
        (boundary phases, normalisations) read these."""
        if self.mesh is None:
            return self.dims
        t, x, y, z = self.dims
        return (t * self.mesh.t, x, y * self.mesh.y, z)

    @property
    def global_volume(self) -> int:
        return int(np.prod(self.global_dims))

    @property
    def offset(self) -> tuple[int, int]:
        """(t, y) of the slab's first site in the whole lattice."""
        if self.mesh is None:
            return (0, 0)
        i, j = self.mesh.coords
        return (i * self.dims[0], j * self.dims[2])

    @property
    def zh(self) -> int:
        return self.dims[3] // 2

    @property
    def mf(self) -> int:
        """Flattened (Y, Z) extent of full-lattice fields."""
        return self.dims[2] * self.dims[3]

    @property
    def m(self) -> int:
        """Flattened (Y, Z/2) extent of e/o-packed fields."""
        return self.dims[2] * self.zh

    @property
    def site_shape(self) -> tuple[int, int, int]:
        return (self.dims[0], self.dims[1], self.mf)

    @property
    def eo_site_shape(self) -> tuple[int, int, int]:
        return (self.dims[0], self.dims[1], self.m)


# ---------------------------------------------------------------------------
# static masks: numpy once per (lattice, parity), then one device copy each
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _slot_mask(lat: Lattice, p: int) -> np.ndarray:
    """[T, X, M] bool: slot s = (t+x+y+p) % 2 == 1 at each packed site."""
    t, x, y, _ = lat.dims
    tt = np.arange(t)[:, None, None]
    xx = np.arange(x)[None, :, None]
    yy = np.repeat(np.arange(y), lat.zh)[None, None, :]
    return (tt + xx + yy + p) % 2 == 1


@lru_cache(maxsize=None)
def _k_edge_mask(lat: Lattice, last: bool) -> np.ndarray:
    """[M] bool: k == Z/2-1 (last) or k == 0 (first) within each y-block."""
    k = np.tile(np.arange(lat.zh), lat.dims[2])
    return (k == (lat.zh - 1)) if last else (k == 0)


@lru_cache(maxsize=None)
def _z_edge_mask_full(lat: Lattice, last: bool) -> np.ndarray:
    """[Mf] bool: z == Z-1 (last) or z == 0 (first) within each y-block."""
    z = np.tile(np.arange(lat.dims[3]), lat.dims[2])
    return (z == (lat.dims[3] - 1)) if last else (z == 0)


@lru_cache(maxsize=None)
def _txy_parity_mask(lat: Lattice, _unused=None) -> np.ndarray:
    """[T, X, Y, 1] bool: (t+x+y) % 2 == 1 (eo_pack slot selection)."""
    t, x, y, _ = lat.dims
    tt = np.arange(t)[:, None, None]
    xx = np.arange(x)[None, :, None]
    yy = np.arange(y)[None, None, :]
    return (((tt + xx + yy) % 2) == 1)[..., None]


@lru_cache(maxsize=None)
def _on(mask_fn, lat: Lattice, arg, device: str) -> torch.Tensor:
    return torch.as_tensor(mask_fn(lat, arg), device=device)


def _mask(mask_fn, lat: Lattice, arg, like: torch.Tensor) -> torch.Tensor:
    return _on(mask_fn, lat, arg, str(like.device))


# ---------------------------------------------------------------------------
# shifts
# ---------------------------------------------------------------------------


def _roll(f: torch.Tensor, shift: int, dim: int, lat: Lattice) -> torch.Tensor:
    """torch.roll of the whole field along T (`dim` -3) or along whole
    y-rows of M (-1): across the ranks on a distributed slab."""
    if lat.mesh is None:
        return torch.roll(f, shift, dim)
    require(lat.mesh)
    return dist_roll(f, shift, dim, "t" if dim == _AXT else "y", lat.mesh)


def shift_full(f: torch.Tensor, mu: int, d: int, lat: Lattice) -> torch.Tensor:
    """Value at x + d*mu_hat of a full-lattice field [..., T, X, Y*Z]
    (periodic wrap); d=+1 reads the forward neighbour."""
    if mu == 0:
        return _roll(f, -d, _AXT, lat)
    if mu == 1:
        return torch.roll(f, -d, _AXX)
    if mu == 2:
        return _roll(f, -d * lat.dims[3], _AXM, lat)
    z = lat.dims[3]
    if d == +1:
        edge = _mask(_z_edge_mask_full, lat, True, f)
        return torch.where(edge, torch.roll(f, z - 1, _AXM), torch.roll(f, -1, _AXM))
    edge = _mask(_z_edge_mask_full, lat, False, f)
    return torch.where(edge, torch.roll(f, -(z - 1), _AXM), torch.roll(f, 1, _AXM))


def hop_packed(f_q: torch.Tensor, p: int, mu: int, d: int, lat: Lattice) -> torch.Tensor:
    """For each parity-p site x, the value of the parity-(1-p) field `f_q`
    [..., T, X, Y*Z/2] at x + d*mu_hat."""
    if mu == 0:
        return _roll(f_q, -d, _AXT, lat)
    if mu == 1:
        return torch.roll(f_q, -d, _AXX)
    if mu == 2:
        return _roll(f_q, -d * lat.zh, _AXM, lat)
    # z-hop: the slot s = (t+x+y+p) % 2 of the destination site decides
    # whether the neighbour sits at the same k or at k +- 1 (wrapping inside
    # the y-block)
    s1 = _mask(_slot_mask, lat, p, f_q)
    zh = lat.zh
    if d == +1:
        base = torch.where(s1, torch.roll(f_q, -1, _AXM), f_q)
        edge = s1 & _mask(_k_edge_mask, lat, True, f_q)
        return torch.where(edge, torch.roll(f_q, zh - 1, _AXM), base)
    s0 = ~s1
    base = torch.where(s0, torch.roll(f_q, 1, _AXM), f_q)
    edge = s0 & _mask(_k_edge_mask, lat, False, f_q)
    return torch.where(edge, torch.roll(f_q, -(zh - 1), _AXM), base)


# ---------------------------------------------------------------------------
# even/odd packing
# ---------------------------------------------------------------------------


def eo_pack(f: torch.Tensor, lat: Lattice):
    """Full-lattice field [..., T, X, Y*Z] -> (even, odd) [..., T, X, Y*Z/2]."""
    t, x, y, _ = lat.dims
    pairs = f.reshape(f.shape[:-3] + (t, x, y, lat.zh, 2))
    slot0 = pairs[..., 0]
    slot1 = pairs[..., 1]
    m = _mask(_txy_parity_mask, lat, None, f)
    even = torch.where(m, slot1, slot0)
    odd = torch.where(m, slot0, slot1)
    newshape = f.shape[:-3] + (t, x, lat.m)
    return even.reshape(newshape), odd.reshape(newshape)


def eo_unpack(even: torch.Tensor, odd: torch.Tensor, lat: Lattice) -> torch.Tensor:
    """Inverse of :func:`eo_pack`."""
    t, x, y, _ = lat.dims
    e = even.reshape(even.shape[:-3] + (t, x, y, lat.zh))
    o = odd.reshape(odd.shape[:-3] + (t, x, y, lat.zh))
    m = _mask(_txy_parity_mask, lat, None, even)
    slot0 = torch.where(m, o, e)
    slot1 = torch.where(m, e, o)
    return torch.stack([slot0, slot1], dim=-1).reshape(even.shape[:-3] + (t, x, lat.mf))


def pack_gauge_eo(u: torch.Tensor, lat: Lattice) -> torch.Tensor:
    """Full gauge [3, 3, 4, T, X, Y*Z] -> per-parity links
    [2, 3, 3, 4, T, X, Y*Z/2]."""
    even, odd = eo_pack(u, lat)
    return torch.stack([even, odd], dim=0)
