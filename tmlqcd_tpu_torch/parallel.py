"""Domain decomposition: the (t, y) slab mesh, and the host staging of
checkpoints onto it.

Port of `tmlqcd_tpu/parallel.py` for one device.  The reference builds a
('t', 'm') device mesh from NrTProcs x NrYProcs and places one slab on each
device; its sharded hopping kernel then exchanges halos between devices.
Here a `Mesh` cuts the lattice into NrTProcs x NrYProcs (t, y) slabs that
all live on one device (several slabs per device: the counterpart of the
reference's 8 virtual CPU devices).  Fields stay whole, in the global
layout; `ops/dslash_cuda.hopping_shard` runs the slab kernels over all slabs
in one launch per variant and moves the halos by device-local copies.  A
mesh over more than one device is not ported yet (ROADMAP S15b: transport
between cards through torch.distributed / NCCL), and neither are the
reference's vmapped independent chains (`chain_init`, `parallel_chains`).

The mesh is a value passed by keyword from `HMCConfig` down to the solve
seams (monomials, inverter); there is no module-level active mesh.

Axes: the packed site axes are (T, X, M = Y*Z/2) with M y-major, so a
y-slab is a contiguous M range; slab (i, j) holds t in [i T_loc, (i+1) T_loc)
and m in [j m_loc, (j+1) m_loc), m_loc = Y_loc Z/2.  T_loc and Y_loc must be
even, so that the even/odd slot of a site read from local coordinates is
the global one.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tmlqcd_tpu_torch.lattice import Lattice

__all__ = [
    "Mesh",
    "make_mesh",
    "mesh_from_procs",
    "auto_shape",
    "auto_mesh",
    "gather_to_host",
    "place_from_host",
    "load_gauge_sharded",
    "halo_bytes_per_dslash",
    "slab_slices",
    "split_slabs",
    "join_slabs",
]


def _default_device() -> torch.device:
    """The current CUDA device; without a card it raises instead of choosing
    the CPU, so a mesh on the CPU is always asked for by name."""
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    raise RuntimeError("no CUDA device: pass the mesh's device explicitly (device= of Mesh, "
                       "mesh_from_procs; devices= of make_mesh, auto_mesh), e.g. 'cpu'")


def _several_devices(n: int):
    return NotImplementedError(
        f"a mesh over {n} devices is not yet ported to tmlqcd_tpu_torch (ROADMAP S15b: halo "
        "transport between cards); the slabs of a mesh live on one device")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """NrTProcs x NrYProcs (t, y) slabs of the lattice, all on `device`.
    `halfspinor` and `overlap` set the sharded hop, as the arguments of the
    reference's `hopping_pallas_shard`: half-spinor halos, and the interior
    kernel K3-I beside the t exchange (else K3 on the extended slabs; K1-T
    when there is one y slab)."""

    t: int
    y: int
    device: torch.device = dataclasses.field(default_factory=_default_device)
    halfspinor: bool = True
    overlap: bool = True

    def __post_init__(self):
        if self.t < 1 or self.y < 1:
            raise ValueError(f"mesh shape ({self.t}, {self.y}) must be positive")
        object.__setattr__(self, "device", torch.device(self.device))

    @property
    def shape(self) -> dict:
        """The reference's mesh.shape: {'t': t shards, 'm': y shards}."""
        return {"t": self.t, "m": self.y}

    @property
    def n_slabs(self) -> int:
        return self.t * self.y

    def local(self, lat: Lattice) -> Lattice:
        """The lattice of one slab; raises unless T and Y split into even
        slabs (the reference's `hopping_pallas_shard` checks)."""
        t, x, y, z = lat.dims
        if t % self.t or (t // self.t) % 2:
            raise ValueError(f"T={t} must split into even slabs over {self.t} shards")
        if y % self.y or (y // self.y) % 2:
            raise ValueError(f"Y={y} must split into even slabs over {self.y} shards")
        return Lattice((t // self.t, x, y // self.y, z))


def make_mesh(shape: tuple[int, int] | None = None, devices=None) -> Mesh:
    """(t, y) mesh over `devices` (default: the current device).  Default
    shape: all devices, as square as possible with the larger factor on t,
    as in the reference; `shape` may hold more slabs than there are devices
    (several slabs per device).  More than one device raises (S15b)."""
    devices = list(devices) if devices is not None else [_default_device()]
    if len(devices) > 1:
        raise _several_devices(len(devices))
    if shape is None:
        shape = (1, 1)
    return Mesh(int(shape[0]), int(shape[1]), devices[0])


def mesh_from_procs(nr_procs, lat: Lattice | None = None, device=None) -> Mesh | None:
    """The (t, y) mesh of the input file's NrTProcs/NrXProcs/NrYProcs/
    NrZProcs (reference: tmlqcd_mpi_init's MPI_Cart_create).  NrTProcs cuts
    T, NrYProcs cuts Y; NrXProcs/NrZProcs > 1 raise ValueError, as in the
    reference.  None when no decomposition is asked for.  With `lat`, T and
    Y must split into even slabs (ValueError).

    Unlike the reference, a mesh needs no more devices than one: all its
    slabs live on `device` (default: the current CUDA device; without a card
    the default raises, and the CPU is asked for by name)."""
    t_p, x_p, y_p, z_p = (max(1, int(p)) for p in nr_procs)
    if x_p > 1 or z_p > 1:
        raise ValueError(
            f"NrXProcs={x_p}/NrZProcs={z_p} unsupported: this framework "
            "decomposes (T, Y) only — see parallel.mesh_from_procs docstring "
            "for the measured scaling ceiling of the 2D mesh"
        )
    if t_p * y_p <= 1:
        return None
    if lat is not None:
        t, _, y, _ = lat.dims
        if t % t_p or y % y_p:
            raise ValueError(f"lattice T={t}, Y={y} not divisible by mesh {t_p}x{y_p}")
    mesh = Mesh(t_p, y_p, _default_device() if device is None else device)
    if lat is not None:
        mesh.local(lat)
    return mesh


def auto_shape(lat: Lattice, n: int) -> tuple[int, int] | None:
    """The reference's `auto_mesh` choice for n devices: the factorisation
    t_p * y_p = n that divides T and Y, squarest first, ties toward more t
    shards; None if n <= 1 or nothing divides."""
    if n <= 1:
        return None
    t, _, y, _ = lat.dims
    best = None
    for t_p in range(1, n + 1):
        if n % t_p:
            continue
        y_p = n // t_p
        if t % t_p or y % y_p:
            continue
        score = (min(t_p, y_p), t_p)
        if best is None or score > best[0]:
            best = (score, (t_p, y_p))
    return None if best is None else best[1]


def auto_mesh(lat: Lattice, devices=None) -> Mesh | None:
    """A mesh over all `devices` (default: the current device) that divides
    the lattice, or None — the default of `cli.hmc` without NrTProcs/NrYProcs.
    One device gives None, as in the reference; several raise (S15b)."""
    devices = list(devices) if devices is not None else [_default_device()]
    shape = auto_shape(lat, len(devices))
    if shape is None:
        return None
    raise _several_devices(len(devices))


def gather_to_host(x) -> np.ndarray:
    """Field -> numpy on the host (the checkpoint writer's staging).  The
    slabs of a one-device mesh are views of one whole field, so this is a
    copy to the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def place_from_host(arr, mesh: Mesh, dtype=torch.complex64) -> torch.Tensor:
    """Host array -> the whole field on the mesh's device (the reader's
    staging; every slab of a one-device mesh is a view of it)."""
    return torch.as_tensor(np.ascontiguousarray(arr)).to(device=mesh.device, dtype=dtype)


def load_gauge_sharded(path: str, mesh: Mesh, expect_lat: Lattice | None = None):
    """Read a native or ILDG checkpoint and place the gauge field on the
    mesh -> (u, trajectory, seed)."""
    from tmlqcd_tpu_torch.io.checkpoint import load_checkpoint

    u, traj, seed = load_checkpoint(path, expect_lat)
    return place_from_host(u, mesh), traj, seed


def halo_bytes_per_dslash(lat: Lattice, mesh_shape: tuple[int, int], halfspinor: bool = True,
                          bytes_per_real: int = 4) -> dict:
    """Halo volume of ONE sharded hopping application per slab, as the
    reference counts it (the xchange_field message sizes): one t-slice in
    each t direction and one y-slice in each y direction, half the spin
    components with `halfspinor`; plus the per-CG-iteration figures (4 hops
    in Qhat_pm) and the slab's own bytes of one hop for a ratio.  On a
    one-device mesh these bytes are device-local copies."""
    tsh, msh = mesh_shape
    t, x, _, _ = lat.dims
    m_loc = lat.m // msh
    t_loc = t // tsh
    spin = 2 if halfspinor else 4
    reals = spin * 3 * 2
    site_b = reals * bytes_per_real
    t_halo = 2 * x * m_loc * site_b if tsh > 1 else 0
    m_halo = 2 * t_loc * x * lat.zh * site_b if msh > 1 else 0
    per_hop = t_halo + m_halo
    sites_loc = t_loc * x * m_loc
    hbm = (576 + 3 * 96 + 96) * sites_loc
    return {
        "bytes_per_hop": per_hop,
        "t_halo_bytes": t_halo,
        "m_halo_bytes": m_halo,
        "bytes_per_cg_iteration": 4 * per_hop,
        "hbm_bytes_per_hop": hbm,
        "comm_to_hbm_ratio": per_hop / hbm if hbm else 0.0,
        "local_sites": sites_loc,
    }


# ---------------------------------------------------------------------------
# slab <-> global index helpers (site axes are the last three: T, X, M)
# ---------------------------------------------------------------------------


def slab_slices(lat: Lattice, mesh: Mesh, i: int, j: int) -> tuple[slice, slice]:
    """(t slice, m slice) of slab (i, j) in the global packed site axes."""
    loc = mesh.local(lat)
    return (slice(i * loc.dims[0], (i + 1) * loc.dims[0]), slice(j * loc.m, (j + 1) * loc.m))


def split_slabs(f: torch.Tensor, lat: Lattice, mesh: Mesh) -> list:
    """A packed field [..., T, X, M] -> its slabs [..., T_loc, X, m_loc] as
    views, in (i, j) row-major order (the reference's device order)."""
    out = []
    for i in range(mesh.t):
        for j in range(mesh.y):
            ts, ms = slab_slices(lat, mesh, i, j)
            out.append(f[..., ts, :, ms])
    return out


def join_slabs(slabs, lat: Lattice, mesh: Mesh) -> torch.Tensor:
    """The inverse of `split_slabs`: slabs in (i, j) order -> the field."""
    rows = [torch.cat(list(slabs[i * mesh.y:(i + 1) * mesh.y]), dim=-1) for i in range(mesh.t)]
    return torch.cat(rows, dim=-3)
