"""Domain decomposition: the (t, y) slab mesh, in one process or over the
ranks of a torch.distributed group, and the host staging of checkpoints
onto it.

Port of `tmlqcd_tpu/parallel.py`.  The reference builds a ('t', 'm') device
mesh from NrTProcs x NrYProcs and places one slab on each device; its
sharded hopping kernel then exchanges halos between devices.  The port has
two forms of a `Mesh`:

  * one process (`Mesh(t, y, device)`): the lattice cut into NrTProcs x
    NrYProcs (t, y) slabs that all live on one device (the counterpart of
    the reference's 8 virtual CPU devices).  Fields stay whole, in the
    global layout; `ops/dslash_cuda.hopping_shard` runs the slab kernels
    over all slabs in one launch per variant and moves the halos by
    device-local copies.
  * distributed (`group` set; built by `make_mesh`, `mesh_from_procs` or
    `auto_mesh` in a process of an initialised group, see
    `init_distributed`): tmLQCD's MPI model, one process per slab.  Rank
    r = i y + j holds slab (i, j) of every field as a contiguous tensor of
    the slab's lattice (`mesh.local(lat)`, a `Lattice` that carries the
    mesh), the hop exchanges its faces with the four neighbour ranks
    (`dslash_cuda.hopping_rank`), every shift along t or y crosses ranks
    through `comm.dist_roll` and every lattice sum through
    `comm.global_sum`.  A run needs exactly NrTProcs x NrYProcs ranks.

A list of several devices in one process raises: the port runs one process
per device (the reference's single controller drives a mesh of devices from
one process; torch does not).  The reference's independent chains
(`chain_init`, `parallel_chains`, vmapped there) run one after another on
one device, or chain c on rank c mod world over a group.

The mesh is a value passed by keyword from `HMCConfig` down to the solve
seams (monomials, inverter).  A distributed mesh is also the process's
decomposition, which the reductions read (`comm.activate`, called here
when the mesh is built and nowhere else); its slab lattices carry the same
mesh and check that it is the active one (`comm.require`).

Axes: the packed site axes are (T, X, M = Y*Z/2) with M y-major, so a
y-slab is a contiguous M range; slab (i, j) holds t in [i T_loc, (i+1) T_loc)
and m in [j m_loc, (j+1) m_loc), m_loc = Y_loc Z/2.  T_loc and Y_loc must be
even, so that the even/odd slot of a site read from local coordinates is
the global one.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from tmlqcd_tpu_torch import comm
from tmlqcd_tpu_torch.lattice import Lattice

__all__ = [
    "init_distributed",
    "Mesh",
    "make_mesh",
    "mesh_from_procs",
    "auto_shape",
    "auto_mesh",
    "chain_init",
    "parallel_chains",
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
        f"a mesh over {n} devices in one process is not supported by tmlqcd_tpu_torch "
        "(ROADMAP S15b: one process per device): start one process per device (torchrun "
        "--nproc-per-node N ... --distributed) and build the mesh over their group, or keep "
        "every slab on one device")


def _process_count() -> int:
    """The ranks of the initialised group, 1 without one (an indirection
    the multi-process staging branches are tested through)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def init_distributed(backend: str | None = None, init_method: str | None = None,
                     rank: int | None = None, world_size: int | None = None,
                     cpu: bool = False, timeout: float | None = None) -> torch.device:
    """Join the process group of a distributed run and return this rank's
    device; a no-op (returning the device) when a group exists already.

    Rank, world size and address come from the environment `torchrun` sets
    (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR / MASTER_PORT) unless given,
    `init_method` names the rendezvous otherwise (`tcp://host:port`,
    `file://path`).  The device is cuda:(LOCAL_RANK mod the cards) and the
    backend nccl; without a card it raises unless the caller asks for the
    CPU (`cpu=True`, backend gloo).  `backend="gloo"` on cards runs the
    kernels on the card and moves the faces through host memory.  A failed
    init raises; NCCL never gives way to gloo."""
    if cpu:
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: a distributed run needs a card per rank, "
                               "or cpu=True (--cpu) for the plain path over gloo")
        local = int(os.environ.get("LOCAL_RANK", rank if rank is not None else 0))
        device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    if dist.is_initialized():
        return device
    backend = backend or ("gloo" if device.type == "cpu" else "nccl")
    if backend not in ("gloo", "nccl") or (backend == "nccl" and device.type != "cuda"):
        raise ValueError(f"backend {backend!r} on {device}: nccl needs cards, gloo runs on both")
    kw = {}
    if rank is not None:
        kw["rank"] = rank
    if world_size is not None:
        kw["world_size"] = world_size
    if timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout)
    if backend == "nccl":
        kw["device_id"] = device
    dist.init_process_group(backend, init_method=init_method, **kw)
    return device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """NrTProcs x NrYProcs (t, y) slabs of the lattice: all on `device`, or,
    with `group` (a torch.distributed group; `rank` this process's rank in
    it), one slab per rank, slab (i, j) on rank i y + j.  `halfspinor` and
    `overlap` set the sharded hop, as the arguments of the reference's
    `hopping_pallas_shard`: half-spinor halos, and the interior kernel K3-I
    beside the t exchange (else K3 on the extended slabs; K1-T when there
    is one y slab)."""

    t: int
    y: int
    device: torch.device = dataclasses.field(default_factory=_default_device)
    halfspinor: bool = True
    overlap: bool = True
    rank: int | None = None
    group: object = dataclasses.field(default=None, compare=False, repr=False)

    def __post_init__(self):
        if self.t < 1 or self.y < 1:
            raise ValueError(f"mesh shape ({self.t}, {self.y}) must be positive")
        object.__setattr__(self, "device", torch.device(self.device))
        if self.distributed:
            world = dist.get_world_size(self.group)
            if self.t * self.y != world:
                raise ValueError(f"NrTProcs x NrYProcs = {self.t}x{self.y} needs exactly "
                                 f"{self.t * self.y} ranks, the group has {world}")

    @property
    def distributed(self) -> bool:
        return self.rank is not None

    @property
    def backend(self) -> str:
        return dist.get_backend(self.group)

    @property
    def coords(self) -> tuple[int, int]:
        """This rank's slab (i, j)."""
        return divmod(self.rank, self.y)

    def neighbour(self, axis: str, step: int) -> int:
        """The rank of the slab `step` slabs away along `axis` ('t' or 'y')."""
        i, j = self.coords
        if axis == "t":
            return ((i + step) % self.t) * self.y + j
        return i * self.y + (j + step) % self.y

    @property
    def shape(self) -> dict:
        """The reference's mesh.shape: {'t': t shards, 'm': y shards}."""
        return {"t": self.t, "m": self.y}

    @property
    def n_slabs(self) -> int:
        return self.t * self.y

    def local(self, lat: Lattice) -> Lattice:
        """The lattice of one slab; raises unless T and Y split into even
        slabs (the reference's `hopping_pallas_shard` checks).  On a
        distributed mesh the slab's lattice carries the mesh, which must be
        the process's decomposition (and a slab's lattice is its own local
        one)."""
        if lat.mesh is not None:
            if lat.mesh != self:
                raise ValueError("the lattice is a slab of another mesh")
            return lat
        t, x, y, z = lat.dims
        if t % self.t or (t // self.t) % 2:
            raise ValueError(f"T={t} must split into even slabs over {self.t} shards")
        if y % self.y or (y // self.y) % 2:
            raise ValueError(f"Y={y} must split into even slabs over {self.y} shards")
        return Lattice((t // self.t, x, y // self.y, z),
                       mesh=self if self.distributed else None)


def _group_mesh(t: int, y: int, device) -> Mesh:
    """The distributed mesh over the initialised group, activated as this
    process's decomposition (`comm.activate`)."""
    if device is None:
        device = _default_device()
    mesh = Mesh(t, y, device, rank=dist.get_rank(), group=dist.group.WORLD)
    comm.activate(mesh)
    return mesh


def make_mesh(shape: tuple[int, int] | None = None, devices=None) -> Mesh:
    """(t, y) mesh over `devices` (default: the current device), or, in a
    process of an initialised group and without `devices`, over its ranks
    (one slab per rank; `devices` may then name this rank's device).
    Default shape: all devices (ranks), as square as possible with the
    larger factor on t, as in the reference; in one process `shape` may
    hold more slabs than there are devices (several slabs per device).
    Several devices in one process raise (one process per device)."""
    if dist.is_initialized() and (devices is None or len(list(devices)) == 1):
        n = _process_count()
        if shape is None:
            a = max(c for c in range(1, int(n ** 0.5) + 1) if n % c == 0)
            shape = (max(a, n // a), min(a, n // a))
        return _group_mesh(int(shape[0]), int(shape[1]), None if devices is None
                           else list(devices)[0])
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

    In a process of an initialised group (`init_distributed`, `cli.hmc
    --distributed`) the mesh is over its ranks, one slab each, and the group
    must hold exactly NrTProcs x NrYProcs ranks (ValueError), as MPI tmLQCD
    needs.  Otherwise a mesh needs no more devices than one: all its slabs
    live on `device` (default: the current CUDA device; without a card the
    default raises, and the CPU is asked for by name)."""
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
    if dist.is_initialized():
        mesh = _group_mesh(t_p, y_p, device)
    else:
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
    """A mesh over all `devices` (default: the current device; in a process
    of an initialised group, its ranks) that divides the lattice, or None —
    the default of `cli.hmc` without NrTProcs/NrYProcs.  One device (rank)
    gives None, as in the reference; several devices in one process raise."""
    if dist.is_initialized() and (devices is None or len(list(devices)) == 1):
        shape = auto_shape(lat, _process_count())
        if shape is None:
            return None
        mesh = _group_mesh(shape[0], shape[1], None if devices is None else list(devices)[0])
        mesh.local(lat)
        return mesh
    devices = list(devices) if devices is not None else [_default_device()]
    shape = auto_shape(lat, len(devices))
    if shape is None:
        return None
    raise _several_devices(len(devices))


def _gather_slabs(x: torch.Tensor, mesh: Mesh) -> list:
    """Every rank's slab of `x` [..., T_loc, X, m_loc] on the host, in rank
    order (an all-gather; the slabs have one shape)."""
    w = torch.view_as_real(x.detach()) if x.is_complex() else x.detach()
    w = w.contiguous() if mesh.backend == "nccl" else w.cpu().contiguous()
    bufs = [torch.empty_like(w) for _ in range(mesh.t * mesh.y)]
    dist.all_gather(bufs, w, group=mesh.group)
    return [torch.view_as_complex(b.cpu()) if x.is_complex() else b.cpu() for b in bufs]


def gather_to_host(x, mesh: Mesh | None = None) -> np.ndarray:
    """Field -> numpy on the host (the checkpoint writer's staging).  The
    slabs of a one-device mesh are views of one whole field, so this is a
    copy to the host.  On a distributed mesh (default: the process's
    decomposition) every rank calls it, an all-gather assembles the global
    field, and every rank holds it; the caller writes from rank 0, as the
    reference's multi-process branch (`process_allgather`) does."""
    mesh = comm.active() if mesh is None else mesh
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    if mesh is None or not mesh.distributed or _process_count() == 1:
        return x.detach().cpu().numpy()
    return join_slabs(_gather_slabs(x, mesh), None, mesh).numpy()


def place_from_host(arr, mesh: Mesh, dtype=torch.complex64) -> torch.Tensor:
    """Host array -> the field on the mesh: on one device the whole field
    (every slab of a one-device mesh is a view of it); on a distributed mesh
    this rank's slab only, the one upload of each rank (the reference's
    `make_array_from_callback`)."""
    arr = np.asarray(arr)
    if mesh.distributed:
        i, j = mesh.coords
        t_loc, m_loc = arr.shape[-3] // mesh.t, arr.shape[-1] // mesh.y
        arr = arr[..., i * t_loc:(i + 1) * t_loc, :, j * m_loc:(j + 1) * m_loc]
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


def join_slabs(slabs, lat: Lattice | None, mesh: Mesh) -> torch.Tensor:
    """The inverse of `split_slabs`: slabs in (i, j) order -> the field
    (`lat` is not read: the slabs carry their shape)."""
    rows = [torch.cat(list(slabs[i * mesh.y:(i + 1) * mesh.y]), dim=-1) for i in range(mesh.t)]
    return torch.cat(rows, dim=-3)


def chain_init(n_chains: int, make_u, key) -> torch.Tensor:
    """Stack n independent starts along a leading chain axis: chain c is
    `make_u(key.fold(c))` (an `rng.Key` per chain)."""
    return torch.stack([make_u(key.fold(c)) for c in range(n_chains)])


def parallel_chains(cfg, u_stack: torch.Tensor, keys, draws=None):
    """One trajectory on every chain: `hmc_trajectory(cfg, u_stack[c],
    keys[c])` (with `draws[c]` injected where given), the reference's
    vmapped chains (BASELINE config 5's parallel HMC streams).  In one
    process a loop on the one device; in a process of an initialised group
    chain c runs on rank c mod world (whole-lattice chains: no slab
    decomposition inside, `comm.suspended`) and the results are exchanged,
    so every rank returns every chain, as the reference returns a global
    array.  Returns (u' [C, ...gauge], stats): the TrajectoryStats fields
    stacked over the chains as numpy arrays."""
    from tmlqcd_tpu_torch.hmc.trajectory import TrajectoryStats, hmc_trajectory

    world = _process_count()
    rank = dist.get_rank() if world > 1 else 0
    outs, stats = [], []
    with comm.suspended():
        for c in range(u_stack.shape[0]):
            if c % world != rank:
                outs.append(torch.empty_like(u_stack[c]))
                stats.append(None)
                continue
            u_c, st = hmc_trajectory(cfg, u_stack[c], keys[c],
                                     draws=None if draws is None else draws[c])
            outs.append(u_c)
            stats.append(st)
    if world > 1:
        nccl = dist.get_backend() == "nccl"
        for c, u_c in enumerate(outs):
            w = torch.view_as_real(u_c) if nccl else torch.view_as_real(u_c.cpu())
            dist.broadcast(w, src=c % world)
            outs[c] = torch.view_as_complex(w).to(u_stack.device)
        held = [None] * world
        dist.all_gather_object(held, stats[rank::world])
        stats = [held[c % world][c // world] for c in range(u_stack.shape[0])]
    return torch.stack(outs), TrajectoryStats(*(np.asarray(f) for f in zip(*stats)))
