"""Transport between the ranks of a distributed slab mesh: face exchange,
global sums and the distributed roll, over torch.distributed.

The counterpart of the reference's collectives under its device mesh (the
ppermutes of `hopping_pallas_shard._exchange` and the psums of its
reductions; tmLQCD's xchange_field and MPI_Allreduce).  A process of a
distributed run holds one (t, y) slab of every field (`parallel.Mesh` with a
process group); the functions here move what crosses a slab boundary.

  * `exchange(faces, mesh)`: each face a tensor sent to one rank while a
    tensor of the same shape arrives from another (`batch_isend_irecv`).
    The faces are posted together and received in the order they were
    given: with two slabs along an axis the rank above and the one below
    are the same rank, so the pairs are told apart by a tag per face (gloo)
    and by their order (NCCL matches in posting order).  NCCL moves device
    buffers as they are; gloo cannot read device memory, so a CUDA face
    goes through a pinned host copy each way, the copy back on the
    caller's stream.  Complex tensors travel as their real view.
  * `global_sum(x)`: the f64 sum over the ranks of a rank's partial sum
    (the reference's precision model: f64 reductions of f32 fields).  It
    is an autograd function whose backward passes the gradient through,
    so a force surrogate built on a global sum differentiates each rank's
    own share, and the cross-slab terms come back through `dist_roll`.
  * `dist_roll(x, shift, dim, axis, mesh)`: `torch.roll` along a sharded
    axis: the |shift| boundary slices go to the neighbour and the
    neighbour's arrive; backward is the opposite roll.
  * `all_gather(x)`: every rank's `x` in rank order (the checkpoint's
    slabs; the Polyakov line's partial products, which a sum cannot
    combine); `lead()`: whether this process writes the files (rank 0, or
    no decomposition).

The slab decomposition of a process is process state, as tmLQCD's Cartesian
communicator is, and it has one source: `activate`, which `parallel` calls
when it builds a mesh over a group.  The lattice reductions (`global_sum`,
`global_max`, the gather of `parallel.gather_to_host`) sum over the active
mesh's ranks, and return their argument with none active; a slab's
`Lattice` carries that same mesh, and is made and shifted only while it is
the active one (`require`), so the reductions and the shifts cannot
disagree.  `parallel_chains` runs whole-lattice chains on the ranks with
the decomposition suspended (`suspended`), where a slab lattice raises.
"""

from __future__ import annotations

import contextlib
import time

import torch
import torch.distributed as dist

__all__ = ["activate", "active", "require", "suspended", "lead", "exchange", "global_sum",
           "global_max", "all_gather", "dist_roll", "stats", "reset_stats"]

_ACTIVE = [None]
# exchanges, their wall seconds (posting to the last wait), bytes sent
_STATS = {"exchanges": 0, "seconds": 0.0, "bytes": 0}


def activate(mesh) -> None:
    """Make `mesh` (a distributed `parallel.Mesh`, or None) the slab
    decomposition of this process."""
    if mesh is not None and not mesh.distributed:
        raise ValueError("only a mesh over a process group is a process's decomposition")
    _ACTIVE[0] = mesh


def active():
    """The distributed mesh of this process, or None."""
    return _ACTIVE[0]


def require(mesh) -> None:
    """Raise unless the distributed `mesh` is this process's decomposition
    (the slab lattices' check: a reduction beside it sums over its ranks)."""
    cur = _ACTIVE[0]
    if cur is None or (cur.t, cur.y, cur.rank) != (mesh.t, mesh.y, mesh.rank):
        raise RuntimeError(f"a slab of the mesh {mesh.t}x{mesh.y} (rank {mesh.rank}) is used "
                           f"while {'no mesh' if cur is None else f'{cur.t}x{cur.y}'} is this "
                           "process's decomposition (comm.activate)")


def lead() -> bool:
    """Whether this process writes a run's files and stdout: rank 0 of the
    decomposition, or the one process without one."""
    mesh = _ACTIVE[0]
    return mesh is None or mesh.rank == 0


@contextlib.contextmanager
def suspended():
    """Run whole-lattice work on a rank of a distributed run: no lattice
    reduction crosses the ranks inside."""
    saved = _ACTIVE[0]
    _ACTIVE[0] = None
    try:
        yield
    finally:
        _ACTIVE[0] = saved


def stats() -> dict:
    return dict(_STATS)


def reset_stats() -> None:
    _STATS.update(exchanges=0, seconds=0.0, bytes=0)


def _staged(mesh, t: torch.Tensor) -> bool:
    """Whether `t` travels through host memory: a CUDA tensor over gloo."""
    return t.is_cuda and mesh.backend != "nccl"


def _wire(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return torch.view_as_real(t) if t.is_complex() else t


class Pending:
    """Faces in flight: `wait(k)` blocks for face k and returns it on the
    device of the face that was sent (`wait()` for all of them, in order)."""

    def __init__(self, works, bufs, like, t0):
        self._works, self._bufs, self._like, self._t0 = works, bufs, like, t0
        self._done = [None] * len(bufs)

    def wait(self, k: int | None = None):
        if k is None:
            return [self.wait(i) for i in range(len(self._bufs))]
        if self._done[k] is None:
            for w in self._works[k]:
                w.wait()
            buf, like = self._bufs[k], self._like[k]
            out = torch.view_as_complex(buf) if like.is_complex() else buf
            if out.device != like.device:
                out = out.to(like.device, non_blocking=True)
            self._done[k] = out
            if all(d is not None for d in self._done):
                _STATS["seconds"] += time.perf_counter() - self._t0
        return self._done[k]


def exchange(faces, mesh) -> Pending:
    """Post every face: `faces` is a list of (tensor, dst rank, src rank),
    face k sent to dst and a tensor of its shape received from src, tag k.
    Returns the `Pending` of the received faces."""
    t0 = time.perf_counter()
    group = mesh.group
    ops, works, bufs, like = [], [], [], []
    staged = any(_staged(mesh, f) for f, _, _ in faces)
    sends = []
    for f, _, _ in faces:
        w = _wire(f)
        if _staged(mesh, f):
            h = torch.empty(w.shape, dtype=w.dtype, pin_memory=True)
            h.copy_(w, non_blocking=True)
            w = h
        sends.append(w)
    if staged:
        torch.cuda.current_stream().synchronize()  # the host copies are complete
    for k, (f, dst, src) in enumerate(faces):
        w = sends[k]
        r = torch.empty(w.shape, dtype=w.dtype, device=w.device,
                        pin_memory=w.device.type == "cpu" and _staged(mesh, f))
        ops.append(dist.P2POp(dist.isend, w, dst, group, tag=k))
        ops.append(dist.P2POp(dist.irecv, r, src, group, tag=k))
        bufs.append(r)
        like.append(f)
        _STATS["bytes"] += w.numel() * w.element_size()
    reqs = dist.batch_isend_irecv(ops) if ops else []
    # the requests come back in the order of the ops: (send, recv) per face
    for k in range(len(faces)):
        works.append(reqs[2 * k:2 * k + 2])
    _STATS["exchanges"] += 1
    return Pending(works, bufs, like, t0)


class _GlobalSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        y = x.detach().double()
        if mesh.backend != "nccl":
            y = y.cpu()
        y = y.clone()
        dist.all_reduce(y, group=mesh.group)
        return y.to(x.device)

    @staticmethod
    def backward(ctx, g):
        return g, None


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """The f64 sum over the ranks of the process's decomposition of each
    rank's partial sum `x`; `x` itself without one.  Differentiable: the
    backward passes the gradient through."""
    mesh = active()
    if mesh is None:
        return x
    return _GlobalSum.apply(x, mesh)


def global_max(x: torch.Tensor) -> torch.Tensor:
    """The maximum over the ranks of the process's decomposition of each
    rank's `x` (not differentiable)."""
    mesh = active()
    if mesh is None:
        return x
    y = x.detach().clone() if mesh.backend == "nccl" else x.detach().cpu().clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=mesh.group)
    return y.to(x.device)


def all_gather(x: torch.Tensor, mesh=None, device=None) -> list:
    """Every rank's `x` (the same shape on every rank) in rank order over
    `mesh` (default: the process's decomposition), on `device` (default:
    that of `x`); [x] without a decomposition (not differentiable)."""
    mesh = active() if mesh is None else mesh
    if mesh is None:
        return [x]
    w = torch.view_as_real(x.detach()) if x.is_complex() else x.detach()
    w = w.contiguous() if mesh.backend == "nccl" else w.cpu().contiguous()
    bufs = [torch.empty_like(w) for _ in range(mesh.t * mesh.y)]
    dist.all_gather(bufs, w, group=mesh.group)
    device = x.device if device is None else device
    return [(torch.view_as_complex(b) if x.is_complex() else b).to(device) for b in bufs]


def _roll(x: torch.Tensor, shift: int, dim: int, axis: str, mesh) -> torch.Tensor:
    """torch.roll(x, shift, dim) of the global field along the sharded
    `axis` ('t' or 'y') of `mesh`, on this rank's slab."""
    n = x.shape[dim]
    k = abs(int(shift))
    if k == 0:
        return x
    if k > n:
        raise ValueError(f"a roll by {shift} crosses more than one slab of {n}")
    up, down = mesh.neighbour(axis, +1), mesh.neighbour(axis, -1)
    if shift < 0:
        # out[i] = x[i + k]: the first k slices go down, the slab above's arrive
        (got,) = exchange([(x.narrow(dim, 0, k), down, up)], mesh).wait()
        return torch.cat([x.narrow(dim, k, n - k), got], dim=dim)
    (got,) = exchange([(x.narrow(dim, n - k, k), up, down)], mesh).wait()
    return torch.cat([got, x.narrow(dim, 0, n - k)], dim=dim)


class _DistRoll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shift, dim, axis, mesh):
        ctx.args = (shift, dim, axis, mesh)
        return _roll(x, shift, dim, axis, mesh)

    @staticmethod
    def backward(ctx, g):
        shift, dim, axis, mesh = ctx.args
        return _roll(g, -shift, dim, axis, mesh), None, None, None, None


def dist_roll(x: torch.Tensor, shift: int, dim: int, axis: str, mesh) -> torch.Tensor:
    """`torch.roll(x, shift, dim)` of the whole field, `dim` the slab's
    share of the mesh axis `axis` ('t': the T axis; 'y': the packed or full
    site axis M, shifts in whole y-rows).  With one slab along the axis it
    is torch.roll; else a collective: every rank of the mesh calls it."""
    if (mesh.t if axis == "t" else mesh.y) == 1:
        return torch.roll(x, shift, dim)
    return _DistRoll.apply(x, shift, dim, axis, mesh)
