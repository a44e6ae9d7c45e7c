"""Spawned ranks of the port's distributed runs, for its CPU tests and for
chip_smoke.py's phase 19.

`run_ranks(fn, world, tmp_path, *args)` starts `world` processes with the
spawn context, each joining a group through a file store in `tmp_path`
(no ports, so it is safe beside xdist's workers and beside a second
checkout's run), one thread each, and returns the values
`fn(mesh_rank, *args)` returned on every rank, in rank order.  By default
the ranks run on the CPU over gloo; `cpu=False` puts rank r on card r mod
the cards (LOCAL_RANK, as torchrun sets it) with the `backend` asked for.
A rank that raises fails the call with its traceback; the group and the
join have a timeout, so a deadlock fails instead of hanging.  The ranks
import this module and the port only (no jax, no tmlqcd_tpu).

The per-rank functions below build every field from a numpy seed on every
rank (the whole lattice, the same numbers everywhere) and keep their own
slab, so the parent can hold the joined slabs against the one-process port.
`loopback` hands the faces of the slabs of one card to their neighbours,
for the checks of the rank kernels on a card.
"""

from __future__ import annotations

import os
import pickle
import time
import traceback

import numpy as np
import torch

TIMEOUT = 120.0  # seconds, the group's and (by default) the join's


def _child(rank: int, world: int, store: str, out_dir: str, fn, args, cpu: bool, backend):
    os.environ["LOCAL_RANK"] = str(rank)
    torch.set_num_threads(1)
    path = os.path.join(out_dir, f"rank{rank}.pkl")
    try:
        from tmlqcd_tpu_torch import parallel

        parallel.init_distributed(backend=backend, cpu=cpu, init_method=f"file://{store}",
                                  rank=rank, world_size=world, timeout=TIMEOUT)
        result = ("ok", fn(rank, *args))
    except BaseException:  # noqa: BLE001  (reported to the parent)
        result = ("error", traceback.format_exc())
    with open(path, "wb") as f:
        pickle.dump(result, f)
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def run_ranks(fn, world: int, tmp_path, *args, timeout: float = TIMEOUT, cpu: bool = True,
              backend: str | None = None) -> list:
    """fn(rank, *args) on `world` spawned ranks -> their results; every
    process is stopped before it returns or raises."""
    import torch.multiprocessing as mp

    base = os.path.join(str(tmp_path), f"ranks_{fn.__name__}_{os.getpid()}_{id(args)}")
    os.makedirs(base, exist_ok=True)
    store = os.path.join(base, "store")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_child, args=(r, world, store, base, fn, args, cpu, backend))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(1.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    out, errors = [], []
    for r in range(world):
        path = os.path.join(base, f"rank{r}.pkl")
        if not os.path.exists(path):
            errors.append(f"rank {r}: no result (exit code {procs[r].exitcode})")
            continue
        with open(path, "rb") as f:
            status, value = pickle.load(f)
        if status != "ok":
            errors.append(f"rank {r}:\n{value}")
        out.append(value)
    if hung or errors:
        raise RuntimeError(f"ranks hung: {hung}\n" + "\n".join(errors))
    return out


def loopback(faces, shape) -> list:
    """The faces each slab of a (t, y) mesh sent (KH-P's (mh, th) per slab,
    in rank order) handed to its neighbours by device copies -> the (th, mh)
    each slab received (mh None with one y slab): what `comm.exchange`
    delivers between processes, on one card.  Only the checks of the rank
    kernels move faces so."""
    t, y = shape
    out = []
    for r in range(t * y):
        i, j = divmod(r, y)
        up_t, dn_t = ((i + 1) % t) * y + j, ((i - 1) % t) * y + j
        up_y, dn_y = i * y + (j + 1) % y, i * y + (j - 1) % y
        th = torch.stack([faces[dn_t][1].select(-3, 0), faces[up_t][1].select(-3, 1)], dim=-3)
        mh = None
        if y > 1:
            t_loc = faces[r][0].shape[-3] // 2
            mh = torch.cat([faces[dn_y][0].narrow(-3, 0, t_loc),
                            faces[up_y][0].narrow(-3, t_loc, t_loc)], dim=-3).contiguous()
        out.append((th.contiguous(), mh))
    return out


def slab_of(x: np.ndarray, mesh) -> np.ndarray:
    """This rank's slab [..., T_loc, X, m_loc] of a whole field."""
    i, j = mesh.coords
    t_loc, m_loc = x.shape[-3] // mesh.t, x.shape[-1] // mesh.y
    return np.ascontiguousarray(x[..., i * t_loc:(i + 1) * t_loc, :, j * m_loc:(j + 1) * m_loc])


def join(slabs, shape) -> np.ndarray:
    """The whole field from the slabs of ranks 0 .. t y - 1 (mesh `shape`)."""
    t, y = shape
    rows = [np.concatenate(slabs[i * y:(i + 1) * y], axis=-1) for i in range(t)]
    return np.concatenate(rows, axis=-3)
