"""Checkpoint / resume: `conf.NNNNNN.npz` (native) or `conf.NNNNNN.lime`
(ILDG).

Port of `tmlqcd_tpu/io/checkpoint.py`: the same npz keys (`gauge` complex
[3,3,4,T,X,Y*Z], `trajectory`, `seed`, `dims`, `meta`), the same ILDG records
(`io/ildg.py`), the same `nstore_counter` file ("<trajectory> <name> <seed>"),
tmp+rename atomic writes and pruning to the newest `keep` configurations —
so a file written by either package reads in the other.  The RNG state is
(seed, trajectory counter), as in the reference.

On the ranks of a distributed run every rank calls `save_checkpoint` with
its slab and the slab's lattice: the slabs are gathered over the
lattice's mesh (`parallel.gather_to_host`) and rank 0 writes, as the
reference writes from process 0 after its all-gather; the read places each
rank's slab (`parallel.load_gauge_sharded`).
"""

from __future__ import annotations

import json
import os

import numpy as np

from tmlqcd_tpu_torch.io import ildg
from tmlqcd_tpu_torch.lattice import Lattice
from tmlqcd_tpu_torch.utils import to_host

__all__ = ["save_checkpoint", "load_checkpoint", "latest_checkpoint", "checkpoint_at",
           "CheckpointInfo"]

_COUNTER_FILE = "nstore_counter"


def save_checkpoint(run_dir: str, u, trajectory: int, seed: int, lat: Lattice,
                    fmt: str = "native", keep: int = 2, precision: int = 64, **meta) -> str:
    """Write conf.{trajectory:06d}(.npz|.lime) + nstore_counter atomically and
    prune to the newest `keep` configurations.  With a slab's `lat` (a
    distributed run) `u` is this rank's slab; every rank calls it, rank 0
    writes the gathered field and every rank returns the path."""
    if fmt not in ("native", "ildg"):
        raise ValueError(f"unknown checkpoint format {fmt!r}")
    name = f"conf.{trajectory:06d}." + ("npz" if fmt == "native" else "lime")
    mesh = lat.mesh
    if mesh is not None:
        from tmlqcd_tpu_torch.parallel import gather_to_host

        arr, lat = gather_to_host(u, mesh), Lattice(lat.global_dims)
        if mesh.rank != 0:
            return os.path.join(run_dir, name)
    else:
        arr = to_host(u)
    os.makedirs(run_dir, exist_ok=True)
    if fmt == "native":
        tmp = os.path.join(run_dir, name + ".tmp")
        with open(tmp, "wb") as f:
            np.savez(f, gauge=arr, trajectory=np.int64(trajectory), seed=np.int64(seed),
                     dims=np.asarray(lat.dims, np.int64), meta=json.dumps(meta))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(run_dir, name))
    else:
        ildg.write_gauge_field(os.path.join(run_dir, name), arr, lat, trajectory=trajectory,
                               precision=precision, **meta)

    tmp = os.path.join(run_dir, _COUNTER_FILE + ".tmp")
    with open(tmp, "w") as f:
        f.write(f"{trajectory} {name} {seed}\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(run_dir, _COUNTER_FILE))
    _prune(run_dir, keep)
    return os.path.join(run_dir, name)


def _prune(run_dir: str, keep: int) -> None:
    confs = sorted(f for f in os.listdir(run_dir)
                   if f.startswith("conf.") and not f.endswith(".tmp"))
    for f in confs[:-keep] if keep > 0 else []:
        try:
            os.remove(os.path.join(run_dir, f))
        except FileNotFoundError:
            pass


class CheckpointInfo:
    def __init__(self, trajectory: int, path: str, seed: int):
        self.trajectory = trajectory
        self.path = path
        self.seed = seed


def latest_checkpoint(run_dir: str) -> CheckpointInfo | None:
    """Read nstore_counter (InitialStoreCounter = readin)."""
    counter = os.path.join(run_dir, _COUNTER_FILE)
    if not os.path.exists(counter):
        return None
    with open(counter) as f:
        parts = f.read().split()
    traj, name = int(parts[0]), parts[1]
    seed = int(parts[2]) if len(parts) > 2 else 0
    path = os.path.join(run_dir, name)
    if not os.path.exists(path):
        return None
    return CheckpointInfo(traj, path, seed)


def checkpoint_at(run_dir: str, trajectory: int) -> CheckpointInfo | None:
    """The checkpoint of a given trajectory (InitialStoreCounter = N)."""
    for ext in ("npz", "lime"):
        path = os.path.join(run_dir, f"conf.{trajectory:06d}.{ext}")
        if os.path.exists(path):
            return CheckpointInfo(trajectory, path, 0)
    return None


def load_checkpoint(path: str, expect_lat: Lattice | None = None):
    """Load a native or ILDG checkpoint -> (gauge numpy, trajectory, seed)."""
    if path.endswith(".npz"):
        with np.load(path, allow_pickle=False) as z:
            u = z["gauge"]
            dims = tuple(int(d) for d in z["dims"])
            if expect_lat is not None and dims != expect_lat.dims:
                raise ValueError(f"{path}: lattice {dims} != {expect_lat.dims}")
            return u, int(z["trajectory"]), int(z["seed"])
    u, hdr = ildg.read_gauge_field(path, expect_lat)
    return u, int(hdr.trajectory or 0), 0
