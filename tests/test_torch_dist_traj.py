"""Whole HMC trajectories on the ranks of a distributed mesh (spawned gloo
ranks on the CPU, `tests/dist_ranks.py`) against the port in one process.
Port only: no JAX.

* GAUGE + DET at 4^4 on (2, 2) ranks against the one-process (2, 2) mesh:
  the port of tests/test_sharding.py::test_full_trajectory_sharded_equals_
  unsharded (leapfrog 2 steps over tau 0.4, chrono off, CG to 1e-7 in at
  most 150 iterations, the same key).  Draws come from the key on both sides
  and do not depend on the decomposition (`rng`, by timeslice).
* The action of the reference's `dryrun_multichip` phase 2 (GAUGE +
  CLOVERDETRATIO + NDRAT, `models.suites.dryrun_action`) on (2, 2) ranks
  against one process without a mesh.

Bounds: |ddH| within the derivation of tests/test_torch_shard_hmc.py (the
two sides sum other f32 values in the sharded operators and the f64 sums in
another order: |ddH| ~ eps |H| / sqrt(N), N = 8 x 4 x V, 10x that), the
plaquette to 1e-5, every link to 5e-5 (the reference's own gate), equal
acceptance and iteration counts.
"""

import numpy as np
import pytest
import torch

from dist_ranks import join, run_ranks
from tmlqcd_tpu_torch import parallel, rng
from tmlqcd_tpu_torch.hmc import (
    DetMonomial,
    GaugeMonomial,
    HMCConfig,
    IntegratorConfig,
    Level,
    hmc_trajectory,
)
from tmlqcd_tpu_torch.lattice import Lattice
from tmlqcd_tpu_torch.models.suites import dryrun_action
from tmlqcd_tpu_torch.ops.wilson import DiracParams

torch.set_num_threads(1)

DIMS = (4, 4, 4, 4)
EPS_F32 = 2.0 ** -24


def _gauge_det(lat, mesh):
    det = DetMonomial(lat=lat, params=DiracParams(kappa=0.13, mu=0.05), timescale=0,
                      acc_tol=1e-7, force_tol=1e-7, maxiter=150, chrono_n=0, mesh=mesh)
    return HMCConfig(lat, (GaugeMonomial(lat=lat, beta=5.5, timescale=0), det),
                     IntegratorConfig(tau=0.4, levels=(Level("leapfrog", 2),)), mesh=mesh)


def _trajectory(rank, action, shape, seed):
    """One trajectory of `action` from the hot start and draws of `seed`: on
    a group of ranks the distributed mesh of `shape`; in the parent (rank
    None) one process with the one-process mesh of `shape`, or none."""
    lat = Lattice(DIMS)
    if rank is None:
        mesh = None if shape is None else parallel.Mesh(*shape, device="cpu")
    else:
        mesh = parallel.make_mesh(shape, ["cpu"])
        lat = mesh.local(lat)
    cfg = _gauge_det(lat, mesh) if action == "gauge_det" else dryrun_action(Lattice(DIMS), mesh)
    key = rng.Key(seed)
    with torch.no_grad():
        u, st = hmc_trajectory(cfg, rng.random_su3_field(key.fold(0), cfg.lat, "cpu"),
                               key.fold(1))
    return u.numpy(), st._asdict()


def _ddh_bound(st) -> float:
    n = 8 * 4 * int(np.prod(DIMS))
    return 10 * EPS_F32 * (abs(st["h_old"]) + abs(st["h_new"])) / np.sqrt(n)


@pytest.fixture(scope="module", params=["gauge_det", "dryrun"])
def pair(request, tmp_path_factory):
    action = request.param
    ranks = run_ranks(_trajectory, 4, tmp_path_factory.mktemp(action), action, (2, 2), 11)
    one = _trajectory(None, action, (2, 2) if action == "gauge_det" else None, 11)
    return join([u for u, _ in ranks], (2, 2)), [st for _, st in ranks], one


def test_ranks_agree_among_themselves(pair):
    """Every rank reports the same trajectory statistics (global sums)."""
    _, sts, _ = pair
    assert all(st == sts[0] for st in sts[1:])


def test_distributed_trajectory_matches_one_process(pair):
    u, sts, (u_one, st_one) = pair
    st = sts[0]
    assert np.isfinite(st["delta_h"])
    assert abs(st["delta_h"] - st_one["delta_h"]) <= _ddh_bound(st_one)
    assert abs(st["plaquette"] - st_one["plaquette"]) <= 1e-5
    assert st["accepted"] == st_one["accepted"]
    assert st["acc_iterations"] == st_one["acc_iterations"]
    assert st["force_iterations"] == st_one["force_iterations"]
    assert float(np.max(np.abs(u - u_one))) <= 5e-5
