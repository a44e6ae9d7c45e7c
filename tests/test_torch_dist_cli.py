"""Chains over ranks and the CLIs with --distributed on spawned gloo
ranks (`tests/dist_ranks.py`) against the port in one process, on the CPU:
the costly runs of tests/test_torch_dist.py, in a file of at most 8 tests
so that the test runner queues it behind tests/test_multirhs.py.  Port
only: the ranks and this file import no JAX.

Bounds, each stated where it is used:
* chains over ranks equal the one-process loop bit for bit;
* `cli.hmc --distributed` on hmc5-multichip.input as shipped, 8 ranks,
  against the one-process mesh run: dH within the bound derived below,
  the plaquette to 1e-5, equal acceptance and iteration counts;
* `cli.invert --distributed` writes from rank 0 alone, the propagator
  equal to the one-process run's bit for bit.
"""

import os

import numpy as np
import torch

from dist_ranks import run_ranks
from tmlqcd_tpu_torch import comm, parallel, rng
from tmlqcd_tpu_torch.lattice import Lattice
from tmlqcd_tpu_torch.ops import dslash_cuda as dc

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HMC5 = os.path.join(ROOT, "sample-input", "hmc5-multichip.input")
EPS_F32 = 2.0 ** -24


def _chains(rank, n_chains):
    from tmlqcd_tpu_torch import su3
    from tmlqcd_tpu_torch.models.suites import pure_gauge

    lat = Lattice((4, 4, 4, 4))
    cfg = pure_gauge(lat, beta=5.5, tau=0.5, steps=3)
    us = parallel.chain_init(n_chains, lambda k: su3.random_su3(rng.generator(k, "cpu"),
                                                               (4,) + lat.site_shape), rng.Key(7))
    keys = [rng.Key(8).fold(c) for c in range(n_chains)]
    with torch.no_grad():
        out, st = parallel.parallel_chains(cfg, us, keys)
    return out.numpy(), st._asdict()


def test_chains_over_ranks_equal_the_one_process_loop(tmp_path):
    """Three chains on two ranks (chain c on rank c mod 2, the results
    exchanged): every rank returns every chain, bit for bit the chains of
    the one-process loop with the same keys (tests/test_aux.py:85)."""
    res = run_ranks(_chains, 2, tmp_path, 3)
    want_u, want_st = _chains(0, 3)
    for u, st in res:
        np.testing.assert_array_equal(u, want_u)
        for name, val in want_st.items():
            np.testing.assert_array_equal(st[name], val, err_msg=name)


def _cli_hmc(rank, out_dir):
    from tmlqcd_tpu_torch.cli import hmc as cli_hmc

    dc.reset_counters()
    cli_hmc.main(["-f", HMC5, "-o", out_dir, "--cpu", "--distributed"])
    return dc.hopping_slab_split_plain.calls, dc.hopping_ug_vjp_slab_plain.calls, \
        dc.hopping_split_plain.calls, dc.hopping_schur_plain.calls, comm.stats()


def _rows(path):
    with open(path) as f:
        return [ln.split() for ln in f if ln.strip() and not ln.startswith("#")]


def test_cli_hmc_distributed_runs_hmc5_as_shipped(tmp_path, capfd):
    """`cli.hmc --distributed --cpu` on hmc5-multichip.input as shipped over
    8 gloo ranks (4 x 2 slabs, one per rank) against the one-process mesh
    run of the same input: the same trajectories to f32 rounding.

    dH bound, derived as in tests/test_torch_shard_hmc.py: the two runs sum
    other f32 values (the sharded heatbath, the f64 sums in another order),
    |dH_new| ~ eps |H| / sqrt(N), N = 8 x 4 x V terms, bounded by 10x that
    with |H_old| + |H_new| <= 2 |H|; output.data holds no H, so |H| is
    bounded from above by the means of its parts at V = 8 x 4^3: momenta
    16 V, gauge 6 beta V (1 - plaquette) <= 6 beta V, pseudofermion 6 V."""
    dist_dir, one_dir = str(tmp_path / "dist"), str(tmp_path / "one")
    counts = run_ranks(_cli_hmc, 8, tmp_path, dist_dir)
    out = capfd.readouterr().out
    assert "device mesh {'t': 4, 'm': 2} over 8 ranks (gloo; t x y slabs: 2 x 2" in out
    from tmlqcd_tpu_torch.cli import hmc as cli_hmc

    assert cli_hmc.main(["-f", HMC5, "-o", one_dir, "--cpu"]) == 0
    dist_rows, one_rows = _rows(os.path.join(dist_dir, "output.data")), \
        _rows(os.path.join(one_dir, "output.data"))
    assert len(dist_rows) == len(one_rows) == 4
    vol = 8 * 4 ** 3
    h = 16 * vol + 6 * 5.3 * vol + 6 * vol
    bound = 10 * EPS_F32 * 2 * h / np.sqrt(8 * 4 * vol)
    for d, o in zip(dist_rows, one_rows):
        assert d[0] == o[0] and d[5] == o[5] and d[7:] == o[7:]  # traj, accept, iterations
        assert abs(float(d[3]) - float(o[3])) <= bound and np.isfinite(float(d[3]))
        assert abs(float(d[1]) - float(o[1])) <= 1e-5
    assert sorted(os.listdir(dist_dir)) == ["conf.000002.npz", "conf.000004.npz",
                                            "nstore_counter", "output.data"]
    a, b = (np.load(os.path.join(x, "conf.000004.npz"))["gauge"] for x in (dist_dir, one_dir))
    assert np.max(np.abs(a - b)) <= 1e-4
    for slab_calls, vjp_calls, k1_calls, k1s_calls, st in counts:
        # every hop on the slab kernels' plain version, K2-S in every force,
        # the whole-lattice hops never
        assert slab_calls > 0 and vjp_calls > 0 and k1_calls == 0 and k1s_calls == 0
        assert st["exchanges"] > 0


_INVERT_INPUT = ("L = 4\nT = 4\nBeginOperator TMWILSON\n  kappa = 0.13\n  2KappaMu = 0.026\n"
                 "  Solver = cg\n  SolverPrecision = 1e-12\n  MaxSolverIterations = 200\n"
                 "EndOperator\n")


def _cli_invert(rank, argv):
    from tmlqcd_tpu_torch.cli import invert as cli_invert

    return cli_invert.main(argv + ["--cpu", "--distributed"])


def test_cli_invert_distributed_writes_from_rank_zero(tmp_path, capfd):
    """`cli.invert --distributed` on 2 gloo ranks: the inverter builds no
    mesh, so each rank inverts the whole lattice and rank 0 alone writes
    the propagator and the log (the reference's --distributed); the file
    equals the one-process run's bit for bit."""
    from tmlqcd_tpu_torch import su3
    from tmlqcd_tpu_torch.cli import invert as cli_invert
    from tmlqcd_tpu_torch.io.checkpoint import save_checkpoint

    lat = Lattice((4, 4, 4, 4))
    conf = save_checkpoint(str(tmp_path / "confs"),
                           su3.random_su3(rng.generator(rng.Key(9), "cpu"), (4,) + lat.site_shape),
                           3, 1, lat)
    inp = tmp_path / "invert.input"
    inp.write_text(_INVERT_INPUT)
    common = ["-f", str(inp), "-c", conf, "--format", "npz", "--columns", "2"]
    assert run_ranks(_cli_invert, 2, tmp_path, common + ["-o", str(tmp_path / "dist")]) == [0, 0]
    out = capfd.readouterr().out
    assert out.count("[invert] distributed: process 0 of 2") == 1
    assert out.count("[invert] wrote") == 1
    assert os.listdir(tmp_path / "dist") == ["propagator.00.000003.npz"]
    assert cli_invert.main(common + ["-o", str(tmp_path / "one"), "--cpu"]) == 0
    with np.load(tmp_path / "dist" / "propagator.00.000003.npz") as a, \
            np.load(tmp_path / "one" / "propagator.00.000003.npz") as b:
        np.testing.assert_array_equal(a["propagator"], b["propagator"])
