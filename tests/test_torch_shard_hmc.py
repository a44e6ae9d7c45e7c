"""The domain-decomposed paths of the port on the CPU: `cli.hmc --cpu` on
sample-input/hmc5-multichip.input as shipped (4^3 x 8 on 4 x 2 slabs), one
trajectory of hmc5's action on a (2, 2) mesh against the same trajectory
without a mesh, and the batched inversion and the doublet multishift solve
under a mesh against the same solves without one.  These compare the port
with itself; its hop on the slabs is held to the reference in
tests/test_torch_shard.py.
"""

import os

import numpy as np
import pytest
import torch

from tmlqcd_tpu_torch import bridge, config, config_tmlqcd, parallel, rng, su3
from tmlqcd_tpu_torch.cli import hmc as cli_hmc
from tmlqcd_tpu_torch.hmc import Draws, hmc_trajectory
from tmlqcd_tpu_torch.hmc.rational_monomials import _NDOps
from tmlqcd_tpu_torch.inverter import invert_eo_rhs
from tmlqcd_tpu_torch.lattice import Lattice
from tmlqcd_tpu_torch.ops import dslash_cuda as dc
from tmlqcd_tpu_torch.ops import wilson_fast as wf
from tmlqcd_tpu_torch.ops.ndoublet import NDParams
from tmlqcd_tpu_torch.ops.wilson import DiracParams, d_full
from tmlqcd_tpu_torch.solvers.multishift import cg_multishift

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HMC5 = os.path.join(ROOT, "sample-input", "hmc5-multichip.input")
DIMS = (8, 4, 4, 4)
LAT = Lattice(DIMS)


def test_cli_hmc_runs_hmc5_as_shipped(tmp_path, capsys):
    """`python -m tmlqcd_tpu_torch.cli.hmc -f hmc5-multichip.input --cpu`:
    the mesh line, 4 trajectories in output.data with the plaquette in
    (0, 1), the checkpoints of NSave = 2, and every solve on the slab
    kernels' plain version (K4 alone: T_loc = 2)."""
    dc.reset_counters()
    assert cli_hmc.main(["-f", HMC5, "-o", str(tmp_path), "--cpu"]) == 0
    out = capsys.readouterr().out
    assert ("[hmc] device mesh {'t': 4, 'm': 2} over 1 devices (t x y slabs: 2 x 2, "
            "8 slabs per device)") in out
    with open(tmp_path / "output.data") as f:
        rows = [ln.split() for ln in f if ln.strip() and not ln.startswith("#")]
    assert len(rows) == 4
    for traj, cols in enumerate(rows):
        assert int(cols[0]) == traj and 0.0 < float(cols[1]) < 1.0
        assert np.isfinite(float(cols[3])) and 0 < int(cols[8]) < 500
    assert sorted(os.listdir(tmp_path)) == ["conf.000002.npz", "conf.000004.npz",
                                            "nstore_counter", "output.data"]
    assert dc.hopping_slab_split_plain.calls > 0 and dc.hopping_split_rhs_plain.calls == 0
    if not torch.cuda.is_available():  # without --cpu the run needs the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli_hmc.main(["-f", HMC5, "-o", str(tmp_path / "gpu")])


_ACTION = """L = 4
T = 8
NrTProcs = {t}
NrYProcs = {y}
beta = 5.3
tau = 0.5
NumberOfTimescales = 2
BeginMonomial GAUGE
  Timescale = 0
  IntegrationSteps = 4
EndMonomial
BeginMonomial DET
  Timescale = 1
  kappa = 0.125
  2KappaMu = 0.02
  AcceptancePrecision = 1e-16
  ForcePrecision = 1e-14
  MaxSolverIterations = 500
  IntegrationSteps = 2
EndMonomial
"""

# |ddH| between the trajectory on the (2, 2) mesh and without one, derived.
# Both run the same f32 trajectory from the same draws (H_old is the same
# number: the heatbaths run the whole-lattice kernels).  They differ where a
# hop on the slabs sums other f32 values than the whole-lattice hop (the
# rebuilt half-spinor halos, the diagonals applied outside the kernel):
# roundings of relative size eps = 2^-24 ~ 6e-8 on single components, with
# the same solver iteration counts (asserted).  H_new is an f64 sum of
# N ~ 8 x 4 x V terms of size ~ |H| / N each (momenta, plaquettes and
# pseudofermion components alike), whose roundings in the two runs are
# independent, so |dH_new| ~ eps |H| / sqrt(N): 6e-8 x 2.8e4 / 90 ~ 2e-5 at
# 8 x 4^3.  Over 4 x 2 MD steps of tau = 0.5 the perturbation is not
# amplified by much more; the bound is 10x the estimate.  Measured
# (seeds 9-11, meshes (2,2) and (4,2)): 5e-6 to 3.4e-5 against a bound of
# 3.7e-4.  A wrong neighbour on a slab surface moves dH by O(1).
EPS_F32 = 2.0 ** -24


def _ddh_bound(st, lat) -> float:
    n = 8 * 4 * lat.volume
    return 10 * EPS_F32 * (abs(st.h_old) + abs(st.h_new)) / np.sqrt(n)


def _draws(lat, cfg, seed):
    gen = np.random.default_rng(seed)
    mom = su3.random_momenta(rng.generator(rng.Key(seed), "cpu"), (4,) + lat.site_shape)
    etas = [None if not hasattr(m, "chrono_init_state") else
            torch.as_tensor(bridge.numpy_spinor(gen, (4, 3) + lat.eo_site_shape))
            for m in cfg.monomials]
    return Draws(mom, etas, 0.5)


def test_sharded_trajectory_matches_unsharded():
    """hmc5's action (GAUGE + DET at beta 5.3, kappa 0.125, 2 kappa mu 0.02,
    steps 4/2) at 8 x 4^3: on 2 x 2 slabs (T_loc = 4: K3-I and K4) and
    without a mesh, the same draws.  Equal acceptance-solve and force-solve
    iteration counts and acceptance, |ddH| within the derived bound above."""
    runs = {}
    for t, y in ((2, 2), (1, 1)):
        run = config_tmlqcd.parse_input(_ACTION.format(t=t, y=y))
        cfg = config.build_hmc(run, parallel.mesh_from_procs(run.nr_procs, run.lat, "cpu"))
        assert cfg.lat.dims == DIMS
        assert (cfg.mesh is None) == (t == 1) and all(
            getattr(m, "mesh", None) is cfg.mesh for m in cfg.monomials[1:])
        u = su3.random_su3(rng.generator(rng.Key(7), "cpu"), (4,) + LAT.site_shape)
        dc.reset_counters()
        with torch.no_grad():
            _, st = hmc_trajectory(cfg, u, rng.Key(8), draws=_draws(LAT, cfg, 9))
        runs[(t, y)] = (st, dc.hopping_slab_split_plain.calls)
    (sh, n_slab), (whole, n_whole) = runs[(2, 2)], runs[(1, 1)]
    assert n_slab > 0 and n_whole == 0
    assert sh.acc_iterations == whole.acc_iterations
    assert sh.force_iterations == whole.force_iterations
    assert sh.accepted == whole.accepted
    assert sh.h_old == whole.h_old
    bound = _ddh_bound(whole, LAT)
    ddh = abs(sh.delta_h - whole.delta_h)
    assert ddh <= bound, (ddh, bound)
    assert abs(sh.plaquette - whole.plaquette) < 1e-6


@pytest.fixture(scope="module")
def gauge():
    u = bridge.numpy_su3(np.random.default_rng(71), (4,) + LAT.site_shape)
    return bridge.gauge_from_numpy(u, LAT)


@pytest.mark.parametrize("c_sw,mesh", [
    (0.0, parallel.Mesh(2, 2, "cpu")), (1.3, parallel.Mesh(2, 2, "cpu")),
    (0.0, parallel.Mesh(2, 2, "cpu", overlap=False)),
    (0.0, parallel.Mesh(2, 1, "cpu", overlap=False))],
    ids=["tm", "clover", "tm-2x2-K3", "tm-2x1-K1T"])
def test_batched_inversion_under_a_mesh(gauge, c_sw, mesh):
    """invert_eo_rhs of 3 sources on slabs (the batched CG on the multi-RHS
    slab kernels: KH's halos and K3-I+K4 on 2 x 2 slabs, K3 without the
    overlap, K1-T on t slabs without it) against the same solve
    without a mesh: the same iterations, solutions within 1e-5."""
    params = DiracParams(kappa=0.13, mu=0.04, c_sw=c_sw)
    bs = bridge.sources_from_numpy(
        bridge.numpy_spinor(np.random.default_rng(72), (3, 4, 3) + LAT.site_shape), LAT)
    dc.reset_counters()
    out = invert_eo_rhs(gauge, bs, params, LAT, tol=1e-7, maxiter=300, mesh=mesh)
    # one slab call per hop (K3-I+K4 with the overlap, after KH's halos);
    # 4 hops per CG iteration and per initial residual
    assert dc.hopping_slab_split_plain.calls == 4 * (out.iterations + 1)
    assert dc.halo_pack.plain_calls == (4 * (out.iterations + 1) if mesh.overlap else 0)
    ref = invert_eo_rhs(gauge, bs, params, LAT, tol=1e-7, maxiter=300)
    assert out.iterations == ref.iterations < 300
    assert float((out.x - ref.x).abs().max()) < 1e-5


@pytest.mark.parametrize("c_sw", [0.0, 1.3], ids=["tm", "clover"])
def test_doublet_multishift_under_a_mesh(gauge, c_sw):
    """The NDRAT multishift solve (Q_nd^2 + sigma_k) x_k = b on 2 x 2 slabs
    (the doublet on the multi-RHS slab kernels, flavour the R axis) against
    the same solve without a mesh: the same iterations, solutions within
    1e-5."""
    params = NDParams(kappa=0.13, mubar=0.12, epsbar=0.15, c_sw=c_sw)
    b2 = wf.to_split(torch.as_tensor(
        bridge.numpy_spinor(np.random.default_rng(73), (2, 4, 3) + LAT.eo_site_shape)))
    shifts = np.array([0.01, 0.1, 1.0])
    mesh = parallel.Mesh(2, 2, "cpu")
    with torch.no_grad():
        got = cg_multishift(_NDOps(gauge, params, LAT, False, mesh).a, b2, shifts, tol=1e-7,
                            maxiter=300)
        ref = cg_multishift(_NDOps(gauge, params, LAT, False).a, b2, shifts, tol=1e-7,
                            maxiter=300)
    assert got.iterations == ref.iterations < 300
    assert float((got.x - ref.x).abs().max()) < 1e-5
