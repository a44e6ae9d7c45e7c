"""Measurements, NDPOLY and the Schrödinger functional on the ranks of a
distributed mesh (spawned gloo ranks on the CPU, `tests/dist_ranks.py`)
against the port in one process.  Port only: the ranks and this file
import no JAX.

One function (`_measure`) runs on each rank of a mesh, on its slab, and in
the parent on the whole lattice, while the ranks run; the parent joins the
ranks' slabs.  One spawn per mesh shape at 8 x 4^3: (2, 1) here, with its
10 tests; (2, 2) and (1, 2) in tests/test_torch_dist_meas_2x2.py and
tests/test_torch_dist_meas_1x2.py, which collect the checks of this file on
their ranks (a spawn with at most 8 users runs in a file of at most 8
tests, which the test runner queues behind tests/test_multirhs.py).
Bounds, each stated where it is used:
* the Z2, gaussian and point sources do not depend on the decomposition
  (bit for bit: drawn by global timeslice);
* ONLINE and PIONNORM through the runner, their source drawn from the key:
  equal CG iterations and C(t) to 1e-6 relative (f32 solves that differ by
  the rounding of the sharded operator against the whole-lattice one), and
  only rank 0 writes the files;
* the gauge observables on a complex128 field (Polyakov loops along 0-3,
  oriented plaquettes, E_plaq, E_clover, Q): 1e-12 relative, the same f64
  terms summed in another order (the Polyakov product in the same order);
* 3 flow steps: the flowed links bit for bit (shifts are copies, every
  other operation is per site);
* the SF action, dS/deta, force and momenta mask on t-ranks: 1e-12 relative
  (complex128), the mask exactly;
* NDPOLY (degree 4, twisted mass and clover), its reference in one process
  on the one-process mesh of the same shape (whose sharded hop the ranks'
  equals bit for bit): the action on the same phi to 1e-10 relative, the
  force to 1e-5 of max|F| (the force's hops on HoppingDiff, the
  whole-lattice hop in one process); on (2, 2) the heatbath: S_0 = |eta|^2
  to 1e-12, phi to 1e-6 of max|phi| (CG steps in f32 whose f64 scalars sum
  in another order);
* on (2, 1): a GAUGE + NDPOLY and an SFGAUGE trajectory against one
  process without a mesh, and `cli.hmc --distributed` with ONLINE and
  GRADIENTFLOW against `cli.hmc` in one process (bounds at the tests).
"""

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from dist_ranks import join, run_ranks, slab_of
from tmlqcd_tpu_torch import bridge, comm, config_tmlqcd, parallel, rng
from tmlqcd_tpu_torch.hmc import (
    GaugeMonomial,
    HMCConfig,
    IntegratorConfig,
    Level,
    NDPolyMonomial,
    SFGaugeMonomial,
    hmc_trajectory,
)
from tmlqcd_tpu_torch.inverter import invert_eo
from tmlqcd_tpu_torch.lattice import Lattice
from tmlqcd_tpu_torch.meas import correlators, gauge_obs, gradient_flow, runner, sources
from tmlqcd_tpu_torch.ops import ndoublet as nd
from tmlqcd_tpu_torch.ops import sf
from tmlqcd_tpu_torch.ops import wilson_fast as wf
from tmlqcd_tpu_torch.ops.wilson import DiracParams

torch.set_num_threads(1)

DIMS = (8, 4, 4, 4)
LAT = Lattice(DIMS)
PARAMS = DiracParams(kappa=0.13, mu=0.1)
ND = dict(kappa=0.15, mubar=0.15, epsbar=0.05)
SF = dict(beta=6.0, eta=0.3, nu=0.1, ct=1.2)
TRAJ = 5
MEAS_INPUT = ("L = 4\nT = 8\n"
              "BeginMeasurement ONLINE\n Frequency = 1\n kappa = 0.13\n 2KappaMu = 0.026\n"
              " SolverPrecision = 1e-12\n MaxSolverIterations = 500\nEndMeasurement\n"
              "BeginMeasurement PIONNORM\n Frequency = 1\n kappa = 0.13\n 2KappaMu = 0.026\n"
              " SolverPrecision = 1e-12\n MaxSolverIterations = 500\nEndMeasurement\n"
              + "".join(f"BeginMeasurement POLYAKOV\n Frequency = 1\n Direction = {d}\n"
                        "EndMeasurement\n" for d in (0, 2))
              + "BeginMeasurement ORIENTEDPLAQUETTES\n Frequency = 1\nEndMeasurement\n"
              "BeginMeasurement FIELDSTRENGTH\n Frequency = 1\nEndMeasurement\n"
              "BeginMeasurement SFCOUPLING\n Frequency = 1\n Eta = 0.3\nEndMeasurement\n")
# cli.hmc on (2, 1) ranks: a pure-gauge trajectory (its MD per site, so the
# same links on the ranks and in one process), then ONLINE and GRADIENTFLOW
CLI_INPUT = ("L = 4\nT = 8\nNrTProcs = 2\nMeasurements = 1\nNSave = 1\nStartCondition = hot\n"
             "Seed = 13\nbeta = 5.5\ntau = 0.3\nBeginMonomial GAUGE\n IntegrationSteps = 3\n"
             "EndMonomial\n"
             "BeginMeasurement ONLINE\n Frequency = 1\n kappa = 0.13\n 2KappaMu = 0.026\n"
             " SolverPrecision = 1e-12\n MaxSolverIterations = 500\nEndMeasurement\n"
             "BeginMeasurement GRADIENTFLOW\n Frequency = 1\n StepSize = 0.02\n Steps = 3\n"
             "EndMeasurement\n")
EPS_F32 = 2.0 ** -24


def _fields():
    """Every field of the checks, from numpy seeds (the same on every rank;
    contiguous, so that the per-site arithmetic takes the same route on a
    slab and on the whole lattice)."""
    u = np.ascontiguousarray(bridge.numpy_su3(np.random.default_rng(71), (4,) + LAT.site_shape))
    gen = np.random.default_rng(72)
    return dict(u=u, u128=u.astype(np.complex128),
                eta=bridge.numpy_spinor(gen, (2, 4, 3) + LAT.eo_site_shape),
                phi=bridge.numpy_spinor(gen, (2, 4, 3) + LAT.eo_site_shape))


def _ndpoly(lat, c_sw, mesh, degree=4):
    return NDPolyMonomial(lat=lat, params=nd.NDParams(c_sw=c_sw, **ND), degree=degree,
                          s_min=0.05, s_max=6.0, heatbath_tol=1e-5, maxiter=500, mesh=mesh)


def _measure(lat, cut, run_dir):
    """Everything the checks compare that does not depend on the mesh, on
    `lat` (a rank's slab, or the whole lattice in the parent); `cut` takes a
    whole numpy field to the part held here."""
    f = _fields()
    u = torch.as_tensor(cut(f["u"]))
    u128 = torch.as_tensor(cut(f["u128"]))
    site = (4, 3) + lat.site_shape
    out = {"draws": (rng.z2_spinor(rng.Key(5), site, "cpu", lat=lat).numpy(),
                     sources.z2_timeslice_source(lat, 5, rng.Key(6), device="cpu").numpy(),
                     sources.volume_source(lat, rng.Key(6), device="cpu").numpy(),
                     sources.gaussian_timeslice_source(lat, 3, rng.Key(6),
                                                       device="cpu").numpy(),
                     sources.point_source(lat, 2, 1, (5, 1, 3, 2), device="cpu").numpy())}
    # the runner: every rank runs every measurement, rank 0 writes; the
    # solves' iterations recorded on the way
    iterations = []

    def recorded(*a, **k):
        res = invert_eo(*a, **k)
        iterations.append(res.iterations)
        return res

    os.makedirs(run_dir, exist_ok=True)
    saved, correlators.invert_eo = correlators.invert_eo, recorded
    try:
        runner.run_measurements(config_tmlqcd.parse_input(MEAS_INPUT), u, lat, TRAJ, run_dir,
                                rng.Key(9))
    finally:
        correlators.invert_eo = saved
    out["files"] = sorted(os.listdir(run_dir))
    out["iterations"] = iterations
    # gauge observables in complex128
    out["obs"] = np.array([complex(gauge_obs.polyakov_loop(u128, lat, d)) for d in range(4)]
                          + list(gauge_obs.oriented_plaquettes(u128, lat).numpy())
                          + [float(v) for v in gauge_obs.field_strength_observables(u128, lat)])
    flow = gradient_flow.wilson_flow(u, lat, eps=0.02, n_steps=3)
    out["flow"] = (flow.v.numpy(), flow.t2e_plaq.numpy(), flow.t2e_clover.numpy())
    # the Schrödinger functional on t-ranks
    with torch.enable_grad():
        uu = u128.clone().requires_grad_(True)
        s = sf.sf_gauge_action(uu, SF["beta"], lat, SF["eta"], SF["nu"], SF["ct"])
        (g,) = torch.autograd.grad(s, uu)
    out["sf"] = (float(s.detach()), float(sf.sf_dS_deta(u128, lat=lat, **SF)), g.numpy(),
                 sf.sf_momenta_mask(lat).numpy(),
                 sf.sf_classical_background(lat, SF["eta"], SF["nu"]).numpy(),
                 sf.sf_coupling_normalization(lat, SF["ct"]))
    return out


def _ndpoly_checks(lat, cut, mesh):
    """NDPOLY on `mesh` (the ranks', or in the parent the one-process mesh
    of the same shape): the action and the force (twisted mass and clover),
    and on (2, 2) the heatbath (twisted mass)."""
    f = _fields()
    u = torch.as_tensor(cut(f["u"]))
    phi = wf.to_split(bridge.doublet_from_numpy(cut(f["phi"]), lat))
    out = {}
    for c_sw in (0.0, 1.2):
        mono = _ndpoly(lat, c_sw, mesh)
        out[("ndpoly", c_sw)] = (float(mono.action(u, phi)), mono.force(u, phi).numpy())
    if (mesh.t, mesh.y) == (2, 2):
        phi2, s0, iters = _ndpoly(lat, 0.0, mesh).heatbath_info(
            u, None, eta=bridge.doublet_from_numpy(cut(f["eta"]), lat))
        out["heatbath"] = (phi2.numpy(), float(s0), iters)
    return out


def _trajectories(lat, mesh):
    """One GAUGE + NDPOLY trajectory and one SFGAUGE trajectory (leapfrog,
    from the hot start of their seeds) on `lat` with `mesh` (the ranks'; in
    the parent none) -> their TrajectoryStats."""
    gauge = GaugeMonomial(lat=lat, beta=5.5, timescale=0)
    poly = dataclasses.replace(_ndpoly(lat, 0.0, mesh), timescale=0)
    sfg = SFGaugeMonomial(lat=lat, timescale=0, **SF)
    integ = IntegratorConfig(tau=0.2, levels=(Level("leapfrog", 1),))
    out = {}
    for name, cfg in (("ndpoly", HMCConfig(lat, (gauge, poly), integ, mesh=mesh)),
                      ("sf", HMCConfig(lat, (sfg,), integ, mesh=mesh,
                                       momenta_mask=sf.sf_momenta_mask(lat)))):
        key = rng.Key(21)
        with torch.no_grad():
            _, st = hmc_trajectory(cfg, rng.random_su3_field(key.fold(0), lat, "cpu"),
                                   key.fold(1))
        out[name] = st._asdict()
    return out


def _cli(run_dir):
    """`cli.hmc --cpu` on CLI_INPUT (with --distributed on the ranks)."""
    from tmlqcd_tpu_torch.cli import hmc as cli_hmc

    # one input file per process: the ranks write theirs at once
    path = os.path.join(os.path.dirname(run_dir), f"cli{os.getpid()}.input")
    with open(path, "w") as f:
        f.write(CLI_INPUT)
    extra = ["--distributed"] if comm.active() is not None else []
    return cli_hmc.main(["-f", path, "-o", run_dir, "--cpu"] + extra)


def _rank_measure(rank, shape, run_dir):
    mesh = parallel.make_mesh(shape, ["cpu"])
    lat = mesh.local(LAT)
    cut = lambda a: slab_of(a, mesh)  # noqa: E731
    out = _measure(lat, cut, os.path.join(run_dir, f"rank{rank}"))
    out.update(_ndpoly_checks(lat, cut, mesh))
    if shape == (2, 1):
        out["traj"] = _trajectories(lat, mesh)
        out["cli"] = _cli(os.path.join(run_dir, "cli-ranks"))
    return out


_GROUPS: dict = {}


def _group(shape, tmp_path_factory):
    """One spawn of `_rank_measure` per mesh shape for the whole module, and
    the one process's side of its checks, computed here while the ranks run
    -> (the ranks' results, the one process's, their directory).  The one
    process's side: `_measure` on the whole lattice, NDPOLY on the
    one-process mesh of the same shape (whose sharded hop the ranks' equals
    bit for bit), and on (2, 1) the trajectories without a mesh and the
    cli.hmc run."""
    if shape not in _GROUPS:
        d = tmp_path_factory.mktemp(f"meas{shape[0]}x{shape[1]}")
        with ThreadPoolExecutor(1) as pool:
            # the join's deadline above the default: the (2, 1) ranks run
            # ~30 s alone, 2-3x that beside a loaded suite
            ranks = pool.submit(run_ranks, _rank_measure, shape[0] * shape[1], d, shape, str(d),
                                timeout=300.0)
            one = _measure(LAT, lambda a: a, str(d / "one"))
            one.update(_ndpoly_checks(LAT, lambda a: a, parallel.Mesh(*shape, device="cpu")))
            if shape == (2, 1):
                one["traj"] = _trajectories(LAT, None)
                one["cli"] = _cli(str(d / "cli-one"))
            _GROUPS[shape] = ranks.result(), one, d
    return _GROUPS[shape]


def _pair(shape, tmp_path_factory):
    """The ranks' results and the one process's, their directory (twice:
    the ranks' files and the one process's are both under it)."""
    ranks, one, d = _group(shape, tmp_path_factory)
    return shape, ranks, one, d, d


@pytest.fixture(scope="module", params=[(2, 1)], ids=lambda s: f"{s[0]}x{s[1]}")
def pair(request, tmp_path_factory):
    return _pair(request.param, tmp_path_factory)


def test_sources_do_not_depend_on_the_decomposition(pair):
    """Z2 noise, the Z2 wall at t0 = 5, the Z2 volume, the gaussian wall at
    t0 = 3 and the point source at the global site (5, 1, 3, 2): the joined
    slabs equal the one-process draws bit for bit (a rank without the
    timeslice or the site holds zeros)."""
    shape, ranks, one, _, _ = pair
    for k, want in enumerate(one["draws"]):
        np.testing.assert_array_equal(join([r["draws"][k] for r in ranks], shape), want)


def _rows(path):
    with open(path) as f:
        return [[float(v) for v in ln.split()] for ln in f if ln.strip() and ln[0] != "#"]


def test_runner_files_from_rank_zero_equal_one_process(pair):
    """Every measurement of MEAS_INPUT through `run_measurements` on the
    ranks: rank 0 alone writes, the same files as one process.  ONLINE and
    PIONNORM (sources drawn from the key by timeslice, so the same on both
    sides): equal CG iterations, C(t) to 1e-6 relative of max|C|; the
    other files' numbers to 1e-6 relative (complex64 links, f64 sums in
    another order, printed to 10 digits; dS/deta sums its boundary terms in
    f64)."""
    shape, ranks, one, d, d_one = pair
    assert ranks[0]["files"] == one["files"] == sorted(
        ["onlinemeas.000005", "pionnorm.000005", "polyakov.data",
         "oriented_plaquettes.data", "field_strength.data", "sf_coupling.data"])
    assert all(r["files"] == [] for r in ranks[1:])
    assert len(one["iterations"]) == 2 and all(r["iterations"] == one["iterations"]
                                               for r in ranks)
    for name in one["files"]:
        got = np.array(_rows(os.path.join(d, "rank0", name)))
        want = np.array(_rows(os.path.join(d_one, "one", name)))
        assert got.shape == want.shape and got.shape[0] >= 1, name
        scale = np.maximum(np.abs(want).max(axis=0), 1e-300)
        assert np.all(np.abs(got - want) <= 1e-6 * scale), (name, got, want)
    cpp = np.array(_rows(os.path.join(d_one, "one", "onlinemeas.000005")))[:, 3]
    assert len(cpp) == DIMS[0] and np.all(cpp > 0)


def test_gauge_observables_match_one_process(pair):
    """Polyakov loops along t, x, y and z (the cut axes' products in global
    order), the six oriented plaquettes, E_plaq, E_clover and the charge Q
    on a complex128 field: every rank returns the whole lattice's value,
    1e-12 relative to one process."""
    _, ranks, one, _, _ = pair
    want = one["obs"]
    assert np.all(np.abs(want[:4]) > 1e-4)
    for r in ranks:
        assert np.all(np.abs(r["obs"] - want) <= 1e-12 * np.abs(want)), r["obs"] - want


def test_flow_bit_for_bit(pair):
    """Three RK3 flow steps on the ranks: the joined links equal one
    process's bit for bit; t^2 E_plaq and t^2 E_clover to 1e-12 relative,
    and E_plaq falls along the flow."""
    shape, ranks, one, _, _ = pair
    v, ep, ec = one["flow"]
    np.testing.assert_array_equal(join([r["flow"][0] for r in ranks], shape), v)
    times = 0.02 * np.arange(1, 4)
    assert np.all(np.diff(ep / times ** 2) < 0)
    for r in ranks:
        np.testing.assert_allclose(r["flow"][1], ep, rtol=1e-12)
        np.testing.assert_allclose(r["flow"][2], ec, rtol=1e-12)


def test_sf_action_slope_force_and_mask_on_ranks(pair):
    """S_SF, dS/deta (the ranks' shares summed) and the force's gradient on
    a complex128 field, with W frozen on the rank holding x0 = 0 and W' on
    the one holding x0 = T-1 (on (2, *) the rank below and the rank above
    are the same rank): 1e-12 relative to one process; the momenta mask,
    the classical background and k exactly."""
    shape, ranks, one, _, _ = pair
    s, ds, g, mask, bg, k = one["sf"]
    for r in ranks:
        assert abs(r["sf"][0] - s) <= 1e-12 * abs(s)
        assert abs(r["sf"][1] - ds) <= 1e-12 * abs(ds)
        assert r["sf"][5] == k
    got = join([r["sf"][2] for r in ranks], shape)
    assert np.max(np.abs(got - g)) <= 1e-12 * np.max(np.abs(g))
    assert not np.any(g[:, :, 1:4, 0])  # the frozen links get no force
    np.testing.assert_array_equal(join([r["sf"][3] for r in ranks], shape), mask)
    np.testing.assert_array_equal(join([r["sf"][4] for r in ranks], shape), bg)


@pytest.mark.parametrize("c_sw", [0.0, 1.2], ids=["tm", "clover"])
def test_ndpoly_action_and_force_on_ranks(pair, c_sw):
    """NDPOLY's action and force on the same phi (the bounds in the module
    docstring): every rank returns the whole action."""
    shape, ranks, one, _, _ = pair
    act, force = one[("ndpoly", c_sw)]
    got = [r[("ndpoly", c_sw)] for r in ranks]
    assert all(abs(g[0] - act) <= 1e-10 * act for g in got)
    f = join([g[1] for g in got], shape)
    assert np.max(np.abs(f - force)) <= 1e-5 * np.max(np.abs(force))


def _ddh_bound(st) -> float:
    """tests/test_torch_shard_hmc.py's bound: the two sides sum other f32
    values in the sharded operators and the f64 sums in another order,
    |ddH| ~ eps |H| / sqrt(N), N = 8 x 4 x V terms, 10x that."""
    return 10 * EPS_F32 * (abs(st["h_old"]) + abs(st["h_new"])) / np.sqrt(8 * 4 * LAT.volume)


@pytest.fixture(scope="module")
def pair_21(tmp_path_factory):
    """The (2, 1) ranks' trajectories and cli.hmc run beside the one
    process's."""
    ranks, one, d = _group((2, 1), tmp_path_factory)
    return ranks, one["traj"], one["cli"], d


@pytest.mark.parametrize("action", ["ndpoly", "sf"])
def test_trajectory_on_ranks(pair_21, action):
    """One GAUGE + NDPOLY (degree 4, its heatbath, acceptance and force on
    the sharded doublet operators) and one SFGAUGE trajectory on (2, 1)
    ranks against one process without a mesh: every rank the same stats,
    |ddH| within `_ddh_bound`, the plaquette to 1e-6, equal acceptance and
    heatbath iterations."""
    ranks, traj, _, _ = pair_21
    want = traj[action]
    got = [r["traj"][action] for r in ranks]
    assert all(g == got[0] for g in got[1:])
    g = got[0]
    assert np.isfinite(g["delta_h"]) and abs(g["delta_h"] - want["delta_h"]) <= _ddh_bound(want)
    assert abs(g["plaquette"] - want["plaquette"]) <= 1e-6
    assert g["accepted"] == want["accepted"] and g["acc_iterations"] == want["acc_iterations"]


def test_cli_hmc_distributed_with_online_and_gradientflow(pair_21):
    """`cli.hmc --distributed --cpu` on (2, 1) ranks with ONLINE and
    GRADIENTFLOW: rank 0 writes output.data, onlinemeas and gradflow, equal
    to one process's: the pure-gauge trajectory's links are the same bit for
    bit (per-site MD, shifts are copies; its dH within `_ddh_bound` of
    |H| <= 16 V + 6 beta V, the same acceptance), C(t) to 1e-6 relative (an
    f32 solve on the sharded operator against the whole-lattice one), the
    flow's t^2 E to 1e-9 relative (printed to 10 digits)."""
    ranks, _, rc, d = pair_21
    assert rc == 0 and all(r["cli"] == 0 for r in ranks)
    names = ["conf.000001.npz", "gradflow.000000", "nstore_counter", "onlinemeas.000000",
             "output.data"]
    assert sorted(os.listdir(d / "cli-ranks")) == sorted(os.listdir(d / "cli-one")) == names
    (o_r,), (o_1,) = (_rows(d / w / "output.data") for w in ("cli-ranks", "cli-one"))
    h = 16 * LAT.volume + 6 * 5.5 * LAT.volume
    assert abs(o_r[3] - o_1[3]) <= _ddh_bound({"h_old": h, "h_new": h})
    assert o_r[1] == o_1[1] and o_r[5] == o_1[5]
    with np.load(d / "cli-ranks" / "conf.000001.npz") as a, \
            np.load(d / "cli-one" / "conf.000001.npz") as b:
        np.testing.assert_array_equal(a["gauge"], b["gauge"])
    for name, rtol in (("onlinemeas.000000", 1e-6), ("gradflow.000000", 1e-9)):
        got, want = (np.array(_rows(d / w / name)) for w in ("cli-ranks", "cli-one"))
        scale = np.maximum(np.abs(want).max(axis=0), 1e-300)
        assert got.shape == want.shape and np.all(np.abs(got - want) <= rtol * scale), name
