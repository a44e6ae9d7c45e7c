"""The distributed slab mesh (one process per slab over torch.distributed)
on the CPU: spawned gloo ranks (`tests/dist_ranks.py`) against the port in
one process.  Port only: the ranks and this file import no JAX.

Each group of ranks builds every field from numpy seeds (the whole lattice,
on every rank) and keeps its own slab; the parent joins the slabs.
Bounds, each stated where it is used:
* the sharded hop on ranks (`dslash_cuda.hopping_rank`, plain route: the
  torch exchange at one slab, the faces through gloo, the slab kernels'
  plain version) equals the one-process mesh's sharded hop bit for bit, and
  the whole-lattice plain hop within the relative 2e-6 of
  tests/test_torch_shard.py (the two plain versions sum in another order;
  on the card the kernels equal K1 bit for bit, chip_smoke.py's phase 19);
* K2-S's plain version equals the whole-lattice K2 plain version bit for
  bit (the halos carry the neighbours' values or W^+-exact rebuilds);
* `dist_roll` and its backward equal torch.roll of the whole field bit for
  bit; a global sum, the plaquette and the gauge action to 1e-12 relative
  in f64 (the same terms summed in another order);
* the draws do not depend on the decomposition (bit for bit);
* the gather and the checkpoint round trip are exact;
* chains over ranks equal the one-process loop bit for bit;
* `cli.hmc --distributed` on hmc5-multichip.input as shipped, 8 ranks,
  against the one-process mesh run: dH within the bound derived below,
  the plaquette to 1e-5, equal acceptance and iteration counts;
* NDPOLY, SFGAUGE, ONLINE and GRADIENTFLOW lower through `build_hmc` on a
  (2, 1) rank mesh and run, against one process to 1e-5 relative
  (tests/test_torch_dist_meas.py holds every measurement, NDPOLY and the
  Schrödinger functional on ranks to tighter bounds).
"""

import dataclasses
import itertools
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from dist_ranks import join, run_ranks, slab_of
from tmlqcd_tpu_torch import bridge, comm, parallel, rng
from tmlqcd_tpu_torch.lattice import EVEN, ODD, Lattice, shift_full
from tmlqcd_tpu_torch.ops import dslash_cuda as dc
from tmlqcd_tpu_torch.ops import wilson_fast as wf
from tmlqcd_tpu_torch.ops.gauge_action import gauge_action, plaquette
from tmlqcd_tpu_torch.ops.wilson import DiracParams

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HMC5 = os.path.join(ROOT, "sample-input", "hmc5-multichip.input")
DIMS = (8, 4, 4, 4)
LAT = Lattice(DIMS)
PARAMS = DiracParams(kappa=0.15, mu=0.1)
SHAPES = [(2, 2), (2, 1), (1, 2)]
OPTIONS = [(True, True), (False, False), (True, False)]  # (halfspinor, overlap)
# every shift lattice.py makes along t (packed and full fields) and y (Z/2
# on packed, Z on full fields, the rectangle's repeated shifts included)
ROLLS = [(-1, -3, "t"), (1, -3, "t"), (-2, -1, "y"), (2, -1, "y"), (-4, -1, "y"), (4, -1, "y")]
RTOL_PORT = 2e-6
EPS_F32 = 2.0 ** -24


def _fields():
    """Every field of the checks, from numpy seeds (the same on every rank)."""
    u = bridge.numpy_su3(np.random.default_rng(61), (4,) + LAT.site_shape)
    gen = np.random.default_rng(62)
    return dict(u=u, psi=bridge.numpy_spinor(gen, (4, 3) + LAT.eo_site_shape),
                cols=bridge.numpy_spinor(gen, (3, 4, 3) + LAT.eo_site_shape),
                chi=bridge.numpy_spinor(gen, (2, 4, 3) + LAT.eo_site_shape),
                g=bridge.numpy_spinor(gen, (4, 3) + LAT.eo_site_shape),
                u64=bridge.numpy_su3(np.random.default_rng(63), (4,) + LAT.site_shape)
                .astype(np.complex128))


def _inputs(f, cut):
    """{r_axis: split input}: one spinor, R = 3 columns and a doublet; `cut`
    takes a whole numpy field to the part this process holds."""
    return {None: wf.to_split(torch.as_tensor(cut(f["psi"]))),
            3: wf.to_split_rhs(torch.as_tensor(cut(f["cols"]))),
            1: wf.to_split(torch.as_tensor(cut(f["chi"])))}


def _hops(fg, xs, lat, mesh):
    """The sharded hop of every input on both parities -> {(r_axis, p): numpy}."""
    out = {}
    for (r_axis, x), p in itertools.product(xs.items(), (EVEN, ODD)):
        ug = fg.ug_even if p == EVEN else fg.ug_odd
        out[(r_axis, p)] = dc.hopping_shard(ug, x, p, lat, mesh, fg.gcomp, r_axis).numpy()
    return out


def _rank_checks(rank, shape, run_dir):
    """Everything one group of ranks computes for the tests below."""
    from tmlqcd_tpu_torch.io.checkpoint import save_checkpoint

    f = _fields()
    base = parallel.make_mesh(shape, ["cpu"])
    lat = base.local(LAT)
    cut = lambda a: slab_of(a, base)  # noqa: E731
    ut = parallel.place_from_host(f["u"], base)
    res = {"coords": base.coords, "lat": (lat.dims, lat.global_dims, lat.offset)}
    fg = wf.make_fast_gauge(ut, PARAMS, lat)
    xs = _inputs(f, cut)
    for hs, ov in OPTIONS:
        res[("hop", hs, ov)] = _hops(fg, xs, lat, dataclasses.replace(base, halfspinor=hs,
                                                                      overlap=ov))
    # K2-S on the halos of the forward hop (the 18-real gauge, as HoppingDiff)
    fg18 = wf.make_fast_gauge(ut, PARAMS, lat, compress=False)
    g2 = wf.to_split(torch.as_tensor(cut(f["g"])))
    for hs, p in itertools.product((True, False), (EVEN, ODD)):
        ug = fg18.ug_even if p == EVEN else fg18.ug_odd
        _, th, mh = dc.hopping_rank(ug, xs[None], p, lat, dataclasses.replace(base, halfspinor=hs),
                                    keep_halos=True)
        res[("vjp", hs, p)] = dc.hopping_ug_vjp_slab(g2, xs[None], p, Lattice(lat.dims), th,
                                                     mh).numpy()
    if shape == (2, 1):
        for what in LOWERED:
            res[("lowered", what)] = _lowered(what, base, os.path.join(run_dir, f"{what}{rank}"))
    if shape != (2, 2):
        return res
    # the builders over the group's ranks: auto_mesh, mesh_from_procs, and a
    # decomposition that does not match the number of ranks
    auto = parallel.auto_mesh(LAT, ["cpu"])
    procs = parallel.mesh_from_procs((2, 0, 2, 0), LAT, "cpu")
    try:
        parallel.mesh_from_procs((4, 0, 2, 0), LAT, "cpu")
        wrong = None
    except ValueError as exc:
        wrong = str(exc)
    res["meshes"] = ((auto.t, auto.y, auto.rank, auto.distributed),
                     (procs.t, procs.y, procs.rank, comm.active() == procs), wrong)
    comm.activate(base)
    # one source of the decomposition: a slab lattice is made and shifted only
    # while its mesh is the active one
    guard = []
    with comm.suspended():
        for make in (lambda: shift_full(ut[0], 0, 1, lat), lambda: Lattice(lat.dims, mesh=base)):
            try:
                make()
                guard.append(None)
            except RuntimeError as exc:
                guard.append(str(exc))
    res["guard"] = guard
    # dist_roll forward and backward: the gradient of sum Re(w roll(x))
    x, w = torch.as_tensor(cut(f["u64"])), torch.as_tensor(cut(f["u64"] * (1 + 2j)))
    for shift, dim, axis in ROLLS:
        xx = x.clone().requires_grad_(True)
        y = comm.dist_roll(xx, shift, dim, axis, base)
        (gx,) = torch.autograd.grad(comm.global_sum(torch.sum((w * y).real)), xx)
        res[("roll", shift, dim)] = (y.detach().numpy(), gx.numpy())
    res["sums"] = (float(comm.global_sum(torch.sum(x.real))), float(plaquette(x, lat)),
                   float(gauge_action(x, 5.3, lat, c1=-0.331)))
    res["draws"] = (rng.normal_spinor(rng.Key(3, (1, 2)), (4, 3) + lat.eo_site_shape, "cpu",
                                      lat=lat).numpy(),
                    rng.random_momenta(rng.Key(4), (4,) + lat.site_shape, "cpu", lat=lat).numpy(),
                    rng.random_su3_field(rng.Key(5), lat, "cpu").numpy())
    # the gather's multi-process branch, then a checkpoint written by rank 0
    # after it and read back onto the slabs
    res["gathered"] = parallel.gather_to_host(ut, base)
    if rank == 0:
        save_checkpoint(run_dir, res["gathered"], 3, 77, LAT)
    torch.distributed.barrier()
    back, traj, seed = parallel.load_gauge_sharded(os.path.join(run_dir, "conf.000003.npz"),
                                                   base, LAT)
    res["loaded"] = (back.numpy(), traj, seed, parallel._process_count())
    return res


_RUNS: dict = {}


def _run(shape, tmp_path_factory):
    """One group of ranks per mesh shape for the whole module."""
    if shape not in _RUNS:
        d = tmp_path_factory.mktemp(f"dist{shape[0]}x{shape[1]}")
        _RUNS[shape] = run_ranks(_rank_checks, shape[0] * shape[1], d, shape, str(d))
    return _RUNS[shape]


@pytest.fixture(scope="module")
def whole():
    f = _fields()
    fg = wf.make_fast_gauge(torch.as_tensor(f["u"]), PARAMS, LAT)
    return f, fg, _inputs(f, lambda a: a)


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def ranks(request, tmp_path_factory):
    return request.param, _run(request.param, tmp_path_factory)


@pytest.fixture(scope="module")
def ranks22(tmp_path_factory):
    return _run((2, 2), tmp_path_factory)


@pytest.fixture(scope="module")
def ranks21(tmp_path_factory):
    return _run((2, 1), tmp_path_factory)


def test_rank_slabs_coordinates_and_lattices(ranks):
    """Rank r = i y + j holds slab (i, j); its lattice has the slab's shape,
    the whole lattice's global dims and the slab's offset."""
    shape, res = ranks
    loc = (DIMS[0] // shape[0], DIMS[1], DIMS[2] // shape[1], DIMS[3])
    for k, r in enumerate(res):
        i, j = divmod(k, shape[1])
        assert r["coords"] == (i, j)
        assert r["lat"] == (loc, DIMS, (i * loc[0], j * loc[2]))


@pytest.mark.parametrize("halfspinor, overlap", OPTIONS, ids=lambda v: str(int(v)))
def test_rank_hop_equals_one_process_mesh_and_whole_lattice(ranks, whole, halfspinor, overlap):
    """The plain sharded hop on the ranks, one spinor, R = 3 and the doublet
    on the 12-real gauge, both parities: bit for bit the one-process mesh's
    sharded hop, and the whole-lattice plain hop within RTOL_PORT."""
    shape, res = ranks
    f, fg, xs = whole
    one = parallel.Mesh(*shape, device="cpu", halfspinor=halfspinor, overlap=overlap)
    for key, want in _hops(fg, xs, LAT, one).items():
        got = join([r[("hop", halfspinor, overlap)][key] for r in res], shape)
        np.testing.assert_array_equal(got, want, err_msg=str(key))
        r_axis, p = key
        ug = fg.ug_even if p == EVEN else fg.ug_odd
        w = (dc.hopping_split(ug, xs[None], p, LAT, gcomp=fg.gcomp) if r_axis is None else
             dc.hopping_split_rhs(ug, xs[r_axis], p, LAT, gcomp=fg.gcomp, r_axis=r_axis))
        assert np.max(np.abs(got - w.numpy())) <= RTOL_PORT * float(w.abs().max())


@pytest.mark.parametrize("halfspinor", [True, False], ids=["half", "full"])
def test_k2s_plain_equals_whole_lattice_k2(ranks, whole, halfspinor):
    """K2-S's plain version on each slab, its edge neighbours from the faces
    the forward hop received, joined: bit for bit K2's plain version on the
    whole lattice, both parities."""
    shape, res = ranks
    f, _, xs = whole
    g2 = wf.to_split(torch.as_tensor(f["g"]))
    for p in (EVEN, ODD):
        want = dc.hopping_ug_vjp_plain(g2, xs[None], p, LAT).numpy()
        np.testing.assert_array_equal(join([r[("vjp", halfspinor, p)] for r in res], shape), want)


@pytest.mark.parametrize("shift, dim, axis", ROLLS)
def test_dist_roll_forward_and_backward(ranks22, whole, shift, dim, axis):
    """dist_roll on the (2, 2) slabs equals torch.roll of the whole field;
    its backward (through a global sum) the opposite roll of the cotangent."""
    f = whole[0]
    x = torch.as_tensor(f["u64"])
    w = torch.as_tensor(f["u64"] * (1 + 2j))
    got = join([r[("roll", shift, dim)][0] for r in ranks22], (2, 2))
    np.testing.assert_array_equal(got, torch.roll(x, shift, dim).numpy())
    grad = join([r[("roll", shift, dim)][1] for r in ranks22], (2, 2))
    np.testing.assert_array_equal(grad, torch.roll(w.conj(), -shift, dim).numpy())


def test_mesh_builders_over_the_ranks(ranks22):
    """In a process of an initialised group `auto_mesh` and `mesh_from_procs`
    build the mesh over its ranks (and make it the process's decomposition);
    NrTProcs x NrYProcs other than the number of ranks raises ValueError."""
    for k, r in enumerate(ranks22):
        auto, procs, wrong = r["meshes"]
        assert auto == (2, 2, k, True) and procs == (2, 2, k, True)
        assert "needs exactly 8 ranks, the group has 4" in wrong


def test_slab_lattice_needs_the_active_decomposition(ranks22):
    """The process's decomposition has one source (`comm.activate`): with it
    suspended, a slab's shift and a new slab lattice raise instead of
    summing over no ranks beside a shift that crosses them."""
    for r in ranks22:
        assert all(g is not None and "is used while no mesh is this process's decomposition" in g
                   for g in r["guard"]), r["guard"]


def test_global_sum_plaquette_and_action(ranks22, whole):
    """f64 sums over the ranks against one process: relative 1e-12 (the port
    of tests/test_sharding.py's action-and-plaquette check)."""
    x = torch.as_tensor(whole[0]["u64"])
    want = (float(torch.sum(x.real)), float(plaquette(x, LAT)),
            float(gauge_action(x, 5.3, LAT, c1=-0.331)))
    for r in ranks22:
        for got, ref in zip(r["sums"], want):
            assert abs(got - ref) <= 1e-12 * abs(ref)


def test_draws_do_not_depend_on_the_decomposition(ranks22):
    """The port of tests/test_sharding.py::test_rng_decomposition_independence:
    each rank draws its own timeslices only, and the joined slabs equal the
    one-process draw of the same keys."""
    want = (rng.normal_spinor(rng.Key(3, (1, 2)), (4, 3) + LAT.eo_site_shape, "cpu",
                              lat=LAT).numpy(),
            rng.random_momenta(rng.Key(4), (4,) + LAT.site_shape, "cpu", lat=LAT).numpy(),
            rng.random_su3_field(rng.Key(5), LAT, "cpu").numpy())
    for k, ref in enumerate(want):
        np.testing.assert_array_equal(join([r["draws"][k] for r in ranks22], (2, 2)), ref)
    # a draw without the lattice is one draw of the whole shape, as before
    assert not np.array_equal(want[0], rng.normal_spinor(rng.Key(3, (1, 2)),
                                                         (4, 3) + LAT.eo_site_shape,
                                                         "cpu").numpy())


def test_gather_multi_process_branch_and_checkpoint_round_trip(ranks22, whole):
    """gather_to_host on every rank returns the whole field (the reference's
    process_allgather branch, tests/test_round5.py:192-205); rank 0 writes it
    and every rank reads its slab back (tests/test_sharding.py:129,
    test_round5.py:207-228)."""
    u = whole[0]["u"]
    for k, r in enumerate(ranks22):
        np.testing.assert_array_equal(r["gathered"], u)
        back, traj, seed, n = r["loaded"]
        assert (traj, seed, n) == (3, 77, 4)
        np.testing.assert_array_equal(back, slab_of(u, SimpleNamespace(t=2, y=2,
                                                                        coords=divmod(k, 2))))


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


LOWERED = {
    "NDPOLY": "BeginMonomial NDPOLY\n kappa = 0.1\n 2Kappamubar = 0.1\n 2Kappaepsbar = 0.12\n"
              "EndMonomial\n",
    "SFGAUGE": "BeginMonomial SFGAUGE\n Eta = 0.15\nEndMonomial\n",
    "ONLINE": "BeginMeasurement ONLINE\n Frequency = 1\n kappa = 0.13\n 2KappaMu = 0.026\n"
              " SolverPrecision = 1e-12\n MaxSolverIterations = 300\nEndMeasurement\n",
    "GRADIENTFLOW": "BeginMeasurement GRADIENTFLOW\n Frequency = 1\n Steps = 2\nEndMeasurement\n",
}


def _lowered(what, mesh, run_dir):
    """`build_hmc` of LOWERED[what] (4^4; on (2, 1) ranks when `mesh` is
    given) and one call of what it lowered: the monomial's action on a
    fixed field, or the measurement through the runner -> a number per
    value (the runner's file read back on the process that wrote it)."""
    from tmlqcd_tpu_torch import config, config_tmlqcd
    from tmlqcd_tpu_torch.meas.runner import run_measurements

    cfg = config_tmlqcd.parse_input("L = 4\nT = 4\n" + LOWERED[what])
    hmc = config.build_hmc(cfg, mesh=mesh)
    lat = hmc.lat
    cut = (lambda a: a) if mesh is None else (lambda a: slab_of(a, mesh))  # noqa: E731
    u = torch.as_tensor(cut(np.ascontiguousarray(
        bridge.numpy_su3(np.random.default_rng(64), (4,) + cfg.lat.site_shape))))
    if what in ("NDPOLY", "SFGAUGE"):
        mono = hmc.monomials[-1]
        if what == "SFGAUGE":
            return [float(mono.action_info(u, None)[0]),
                    float(comm.global_sum(hmc.momenta_mask.sum()))]
        phi = cut(bridge.numpy_spinor(np.random.default_rng(65),
                                      (2, 2, 4, 3) + cfg.lat.eo_site_shape).real)
        return [float(mono.action(u, torch.as_tensor(phi)))]
    os.makedirs(run_dir, exist_ok=True)
    run_measurements(cfg, u, lat, 0, run_dir, rng.Key(3))
    if not comm.lead():
        return sorted(os.listdir(run_dir))
    (name,) = os.listdir(run_dir)
    with open(os.path.join(run_dir, name)) as f:
        return [float(v) for ln in f if not ln.startswith("#") for v in ln.split()]


@pytest.mark.parametrize("what", sorted(LOWERED))
def test_lowers_on_a_distributed_mesh(ranks21, tmp_path, what):
    """What a distributed run refused before it was ported to slabs (NDPOLY,
    the Schrödinger functional, the measurements) lowers through
    `build_hmc` on a (2, 1) rank mesh and runs: each rank's action (the
    whole lattice's, summed over the ranks) and rank 0's measurement file
    against one process, 1e-5 relative of the largest value (f32 fields on
    the sharded operators against the whole-lattice ones; the momenta mask
    exactly); the other rank writes nothing."""
    want = np.array(_lowered(what, None, str(tmp_path / what)))
    got = [r[("lowered", what)] for r in ranks21]
    assert got[1] in (got[0], [])  # an action on every rank; a file on rank 0 only
    np.testing.assert_allclose(np.array(got[0]), want, rtol=0,
                               atol=1e-5 * float(np.max(np.abs(want))))
