"""The deflation preconditioner and the deflated solvers against the JAX
reference (tmlqcd_tpu) on the CPU, and `cli.invert --cpu` with each solver.
The mixed solvers, increigcg and the clover inverter's solver names are in
tests/test_torch_invert_solvers.py.

The reference's subspace draws are injected into the port's setup (`v0`),
so both build their little operator from the same start; the reference runs
its complex jnp Mhat, the port its split operator on the plain version of
the hopping kernels (K1-R for the batched setup).  Where the two run the
same algorithm (deflated FGMRES) the iteration counts are equal and the
solutions agree; where the port's routing differs (`fastmixed` runs the bf16
copy where the reference runs complex64 off the TPU; eigCG runs on the split
operator) and for deflated GCR (whose solver is held to the reference's in
tests/test_torch_solvers.py) the solution is held to the reference's CG
solution.  The reference side solves the odd-site systems of its invert_eo
(its steps 1 and 2, then its cg, or its fgmres with the V-cycle) on jitted
operators; the port's whole `invert_eo` is compared on the odd sites, and
its full-lattice solution by its true residual.

Tolerances: little operator (4 vectors, 2x2x2 blocks) and V-cycle 1e-5 relative (f32 fields, sums in
another order: measured ~1e-6); solutions 1e-5 absolute on entries of O(1)
(the inverter bound of tests/test_torch_invert.py); true residuals
|M x - b| / |b| <= 1e-5 at tol 1e-7 on f32 fields.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmlqcd_tpu import rng as jrng
from tmlqcd_tpu.gamma import apply_gamma5 as j_gamma5
from tmlqcd_tpu.lattice import Lattice as JLattice
from tmlqcd_tpu.lattice import eo_pack as j_eo_pack
from tmlqcd_tpu.lattice import pack_gauge_eo as j_pack
from tmlqcd_tpu.ops import wilson as jw
from tmlqcd_tpu.solvers.cg import cg as j_cg
from tmlqcd_tpu_torch import bridge, config, config_tmlqcd, rng
from tmlqcd_tpu_torch.inverter import invert_eo, make_deflation_setup
from tmlqcd_tpu_torch.io import checkpoint
from tmlqcd_tpu_torch.lattice import Lattice, eo_pack
from tmlqcd_tpu_torch.meas.sources import z2_timeslice_source
from tmlqcd_tpu_torch.ops import clover as cl
from tmlqcd_tpu_torch.ops import wilson as w
from tmlqcd_tpu_torch.ops import wilson_fast as wf
from tmlqcd_tpu_torch.solvers.deflation import setup_deflation, vcycle

jd = importlib.import_module("tmlqcd_tpu.solvers.deflation")
jk = importlib.import_module("tmlqcd_tpu.solvers.krylov")

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _quick_reference_compiles():
    """XLA's backend optimisations off while this module runs: the
    reference's programs here take far longer to compile than to run."""
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", False)


DIMS = (4, 4, 4, 4)
JL, LAT = JLattice(DIMS), Lattice(DIMS)
P = dict(kappa=0.15, mu=0.01)
JP, TP = jw.DiracParams(**P), w.DiracParams(**P)
SHAPE = (4, 3) + JL.eo_site_shape
TOL = 1e-7


def _maxdiff(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


def _true_residual(ut, x, b, params=TP) -> float:
    return float(torch.linalg.vector_norm(w.d_full(ut, x, params, LAT) - b)
                 / torch.linalg.vector_norm(b))


@pytest.fixture(scope="module")
def system():
    u = bridge.numpy_su3(np.random.default_rng(40), (4,) + JL.site_shape)
    src = np.zeros((4, 3) + JL.site_shape, np.complex64)
    src[1, 2, 0, 0, 0] = 1.0
    ueo, ph = j_pack(u, JL), jw.boundary_phases(JP, JL)
    mhat = lambda x: jw.m_hat(ueo, x, JP, JL, ph, +1.0)  # noqa: E731
    # the reference's make_deflation_setup (key 4242, 2x2x2 blocks; 4
    # vectors here, 8 in cli.invert) with its operator compiled once
    key = jax.random.key(4242)
    jmh = jax.jit(mhat)
    js = jd.setup_deflation(jmh, SHAPE, key, n_vectors=4, matvec_batch=jax.jit(jax.vmap(mhat)))
    v0 = torch.tensor(np.asarray(jrng.normal_spinor(key, (4,) + SHAPE, jnp.complex64)))
    ut = bridge.gauge_from_numpy(u, LAT)
    # the reference's odd-site systems, as its invert_eo builds them (steps 1
    # and 2: bhat = b_o + kappa H_oe Mee^-1 b_e, and Qhat_- g5 bhat for CG),
    # solved below by its cg on Qhat_pm or its fgmres with the V-cycle on Mhat
    qpm = jax.jit(lambda x: jw.q_hat_pm(ueo, x, JP, JL, ph))

    @jax.jit
    def odd_systems(b):
        b_e, b_o = j_eo_pack(b, JL)
        bhat = b_o + JP.kappa * jw.dslash_packed(ueo, jw.mee_inv_packed(b_e, JP.mutld, 1.0), 1,
                                                 JL, ph)
        rhs = jw.q_hat(ueo, j_gamma5(bhat), JP, JL, ph, -1.0)
        return bhat, j_cg(qpm, rhs, tol=TOL, maxiter=500)

    bhat, ref_cg = odd_systems(jnp.asarray(src))
    return dict(u=u, ut=ut, src=src, b=bridge.sources_from_numpy(src, LAT), jmh=jmh, js=js,
                bhat=bhat, ts=make_deflation_setup(ut, TP, LAT, n_vectors=4, v0=v0),
                ref_cg=ref_cg)


def _odd(x) -> torch.Tensor:
    """The odd sites of a full-lattice solution: the odd solve's x_o."""
    return eo_pack(x, LAT)[1]


def test_setup_little_operator_matches_reference(system):
    js, ts = system["js"], system["ts"]
    a_ref = np.asarray(js.a)
    assert ts.a.shape == a_ref.shape == (32, 32) and ts.blocks == (2, 2, 2)
    assert _maxdiff(ts.a, a_ref) < 1e-5 * float(np.abs(a_ref).max())
    assert _maxdiff(ts.v, js.v) < 1e-5
    eye = (ts.a @ ts.a_inv).numpy()
    assert _maxdiff(eye, np.eye(32)) < 1e-3
    # the starting vectors need an explicit device, and a key or v0
    with pytest.raises(TypeError, match="device"):
        setup_deflation(lambda x2: x2, SHAPE, rng.Key(1))
    with pytest.raises(ValueError, match="v0"):
        setup_deflation(lambda x2: x2, SHAPE, device="cpu")


def test_vcycle_matches_reference(system):
    fg = wf.make_fast_gauge(system["ut"], TP, LAT)
    b = bridge.numpy_spinor(np.random.default_rng(41), SHAPE)
    ref = np.asarray(jd.vcycle(system["js"], system["jmh"], jnp.asarray(b)))
    mv = lambda x2: wf.m_hat_fast(fg, x2, TP, LAT, +1.0)  # noqa: E731
    out = wf.from_split(vcycle(system["ts"], mv, wf.to_split(torch.as_tensor(b))))
    assert _maxdiff(out, ref) < 1e-5 * float(np.abs(ref).max())
    # one cycle reduces the residual of Mhat
    b2 = wf.to_split(torch.as_tensor(b))
    assert float(torch.linalg.vector_norm(mv(wf.to_split(out)) - b2)) < 0.5 * float(
        torch.linalg.vector_norm(b2))


def test_dflfgmres_invert_eo_matches_reference(system):
    """FGMRES(5) on Mhat with the V-cycle, the setup built once and passed
    in (the reference's invert_eo branch, on its odd-site system): the same
    restart cycles, the same odd solution."""
    jmh, js = system["jmh"], system["js"]
    ref = jk.fgmres(jmh, system["bhat"], precond=lambda r: jd.vcycle(js, jmh, r), tol=TOL,
                    restart=5, max_restarts=100)
    out = invert_eo(system["ut"], system["b"], TP, LAT, tol=TOL, maxiter=500,
                    solver="dflfgmres", deflation_setup=system["ts"])
    assert out.iterations == int(ref.iterations) >= 1
    assert _maxdiff(_odd(out.x), ref.x) < 1e-5
    assert _true_residual(system["ut"], out.x, system["b"]) < 1e-5


def test_dflgcr_invert_eo_matches_reference_cg(system):
    """GCR(5) with the V-cycle, and the setup built by invert_eo itself when
    none is passed (rng.Key(4242), 8 vectors)."""
    ref = system["ref_cg"]
    out = invert_eo(system["ut"], system["b"], TP, LAT, tol=TOL, maxiter=500, solver="dflgcr",
                    deflation_setup=system["ts"])
    assert 1 <= out.iterations < int(ref.iterations)
    assert _maxdiff(_odd(out.x), ref.x) < 1e-5
    assert _true_residual(system["ut"], out.x, system["b"]) < 1e-5
    own = invert_eo(system["ut"], system["b"], TP, LAT, tol=TOL, maxiter=500, solver="dflgcr")
    assert _maxdiff(_odd(own.x), ref.x) < 1e-5


_CLI_INPUT = """L = 4
T = 4
""" + "".join(f"""BeginOperator {op}
  kappa = {kappa}
  2KappaMu = {2 * kappa * 0.01}
  CSW = {csw}
  Solver = {solver}
  SolverPrecision = 1e-14
  MaxSolverIterations = 500
EndOperator
""".replace("SolverPrecision = 1e-14", f"SolverPrecision = {prec}") for op, kappa, csw, solver, prec in (
    ("TMWILSON", 0.15, 0.0, "fastmixed", 1e-14), ("TMWILSON", 0.15, 0.0, "mixedcg", 1e-14),
    ("TMWILSON", 0.15, 0.0, "dflfgmres", 1e-14), ("TMWILSON", 0.15, 0.0, "dflgcr", 1e-14),
    ("TMWILSON", 0.15, 0.0, "increigcg", 1e-14),
    # at |r| <= 2e-7 |b|: the clover operator's f32 floor lies at ~1.3e-7
    ("CLOVER", 0.13, 1.2, "mixedcg", 4e-14), ("TMWILSON", 0.15, 0.0, "bicgstab", 1e-14)))


def test_cli_invert_runs_each_solver(tmp_path, system, capsys):
    """`cli.invert --cpu` with one operator per solver on a Z2 source: each
    propagator solves its system; the MG setup, the eigCG sequence and the
    CG that stands in for bicgstab say so."""
    from tmlqcd_tpu_torch.cli import invert as cli

    inp = tmp_path / "invert.input"
    inp.write_text(_CLI_INPUT)
    cfg = config_tmlqcd.read_input(str(inp))
    config.check_invert_ported(cfg)
    conf = checkpoint.save_checkpoint(str(tmp_path / "confs"), system["ut"], 3, 1, LAT)
    assert cli.main(["-f", str(inp), "-c", conf, "--format", "npz", "--cpu", "--source", "z2",
                     "-o", str(tmp_path / "out")]) == 0
    log = capsys.readouterr().out
    b = z2_timeslice_source(LAT, 0, rng.Key(171), device="cpu")  # cli.invert's source
    assert "op 2: MG setup built in" in log and "op 3: MG setup built in" in log
    assert "op 4 (TMWILSON) 1 sources incr-eigcg: iters [" in log
    assert "solver 'bicgstab' has no branch here; CG runs" in log
    for iop, op in enumerate(cfg.operators):
        with np.load(tmp_path / "out" / f"propagator.{iop:02d}.000003.npz") as f:
            x = torch.as_tensor(f["propagator"][0])
        params = w.DiracParams(kappa=op.kappa, mu=op.two_kappa_mu / (2 * op.kappa), c_sw=op.csw)
        if op.type == "CLOVER":
            sw = cl.sw_blocks(system["ut"], params.kappa, params.c_sw, LAT)
            mx = (cl.sw_apply(sw, x, params.mutld, +1.0) - params.kappa * w.dslash_full(
                system["ut"], x, w.boundary_phases(params, LAT), LAT))
            rel = float(torch.linalg.vector_norm(mx - b) / torch.linalg.vector_norm(b))
        else:
            rel = _true_residual(system["ut"], x, b, params)
        assert rel < 1e-5, (op.solver, rel)
