"""Parity of the port's twisted-clover monomials, inversions and inverter
CLI with the JAX reference (tmlqcd_tpu), on the CPU.  The clover
trajectory and the sample input are in test_torch_clover_traj.py: the
reference's trajectory alone compiles for most of two minutes, and a file of
its own lets the test runner's workers share the load.

Inputs come from seeded numpy generators through `bridge`, or are the
reference's own draws re-derived from its keys, and go to both packages as
numpy arrays.  The port runs its plain path (CPU tensors): every Dirac
application through the plain clov_inv / clov_mhat epilogues.  The reference
runs its complex jnp clover operator, as it does on the CPU.

Tolerances, each stated where it is used:
* heatbath fields and forces: 1e-5 absolute on entries of O(1..10) (f32
  operators, f64 sums; measured 1.1e-6 .. 1.2e-6); S_0 = |eta|^2 to 1e-9 (both
  f64 sums of the same f32 numbers); actions to 1e-6 relative (f32 CG
  solutions in an f64 dot).
* a force against the central finite difference of the port's own action
  along a random algebra direction, eps = 3e-3: 2e-3 relative.  The action
  is an f64 sum of f32 fields, so the difference quotient carries ~1e-7 |S| /
  eps of noise beside its O(eps^2) truncation (measured 1e-4 .. 9e-4).
* inversions at tol 1e-7: equal iteration counts, solutions to 1e-5 on
  entries of O(1), true residual |M x - b| / |b| <= 1e-5 with the unpacked
  clover operator (f32 fields; solutions measured 1.2e-6 apart).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmlqcd_tpu import rng as jrng
from tmlqcd_tpu.hmc import monomials as jmono
from tmlqcd_tpu.inverter import invert_clover_eo as j_invert_clover_eo
from tmlqcd_tpu.lattice import Lattice as JLattice
from tmlqcd_tpu.ops import wilson as jw
from tmlqcd_tpu_torch import bridge, rng, su3
from tmlqcd_tpu_torch.hmc import monomials
from tmlqcd_tpu_torch.inverter import invert_clover_eo, invert_eo, invert_eo_rhs
from tmlqcd_tpu_torch.io import checkpoint
from tmlqcd_tpu_torch.lattice import Lattice
from tmlqcd_tpu_torch.ops import clover as cl
from tmlqcd_tpu_torch.ops import wilson as w
from tmlqcd_tpu_torch.ops import wilson_fast as wf

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
LIGHT = dict(kappa=0.14, mu=0.04, c_sw=1.3)
HEAVY = dict(kappa=0.14, mu=0.3, c_sw=1.3)
TOLS = dict(acc_tol=1e-9, force_tol=1e-9, maxiter=1000)
NAMES = ("cloverdet", "cloverdetratio", "clovertrlog")


def _maxdiff(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


def _monomials(mod, lat, params_cls):
    light, heavy = params_cls(**LIGHT), params_cls(**HEAVY)
    return {"cloverdet": mod.CloverDetMonomial(lat=lat, params=light, **TOLS),
            "cloverdetratio": mod.CloverDetRatioMonomial(lat=lat, params1=light, params2=heavy,
                                                         **TOLS),
            "clovertrlog": mod.CloverTrlogMonomial(lat=lat, params=light)}


@pytest.fixture(scope="module")
def gauge():
    u = bridge.numpy_su3(np.random.default_rng(50), (4,) + JL.site_shape)
    return u, bridge.gauge_from_numpy(u, LAT)


@pytest.fixture(scope="module")
def reference(gauge):
    """The reference's heatbath draws and fields, actions with their
    iteration counts and forces of the three clover monomials on one gauge
    field, in one compiled program (jax.grad through sw_blocks compiles
    slowly on the CPU, so it is compiled once for all tests)."""
    u, _ = gauge
    mons = _monomials(jmono, JL, jw.DiracParams)

    def run(u, key):
        out = {}
        for name in ("cloverdet", "cloverdetratio"):
            m = mons[name]
            eta = jrng.normal_spinor(key, (4, 3) + JL.eo_site_shape, u.dtype)
            phi, s0 = m.heatbath(u, key)
            s, iters = m.action_info(u, phi)
            out[name] = dict(eta=eta, phi=phi, s0=s0, s=s, iters=iters, force=m.force(u, phi))
        m = mons["clovertrlog"]
        out["clovertrlog"] = dict(s=m.action(u, None), force=m.force(u, None))
        return out

    res = jax.jit(run)(jnp.asarray(u), jax.random.key(51))
    return jax.tree_util.tree_map(np.asarray, res)


@pytest.fixture(scope="module")
def ported(gauge, reference):
    """The port's monomials with the reference's eta injected."""
    _, ut = gauge
    mons = _monomials(monomials, LAT, w.DiracParams)
    out = {}
    for name in ("cloverdet", "cloverdetratio"):
        eta = bridge.spinor_from_numpy(reference[name]["eta"], LAT)
        phi2, s0 = mons[name].heatbath(ut, None, eta)
        out[name] = dict(m=mons[name], phi2=phi2, s0=float(s0))
    out["clovertrlog"] = dict(m=mons["clovertrlog"], phi2=None,
                              s0=float(mons["clovertrlog"].heatbath(ut, None)[1]))
    return out


# ---------------------------------------------------------------------------
# monomials
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES[:2])
def test_clover_heatbath_matches_reference(reference, ported, name):
    ref, out = reference[name], ported[name]
    assert _maxdiff(wf.from_split(out["phi2"]), ref["phi"]) < 1e-5
    eta2 = float(np.sum(np.abs(ref["eta"].astype(np.complex128)) ** 2))
    assert abs(out["s0"] - eta2) < 1e-9 * eta2
    assert abs(float(ref["s0"]) - eta2) < 1e-9 * eta2


@pytest.mark.parametrize("name", NAMES)
def test_clover_action_matches_reference(gauge, reference, ported, name):
    """Action and acceptance-solve iteration count on the reference's phi."""
    _, ut = gauge
    ref, m = reference[name], ported[name]["m"]
    if name == "clovertrlog":
        s, iters = m.action_info(ut, None)
        assert iters == 0 and abs(ported[name]["s0"] - float(s)) == 0.0
    else:
        phi2 = wf.to_split(bridge.spinor_from_numpy(ref["phi"], LAT))
        s, iters = m.action_info(ut, phi2)
        assert iters == int(ref["iters"]) and 10 < iters < 1000
        # S = |eta|^2 again: phi was drawn from this gauge field
        assert abs(float(s) - ported[name]["s0"]) < 1e-5 * ported[name]["s0"]
    assert abs(float(ref["s"])) > 1.0
    assert abs(float(s) - float(ref["s"])) < 1e-6 * abs(float(ref["s"]))


@pytest.mark.parametrize("name", NAMES)
def test_clover_force_matches_reference(gauge, reference, ported, name):
    _, ut = gauge
    ref, m = reference[name], ported[name]["m"]
    phi2 = None if name == "clovertrlog" else wf.to_split(
        bridge.spinor_from_numpy(ref["phi"], LAT))
    out = m.force(ut, phi2)
    assert float(np.max(np.abs(ref["force"]))) > 0.01
    assert _maxdiff(out, ref["force"]) < 1e-5


@pytest.mark.parametrize("name", NAMES)
def test_clover_force_matches_finite_difference_of_the_action(gauge, ported, name):
    """dS/dt along dU/dt = P U is -Re<P, F> (H = |P|^2 + S is conserved with
    dP/dt = F / 2)."""
    _, ut = gauge
    m, phi2 = ported[name]["m"], ported[name]["phi2"]
    if name != "clovertrlog":  # solve well below the difference quotient's noise
        m = dataclasses.replace(m, acc_tol=1e-10, force_tol=1e-10)
    mom = rng.random_momenta(rng.Key(52), ut.shape[2:], "cpu")
    pred = -float(torch.sum((torch.conj_physical(mom) * m.force(ut, phi2)).real.double()))
    eps = 3e-3
    s_pm = [float(m.action_info(su3.project_su3(su3.mul(su3.expm_ta(e * mom), ut)), phi2)[0])
            for e in (eps, -eps)]
    fd = (s_pm[0] - s_pm[1]) / (2 * eps)
    assert abs(pred) > 0.5
    assert abs(fd - pred) < 2e-3 * abs(pred)


def test_clover_monomials_share_and_check_their_blocks(gauge):
    _, ut = gauge
    with pytest.raises(ValueError, match="kappa/c_sw must match"):
        monomials.CloverDetRatioMonomial(lat=LAT, params1=w.DiracParams(**LIGHT),
                                         params2=w.DiracParams(kappa=0.14, mu=0.3, c_sw=1.0))
    # Solver = mixedcg is carried: a zero pseudofermion has zero action and
    # needs no iteration; an unknown solver name is refused
    m = monomials.CloverDetMonomial(lat=LAT, params=w.DiracParams(**LIGHT), solver="mixedcg")
    s, iters = m.action_info(ut, torch.zeros((2, 4, 3) + LAT.eo_site_shape))
    assert float(s) == 0.0 and iters == 0
    with pytest.raises(ValueError, match="unknown solver"):
        monomials.CloverDetMonomial(lat=LAT, params=w.DiracParams(**LIGHT), solver="nope") \
            .action_info(ut, torch.zeros((2, 4, 3) + LAT.eo_site_shape))
    # one state serves both operators of the ratio: same gauge copy, the
    # blocks of each mu from one clover term
    st = monomials._CloverState(ut, w.DiracParams(**LIGHT), LAT, grad=False)
    fc1, fc2 = st.fast(w.DiracParams(**LIGHT)), st.fast(w.DiracParams(**HEAVY))
    assert fc1.fg is fc2.fg
    ref = wf.make_fast_clover(ut, w.DiracParams(**HEAVY), LAT)
    assert torch.equal(fc2.moo_m, ref.moo_m) and torch.equal(fc2.mee_inv_p, ref.mee_inv_p)
    assert torch.equal(fc2.fg.ug_odd, ref.fg.ug_odd) and fc2.fg.gcomp == ref.fg.gcomp


# ---------------------------------------------------------------------------
# inversions
# ---------------------------------------------------------------------------

INV = dict(kappa=0.13, mu=0.04, c_sw=1.2)  # the point of tests/test_meas.py:45
R = 3


def _d_full_clover(u, x, params, lat):
    """The unpreconditioned twisted-clover operator on the full lattice:
    (1 + T + i mutld g5) x - kappa H x."""
    sw = cl.sw_blocks(u, params.kappa, params.c_sw, lat)
    return (cl.sw_apply(sw, x, params.mutld, +1.0)
            - params.kappa * w.dslash_full(u, x, w.boundary_phases(params, lat), lat))


@pytest.fixture(scope="module")
def sources():
    """Two point sources and one gaussian field on the full lattice."""
    src = np.zeros((R, 4, 3) + JL.site_shape, np.complex64)
    src[0, 0, 0, 0, 0, 0] = 1.0
    src[1, 2, 1, 1, 2, 3] = 1.0
    src[2] = bridge.numpy_spinor(np.random.default_rng(54), (4, 3) + JL.site_shape)
    return src


@pytest.fixture(scope="module")
def reference_solutions(gauge, sources):
    u = jnp.asarray(gauge[0])
    jp = jw.DiracParams(**INV)
    solve = jax.jit(lambda b: j_invert_clover_eo(u, b, jp, JL, tol=1e-7, maxiter=500,
                                                 solver="cg"))
    return [solve(jnp.asarray(sources[r])) for r in range(R)]


@pytest.mark.parametrize("solver", ["cg", "fastcg"])
def test_invert_clover_eo_matches_reference(gauge, sources, reference_solutions, solver):
    _, ut = gauge
    tp = w.DiracParams(**INV)
    for r in (0, 2):
        b = bridge.sources_from_numpy(sources[r], LAT)
        out = invert_clover_eo(ut, b, tp, LAT, tol=1e-7, maxiter=500, solver=solver)
        ref = reference_solutions[r]
        assert out.iterations == int(ref.iterations) and 5 < out.iterations < 500
        assert _maxdiff(out.x, ref.x) < 1e-5
        res = _d_full_clover(ut, out.x, tp, LAT) - b
        assert float(torch.linalg.vector_norm(res) / torch.linalg.vector_norm(b)) < 1e-5
    if solver == "cg":
        # mixedcg: the defect correction on the same operator reaches the
        # same solution; at 2e-7, above the f32 floor of the true residual,
        # where it would run to its 50 outer steps
        mixed = invert_clover_eo(ut, b, tp, LAT, tol=2e-7, maxiter=500, solver="mixedcg")
        assert mixed.iterations >= out.iterations - 2 and _maxdiff(mixed.x, ref.x) < 1e-5


def test_invert_eo_rhs_clover_matches_reference(gauge, sources, reference_solutions):
    _, ut = gauge
    tp = w.DiracParams(**INV)
    bs = bridge.sources_from_numpy(sources, LAT)
    out = invert_eo_rhs(ut, bs, tp, LAT, tol=1e-7, maxiter=500)
    assert tuple(out.x.shape) == (R, 4, 3) + LAT.site_shape
    assert out.iterations == max(int(ref.iterations) for ref in reference_solutions)
    for r, ref in enumerate(reference_solutions):
        assert _maxdiff(out.x[r], ref.x) < 1e-5
        res = _d_full_clover(ut, out.x[r], tp, LAT) - bs[r]
        assert float(torch.linalg.vector_norm(res) / torch.linalg.vector_norm(bs[r])) < 1e-5
        one = invert_clover_eo(ut, bs[r], tp, LAT, tol=1e-7, maxiter=500)
        assert _maxdiff(out.x[r], one.x) < 1e-5
    # c_sw selects the pipeline: without it the same call is twisted mass
    tm = invert_eo_rhs(ut, bs, w.DiracParams(kappa=INV["kappa"], mu=INV["mu"]), LAT, tol=1e-7)
    assert _maxdiff(tm.x[0], out.x[0]) > 1e-3


_CLI_INPUT = ("L = 4\nT = 4\nBeginOperator {op}\n  kappa = 0.13\n  2KappaMu = 0.0104\n  CSW = 1.2\n"
              "  Solver = cg\n  SolverPrecision = 1e-14\n  MaxSolverIterations = 500\nEndOperator\n")


def _run_cli(tmp_path, gauge, op, extra=()):
    from tmlqcd_tpu_torch.cli import invert as cli

    inp = tmp_path / f"{op}.input"
    inp.write_text(_CLI_INPUT.format(op=op))
    conf = checkpoint.save_checkpoint(str(tmp_path / "confs"), gauge[1], 3, 1, LAT)
    out = tmp_path / f"out-{op}{len(extra)}"
    assert cli.main(["-f", str(inp), "-c", conf, "--format", "npz", "--cpu", "-o", str(out),
                     *extra]) == 0
    with np.load(out / "propagator.00.000003.npz") as f:
        return {k: f[k] for k in f.files}


def test_cli_invert_clover_end_to_end(tmp_path, gauge, reference_solutions):
    """`BeginOperator CLOVER` through the CLI on the CPU: 12 point-source
    columns in one batched solve; column 0 is the reference's solution of the
    same system (2KappaMu = 0.0104 is mu = 0.04 at kappa = 0.13); csw goes
    into the propagator file's header."""
    out = _run_cli(tmp_path, gauge, "CLOVER")
    assert out["propagator"].shape == (12, 4, 3) + LAT.site_shape
    assert float(out["csw"]) == 1.2 and abs(float(out["mu"]) - 0.04) < 1e-12
    assert _maxdiff(out["propagator"][0], reference_solutions[0].x) < 1e-5
    tp = w.DiracParams(**INV)
    x7 = torch.as_tensor(out["propagator"][7])
    b7 = torch.zeros_like(x7)
    b7[2, 1, 0, 0, 0] = 1.0
    assert float(torch.linalg.vector_norm(_d_full_clover(gauge[1], x7, tp, LAT) - b7)) < 1e-5


def test_cli_invert_tmwilson_with_csw_follows_the_reference_cli(tmp_path, gauge):
    """The reference's CLI hands any operator's CSW to the batched solve,
    which takes the clover pipeline for it, and sends a single column of a
    TMWILSON operator to `invert_eo`, which does not read it."""
    clov = _run_cli(tmp_path, gauge, "CLOVER")
    tmw = _run_cli(tmp_path, gauge, "TMWILSON")
    np.testing.assert_array_equal(tmw["propagator"], clov["propagator"])
    one = _run_cli(tmp_path, gauge, "TMWILSON", ("--source", "z2"))
    src_clov = _run_cli(tmp_path, gauge, "CLOVER", ("--source", "z2"))
    assert one["propagator"].shape == (1, 4, 3) + LAT.site_shape
    assert _maxdiff(one["propagator"], src_clov["propagator"]) > 1e-3
    tp = w.DiracParams(**INV)
    b = bridge.sources_from_numpy(np.zeros((4, 3) + LAT.site_shape, np.complex64), LAT)
    b[1, 2, 0, 1, 0] = 1.0
    plain = invert_eo(gauge[1], b, w.DiracParams(kappa=0.13, mu=0.04), LAT, tol=1e-7)
    assert torch.equal(invert_eo(gauge[1], b, tp, LAT, tol=1e-7).x, plain.x)
