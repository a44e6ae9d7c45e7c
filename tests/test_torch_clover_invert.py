"""Parity of the port's twisted-clover inversions and inverter CLI with the
JAX reference (tmlqcd_tpu), on the CPU: `invert_clover_eo` (cg, fastcg),
the batched `invert_eo_rhs` with the clover term, and `cli.invert --cpu` on
CLOVER and on TMWILSON with a CSW, against the reference's inverter and
CLI.  The clover monomials are in test_torch_clover_hmc.py and
test_torch_clover_monomials.py.

Inputs come from seeded numpy generators through `bridge` and go to both
packages as numpy arrays.  The port runs its plain path (CPU tensors):
every Dirac application through the plain clov_inv / clov_mhat epilogues.
The reference runs its complex jnp clover operator, as it does on the CPU.

Tolerance: inversions at tol 1e-7: equal iteration counts, solutions to
1e-5 on entries of O(1), true residual |M x - b| / |b| <= 1e-5 with the
unpacked clover operator (f32 fields; solutions measured 1.2e-6 apart).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmlqcd_tpu.inverter import invert_clover_eo as j_invert_clover_eo
from tmlqcd_tpu.lattice import Lattice as JLattice
from tmlqcd_tpu.ops import wilson as jw
from tmlqcd_tpu_torch import bridge
from tmlqcd_tpu_torch.inverter import invert_clover_eo, invert_eo, invert_eo_rhs
from tmlqcd_tpu_torch.io import checkpoint
from tmlqcd_tpu_torch.lattice import Lattice
from tmlqcd_tpu_torch.ops import clover as cl
from tmlqcd_tpu_torch.ops import wilson as w

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


def _maxdiff(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


@pytest.fixture(scope="module")
def gauge():
    u = bridge.numpy_su3(np.random.default_rng(50), (4,) + JL.site_shape)
    return u, bridge.gauge_from_numpy(u, LAT)


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
