"""Parity of the port's batched inverter path with the JAX reference
(tmlqcd_tpu), on the CPU: Q-hat-pm on the multi-RHS batch, the batched CG,
the even/odd Schur inversions and `cli.invert`.  Each case
compiles a reference program, so they have a file of at most 8 tests,
which the test runner queues behind tests/test_multirhs.py; the rest of
the inverter path is in tests/test_torch_invert.py, whose gauge and inputs
(`fields`) these cases share.

Tolerances, each derived where it is used: CG and inversions at tol
1e-5..1e-7: equal iteration counts (f64 norms on both sides); solutions to
1e-5 on entries of O(1): f32 rounding over the ~15 iterations (measured
4.8e-7 for cg_rhs, 7.2e-7 for the inversions).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from test_torch_invert import JL, JP, LAT, R, TP, _maxdiff, fields  # noqa: F401  (a fixture)
from tmlqcd_tpu.inverter import invert_eo as j_invert_eo
from tmlqcd_tpu.lattice import pack_gauge_eo as j_pack
from tmlqcd_tpu.ops import wilson as jw
from tmlqcd_tpu.ops import wilson_fast as jwf
from tmlqcd_tpu.solvers.cg import cg_rhs as j_cg_rhs
from tmlqcd_tpu_torch import bridge
from tmlqcd_tpu_torch.inverter import invert_eo, invert_eo_rhs
from tmlqcd_tpu_torch.io import checkpoint
from tmlqcd_tpu_torch.ops import wilson as w
from tmlqcd_tpu_torch.ops import wilson_fast as wf
from tmlqcd_tpu_torch.solvers.cg import cg, cg_rhs

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def sources():
    """Three full-lattice sources: two point sources and one gaussian field."""
    src = np.zeros((R, 4, 3) + JL.site_shape, np.complex64)
    src[0, 0, 0, 0, 0, 0] = 1.0
    src[1, 2, 1, 1, 2, 3] = 1.0
    src[2] = bridge.numpy_spinor(np.random.default_rng(33), (4, 3) + JL.site_shape)
    return src


# ---------------------------------------------------------------------------
# the batched operator
# ---------------------------------------------------------------------------


def test_q_hat_pm_fast_rhs_matches_reference_operator(fields):
    """Q̂± on the 7-dim batch against the reference's jnp operator per column.
    1e-5: two Schur complements in f32, outputs of O(10) (measured 3.6e-7)."""
    ueo, ph = j_pack(jnp.asarray(fields["u"]), JL), jw.boundary_phases(JP, JL)
    ref = jax.jit(jax.vmap(lambda x: jw.q_hat_pm(ueo, x, JP, JL, ph)))(jnp.asarray(fields["psis"]))
    out = wf.from_split_rhs(wf.q_hat_pm_fast(fields["fg12"], fields["p2"], TP, LAT, r_axis=3))
    assert _maxdiff(out, ref) < 1e-5


# ---------------------------------------------------------------------------
# cg_rhs
# ---------------------------------------------------------------------------


def test_cg_rhs_matches_reference(fields):
    """Absolute stopping with column 0 scaled down by 1e-3, so that side
    converges first and freezes while the others iterate; per-side counts
    are read off single solves."""
    scale = torch.tensor([1e-3, 1.0, 1.0]).reshape(1, 1, 1, R, 1, 1, 1)
    b2 = fields["p2"] * scale
    kw = dict(tol=1e-5, maxiter=300, rel_prec=False)
    ueo, ph = j_pack(jnp.asarray(fields["u"]), JL), jw.boundary_phases(JP, JL)

    @jax.jit  # traced once for cg_rhs's several call sites
    def j_mv(x2):
        return jwf.to_split_rhs(jax.vmap(lambda x: jw.q_hat_pm(ueo, x, JP, JL, ph))(
            jwf.from_split_rhs(x2)))

    ref = jax.jit(lambda b: j_cg_rhs(j_mv, b, rhs_axis=3, **kw))(jnp.asarray(bridge.to_numpy(b2)))
    mv = lambda x2: wf.q_hat_pm_fast(fields["fg12"], x2, TP, LAT, r_axis=3)  # noqa: E731
    out = cg_rhs(mv, b2, rhs_axis=3, **kw)
    assert out.iterations == int(ref.iterations)
    assert tuple(out.residual_sq.shape) == (R,)
    assert bool((out.residual_sq <= 1e-10).all())
    np.testing.assert_allclose(bridge.to_numpy(out.residual_sq), np.asarray(ref.residual_sq),
                               rtol=2e-2)  # f32 fields: the last |r|^2 agrees to a few 1e-3
    assert _maxdiff(out.x, ref.x) < 1e-5
    singles = [cg(lambda x: wf.q_hat_pm_fast(fields["fg12"], x, TP, LAT),
                  b2[:, :, :, r].contiguous(), **kw) for r in range(R)]
    its = [s.iterations for s in singles]
    assert its[0] < min(its[1:]) and max(its) == out.iterations
    # the frozen side is bit-for-bit the single solve of that column
    assert torch.equal(out.x[:, :, :, 0], singles[0].x)
    for r in range(R):
        assert _maxdiff(out.x[:, :, :, r], singles[r].x) < 1e-5


# ---------------------------------------------------------------------------
# invert_eo, invert_eo_rhs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def reference_solutions(fields, sources):
    u = jnp.asarray(fields["u"])
    solve = jax.jit(lambda b: j_invert_eo(u, b, JP, JL, tol=1e-7, maxiter=500, solver="cg"))
    return [solve(jnp.asarray(sources[r])) for r in range(R)]


def test_invert_eo_matches_reference(fields, sources, reference_solutions):
    for r in (0, 2):
        b = bridge.sources_from_numpy(sources[r], LAT)
        out = invert_eo(fields["ut"], b, TP, LAT, tol=1e-7, maxiter=500)
        ref = reference_solutions[r]
        assert out.iterations == int(ref.iterations) and 5 < out.iterations < 500
        assert _maxdiff(out.x, ref.x) < 1e-5
        # true residual on the full lattice with the unpacked operator:
        # |M x - b| / |b| <= 1e-5 (tol 1e-7 on the normal equations, f32 fields)
        res = w.d_full(fields["ut"], out.x, TP, LAT) - b
        assert float(torch.linalg.vector_norm(res) / torch.linalg.vector_norm(b)) < 1e-5


def test_invert_eo_rhs_matches_reference(fields, sources, reference_solutions):
    bs = bridge.sources_from_numpy(sources, LAT)
    out = invert_eo_rhs(fields["ut"], bs, TP, LAT, tol=1e-7, maxiter=500)
    assert tuple(out.x.shape) == (R, 4, 3) + LAT.site_shape
    assert tuple(out.residual_sq.shape) == (R,)
    assert out.iterations == max(int(ref.iterations) for ref in reference_solutions)
    for r, ref in enumerate(reference_solutions):
        got = bridge.invert_result_from_numpy(np.asarray(ref.x), ref.iterations,
                                              np.asarray(ref.residual_sq), LAT)
        assert _maxdiff(out.x[r], got.x) < 1e-5
        one = invert_eo(fields["ut"], bs[r], TP, LAT, tol=1e-7, maxiter=500, solver="fastcg")
        assert _maxdiff(out.x[r], one.x) < 1e-5


# ---------------------------------------------------------------------------
# cli.invert
# ---------------------------------------------------------------------------

_INPUT = ("L = 4\nT = 4\nBeginOperator TMWILSON\n  kappa = 0.13\n  2KappaMu = 0.026\n"
          "  Solver = cg\n  SolverPrecision = 1e-12\n  MaxSolverIterations = 200\nEndOperator\n")


def test_cli_invert_matches_reference_cli(tmp_path, fields, monkeypatch):
    """Both drivers on one 4^4 input and one checkpoint, 12 point-source
    columns: the port's batched solve against the reference driver; the .npz
    propagators agree to 1e-5 (the inversion bound above) and carry the same
    keys.  The reference driver's batched solve is served by its jnp
    `invert_eo(solver="cg")` column by column: its multi-RHS Pallas kernels
    compile for most of a minute in interpret mode, and they are held against
    K1-R directly in `test_hopping_rhs_matches_reference_kernel`."""
    import tmlqcd_tpu.inverter as jinv
    import tmlqcd_tpu.utils as jutils
    from tmlqcd_tpu.cli import invert as j_cli
    from tmlqcd_tpu_torch.cli import invert as cli

    def per_column(u, bs, params, lat, tol, maxiter):
        solve = jax.jit(lambda b: j_invert_eo(u, b, params, lat, tol=tol, maxiter=maxiter,
                                              solver="cg"))
        res = [solve(b) for b in bs]
        return jinv.InvertResult(x=jnp.stack([r.x for r in res]),
                                 iterations=max(int(r.iterations) for r in res),
                                 residual_sq=jnp.stack([r.residual_sq for r in res]))

    monkeypatch.setattr(jinv, "invert_eo_rhs", per_column)
    # the reference driver would point jax's persistent compile cache into
    # the source tree for the rest of this process
    monkeypatch.setattr(jutils, "enable_persistent_compile_cache", lambda *a, **k: None)
    inp = tmp_path / "invert.input"
    inp.write_text(_INPUT)
    conf = checkpoint.save_checkpoint(str(tmp_path / "confs"), fields["ut"], 3, 1, LAT)
    common = ["-f", str(inp), "-c", conf, "--format", "npz", "--cpu"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(common[:-1] + ["-o", str(tmp_path / "nocuda")])
    assert cli.main(common + ["-o", str(tmp_path / "torch")]) == 0
    assert j_cli.main(common + ["-o", str(tmp_path / "jax")]) == 0
    with np.load(tmp_path / "torch" / "propagator.00.000003.npz") as out, \
            np.load(tmp_path / "jax" / "propagator.00.000003.npz") as ref:
        assert sorted(out.files) == sorted(ref.files)
        assert out["propagator"].shape == (12, 4, 3) + LAT.site_shape
        assert float(np.abs(ref["propagator"]).max()) > 0.5
        assert _maxdiff(out["propagator"], ref["propagator"]) < 1e-5
        for k in ("spin_color", "kappa", "mu", "csw", "dims", "trajectory"):
            np.testing.assert_array_equal(out[k], ref[k])
