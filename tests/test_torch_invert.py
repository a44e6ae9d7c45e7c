"""Parity of the port's inverter path with the JAX reference (tmlqcd_tpu), on
the CPU: the multi-RHS hopping K1-R (plain version), the batched CG, the
even/odd Schur inversions and the `cli.invert` driver.

Inputs come from seeded numpy generators through `bridge` and go to both
packages as numpy arrays.  The port runs its plain path (CPU tensors).  The
reference runs its jnp operators; K1-R against the reference's multi-RHS
Pallas kernel in interpret mode is in tests/test_torch_invert_kernel.py.

Tolerances, each derived where it is used:
* K1-R: 1e-5 absolute on unit-normal inputs, outputs of O(10): both sides
  are f32 and differ by summation order (measured 1.9e-6); per column
  against the single-RHS plain version the arithmetic is identical, so the
  bound there is 0.
* CG and inversions at tol 1e-5..1e-7: equal iteration counts (f64 norms on
  both sides); solutions to 1e-5 on entries of O(1): f32 rounding over the
  ~15 iterations (measured 4.8e-7 for cg_rhs, 7.2e-7 for the inversions).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from tmlqcd_tpu.inverter import invert_eo as j_invert_eo
from tmlqcd_tpu.lattice import Lattice as JLattice
from tmlqcd_tpu.lattice import pack_gauge_eo as j_pack
from tmlqcd_tpu.ops import wilson as jw
from tmlqcd_tpu.ops import wilson_fast as jwf
from tmlqcd_tpu.solvers.cg import cg_rhs as j_cg_rhs
from tmlqcd_tpu_torch import bridge, config, config_tmlqcd
from tmlqcd_tpu_torch.inverter import invert_eo, invert_eo_rhs
from tmlqcd_tpu_torch.io import checkpoint
from tmlqcd_tpu_torch.lattice import EVEN, ODD, Lattice
from tmlqcd_tpu_torch.ops import dslash_cuda as dc
from tmlqcd_tpu_torch.ops import wilson as w
from tmlqcd_tpu_torch.ops import wilson_fast as wf
from tmlqcd_tpu_torch.solvers.cg import cg, cg_rhs

torch.set_num_threads(1)

DIMS = (4, 4, 4, 4)
JL, LAT = JLattice(DIMS), Lattice(DIMS)
KAPPA, MU = 0.13, 0.1
JP, TP = jw.DiracParams(kappa=KAPPA, mu=MU), w.DiracParams(kappa=KAPPA, mu=MU)
R = 3
K2 = KAPPA * KAPPA
EPILOGUES = {
    "none": ("none",),
    "mee_inv": ("mee_inv", TP.mutld, 1.0),
    "mhat+g5": ("mhat", TP.mutld, 1.0, K2, True),
    "mhat-": ("mhat", TP.mutld, -1.0, K2, False),
}


def _maxdiff(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


@pytest.fixture(scope="module")
def fields():
    u = bridge.numpy_su3(np.random.default_rng(30), (4,) + JL.site_shape)
    psis = bridge.numpy_spinor(np.random.default_rng(31), (R, 4, 3) + JL.eo_site_shape)
    psis_o = bridge.numpy_spinor(np.random.default_rng(32), (R, 4, 3) + JL.eo_site_shape)
    ut = bridge.gauge_from_numpy(u, LAT)
    return dict(u=u, ut=ut, psis=psis, psis_o=psis_o,
                p2=wf.to_split_rhs(torch.as_tensor(psis)),
                po2=wf.to_split_rhs(torch.as_tensor(psis_o)),
                fg12=wf.make_fast_gauge(ut, TP, LAT),
                fg18=wf.make_fast_gauge(ut, TP, LAT, compress=False))


@pytest.fixture(scope="module")
def sources():
    """Three full-lattice sources: two point sources and one gaussian field."""
    src = np.zeros((R, 4, 3) + JL.site_shape, np.complex64)
    src[0, 0, 0, 0, 0, 0] = 1.0
    src[1, 2, 1, 1, 2, 3] = 1.0
    src[2] = bridge.numpy_spinor(np.random.default_rng(33), (4, 3) + JL.site_shape)
    return src


# ---------------------------------------------------------------------------
# K1-R
# ---------------------------------------------------------------------------


def test_split_rhs_layout_matches_reference(fields):
    ref = jwf.to_split_rhs(jnp.asarray(fields["psis"]))
    assert tuple(fields["p2"].shape) == (2, 4, 3, R) + LAT.eo_site_shape
    assert fields["p2"].is_contiguous()
    np.testing.assert_array_equal(bridge.to_numpy(fields["p2"]), np.asarray(ref))
    np.testing.assert_array_equal(bridge.to_numpy(wf.from_split_rhs(fields["p2"])),
                                  fields["psis"])


@pytest.mark.parametrize("gauge", ["fg18", "fg12"])
@pytest.mark.parametrize("epi", sorted(EPILOGUES))
def test_hopping_rhs_plain_equals_per_column_plain(fields, gauge, epi):
    """K1-R's plain version is K1's plain version column by column, to the
    last bit: the links only broadcast over R."""
    fg, e = fields[gauge], EPILOGUES[epi]
    po = fields["po2"] if e[0] == "mhat" else None
    out = dc.hopping_split_rhs(fg.ug_odd, fields["p2"], ODD, LAT, epi=e, psi_o=po,
                               gcomp=fg.gcomp, r_axis=3)
    for r in range(R):
        one = dc.hopping_split(fg.ug_odd, fields["p2"][:, :, :, r].contiguous(), ODD, LAT, epi=e,
                               psi_o=None if po is None else po[:, :, :, r].contiguous(),
                               gcomp=fg.gcomp)
        assert torch.equal(out[:, :, :, r], one)


def test_hopping_rhs_checks_its_arguments(fields):
    fg, p2 = fields["fg12"], fields["p2"]
    with pytest.raises(ValueError, match="a flavour doublet has 2 flavours"):
        dc.hopping_split_rhs(fg.ug_even, p2, EVEN, LAT, gcomp=fg.gcomp, r_axis=1)
    with pytest.raises(ValueError, match="r_axis = 2"):
        dc.hopping_split_rhs(fg.ug_even, p2, EVEN, LAT, gcomp=fg.gcomp, r_axis=2)
    with pytest.raises(ValueError, match="contiguous"):
        dc.hopping_split_rhs(fg.ug_even, torch.stack([p2, p2], dim=-1)[..., 0], EVEN, LAT,
                             gcomp=fg.gcomp)
    with pytest.raises(ValueError, match="needs psi_o"):
        dc.hopping_split_rhs(fg.ug_even, p2, EVEN, LAT, epi=EPILOGUES["mhat+g5"], gcomp=fg.gcomp)
    with pytest.raises(ValueError, match="shape"):
        dc.hopping_split_rhs(fg.ug_even, p2[:, :, :, 0].contiguous(), EVEN, LAT, gcomp=fg.gcomp)


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


@pytest.mark.parametrize("what, text", [
    ("NrYProcs", "NrYProcs = 2\nBeginOperator DBTMWILSON\n kappa = 0.13\nEndOperator\n"),
    ("NrZProcs", "NrZProcs = 2\nBeginOperator DBCLOVER\n kappa = 0.13\nEndOperator\n"),
    ("OVERLAP", "BeginOperator OVERLAP\n kappa = 0.13\nEndOperator\n"),
    ("NrXProcs", "NrXProcs = 2\nBeginOperator CLOVER\n kappa = 0.13\n CSW = 1.5\nEndOperator\n"),
    # a carried solver or smearing option does not hide an unported feature beside it
    ("OVERLAP", "UseStoutSmearing = yes\nBeginOperator CLOVER\n kappa = 0.13\n"
                " CSW = 1.5\n Solver = dfl\nEndOperator\nBeginOperator OVERLAP\n kappa = 0.13\n"
                "EndOperator\n"),
    ("OVERLAP", "BeginOperator TMWILSON\n kappa = 0.13\n Solver = mixedcg\nEndOperator\n"
                "BeginOperator OVERLAP\n kappa = 0.13\nEndOperator\n"),
    ("NrTProcs", "NrTProcs = 2\nBeginOperator TMWILSON\n kappa = 0.13\n Solver = fastmixed\n"
                 "EndOperator\n"),
    ("NrXProcs", "UseSourceSmearing = yes\nNrXProcs = 2\nBeginOperator TMWILSON\n"
                 " kappa = 0.13\n Solver = dflfgmres\nEndOperator\n"),
    ("NrXProcs", "NrXProcs = 2\nBeginOperator TMWILSON\n kappa = 0.13\n Solver = dflgcr\n"
                 "EndOperator\n"),
    ("NrYProcs", "NrYProcs = 2\nBeginOperator TMWILSON\n kappa = 0.13\n Solver = increigcg\n"
                 "EndOperator\n"),
    ("OVERLAP", "UseStoutSmearing = yes\nBeginOperator OVERLAP\n kappa = 0.13\nEndOperator\n"),
    ("NrZProcs", "UseSourceSmearing = yes\nNrZProcs = 2\nBeginOperator TMWILSON\n"
                 " kappa = 0.13\nEndOperator\n"),
    ("NrTProcs", "NrTProcs = 2\nBeginOperator TMWILSON\n kappa = 0.13\nEndOperator\n"),
])
def test_unported_inverter_options_raise(what, text):
    cfg = config_tmlqcd.parse_input(text)
    with pytest.raises(NotImplementedError, match=f"(?i){what}.*not yet ported"):
        config.check_invert_ported(cfg)


def test_ported_inverter_options_pass():
    for op in ("TMWILSON", "WILSON", "CLOVER", "DBTMWILSON", "DBCLOVER"):
        for solver in ("cg", "fastcg"):
            for csw in ("", " CSW = 1.0\n"):
                config.check_invert_ported(config_tmlqcd.parse_input(
                    f"BeginOperator {op}\n kappa = 0.13\n{csw} Solver = {solver}\nEndOperator\n"))
    # stout and source smearing are carried (tests/test_torch_smearing.py runs them)
    for keys in ("UseStoutSmearing = yes\n", "UseSourceSmearing = yes\n",
                 "UseStoutSmearing = yes\nStoutNoIterations = 3\nUseSourceSmearing = yes\n"):
        config.check_invert_ported(config_tmlqcd.parse_input(
            keys + "BeginOperator TMWILSON\n kappa = 0.13\nEndOperator\n"))
    # the overlap's solvers are not the inverter's: refused by name
    for solver in ("sumr", "cgne", "nope"):
        with pytest.raises(ValueError, match="unknown solver"):
            invert_eo(torch.zeros(1), torch.zeros(1), TP, LAT, solver=solver)


@pytest.mark.parametrize("solver", ["mixedcg", "rgmixedcg", "fastmixed", "bicgstab", "cgs",
                                    "gmres", "fgmres", "gcr", "mr", "dfl", "dflfgmres",
                                    "dflgcr", "increigcg"])
def test_inverter_solvers_pass(solver):
    for op in ("TMWILSON", "WILSON", "CLOVER", "DBTMWILSON", "DBCLOVER"):
        config.check_invert_ported(config_tmlqcd.parse_input(
            f"BeginOperator {op}\n kappa = 0.13\n CSW = 1.0\n Solver = {solver.upper()}\n"
            "EndOperator\n"))
