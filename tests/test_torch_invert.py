"""Parity of the port's inverter path with the JAX reference (tmlqcd_tpu), on
the CPU: the multi-RHS hopping K1-R (plain version) and the inverter's
options.  The batched operator and CG, the even/odd Schur inversions and
`cli.invert` against the reference are in
tests/test_torch_invert_eo.py (each compiles a reference program, so they
have a file of at most 8 tests, which the test runner queues behind
tests/test_multirhs.py).

Inputs come from seeded numpy generators through `bridge` and go to both
packages as numpy arrays.  The port runs its plain path (CPU tensors).  The
reference runs its jnp operators; K1-R against the reference's multi-RHS
Pallas kernel in interpret mode is in tests/test_torch_invert_kernel.py.

Tolerances: K1-R, 1e-5 absolute on unit-normal inputs, outputs of O(10):
both sides are f32 and differ by summation order (measured 1.9e-6); per
column against the single-RHS plain version the arithmetic is identical, so
the bound there is 0.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from tmlqcd_tpu.lattice import Lattice as JLattice
from tmlqcd_tpu.ops import wilson as jw
from tmlqcd_tpu.ops import wilson_fast as jwf
from tmlqcd_tpu_torch import bridge, config, config_tmlqcd
from tmlqcd_tpu_torch.inverter import invert_eo
from tmlqcd_tpu_torch.lattice import EVEN, ODD, Lattice
from tmlqcd_tpu_torch.ops import dslash_cuda as dc
from tmlqcd_tpu_torch.ops import wilson as w
from tmlqcd_tpu_torch.ops import wilson_fast as wf

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


# ---------------------------------------------------------------------------
# the inverter's options
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("what, text", [
    ("NrYProcs", "NrYProcs = 2\nBeginOperator DBTMWILSON\n kappa = 0.13\nEndOperator\n"),
    ("NrZProcs", "NrZProcs = 2\nBeginOperator DBCLOVER\n kappa = 0.13\nEndOperator\n"),
    ("NrTProcs", "NrTProcs = 2\nBeginOperator OVERLAP\n m = 0.1\nEndOperator\n"),
    ("NrXProcs", "NrXProcs = 2\nBeginOperator CLOVER\n kappa = 0.13\n CSW = 1.5\nEndOperator\n"),
    # a carried solver or smearing option does not hide an unported feature beside it
    ("NrYProcs", "NrYProcs = 2\nUseStoutSmearing = yes\nBeginOperator CLOVER\n kappa = 0.13\n"
                 " CSW = 1.5\n Solver = dfl\nEndOperator\nBeginOperator OVERLAP\n m = 0.1\n"
                 "EndOperator\n"),
    ("NrZProcs", "NrZProcs = 2\nBeginOperator TMWILSON\n kappa = 0.13\n Solver = mixedcg\n"
                 "EndOperator\nBeginOperator OVERLAP\n m = 0.1\nEndOperator\n"),
    ("NrTProcs", "NrTProcs = 2\nBeginOperator TMWILSON\n kappa = 0.13\n Solver = fastmixed\n"
                 "EndOperator\n"),
    ("NrXProcs", "UseSourceSmearing = yes\nNrXProcs = 2\nBeginOperator TMWILSON\n"
                 " kappa = 0.13\n Solver = dflfgmres\nEndOperator\n"),
    ("NrXProcs", "NrXProcs = 2\nBeginOperator TMWILSON\n kappa = 0.13\n Solver = dflgcr\n"
                 "EndOperator\n"),
    ("NrYProcs", "NrYProcs = 2\nBeginOperator TMWILSON\n kappa = 0.13\n Solver = increigcg\n"
                 "EndOperator\n"),
    ("NrXProcs", "NrXProcs = 2\nUseStoutSmearing = yes\nBeginOperator OVERLAP\n m = 0.1\n"
                 "EndOperator\n"),
    ("NrZProcs", "UseSourceSmearing = yes\nNrZProcs = 2\nBeginOperator TMWILSON\n"
                 " kappa = 0.13\nEndOperator\n"),
    ("NrTProcs", "NrTProcs = 2\nBeginOperator TMWILSON\n kappa = 0.13\nEndOperator\n"),
])
def test_unported_inverter_options_raise(what, text):
    cfg = config_tmlqcd.parse_input(text)
    with pytest.raises(NotImplementedError, match=f"(?i){what}.*not yet ported"):
        config.check_invert_ported(cfg)


def test_ported_inverter_options_pass():
    # OVERLAP takes any solver name (sumr, cgne; anything else runs sumr);
    # tests/test_torch_overlap.py runs it
    for solver in ("sumr", "cgne", "cg", "bogus"):
        config.check_invert_ported(config_tmlqcd.parse_input(
            f"UseStoutSmearing = yes\nBeginOperator OVERLAP\n m = 0.1\n Solver = {solver}\n"
            "EndOperator\n"))
    with pytest.raises(ValueError, match="unknown operator type 'NOSUCH'"):
        config.check_invert_ported(config_tmlqcd.parse_input(
            "BeginOperator NOSUCH\n kappa = 0.13\nEndOperator\n"))
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
