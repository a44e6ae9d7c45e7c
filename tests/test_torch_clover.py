"""The port's twisted-clover operator on the CPU: the sigma matrices against
the JAX reference (tmlqcd_tpu), the plain versions of the kernel's
clov_inv / clov_mhat epilogues for K1 and K1-R, the split-field operators
at c_sw = 0 and on a batch, and the even/odd packing of the blocks.  The
parity with the reference's operators is in two files of at most 8 tests,
which the test runner queues behind tests/test_multirhs.py (each case
compiles the reference's jnp programs for seconds):
tests/test_torch_clover_term.py (the field strength, the clover blocks and
their application, inverse and log determinant in complex128 and
complex64) and tests/test_torch_clover_ref.py (the reference's blocks: the
6 x 6 block algebra, Qsw_pm, the fused Schur complement and the split-field
operators on both packages' blocks).  The two epilogue cases that hold the
plain versions against the reference's Pallas kernel in interpret mode,
and the clover force surrogate, are in tests/test_torch_clover_kernel.py.

Inputs come from seeded numpy generators through `bridge` (`_data`, which
the three files share).  The port runs its plain path (CPU tensors).

Tolerances, each derived where it is used: 2e-6 on single applications
(entries of O(1), f32 rounding); K1-R plain against K1 plain per column:
identical arithmetic, bound 0.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from tmlqcd_tpu.lattice import Lattice as JLattice
from tmlqcd_tpu.ops import wilson as jw
from tmlqcd_tpu_torch import bridge
from tmlqcd_tpu_torch import gamma as tgamma
from tmlqcd_tpu_torch.lattice import EVEN, ODD, Lattice, eo_pack, pack_gauge_eo
from tmlqcd_tpu_torch.ops import clover as cl
from tmlqcd_tpu_torch.ops import dslash_cuda as dc
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
# the point of tests/test_pallas_dslash.py::test_q_clover_fast_matches_reference
KW = dict(kappa=0.14, mu=0.04, c_sw=1.3)
JP, TP = jw.DiracParams(**KW), w.DiracParams(**KW)
K2 = TP.kappa * TP.kappa
R = 3


def _maxdiff(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


def _data():
    """The gauge and the spinors of the checks, from one numpy seed, and the
    port's clover blocks on them."""
    g = np.random.default_rng(40)
    u = bridge.numpy_su3(g, (4,) + JL.site_shape)
    psi = bridge.numpy_spinor(g, (4, 3) + JL.eo_site_shape)
    psis = bridge.numpy_spinor(g, (R, 4, 3) + JL.eo_site_shape)
    ut = bridge.gauge_from_numpy(u, LAT)
    return dict(u=u, ut=ut, psi=psi, pt=bridge.spinor_from_numpy(psi, LAT), psis=psis,
                tsw=cl.sw_blocks_eo(ut, TP.kappa, TP.c_sw, LAT),
                fc=wf.make_fast_clover(ut, TP, LAT))


@pytest.fixture(scope="module")
def fields():
    return _data()


# ---------------------------------------------------------------------------
# ops/clover.py
# ---------------------------------------------------------------------------


def test_sigma_munu_and_matvec_match_reference():
    from tmlqcd_tpu import gamma as jgamma
    from tmlqcd_tpu import su3 as jsu3
    from tmlqcd_tpu_torch import su3

    np.testing.assert_array_equal(tgamma.SIGMA_MUNU, jgamma.SIGMA_MUNU)
    g = np.random.default_rng(41)
    m = bridge.numpy_su3(g, (5,))
    v = bridge.numpy_spinor(g, (3, 5))
    assert _maxdiff(su3.matvec(torch.as_tensor(m), torch.as_tensor(v)),
                    jsu3.matvec(jnp.asarray(m), jnp.asarray(v))) < 1e-6


def test_clover_operator_at_csw_zero_is_twisted_mass(fields):
    p0 = w.DiracParams(kappa=TP.kappa, mu=TP.mu, c_sw=0.0)
    ueo, ph = pack_gauge_eo(fields["ut"], LAT), w.boundary_phases(p0, LAT)
    sw_e, sw_o = cl.sw_blocks_eo(fields["ut"], p0.kappa, 0.0, LAT)
    assert float(sw_e.abs().max()) == 0.0
    out = cl.q_hat_pm_clover(ueo, sw_e, sw_o, fields["pt"], p0, LAT, ph)
    assert _maxdiff(out, w.q_hat_pm(ueo, fields["pt"], p0, LAT, ph)) < 2e-6
    fast = wf.q_hat_pm_clover_fast(wf.make_fast_clover(fields["ut"], p0, LAT),
                                   wf.to_split(fields["pt"]), p0, LAT)
    ref = wf.q_hat_pm_fast(wf.make_fast_gauge(fields["ut"], p0, LAT), wf.to_split(fields["pt"]),
                           p0, LAT)
    assert _maxdiff(fast, ref) < 2e-6


@pytest.mark.parametrize("compress", [False, True], ids=["18real", "12real"])
@pytest.mark.parametrize("epi", [("clov_inv",), ("clov_mhat", K2, True), ("clov_mhat", K2, False)],
                         ids=["clov_inv", "clov_mhat+g5", "clov_mhat"])
def test_clover_rhs_plain_equals_per_column_plain(fields, compress, epi):
    """K1-R's plain version is K1's plain version column by column, to the
    last bit: the links and the blocks only broadcast over R."""
    fc = fields["fc"]
    fg = wf.make_fast_gauge(fields["ut"], TP, LAT, compress=compress)
    p2 = wf.to_split_rhs(torch.as_tensor(fields["psis"]))
    po2 = torch.flip(p2, dims=(3,)) if epi[0] == "clov_mhat" else None
    out = dc.hopping_split_rhs(fg.ug_odd, p2, ODD, LAT, epi=epi, psi_o=po2, gcomp=fg.gcomp,
                               r_axis=3, blocks=fc.moo_p)
    for r in range(R):
        one = dc.hopping_split(fg.ug_odd, p2[:, :, :, r].contiguous(), ODD, LAT, epi=epi,
                               psi_o=None if po2 is None else po2[:, :, :, r].contiguous(),
                               gcomp=fg.gcomp, blocks=fc.moo_p)
        assert torch.equal(out[:, :, :, r], one)


def test_clover_epilogues_check_their_arguments(fields):
    fc, p2 = fields["fc"], wf.to_split(fields["pt"])
    kw = dict(gcomp=fc.fg.gcomp)
    with pytest.raises(ValueError, match="needs blocks"):
        dc.hopping_split(fc.fg.ug_even, p2, EVEN, LAT, epi=("clov_inv",), **kw)
    with pytest.raises(ValueError, match="needs psi_o"):
        dc.hopping_split(fc.fg.ug_odd, p2, ODD, LAT, epi=("clov_mhat", K2, True),
                         blocks=fc.moo_p, **kw)
    with pytest.raises(ValueError, match="blocks has shape"):
        dc.hopping_split(fc.fg.ug_even, p2, EVEN, LAT, epi=("clov_inv",),
                         blocks=dc.blk_unflatten(fc.mee_inv_p), **kw)
    with pytest.raises(TypeError, match="blocks must be float32"):
        dc.hopping_split(fc.fg.ug_even, p2, EVEN, LAT, epi=("clov_inv",),
                         blocks=fc.mee_inv_p.double(), **kw)
    with pytest.raises(ValueError, match="blocks must be contiguous"):
        dc.hopping_split(fc.fg.ug_even, p2, EVEN, LAT, epi=("clov_inv",),
                         blocks=torch.stack([fc.mee_inv_p] * 2, dim=-1)[..., 0], **kw)
    with pytest.raises(ValueError, match="none, mee_inv, mhat, clov_inv, clov_mhat"):
        dc.hopping_split(fc.fg.ug_even, p2, EVEN, LAT, epi=("clov",), **kw)
    p7 = wf.to_split_rhs(torch.as_tensor(fields["psis"]))
    with pytest.raises(ValueError, match="blocks has shape"):
        dc.hopping_split_rhs(fc.fg.ug_even, p7, EVEN, LAT, epi=("clov_inv",), r_axis=3,
                             blocks=torch.stack([fc.mee_inv_p] * R, dim=2), **kw)


# ---------------------------------------------------------------------------
# ops/wilson_fast.py and bridge
# ---------------------------------------------------------------------------


def test_q_hat_pm_clover_fast_rhs_matches_single(fields):
    fc = fields["fc"]
    p7 = wf.to_split_rhs(torch.as_tensor(fields["psis"]))
    out = wf.q_hat_pm_clover_fast(fc, p7, TP, LAT, r_axis=3)
    for r in range(R):
        one = wf.q_hat_pm_clover_fast(fc, p7[:, :, :, r].contiguous(), TP, LAT)
        assert torch.equal(out[:, :, :, r], one)
    # the flavour-doublet axis carries no fused epilogue
    with pytest.raises(ValueError, match="epilogue 'none' only"):
        wf.q_hat_pm_clover_fast(fc, p7, TP, LAT, r_axis=1)


def test_eo_pack_of_blocks_round_trips(fields):
    sw = cl.sw_blocks(fields["ut"], TP.kappa, TP.c_sw, LAT)
    sw_e, sw_o = eo_pack(sw, LAT)
    assert torch.equal(sw_e, fields["tsw"][0]) and torch.equal(sw_o, fields["tsw"][1])
