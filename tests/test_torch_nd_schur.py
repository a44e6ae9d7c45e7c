"""K1-SD (`dslash_cuda.hopping_schur_nd`), the non-degenerate doublet's
Schur operator in one launch, on the CPU: its plain version equals the
doublet operators as they were composed before it (two K1-R-D hops per Q_nd
and the torch flavour diagonals), bit for bit, for Q_nd and Q_nd^2, the
twisted-mass and the clover doublet, 12- and 18-real links; the operators
of `ops/wilson_fast.py`, the NDRAT multishift operator and the doublet
inverter route through it; its wrapper raises on what the kernel does not
take.  The port alone: no reference program is compiled here (the
composed operators' parity with the reference is held by
`test_torch_nd.py` and `test_torch_nd_kernel.py`).  The kernel itself is
held to the composed path on the card by `test_torch_cuda.py` and
`chip_smoke.py`."""

import numpy as np
import pytest
import torch

from tmlqcd_tpu_torch import rng, su3
from tmlqcd_tpu_torch.lattice import EVEN, ODD, Lattice
from tmlqcd_tpu_torch.ops import clover as cl
from tmlqcd_tpu_torch.ops import dslash_cuda as dc
from tmlqcd_tpu_torch.ops import split_diag as sd
from tmlqcd_tpu_torch.ops import wilson_fast as wf
from tmlqcd_tpu_torch.ops.ndoublet import NDParams

torch.set_num_threads(1)

LAT = Lattice((4, 4, 4, 4))
TM = NDParams(kappa=0.13, mubar=0.15, epsbar=0.12)
SW = NDParams(kappa=0.13, mubar=0.15, epsbar=0.12, c_sw=1.74)


def _gauge():
    return su3.random_su3(rng.generator(rng.Key(7), "cpu"), (4,) + LAT.site_shape)


def _doublet(seed: int) -> torch.Tensor:
    g = np.random.default_rng(seed)
    return torch.tensor(g.standard_normal((2, 2, 4, 3) + LAT.eo_site_shape), dtype=torch.float32)


def _operators(compress: bool):
    """The twisted-mass FastGauge and the clover FastCloverND on one gauge."""
    u = _gauge()
    fg = wf.make_fast_gauge(u, TM.wilson, LAT, compress=compress)
    sw_e, sw_o = cl.sw_blocks_eo(u, SW.kappa, SW.c_sw, LAT)
    return fg, wf.fast_clover_nd_from(fg, sw_e, sw_o, SW)


def _q_nd_composed(op, x: torch.Tensor, params, clover: bool) -> torch.Tensor:
    """Q_nd as composed before K1-SD: each hop one multi-RHS call on the
    flavour axis, the flavour-mixing diagonals in torch between and after."""
    k2 = params.kappa * params.kappa
    fg = op.fg if clover else op
    tmp = wf._hop_nd(fg, x, EVEN, LAT)
    if clover:
        tmp = sd.mee_inv_nd_apply_split(op.minv_a, op.minv_b, op.minv_e, op.epsbar_t, tmp)
    else:
        tmp = sd.mee_inv_nd_split(tmp, params.mubar_t, params.epsbar_t, +1.0)
    tmp = wf._hop_nd(fg, tmp, ODD, LAT)
    if clover:
        m = sd.mee_nd_apply_split(op.moo_u, op.moo_d, op.epsbar_t, x) - k2 * tmp
    else:
        m = sd.mee_nd_split(x, params.mubar_t, params.epsbar_t, +1.0) - k2 * tmp
    return sd.gamma5_nd(sd.tau1_split(m))


@pytest.mark.parametrize("compress", [True, False], ids=["12real", "18real"])
def test_schur_nd_plain_is_the_composed_operator(compress):
    """hopping_schur_nd on CPU tensors (its plain version) equals the
    doublet operators composed hop by hop, bit for bit: Q_nd and Q_nd^2,
    twisted mass and clover; no kernel launch is counted."""
    fg, fc = _operators(compress)
    chi = _doublet(3)
    dc.reset_counters()
    for clover, op, params in ((False, fg, TM), (True, fc, SW)):
        stage = wf._nd_stage(params, fc if clover else None)
        one = dc.hopping_schur_nd(fg.ug_even, fg.ug_odd, chi, LAT, stage, fg.gcomp)
        two = dc.hopping_schur_nd(fg.ug_even, fg.ug_odd, chi, LAT, stage, fg.gcomp, square=True)
        ref = _q_nd_composed(op, chi, params, clover)
        assert one.shape == chi.shape and one.dtype == torch.float32
        assert torch.equal(one, ref), clover
        assert torch.equal(two, _q_nd_composed(op, ref, params, clover)), clover
        assert float(two.abs().max()) > 0.1
    assert dc.hopping_schur_nd_plain.calls == 4 and dc.hopping_schur_nd.launches == 0
    assert dc.hopping_schur_nd.hops == 0 and dc.hopping_split_rhs.launches == 0


def test_doublet_operators_route_through_k1sd():
    """q_nd_fast, q_nd_sq_fast and their clover forms make one K1-SD call
    each (its plain version here: two hops per Q_nd) and give the composed
    operators' bits."""
    fg, fc = _operators(True)
    chi = _doublet(4)
    dc.reset_counters()
    assert torch.equal(wf.q_nd_fast(fg, chi, TM, LAT), _q_nd_composed(fg, chi, TM, False))
    assert torch.equal(wf.q_nd_clover_fast(fc, chi, SW, LAT),
                       _q_nd_composed(fc, chi, SW, True))
    calls = dc.hopping_split_rhs_plain.calls
    sq = wf.q_nd_sq_fast(fg, chi, TM, LAT)
    sq_sw = wf.q_nd_sq_clover_fast(fc, chi, SW, LAT)
    assert dc.hopping_schur_nd_plain.calls == 4
    assert dc.hopping_split_rhs_plain.calls - calls == 8  # two Q_nd of two hops each
    assert torch.equal(sq, wf.q_nd_fast(fg, wf.q_nd_fast(fg, chi, TM, LAT), TM, LAT))
    assert torch.equal(sq_sw, wf.q_nd_clover_fast(fc, wf.q_nd_clover_fast(fc, chi, SW, LAT), SW,
                                                  LAT))


def test_ndrat_operator_and_doublet_inverter_call_k1sd_once_per_q_nd_sq():
    """_NDOps.a (the NDRAT multishift operator) is one K1-SD call per Q_nd^2,
    twisted mass and clover; invert_doublet_eo's CG runs one K1-SD call per
    operator application plus one for its right-hand side's Q_nd, and keeps
    the two single hops of its prologue and epilogue on K1-R-D."""
    from tmlqcd_tpu_torch.hmc.rational_monomials import _NDOps
    from tmlqcd_tpu_torch.inverter import invert_doublet_eo
    from tmlqcd_tpu_torch.meas.sources import point_source

    u = _gauge()
    chi = _doublet(5)
    for params in (TM, SW):
        ops = _NDOps(u, params, LAT, grad=False)
        dc.reset_counters()
        out = ops.a(chi)
        assert dc.hopping_schur_nd_plain.calls == 1
        assert torch.equal(out, ops.q(ops.q(chi)))
    src = point_source(LAT, 1, 2, device="cpu")
    b = torch.stack([src, torch.zeros_like(src)])
    dc.reset_counters()
    res = invert_doublet_eo(u, b, TM, LAT, tol=1e-6, maxiter=200)
    assert 0 < res.iterations < 200
    # CG applies its operator iterations + 1 times (r0 = b - A x0)
    assert dc.hopping_schur_nd_plain.calls == res.iterations + 2
    # the hops: 2 single ones, 2 in the right-hand side's Q_nd, 4 per Q_nd^2
    assert dc.hopping_split_rhs_plain.calls == 4 * res.iterations + 8


def _bad_cases():
    fg, fc = _operators(True)
    chi = _doublet(1)
    tm = wf._nd_stage(TM)
    sw = wf._nd_stage(SW, fc)
    return fg, chi, {
        "shape": [(dict(chi=chi[:, :1].contiguous()), ValueError, "chi has shape"),
                  (dict(stage=sw[:2] + ((fc.minv_a, fc.minv_b, fc.minv_e[..., :2]), sw[3])),
                   ValueError, "blocks has shape"),
                  (dict(stage=sw[:3] + ((fc.moo_u,),)), ValueError, "2 odd block fields"),
                  (dict(chi=chi.transpose(3, 4).contiguous().transpose(3, 4)), ValueError,
                   "contiguous")],
        "dtype": [(dict(chi=chi.double()), TypeError, "chi must be float32"),
                  (dict(ug="bf16"), TypeError, "K1-SD takes f32 links"),
                  (dict(device="meta"), ValueError, "no kernel for device meta")],
        "stages": [(dict(stage=tm[:3]), ValueError, "a doublet Schur stage is"),
                   (dict(stage=(tm, tm)), ValueError, "a doublet Schur stage is"),
                   (dict(stage=(tm[0], sw[1], None, sw[3])), ValueError, "epilogue pairs"),
                   (dict(stage=(("mee_inv", 0.1, 1.0), tm[1], None, None)), ValueError,
                    "epilogue pairs"),
                   (dict(stage=(tm[0][:2], tm[1], None, None)), ValueError,
                    "epilogue arguments"),
                   (dict(gcomp=((1.0, 0.0),) * 7), ValueError, "8 \\(re, im\\) pairs")],
    }


@pytest.mark.parametrize("kind", ["shape", "dtype", "stages"])
def test_schur_nd_wrapper_raises(kind):
    """The wrapper raises on what the kernel does not take: wrong shapes
    (the doublet, a block field, the number of block fields), layout, type
    (f64 fields, bf16 links), a device with no kernel (no fallback), a stage
    that is not (even epilogue, odd epilogue, even blocks, odd blocks),
    mixed or unknown epilogue pairs, and the row-2 constants."""
    fg, chi0, cases = _bad_cases()
    for change, exc, match in cases[kind]:
        chi = change.get("chi", chi0)
        ug_e, ug_o = fg.ug_even, fg.ug_odd
        if change.get("ug") == "bf16":
            ug_e, ug_o = wf.sloppy_gauge(fg).ug_even, wf.sloppy_gauge(fg).ug_odd
        if change.get("device") == "meta":
            chi, ug_e, ug_o = chi.to("meta"), ug_e.to("meta"), ug_o.to("meta")
        stage = change.get("stage", wf._nd_stage(TM))
        with pytest.raises(exc, match=match):
            dc.hopping_schur_nd(ug_e, ug_o, chi, LAT, stage, change.get("gcomp", fg.gcomp))
