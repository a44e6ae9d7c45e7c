"""K1-S (`dslash_cuda.hopping_schur`), the even/odd Schur operator in one
launch, on the CPU: its plain version is the composition of K1's plain
version, bit for bit, in every epilogue pair, sign, gamma5 and link type;
the Schur operators of `ops/wilson_fast.py` route through it and give the
hop-by-hop results; its wrapper raises on what the kernel does not take.
The port alone: no reference program is compiled here (the operators'
parity with the reference is held by `test_torch_dirac.py`,
`test_torch_clover.py` and `test_torch_sloppy.py`).  The kernel itself is
held to the K1 launches on the card by `test_torch_cuda.py` and
`chip_smoke.py`."""

import numpy as np
import pytest
import torch

from tmlqcd_tpu_torch import rng, su3
from tmlqcd_tpu_torch.lattice import EVEN, ODD, Lattice
from tmlqcd_tpu_torch.ops import dslash_cuda as dc
from tmlqcd_tpu_torch.ops import wilson_fast as wf
from tmlqcd_tpu_torch.ops.wilson import DiracParams

torch.set_num_threads(1)

PARAMS = DiracParams(kappa=0.13, mu=0.01)
K2 = PARAMS.kappa ** 2
# 4^4, and a shape whose parity volume (144) fills no 128-thread block twice
LATS = {"4^4": Lattice((4, 4, 4, 4)), "6x4x2x6": Lattice((6, 4, 2, 6))}
GAUGES = ("18-real f32", "12-real f32", "18-real bf16", "12-real bf16")


def _field(lat: Lattice, seed: int) -> torch.Tensor:
    rs = np.random.default_rng(seed)
    return torch.tensor(rs.standard_normal((2, 4, 3) + lat.eo_site_shape), dtype=torch.float32)


def _gauge(lat: Lattice, name: str) -> wf.FastGauge:
    u = su3.random_su3(rng.generator(rng.Key(7), "cpu"), (4,) + lat.site_shape)
    return wf.make_fast_gauge(u, PARAMS, lat, compress=name.startswith("12"),
                              sloppy=name.endswith("bf16"))


def _blocks(lat: Lattice, seed: int) -> torch.Tensor:
    """Generic (not hermitian) blocks [2, 72, T, X, M] of order one."""
    rs = np.random.default_rng(seed)
    return torch.tensor(rs.standard_normal((2, 72) + lat.eo_site_shape), dtype=torch.float32)


def _stages(kind: str, signs: tuple, g5: bool, blocks) -> tuple:
    if kind == "tm":
        return tuple((("mee_inv", PARAMS.mutld, s), ("mhat", PARAMS.mutld, s, K2, g5), None, None)
                     for s in signs)
    return tuple((("clov_inv",), ("clov_mhat", K2, g5), blocks[2 * j], blocks[2 * j + 1])
                 for j in range(len(signs)))


def _by_hops(fg: wf.FastGauge, x: torch.Tensor, lat: Lattice, stages) -> torch.Tensor:
    """The hops K1-S replaces, one plain K1 each."""
    for epi_e, epi_o, blk_e, blk_o in stages:
        tmp = dc.hopping_split_plain(fg.ug_even, x, EVEN, lat, epi_e, gcomp=fg.gcomp,
                                     blocks=blk_e)
        x = dc.hopping_split_plain(fg.ug_odd, tmp, ODD, lat, epi_o, psi_o=x, gcomp=fg.gcomp,
                                   blocks=blk_o)
    return x


@pytest.mark.parametrize("gauge", GAUGES)
@pytest.mark.parametrize("lat_name", list(LATS))
def test_schur_plain_is_the_k1_composition(lat_name, gauge):
    """hopping_schur on CPU tensors (its plain version) equals the plain K1
    hops it replaces bit for bit: both epilogue pairs, Mhat(+), Mhat(-) and
    Qhat_pm, gamma5 on and off; no kernel launch is counted."""
    lat = LATS[lat_name]
    fg = _gauge(lat, gauge)
    psi = _field(lat, 3)
    blocks = [_blocks(lat, 10 + i) for i in range(4)]
    dc.reset_counters()
    n = 0
    for kind in ("tm", "clover"):
        for g5 in (True, False):
            for signs in ((1.0,), (-1.0,), (1.0, -1.0)):
                stages = _stages(kind, signs, g5, blocks)
                out = dc.hopping_schur(fg.ug_even, fg.ug_odd, psi, lat, stages, fg.gcomp)
                ref = _by_hops(fg, psi, lat, stages)
                assert out.shape == psi.shape and out.dtype == torch.float32
                assert torch.equal(out, ref), (kind, g5, signs)
                assert float(out.abs().max()) > 0.1
                n += 1
    assert dc.hopping_schur_plain.calls == n and dc.hopping_schur.launches == 0
    assert dc.hopping_schur.hops == 0 and dc.hopping_split.launches == 0


@pytest.mark.parametrize("gauge", ["12-real f32", "12-real bf16"])
def test_schur_operators_route_through_k1s(gauge):
    """m_hat_fast, q_hat_pm_fast and their clover forms run one K1-S call
    each (its plain version here) and equal their hops one by one; the
    batched forms (r_axis = 3) stay on K1-R."""
    lat = LATS["4^4"]
    fg = _gauge(lat, gauge)
    u = su3.random_su3(rng.generator(rng.Key(7), "cpu"), (4,) + lat.site_shape)
    from tmlqcd_tpu_torch.ops import clover as cl

    cparams = DiracParams(kappa=0.13, mu=0.01, c_sw=1.74)
    sw_e, sw_o = cl.sw_blocks_eo(u, cparams.kappa, cparams.c_sw, lat)
    fc = wf.fast_clover_from(fg, sw_e, sw_o, cparams.mutld)
    psi = _field(lat, 4)
    blk = {1.0: (fc.mee_inv_p, fc.moo_p), -1.0: (fc.mee_inv_m, fc.moo_m)}
    k2c = cparams.kappa ** 2
    dc.reset_counters()
    for sign in (1.0, -1.0):
        for g5 in (True, False):
            tm = ((("mee_inv", PARAMS.mutld, sign), ("mhat", PARAMS.mutld, sign, K2, g5), None,
                   None),)
            assert torch.equal(wf.m_hat_fast(fg, psi, PARAMS, lat, sign, g5),
                               _by_hops(fg, psi, lat, tm))
            sw = ((("clov_inv",), ("clov_mhat", k2c, g5)) + blk[sign],)
            assert torch.equal(wf.m_hat_clover_fast(fc, psi, cparams, lat, sign, g5),
                               _by_hops(fg, psi, lat, sw))
    pm = tuple((("mee_inv", PARAMS.mutld, s), ("mhat", PARAMS.mutld, s, K2, True), None, None)
               for s in (1.0, -1.0))
    assert torch.equal(wf.q_hat_pm_fast(fg, psi, PARAMS, lat), _by_hops(fg, psi, lat, pm))
    pmc = tuple((("clov_inv",), ("clov_mhat", k2c, True)) + blk[s] for s in (1.0, -1.0))
    assert torch.equal(wf.q_hat_pm_clover_fast(fc, psi, cparams, lat), _by_hops(fg, psi, lat, pmc))
    assert dc.hopping_schur_plain.calls == 10
    # a batch along r_axis = 3 runs four K1-R calls, not K1-S
    batch = torch.movedim(torch.stack([psi, _field(lat, 5)]), 0, 3).contiguous()
    out = wf.q_hat_pm_fast(fg, batch, PARAMS, lat, r_axis=3)
    assert dc.hopping_schur_plain.calls == 10 and dc.hopping_split_rhs_plain.calls == 4
    assert torch.equal(out[:, :, :, 0], _by_hops(fg, psi, lat, pm))


def _bad_cases():
    lat = LATS["4^4"]
    tm = (("mee_inv", 0.1, 1.0), ("mhat", 0.1, 1.0, K2, True), None, None)
    sw = (("clov_inv",), ("clov_mhat", K2, True), _blocks(lat, 1), _blocks(lat, 2))
    psi = _field(lat, 1)
    return {
        "psi shape": (dict(psi=psi[:, :, :, :2].contiguous()), ValueError, "psi_q has shape"),
        "psi dtype": (dict(psi=psi.double()), TypeError, "psi_q must be float32"),
        "psi not contiguous": (dict(psi=psi.transpose(1, 2).contiguous().transpose(1, 2)),
                               ValueError, "contiguous"),
        "blocks missing": (dict(stages=(sw[:2] + (None, sw[3]),)), ValueError, "need blocks"),
        "blocks shape": (dict(stages=(sw[:3] + (sw[3][:, :36].contiguous(),),)), ValueError,
                         "blocks has shape"),
        "psi_o epilogue": (dict(stages=((("mee_inv", 0.1, 1.0), ("none",), None, None),)),
                           ValueError, "epilogue pairs"),
        "pairs differ": (dict(stages=(tm, sw)), ValueError, "share their epilogue pair"),
        "g5 differs": (dict(stages=(tm, tm[:1] + (("mhat", 0.1, 1.0, K2, False),) + tm[2:])),
                       ValueError, "gamma5"),
        "three stages": (dict(stages=(tm, tm, tm)), ValueError, "1 \\(Mhat\\) or 2"),
        "link types differ": (dict(ug_o="bf16"), TypeError, "link copies differ"),
        "bf16 layout": (dict(ug_e="bf16 contiguous", ug_o="bf16 contiguous"), ValueError,
                        "re/im innermost"),
        "gcomp": (dict(gcomp=((1.0, 0.0),) * 7), ValueError, "8 \\(re, im\\) pairs"),
        "device": (dict(device="meta"), ValueError, "no kernel for device meta"),
    }


@pytest.mark.parametrize("case", list(_bad_cases()))
def test_schur_wrapper_raises(case):
    """The wrapper checks its arguments once per call and raises on what the
    kernel does not take: shapes, types, layout, missing blocks, epilogue
    pairs, mixed stages, a third stage, a bf16 gauge not in the sloppy
    copy's layout, the row-2 constants, and a device with no kernel (no
    fallback)."""
    lat = LATS["4^4"]
    fg = _gauge(lat, "12-real f32")
    change, exc, match = _bad_cases()[case]
    psi = change.get("psi", _field(lat, 1))
    ug_e, ug_o = fg.ug_even, fg.ug_odd
    if change.get("ug_o") == "bf16":
        ug_o = ug_o.to(torch.bfloat16)
    if change.get("ug_e") == "bf16 contiguous":  # not the sloppy copy's layout
        ug_e, ug_o = ug_e.to(torch.bfloat16), ug_o.to(torch.bfloat16)
    stages = change.get("stages", ((("mee_inv", 0.1, 1.0), ("mhat", 0.1, 1.0, K2, True), None,
                                    None),))
    gcomp = change.get("gcomp", fg.gcomp)
    if change.get("device") == "meta":
        psi, ug_e, ug_o = psi.to("meta"), ug_e.to("meta"), ug_o.to("meta")
    with pytest.raises(exc, match=match):
        dc.hopping_schur(ug_e, ug_o, psi, lat, stages, gcomp)
