"""The bf16 (sloppy) gauge copy of the port against the JAX reference
(tmlqcd_tpu) on the CPU: the copies bit for bit, and the hopping and the
Schur operators Qhat+- and Qsw+- on them against the reference's fast
operators, whose Pallas kernels run in interpret mode here.  Each kernel
build costs 10-15 s on the CPU, so the four operators share the two builds
of the reference's fast Qsw(+): its sign is the choice of blocks, and Qhat
is Qsw with the c_sw = 0 blocks.

The sloppy copy is the f32 copy rounded to bf16 (nearest even) in both
packages, so the copies agree bit for bit (compared as uint16).  The port's
plain hop upcasts the bf16 links and rebuilds row 2 of the 12-real copy from
the rounded rows 0 and 1, as the kernels do; both sides then compute in f32,
so they agree to f32 rounding of outputs of O(10): ATOL = 1e-5, as in
tests/test_torch_dirac.py.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tmlqcd_tpu.lattice import Lattice as JLattice
from tmlqcd_tpu.ops import dslash_pallas as jdp
from tmlqcd_tpu.ops import wilson as jw
from tmlqcd_tpu.ops import wilson_fast as jwf
from tmlqcd_tpu_torch import bridge
from tmlqcd_tpu_torch.lattice import EVEN, ODD, Lattice
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


ATOL = 1e-5
DIMS = (4, 4, 4, 4)
JL, LAT = JLattice(DIMS), Lattice(DIMS)
PARAMS = dict(kappa=0.15, mu=0.03, c_sw=1.2)


def _maxdiff(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


def _bits(t) -> np.ndarray:
    """bf16 elements as uint16, from either package."""
    if isinstance(t, torch.Tensor):
        return t.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(t).view(np.uint16)


@pytest.fixture(scope="module")
def fields():
    u = bridge.numpy_su3(np.random.default_rng(31), (4,) + JL.site_shape)
    psi = bridge.numpy_spinor(np.random.default_rng(32), (4, 3) + JL.eo_site_shape)
    return dict(u=u, ut=bridge.gauge_from_numpy(u, LAT), psi=psi,
                psi2=wf.to_split(torch.as_tensor(psi)), jp=jw.DiracParams(**PARAMS),
                tp=w.DiracParams(**PARAMS))


@pytest.mark.parametrize("compress", [False, True], ids=["18real", "12real"])
def test_sloppy_copies_are_bit_equal_to_reference(fields, compress):
    fj = jwf.make_fast_gauge(fields["u"], fields["jp"], JL, sloppy=True, compress=compress)
    ft = wf.make_fast_gauge(fields["ut"], fields["tp"], LAT, sloppy=True, compress=compress)
    assert ft.ug_even.dtype == ft.ug_odd.dtype == torch.bfloat16
    # the port's layout: re/im innermost in memory (one bf16x2 load per element)
    assert all(t.movedim(0, -1).is_contiguous() for t in (ft.ug_even, ft.ug_odd))
    assert ft.gcomp == fj.gcomp
    np.testing.assert_array_equal(_bits(ft.ug_even), _bits(fj.ug_even))
    np.testing.assert_array_equal(_bits(ft.ug_odd), _bits(fj.ug_odd))
    # the cast of the f32 copy, and the clover copy's gauge, are the same bits
    f32 = wf.make_fast_gauge(fields["ut"], fields["tp"], LAT, compress=compress)
    np.testing.assert_array_equal(_bits(wf.sloppy_gauge(f32).ug_odd), _bits(ft.ug_odd))
    if compress:
        fc = wf.make_fast_clover(fields["ut"], fields["tp"], LAT, sloppy=True)
        np.testing.assert_array_equal(_bits(fc.fg.ug_even), _bits(ft.ug_even))
        assert fc.moo_p.dtype == torch.float32


def _flip(fc):
    """The reference's FastClover with the blocks of the two signs swapped:
    its sign-(+) operator is then Qsw(-)."""
    return dataclasses.replace(fc, moo_p=fc.moo_m, moo_m=fc.moo_p, mee_inv_p=fc.mee_inv_m,
                               mee_inv_m=fc.mee_inv_p)


@pytest.fixture(scope="module")
def reference_sloppy(fields):
    """The reference's fast Qsw(+) on its sloppy copy, hop by hop (its two
    interpret-mode kernels: clov_inv at p = 0, clov_mhat + g5 at p = 1), as
    ONE compiled function of the operator state, evaluated for Qsw+ and Qsw-
    at c_sw = 1.2 and for Qhat+ and Qhat- through the same kernels with the
    c_sw = 0 blocks, M_ee = 1 + i mu g5 (two kernel builds in all)."""
    jp = fields["jp"]
    k2 = float(jp.kappa ** 2)

    def q_plus(fc, x):
        tmp = jdp.hopping_pallas_split(fc.fg.ug_even, x, EVEN, JL, interpret=True,
                                       epi=("clov_inv",), blocks=fc.mee_inv_p, gcomp=fc.fg.gcomp)
        return tmp, jdp.hopping_pallas_split(fc.fg.ug_odd, tmp, ODD, JL, interpret=True,
                                             epi=("clov_mhat", k2, True), blocks=fc.moo_p,
                                             psi_o=x, gcomp=fc.fg.gcomp)

    q_plus = jax.jit(q_plus)
    x = np.asarray(fields["psi2"])
    fsw = jwf.make_fast_clover(fields["u"], jp, JL, sloppy=True)
    ftm = jwf.make_fast_clover(fields["u"], dataclasses.replace(jp, c_sw=0.0), JL, sloppy=True)
    return {(op, sign): [np.asarray(a) for a in q_plus(fc if sign > 0 else _flip(fc), x)]
            for op, fc in (("qsw", fsw), ("qhat", ftm)) for sign in (1.0, -1.0)}


def test_sloppy_hops_match_reference_kernels(fields, reference_sloppy):
    """The port's plain bf16 hop, clover epilogues, each fed the reference's
    input, against the reference's interpret-mode kernels on the same bits."""
    k2 = float(fields["jp"].kappa ** 2)
    fct = wf.make_fast_clover(fields["ut"], fields["tp"], LAT, sloppy=True)
    psi2 = fields["psi2"]
    dc.reset_counters()
    for sign in (1.0, -1.0):
        tmp, out = reference_sloppy[("qsw", sign)]
        blk_e, blk_o = (fct.mee_inv_p, fct.moo_p) if sign > 0 else (fct.mee_inv_m, fct.moo_m)
        t1 = dc.hopping_split(fct.fg.ug_even, psi2, EVEN, LAT, epi=("clov_inv",), blocks=blk_e,
                              gcomp=fct.fg.gcomp)
        t2 = dc.hopping_split(fct.fg.ug_odd, torch.tensor(tmp), ODD, LAT,
                              epi=("clov_mhat", k2, True), psi_o=psi2, blocks=blk_o,
                              gcomp=fct.fg.gcomp)
        assert _maxdiff(t1, tmp) < ATOL and _maxdiff(t2, out) < ATOL
        assert float(np.abs(out).max()) > 1.0
    # the plain version served these CPU tensors; no kernel launch was counted
    assert dc.hopping_split_plain.calls == 4
    assert (dc.hopping_split.launches, dc.hopping_split.bf16_launches) == (0, 0)


@pytest.mark.parametrize("sign", [1.0, -1.0], ids=["plus", "minus"])
def test_sloppy_qhat_and_qsw_match_reference_fast_operators(fields, reference_sloppy, sign):
    """Qsw(+-) and Qhat(+-) of the port on its sloppy copies against the
    reference's fast operator on its sloppy copy; the port's Qhat runs its
    own twisted-mass epilogues (mee_inv, mhat), the reference the clover
    ones on the c_sw = 0 blocks: the same operator."""
    tp, psi2 = fields["tp"], fields["psi2"]
    fct = wf.make_fast_clover(fields["ut"], tp, LAT, sloppy=True)
    fg = wf.make_fast_gauge(fields["ut"], tp, LAT, sloppy=True)
    assert _maxdiff(wf.q_hat_clover_fast(fct, psi2, tp, LAT, sign),
                    reference_sloppy[("qsw", sign)][1]) < ATOL
    ref = reference_sloppy[("qhat", sign)][1]
    assert _maxdiff(wf.q_hat_fast(fg, psi2, tp, LAT, sign), ref) < ATOL
    # the bf16 copy is another operator than the f32 one, by bf16 rounding
    gap = _maxdiff(wf.q_hat_fast(wf.make_fast_gauge(fields["ut"], tp, LAT), psi2, tp, LAT, sign),
                   ref)
    assert 1e-4 < gap < 0.1
    # the sloppy clover copy shares the f32 copy's blocks
    f32 = wf.make_fast_clover(fields["ut"], tp, LAT)
    assert torch.equal(wf.sloppy_clover(f32).moo_m, fct.moo_m)
    np.testing.assert_array_equal(_bits(wf.sloppy_clover(f32).fg.ug_odd), _bits(fct.fg.ug_odd))


def test_bf16_gauge_wrapper_contract(fields):
    """K1 and K1-R take a bf16 gauge (K1-B, K1-RB); the spinors must be f32
    and the gauge f32 or bf16, and the wrappers say so."""
    ft = wf.make_fast_gauge(fields["ut"], fields["tp"], LAT, sloppy=True)
    psi2 = fields["psi2"]
    batch = torch.stack([psi2, 2 * psi2], dim=3).contiguous()
    out = dc.hopping_split_rhs(ft.ug_even, batch, EVEN, LAT, gcomp=ft.gcomp)
    for r in range(2):
        assert torch.equal(out[:, :, :, r], dc.hopping_split(
            ft.ug_even, batch[:, :, :, r].contiguous(), EVEN, LAT, gcomp=ft.gcomp))
    with pytest.raises(TypeError, match="float32"):
        dc.hopping_split_rhs(ft.ug_even, batch.to(torch.bfloat16), EVEN, LAT, gcomp=ft.gcomp)
    with pytest.raises(TypeError, match="float32"):
        dc.hopping_split(ft.ug_even, psi2.to(torch.bfloat16), EVEN, LAT, gcomp=ft.gcomp)
    with pytest.raises(TypeError):
        dc.hopping_split(ft.ug_even.to(torch.float16), psi2, EVEN, LAT, gcomp=ft.gcomp)
    # the plain bf16 hop is the f32 hop on the upcast links (made contiguous:
    # the upcast keeps the bf16 copy's re/im-innermost layout)
    up = wf.FastGauge(ft.ug_even.float().contiguous(), ft.ug_odd.float().contiguous(), ft.gcomp)
    assert torch.equal(dc.hopping_split(ft.ug_odd, psi2, ODD, LAT, gcomp=ft.gcomp),
                       dc.hopping_split(up.ug_odd, psi2, ODD, LAT, gcomp=up.gcomp))
