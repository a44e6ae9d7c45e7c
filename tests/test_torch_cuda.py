"""CUDA kernels of the PyTorch port against their plain versions, on the card.

Every test here is marked `gpu` and skips without a CUDA device (the
decision is made inside a fixture, never at import).  Run them on a machine
with a GPU; `--noconftest` keeps tests/conftest.py (which imports JAX) out,
as the port needs no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_cuda.py

Tolerance: kernel and plain version compute in f32 on the same card tensors
and differ by summation order and FMA contraction, ~1e-7 of the output
scale; RTOL = 1e-5 of max|plain| (an indexing or sign error is O(1)).
"""

import dataclasses
import numpy as np
import pytest
import torch

from tmlqcd_tpu_torch import bridge, rng, su3
from tmlqcd_tpu_torch.hmc import Draws, hmc_trajectory
from tmlqcd_tpu_torch.lattice import Lattice
from tmlqcd_tpu_torch.models.suites import nf2_twisted_mass_hasenbusch
from tmlqcd_tpu_torch.ops import dslash_cuda as dc
from tmlqcd_tpu_torch.ops import split_diag as sd
from tmlqcd_tpu_torch.ops import wilson_fast as wf
from tmlqcd_tpu_torch.ops.wilson import DiracParams

torch.set_num_threads(1)

pytestmark = pytest.mark.gpu

RTOL = 1e-5
PARAMS = DiracParams(kappa=0.15, mu=0.03)
EPIS = [("none",), ("mee_inv", PARAMS.mutld, 1.0), ("mee_inv", PARAMS.mutld, -1.0),
        ("mhat", PARAMS.mutld, 1.0, PARAMS.kappa ** 2, True),
        ("mhat", PARAMS.mutld, -1.0, PARAMS.kappa ** 2, True),
        ("mhat", PARAMS.mutld, 1.0, PARAMS.kappa ** 2, False),
        ("clov_inv",), ("clov_mhat", PARAMS.kappa ** 2, True),
        ("clov_mhat", PARAMS.kappa ** 2, False)]
CLOVER = DiracParams(kappa=0.13, mu=0.04, c_sw=1.74)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _close(out, ref):
    scale = max(1.0, float(ref.abs().max()))
    return float((out - ref).abs().max()) <= RTOL * scale


def _extras(epi, psi_o, blocks):
    """The extra fields an epilogue reads."""
    return dict(psi_o=psi_o if epi[0] in ("mhat", "clov_mhat") else None,
                blocks=blocks if epi[0].startswith("clov") else None)


def _blocks(lat, dev, seed=5):
    """Generic clover blocks [2, 72, T, X, M]: the kernels read all 72
    complex entries whatever they hold."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((2, 72) + lat.eo_site_shape, generator=gen, device=dev)


def _setup(dims, dev):
    lat = Lattice(dims)
    g = np.random.default_rng(sum(dims))
    u = bridge.gauge_from_numpy(bridge.numpy_su3(g, (4,) + lat.site_shape), lat, dev)
    psi = [wf.to_split(bridge.spinor_from_numpy(
        bridge.numpy_spinor(g, (4, 3) + lat.eo_site_shape), lat, dev)) for _ in range(3)]
    return lat, u, psi


@pytest.mark.parametrize("dims", [(8, 4, 4, 4), (8, 8, 8, 8), (6, 4, 6, 10)])
@pytest.mark.parametrize("compress", [False, True], ids=["18real", "12real"])
def test_hopping_kernel_matches_plain(cuda, dims, compress):
    lat, u, (psi, psi_o, _) = _setup(dims, cuda)
    fg = wf.make_fast_gauge(u, PARAMS, lat, compress=compress)
    blocks = _blocks(lat, cuda)
    for p, ug in ((0, fg.ug_even), (1, fg.ug_odd)):
        for epi in EPIS:
            kw = dict(epi=epi, gcomp=fg.gcomp, **_extras(epi, psi_o, blocks))
            n, nc = dc.hopping_split.launches, dc.hopping_split.clover_launches
            out = dc.hopping_split(ug, psi, p, lat, **kw)
            assert dc.hopping_split.launches == n + 1
            assert dc.hopping_split.clover_launches == nc + epi[0].startswith("clov")
            assert _close(out, dc.hopping_split_plain(ug, psi, p, lat, **kw)), (p, epi)


@pytest.mark.parametrize("dims, nrhs", [((8, 4, 4, 4), 3), ((6, 4, 6, 10), 12), ((8, 8, 8, 8), 13),
                                        ((8, 32, 16, 16), 12)])
@pytest.mark.parametrize("compress", [False, True], ids=["18real", "12real"])
def test_hopping_rhs_kernel_matches_plain_and_single_rhs_kernel(cuda, dims, nrhs, compress):
    """K1-R against its plain version (RTOL) and, column by column, against
    K1 (the same device arithmetic: equal to the last bit).  13 columns need
    two blocks along the R axis; 8 x 32 x 16 x 16 with 12 columns is large
    enough for the kernel's t-blocked block order."""
    lat, u, _ = _setup(dims, cuda)
    gen = torch.Generator(device=cuda).manual_seed(nrhs)
    shape = (2, 4, 3, nrhs) + lat.eo_site_shape
    psi = torch.randn(shape, generator=gen, device=cuda)
    psi_o = torch.randn(shape, generator=gen, device=cuda)
    fg = wf.make_fast_gauge(u, PARAMS, lat, compress=compress)
    blocks = _blocks(lat, cuda)
    for p, ug in ((0, fg.ug_even), (1, fg.ug_odd)):
        for epi in EPIS:
            kw = dict(epi=epi, gcomp=fg.gcomp)
            n, n1 = dc.hopping_split_rhs.launches, dc.hopping_split.launches
            out = dc.hopping_split_rhs(ug, psi, p, lat, r_axis=3, **kw,
                                       **_extras(epi, psi_o, blocks))
            assert (dc.hopping_split_rhs.launches, dc.hopping_split.launches) == (n + 1, n1)
            ref = dc.hopping_split_rhs_plain(ug, psi, p, lat, **kw, **_extras(epi, psi_o, blocks))
            assert _close(out, ref), (p, epi)
            for r in (0, nrhs - 1):
                one = dc.hopping_split(ug, psi[:, :, :, r].contiguous(), p, lat, **kw,
                                       **_extras(epi, psi_o[:, :, :, r].contiguous(), blocks))
                assert torch.equal(out[:, :, :, r], one), (p, epi, r)


def test_batched_inversion_runs_on_the_rhs_kernel(cuda):
    """invert_eo_rhs on CUDA tensors launches K1-R, calls no plain version and
    agrees with the plain path on the CPU to 2e-5 (f32 CG, tol 1e-7)."""
    from tmlqcd_tpu_torch.inverter import invert_eo_rhs
    from tmlqcd_tpu_torch.meas.sources import point_source

    lat, u, _ = _setup((8, 4, 4, 4), cuda)
    bs = torch.stack([point_source(lat, s, c, device=cuda) for s, c in ((0, 0), (1, 2), (3, 1))])
    dc.reset_counters()
    out = invert_eo_rhs(u, bs, PARAMS, lat, tol=1e-7, maxiter=500)
    # Schur prologue 1, right-hand side 2, r0 = b - A x0 4, 4 per iteration, epilogue 1
    assert dc.hopping_split_rhs.launches == 4 * out.iterations + 8
    assert dc.hopping_split_rhs_plain.calls == 0 and dc.hopping_split_plain.calls == 0
    ref = invert_eo_rhs(u.cpu(), bs.cpu(), PARAMS, lat, tol=1e-7, maxiter=500)
    assert out.iterations == ref.iterations
    assert float((out.x.cpu() - ref.x).abs().max()) < 2e-5


def test_clover_inversions_run_on_the_kernels(cuda):
    """The clover `invert_eo_rhs` and `invert_clover_eo` on CUDA tensors
    launch K1-R and K1 with the clover epilogues, call no plain version and
    agree with the plain path on the CPU to 2e-5 (f32 CG, tol 1e-7)."""
    from tmlqcd_tpu_torch.inverter import invert_clover_eo, invert_eo_rhs
    from tmlqcd_tpu_torch.meas.sources import point_source

    lat, u, _ = _setup((8, 4, 4, 4), cuda)
    bs = torch.stack([point_source(lat, s, c, device=cuda) for s, c in ((0, 0), (1, 2), (3, 1))])
    dc.reset_counters()
    out = invert_eo_rhs(u, bs, CLOVER, lat, tol=1e-7, maxiter=500)
    # Schur prologue 1 (no epilogue), right-hand side 2, r0 = b - A x0 4, 4 per
    # iteration, epilogue 1: all but the first with a clover epilogue
    assert dc.hopping_split_rhs.launches == 4 * out.iterations + 8
    assert dc.hopping_split_rhs.clover_launches == 4 * out.iterations + 7
    one = invert_clover_eo(u, bs[1], CLOVER, lat, tol=1e-7, maxiter=500)
    # the Schur operators run on K1-S: its clover hops count as K1 launches did
    assert dc.hopping_split.clover_launches + dc.hopping_schur.clover_hops == (
        4 * one.iterations + 7)
    assert dc.hopping_split_rhs_plain.calls == 0 and dc.hopping_split_plain.calls == 0
    assert dc.hopping_schur_plain.calls == 0
    assert float((out.x[1] - one.x).abs().max()) < 2e-5
    ref = invert_eo_rhs(u.cpu(), bs.cpu(), CLOVER, lat, tol=1e-7, maxiter=500)
    assert out.iterations == ref.iterations
    assert float((out.x.cpu() - ref.x).abs().max()) < 2e-5


def test_q_hat_clover_diff_matches_plain(cuda):
    """Forward and every gradient of the clover force operator (hops on
    HoppingDiff) against autograd of the same operator on the plain hop."""
    lat, u, (psi, _, g) = _setup((8, 4, 4, 4), cuda)
    fg = wf.make_fast_gauge(u, PARAMS, lat, compress=False)
    blk2 = [dc.blk_unflatten(_blocks(lat, cuda, s)) for s in (6, 7)]
    k2 = PARAMS.kappa ** 2

    def plain_q(ug_e, ug_o, moo, mee_inv, x):
        tmp = dc.hopping_split_plain(ug_e, x, 0, lat)
        tmp = dc.hopping_split_plain(ug_o, sd.blocks_apply_split(mee_inv, tmp), 1, lat)
        return wf.gamma5_split(sd.blocks_apply_split(moo, x) - k2 * tmp)

    grads = []
    for fn in (lambda *a: wf.q_hat_clover_diff(*a, PARAMS, lat), plain_q):
        ins = [t.clone().requires_grad_(True) for t in (fg.ug_even, fg.ug_odd, *blk2, psi)]
        out = fn(*ins)
        grads.append((out.detach(),) + torch.autograd.grad(out, ins, g))
    for x, y in zip(*grads):
        assert _close(x, y)


@pytest.mark.parametrize("dims", [(8, 4, 4, 4), (6, 4, 6, 10)])
def test_ug_vjp_kernel_and_hopping_diff_match_plain(cuda, dims):
    lat, u, (psi, _, g) = _setup(dims, cuda)
    fg = wf.make_fast_gauge(u, PARAMS, lat, compress=False)
    for p, ug_p, ug_q in ((0, fg.ug_even, fg.ug_odd), (1, fg.ug_odd, fg.ug_even)):
        assert _close(dc.hopping_ug_vjp(g, psi, p, lat), dc.hopping_ug_vjp_plain(g, psi, p, lat))
        a, b = ug_p.clone().requires_grad_(True), psi.clone().requires_grad_(True)
        da, db = torch.autograd.grad(dc.HoppingDiff.apply(a, ug_q, b, p, lat), (a, b), g)
        a2, b2 = ug_p.clone().requires_grad_(True), psi.clone().requires_grad_(True)
        ra, rb = torch.autograd.grad(dc.hopping_split_plain(a2, b2, p, lat), (a2, b2), g)
        assert _close(da, ra) and _close(db, rb)


def test_kernel_wrapper_raises_instead_of_falling_back(cuda):
    lat, u, (psi, _, _) = _setup((8, 4, 4, 4), cuda)
    fg = wf.make_fast_gauge(u, PARAMS, lat, compress=False)
    with pytest.raises(ValueError):
        dc.hopping_split(fg.ug_even, psi.cpu(), 0, lat)  # mixed devices
    with pytest.raises(TypeError):
        dc.hopping_split(fg.ug_even, psi.half(), 0, lat)
    with pytest.raises(ValueError):
        dc.hopping_ug_vjp(psi, psi[..., :4].contiguous(), 0, lat)
    batch = torch.stack([psi, psi], dim=3)
    with pytest.raises(ValueError, match="contiguous"):
        dc.hopping_split_rhs(fg.ug_even, torch.stack([batch, batch], dim=-1)[..., 0], 0, lat)
    with pytest.raises(ValueError):
        dc.hopping_split_rhs(fg.ug_even, batch.cpu(), 0, lat)  # mixed devices
    with pytest.raises(ValueError, match="2 flavours"):
        dc.hopping_split_rhs(fg.ug_even, batch, 0, lat, r_axis=1)  # a batch is no doublet
    with pytest.raises(ValueError, match="needs blocks"):
        dc.hopping_split(fg.ug_even, psi, 0, lat, epi=("clov_inv",))
    with pytest.raises(ValueError):
        dc.hopping_split(fg.ug_even, psi, 0, lat, epi=("clov_inv",),
                         blocks=_blocks(lat, "cpu"))  # mixed devices


def test_trajectory_kernel_path_matches_plain_path(cuda):
    """One 4^4 Hasenbusch trajectory on CUDA tensors (kernels) and on CPU
    tensors (plain versions) with the same draws.  |ddH| <= 1e-3: the CPU
    comparison of the plain path with the reference at this size differs by
    4.1e-5 (f32 rounding of |H| ~ 1.5e4)."""
    lat = Lattice((4, 4, 4, 4))
    cfg = nf2_twisted_mass_hasenbusch(lat, beta=5.3, kappa=0.13, mu=0.01, mu_hasenbusch=0.1,
                                      steps=(1, 1, 2), acc_tol=1e-10, force_tol=1e-10)
    key = rng.Key(7)
    u = su3.random_su3(rng.generator(key.fold(0), "cpu"), (4,) + lat.site_shape)
    mom = rng.random_momenta(key.fold(1), u.shape[2:], "cpu")
    etas = [None] + [rng.normal_spinor(key.fold(2, i), (4, 3) + lat.eo_site_shape, "cpu")
                     for i in (1, 2)]
    out = {}
    for dev in (cuda, torch.device("cpu")):
        d = Draws(mom.to(dev), [e if e is None else e.to(dev) for e in etas], 0.5)
        _, out[dev.type] = hmc_trajectory(cfg, u.to(dev), key, draws=d)
    assert abs(out["cuda"].delta_h - out["cpu"].delta_h) <= 1e-3
    assert abs(out["cuda"].plaquette - out["cpu"].plaquette) <= 1e-6
    assert out["cuda"].acc_iterations == out["cpu"].acc_iterations


_CLOVER_INPUT = """L = 4
T = 4
beta = 5.3
NumberOfTimescales = 3
BeginMonomial GAUGE
  Timescale = 0
  IntegrationSteps = 1
EndMonomial
BeginMonomial CLOVERTRLOG
  Timescale = 0
  kappa = 0.13
  2KappaMu = 0.0026
  CSW = 1.74
EndMonomial
BeginMonomial CLOVERDET
  Timescale = 1
  kappa = 0.13
  2KappaMu = 0.026
  CSW = 1.74
  AcceptancePrecision = 1e-20
  ForcePrecision = 1e-20
  IntegrationSteps = 1
EndMonomial
BeginMonomial CLOVERDETRATIO
  Timescale = 2
  kappa = 0.13
  2KappaMu = 0.0026
  2KappaMu2 = 0.026
  CSW = 1.74
  AcceptancePrecision = 1e-20
  ForcePrecision = 1e-20
  IntegrationSteps = 2
EndMonomial
"""


def test_clover_trajectory_kernel_path_matches_plain_path(cuda):
    """One 4^4 twisted-clover Hasenbusch trajectory on CUDA tensors (kernels
    with the clover epilogues) and on CPU tensors (plain versions) with the
    same draws; bounds as for the twisted-mass trajectory above."""
    from tmlqcd_tpu_torch import config, config_tmlqcd

    cfg = config.build_hmc(config_tmlqcd.parse_input(_CLOVER_INPUT))
    lat = cfg.lat
    key = rng.Key(8)
    u = su3.random_su3(rng.generator(key.fold(0), "cpu"), (4,) + lat.site_shape)
    mom = rng.random_momenta(key.fold(1), u.shape[2:], "cpu")
    etas = [None, None] + [rng.normal_spinor(key.fold(2, i), (4, 3) + lat.eo_site_shape, "cpu")
                           for i in (2, 3)]
    out = {}
    dc.reset_counters()
    for dev in (cuda, torch.device("cpu")):
        d = Draws(mom.to(dev), [e if e is None else e.to(dev) for e in etas], 0.5)
        _, out[dev.type] = hmc_trajectory(cfg, u.to(dev), key, draws=d)
        if dev.type == "cuda":
            assert dc.hopping_split.clover_launches + dc.hopping_schur.clover_hops > 0
            assert dc.hopping_schur.launches > 0 and dc.hopping_ug_vjp.launches > 0
            assert dc.hopping_split_plain.calls == 0 and dc.hopping_ug_vjp_plain.calls == 0
            assert dc.hopping_schur_plain.calls == 0
    assert abs(out["cuda"].delta_h - out["cpu"].delta_h) <= 1e-3
    assert abs(out["cuda"].plaquette - out["cpu"].plaquette) <= 1e-6
    assert out["cuda"].acc_iterations == out["cpu"].acc_iterations


# ---------------------------------------------------------------------------
# the flavour doublet: K1-R on r_axis = 1, the doublet inversion, NDRAT
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dims", [(8, 4, 4, 4), (8, 8, 8, 8), (6, 4, 6, 10)])
@pytest.mark.parametrize("compress", [False, True], ids=["18real", "12real"])
def test_doublet_hopping_kernel_matches_plain_and_two_k1_launches(cuda, dims, compress):
    """K1-R on the flavour-doublet axis against its plain version and, bit
    for bit, against K1 on each flavour alone (the two flavours hold
    different fields, so a wrong flavour or component stride shows)."""
    lat, u, psi = _setup(dims, cuda)
    fg = wf.make_fast_gauge(u, PARAMS, lat, compress=compress)
    chi = torch.stack([psi[0], psi[1]], dim=1).contiguous()
    for p, ug in ((0, fg.ug_even), (1, fg.ug_odd)):
        dc.reset_counters()
        out = dc.hopping_split_rhs(ug, chi, p, lat, gcomp=fg.gcomp, r_axis=1)
        assert dc.hopping_split_rhs.launches == dc.hopping_split_rhs.doublet_launches == 1
        assert dc.hopping_split_rhs_plain.calls == 0
        assert _close(out, dc.hopping_split_rhs_plain(ug, chi, p, lat, gcomp=fg.gcomp, r_axis=1))
        for f in range(2):
            one = dc.hopping_split(ug, psi[f], p, lat, gcomp=fg.gcomp)
            assert torch.equal(out[:, f], one)
    with pytest.raises(ValueError, match="epilogue 'none' only"):
        dc.hopping_split_rhs(fg.ug_even, chi, 0, lat, epi=("mee_inv", 0.1, 1.0), gcomp=fg.gcomp,
                             r_axis=1)


@pytest.mark.parametrize("c_sw", [0.0, 1.74])
def test_doublet_inversion_runs_on_the_doublet_kernel(cuda, c_sw):
    """invert_doublet_eo on CUDA tensors launches K1-R on the doublet axis for
    every hop, calls no plain version and agrees with the plain path on the
    CPU to 2e-5 (f32 CG, tol 1e-7)."""
    from tmlqcd_tpu_torch.inverter import invert_doublet_eo
    from tmlqcd_tpu_torch.meas.sources import point_source
    from tmlqcd_tpu_torch.ops.ndoublet import NDParams

    lat, u, _ = _setup((8, 4, 4, 4), cuda)
    params = NDParams(kappa=0.13, mubar=0.15, epsbar=0.12, c_sw=c_sw)
    src = point_source(lat, 1, 2, device=cuda)
    b = torch.stack([src, torch.zeros_like(src)])
    dc.reset_counters()
    out = invert_doublet_eo(u, b, params, lat, tol=1e-7, maxiter=500)
    # K1-SD: the right-hand side's Q_nd, r0 = b - A x0, one Q_nd^2 per
    # iteration; K1-R-D: the Schur prologue's and epilogue's single hops
    assert dc.hopping_schur_nd.launches == out.iterations + 2
    assert dc.hopping_schur_nd.clover_launches == (out.iterations + 2) * (c_sw != 0.0)
    assert dc.hopping_split_rhs.doublet_launches == 2
    assert dc.hopping_split_rhs.launches == dc.hopping_split_rhs.doublet_launches
    assert dc.hopping_split_rhs_plain.calls == 0 and dc.hopping_split_plain.calls == 0
    assert dc.hopping_schur_nd_plain.calls == 0
    ref = invert_doublet_eo(u.cpu(), b.cpu(), params, lat, tol=1e-7, maxiter=500)
    assert out.iterations == ref.iterations
    assert float((out.x.cpu() - ref.x).abs().max()) < 2e-5


@pytest.mark.parametrize("dims", [(8, 4, 4, 4), (6, 4, 6, 10)])
@pytest.mark.parametrize("compress", [False, True], ids=["18real", "12real"])
def test_doublet_schur_kernel_matches_the_composed_operator(cuda, dims, compress):
    """K1-SD (Q_nd and Q_nd^2 in one launch) against the K1-R-D launches and
    torch flavour diagonals it replaces: bit for bit on the twisted-mass
    doublet; on the clover doublet within 1e-6 of max|composed| (torch sums
    a block row in another order); against its plain version RTOL."""
    from tmlqcd_tpu_torch.ops import clover as cl
    from tmlqcd_tpu_torch.ops.ndoublet import NDParams

    lat, u, psi = _setup(dims, cuda)
    tm = NDParams(kappa=0.13, mubar=0.15, epsbar=0.12)
    sw = NDParams(kappa=0.13, mubar=0.15, epsbar=0.12, c_sw=1.74)
    fg = wf.make_fast_gauge(u, tm.wilson, lat, compress=compress)
    sw_e, sw_o = cl.sw_blocks_eo(u, sw.kappa, sw.c_sw, lat)
    fc = wf.fast_clover_nd_from(fg, sw_e, sw_o, sw)
    chi = torch.stack([psi[0], psi[1]], dim=1).contiguous()

    def composed(op, x, params, clover):
        k2 = params.kappa * params.kappa
        g = op.fg if clover else op
        tmp = wf._hop_nd(g, x, 0, lat)
        tmp = (sd.mee_inv_nd_apply_split(op.minv_a, op.minv_b, op.minv_e, op.epsbar_t, tmp)
               if clover else sd.mee_inv_nd_split(tmp, params.mubar_t, params.epsbar_t, 1.0))
        tmp = wf._hop_nd(g, tmp, 1, lat)
        m = (sd.mee_nd_apply_split(op.moo_u, op.moo_d, op.epsbar_t, x) if clover
             else sd.mee_nd_split(x, params.mubar_t, params.epsbar_t, 1.0)) - k2 * tmp
        return sd.gamma5_nd(sd.tau1_split(m))

    for clover, op, params, q, q2 in ((False, fg, tm, wf.q_nd_fast, wf.q_nd_sq_fast),
                                      (True, fc, sw, wf.q_nd_clover_fast,
                                       wf.q_nd_sq_clover_fast)):
        stage = wf._nd_stage(params, fc if clover else None)
        one, two = q(op, chi, params, lat), q2(op, chi, params, lat)
        ref_one = composed(op, chi, params, clover)
        ref_two = composed(op, ref_one, params, clover)
        for out, ref, square in ((one, ref_one, False), (two, ref_two, True)):
            if clover:
                assert float((out - ref).abs().max()) <= 1e-6 * float(ref.abs().max())
            else:
                assert torch.equal(out, ref)
            assert _close(out, dc.hopping_schur_nd_plain(fg.ug_even, fg.ug_odd, chi, lat,
                                                         stage, fg.gcomp, square))


@pytest.mark.parametrize("shape", [(4, 2), (2, 1)])
def test_halo_kernel_matches_the_torch_exchange(cuda, shape):
    """KH against its plain version, the torch exchange it replaces
    (`_y_halos`, `_t_halos`), element for element: one spinor, R = 5 and
    the doublet, half-spinor halos on and off."""
    from tmlqcd_tpu_torch import parallel

    lat, _, (psi, _, _) = _setup((16, 8, 8, 8), cuda)
    gen = torch.Generator(device=cuda).manual_seed(4)
    inputs = {None: psi,
              3: torch.randn((2, 4, 3, 5) + lat.eo_site_shape, generator=gen, device=cuda),
              1: torch.randn((2, 2, 4, 3) + lat.eo_site_shape, generator=gen, device=cuda)}
    for hs in (True, False):
        mesh = parallel.Mesh(*shape, device=cuda, halfspinor=hs)
        for r_axis, x in inputs.items():
            n = dc.halo_pack.launches
            mh, th = dc.halo_pack(x, lat, mesh, r_axis)
            assert dc.halo_pack.launches == n + 1
            ref_mh = dc._y_halos(x, lat, mesh, hs, r_axis)
            assert (mh is None) == (ref_mh is None)
            assert mh is None or torch.equal(mh, ref_mh)
            assert torch.equal(th, dc._t_halos(x, lat, mesh, hs, r_axis))


_NDRAT_INPUT = """L = 4
T = 4
beta = 5.3
NumberOfTimescales = 2
BeginMonomial GAUGE
  Timescale = 0
  IntegrationSteps = 1
EndMonomial
BeginMonomial NDRAT
  Timescale = 1
  kappa = 0.13
  2Kappamubar = 0.1
  2Kappaepsbar = 0.12
  DegreeOfRational = 6
  StildeMin = 0.01
  StildeMax = 4.7
  AcceptancePrecision = 1e-20
  ForcePrecision = 1e-20
  IntegrationSteps = 2
EndMonomial
"""


def test_ndrat_trajectory_kernel_path_matches_plain_path(cuda):
    """One 4^4 GAUGE + NDRAT trajectory on CUDA tensors (multishift solves on
    K1-R's doublet axis, forces on K1 + K2) and on CPU tensors (plain
    versions) with the same draws; bounds as for the trajectories above."""
    from tmlqcd_tpu_torch import config, config_tmlqcd

    cfg = config.build_hmc(config_tmlqcd.parse_input(_NDRAT_INPUT))
    lat = cfg.lat
    key = rng.Key(9)
    u = su3.random_su3(rng.generator(key.fold(0), "cpu"), (4,) + lat.site_shape)
    mom = rng.random_momenta(key.fold(1), u.shape[2:], "cpu")
    etas = [None, rng.normal_spinor(key.fold(2, 1), (2, 4, 3) + lat.eo_site_shape, "cpu")]
    out = {}
    dc.reset_counters()
    for dev in (cuda, torch.device("cpu")):
        d = Draws(mom.to(dev), [e if e is None else e.to(dev) for e in etas], 0.5)
        _, out[dev.type] = hmc_trajectory(cfg, u.to(dev), key, draws=d)
        if dev.type == "cuda":
            assert dc.hopping_schur_nd.launches > 0 and dc.hopping_ug_vjp.launches > 0
            assert dc.hopping_split_rhs_plain.calls == 0 and dc.hopping_split_plain.calls == 0
            assert dc.hopping_ug_vjp_plain.calls == 0 and dc.hopping_schur_nd_plain.calls == 0
    assert abs(out["cuda"].delta_h - out["cpu"].delta_h) <= 1e-3
    assert abs(out["cuda"].plaquette - out["cpu"].plaquette) <= 1e-6
    assert out["cuda"].acc_iterations == out["cpu"].acc_iterations
    assert out["cuda"].force_iterations == out["cpu"].force_iterations


@pytest.mark.parametrize("dims", [(8, 4, 4, 4), (8, 8, 8, 8), (6, 4, 6, 10)])
@pytest.mark.parametrize("compress", [False, True], ids=["18real", "12real"])
def test_bf16_gauge_hopping_kernel_matches_plain(cuda, dims, compress):
    """K1 on the bf16 gauge copy (K1-B) against its plain version, which
    upcasts the same bits, in every epilogue; the copy is the bf16 cast of
    the f32 copy."""
    lat, u, (psi, psi_o, _) = _setup(dims, cuda)
    fg = wf.make_fast_gauge(u, PARAMS, lat, compress=compress, sloppy=True)
    f32 = wf.make_fast_gauge(u, PARAMS, lat, compress=compress)
    assert torch.equal(fg.ug_odd.view(torch.int16),
                       f32.ug_odd.to(torch.bfloat16).view(torch.int16))
    blocks = _blocks(lat, cuda)
    for p, ug in ((0, fg.ug_even), (1, fg.ug_odd)):
        for epi in EPIS:
            kw = dict(epi=epi, gcomp=fg.gcomp, **_extras(epi, psi_o, blocks))
            n = dc.hopping_split.bf16_launches
            out = dc.hopping_split(ug, psi, p, lat, **kw)
            assert dc.hopping_split.bf16_launches == n + 1
            assert _close(out, dc.hopping_split_plain(ug, psi, p, lat, **kw)), (p, epi)
    # K1-RB: K1-R on the bf16 copy, its plain version and column by column
    # K1-B (bit for bit with the epilogue none)
    batch = torch.stack([psi, psi_o], dim=3).contiguous()
    n = dc.hopping_split_rhs.bf16_launches
    out = dc.hopping_split_rhs(fg.ug_odd, batch, 1, lat, gcomp=fg.gcomp)
    assert dc.hopping_split_rhs.bf16_launches == n + 1
    assert _close(out, dc.hopping_split_rhs_plain(fg.ug_odd, batch, 1, lat, gcomp=fg.gcomp))
    for r in range(2):
        assert torch.equal(out[:, :, :, r], dc.hopping_split(
            fg.ug_odd, batch[:, :, :, r].contiguous(), 1, lat, gcomp=fg.gcomp))


def _schur_stages(params, kind, signs, g5, blocks):
    k2 = params.kappa ** 2
    if kind == "tm":
        return tuple((("mee_inv", params.mutld, s), ("mhat", params.mutld, s, k2, g5), None, None)
                     for s in signs)
    return tuple((("clov_inv",), ("clov_mhat", k2, g5), blocks[2 * j], blocks[2 * j + 1])
                 for j in range(len(signs)))


@pytest.mark.parametrize("dims", [(8, 4, 4, 4), (6, 4, 6, 10), (16, 8, 8, 8)])
@pytest.mark.parametrize("gauge", ["18real", "12real", "18real-bf16", "12real-bf16"])
def test_schur_kernel_matches_k1_launches(cuda, dims, gauge):
    """K1-S (the Schur operator in one cooperative launch) against the K1
    launches it replaces, bit for bit, and against its plain version: both
    epilogue pairs, Mhat(+), Mhat(-) and Qhat_pm, gamma5 on and off.  Every
    lattice here fits the resident grid in one pass; chip_smoke.py holds the
    grid-stride loop's wrap at 32^3 x 64."""
    lat, u, (psi, _, _) = _setup(dims, cuda)
    fg = wf.make_fast_gauge(u, PARAMS, lat, compress=gauge.startswith("12"),
                            sloppy=gauge.endswith("bf16"))
    blocks = [_blocks(lat, cuda, 20 + i) for i in range(4)]
    for kind in ("tm", "clover"):
        for g5 in (True, False):
            for signs in ((1.0,), (-1.0,), (1.0, -1.0)):
                stages = _schur_stages(PARAMS, kind, signs, g5, blocks)
                n, h = dc.hopping_schur.launches, dc.hopping_schur.hops
                out = dc.hopping_schur(fg.ug_even, fg.ug_odd, psi, lat, stages, fg.gcomp)
                assert (dc.hopping_schur.launches, dc.hopping_schur.hops) == (n + 1,
                                                                            h + 2 * len(signs))
                x = psi
                for epi_e, epi_o, blk_e, blk_o in stages:
                    tmp = dc.hopping_split(fg.ug_even, x, 0, lat, epi=epi_e, gcomp=fg.gcomp,
                                           blocks=blk_e)
                    x = dc.hopping_split(fg.ug_odd, tmp, 1, lat, epi=epi_o, psi_o=x,
                                         gcomp=fg.gcomp, blocks=blk_o)
                assert torch.equal(out, x), (kind, g5, signs)
                ref = dc.hopping_schur_plain(fg.ug_even, fg.ug_odd, psi, lat, stages, fg.gcomp)
                assert _close(out, ref), (kind, g5, signs)


@pytest.mark.parametrize("dims", [(8, 4, 4, 4), (6, 4, 6, 10), (16, 8, 8, 8)])
def test_bf16x2_link_loads_match_plain_and_k1rb(cuda, dims):
    """K1-B reading each link element's re and im as one bf16x2 load (the
    sloppy copy holds them side by side) against its plain version in every
    epilogue, with no spills, and each column of K1-RB (the same loads,
    staged in shared memory) against it bit for bit with the epilogue none."""
    lat, u, (psi, psi_o, chi) = _setup(dims, cuda)
    fg = wf.make_fast_gauge(u, PARAMS, lat, sloppy=True)
    blocks = _blocks(lat, cuda)
    info = dc.kernel_info(("none",), True, True)
    assert info["local_bytes"] == 0
    for p, ug in ((0, fg.ug_even), (1, fg.ug_odd)):
        for epi in EPIS:
            kw = dict(epi=epi, gcomp=fg.gcomp, **_extras(epi, psi_o, blocks))
            assert _close(dc.hopping_split(ug, psi, p, lat, **kw),
                          dc.hopping_split_plain(ug, psi, p, lat, **kw)), (p, epi)
        batch = torch.stack([psi, chi], dim=3).contiguous()
        out = dc.hopping_split_rhs(ug, batch, p, lat, gcomp=fg.gcomp)
        for r in range(2):
            assert torch.equal(out[:, :, :, r], dc.hopping_split(
                ug, batch[:, :, :, r].contiguous(), p, lat, gcomp=fg.gcomp))


@pytest.mark.parametrize("solver", ["fastmixed", "dflfgmres"])
def test_mixed_and_deflated_inversions_run_on_the_kernels(cuda, solver):
    """invert_eo with fastmixed (inner solves on K1-B) and with dflfgmres
    (setup on K1-R) at 8^4 on CUDA tensors: no plain version is called, the
    true residual |M x - b| / |b| <= 1e-5 (tol 1e-7 on f32 fields), and the
    solution agrees with the CPU plain path to 2e-5."""
    from tmlqcd_tpu_torch.inverter import invert_eo
    from tmlqcd_tpu_torch.meas.sources import point_source
    from tmlqcd_tpu_torch.ops.wilson import d_full

    lat, u, _ = _setup((8, 8, 8, 8), cuda)
    b = point_source(lat, 1, 2, device=cuda)
    dc.reset_counters()
    out = invert_eo(u, b, PARAMS, lat, tol=1e-7, maxiter=500, solver=solver)
    assert dc.hopping_split_plain.calls == 0 and dc.hopping_split_rhs_plain.calls == 0
    assert dc.hopping_schur_plain.calls == 0
    if solver == "fastmixed":
        assert dc.hopping_split.bf16_launches + dc.hopping_schur.bf16_hops > 0
    else:
        assert dc.hopping_split_rhs.launches > 0
    res = torch.linalg.vector_norm(d_full(u, out.x, PARAMS, lat) - b) / torch.linalg.vector_norm(b)
    assert float(res) < 1e-5
    ref = invert_eo(u.cpu(), b.cpu(), PARAMS, lat, tol=1e-7, maxiter=500,
                    solver="cg" if solver == "dflfgmres" else solver)
    assert float((out.x.cpu() - ref.x).abs().max()) < 2e-5


def test_mixedcg_trajectory_kernel_path_matches_plain_path(cuda):
    """One 8^4 Hasenbusch trajectory with Solver = mixedcg (the low operator
    on K1-B) on CUDA tensors and on CPU tensors with the same draws, at tol
    1e-7 (the f32 floor of the defect correction's true residual):
    |ddH| <= 3e-3, the bound of chip_smoke.py's parity trajectories."""
    import dataclasses

    lat = Lattice((8, 8, 8, 8))
    cfg = nf2_twisted_mass_hasenbusch(lat, beta=5.3, kappa=0.13, mu=0.01, mu_hasenbusch=0.1,
                                      steps=(1, 1, 2), acc_tol=1e-7, force_tol=1e-7)
    cfg = dataclasses.replace(cfg, monomials=tuple(
        dataclasses.replace(m, solver="mixedcg") if hasattr(m, "solver") else m
        for m in cfg.monomials))
    key = rng.Key(8)
    u = su3.random_su3(rng.generator(key.fold(0), "cpu"), (4,) + lat.site_shape)
    mom = rng.random_momenta(key.fold(1), u.shape[2:], "cpu")
    etas = [None] + [rng.normal_spinor(key.fold(2, i), (4, 3) + lat.eo_site_shape, "cpu")
                     for i in (1, 2)]
    out = {}
    dc.reset_counters()
    for dev in (cuda, torch.device("cpu")):
        d = Draws(mom.to(dev), [e if e is None else e.to(dev) for e in etas], 0.5)
        with torch.no_grad():
            _, out[dev.type] = hmc_trajectory(cfg, u.to(dev), key, draws=d)
        if dev.type == "cuda":
            assert dc.hopping_split.bf16_launches + dc.hopping_schur.bf16_hops > 0
            assert dc.hopping_split_plain.calls == 0 and dc.hopping_schur_plain.calls == 0
    assert abs(out["cuda"].delta_h - out["cpu"].delta_h) <= 3e-3
    assert abs(out["cuda"].plaquette - out["cpu"].plaquette) <= 1e-6


# ---------------------------------------------------------------------------
# the slab kernels (K3, K3-I, K4, K1-T) and the sharded hop
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(4, 2), (2, 2), (2, 1)])
@pytest.mark.parametrize("gauge", ["12real", "18real-bf16"])
def test_slab_kernels_match_plain_and_k1(cuda, shape, gauge):
    """Each slab kernel against its plain version on the same halos, and the
    assembled sharded hop against K1 / K1-R / K1-R-D on the whole lattice at
    16 x 8^3 (T_loc = 4 or 8: KH and K3-I+K4; without overlap K3, or K1-T on
    t slabs alone), one spinor, R = 5 and the doublet, every (halfspinor,
    overlap) pair.  The slab kernels run K1's
    per-site sum on the same neighbour values: 1e-6 of max|K1| (bit equality
    expected)."""
    from tmlqcd_tpu_torch import parallel

    lat, u, (psi, _, _) = _setup((16, 8, 8, 8), cuda)
    fg = wf.make_fast_gauge(u, PARAMS, lat, compress=gauge == "12real",
                            sloppy=gauge.endswith("bf16"))
    gen = torch.Generator(device=cuda).manual_seed(3)
    inputs = {None: psi,
              3: torch.randn((2, 4, 3, 5) + lat.eo_site_shape, generator=gen, device=cuda),
              1: torch.randn((2, 2, 4, 3) + lat.eo_site_shape, generator=gen, device=cuda)}
    mesh = parallel.Mesh(*shape, device=cuda)
    for r_axis, x in inputs.items():
        mh = dc._y_halos(x, lat, mesh, True, r_axis)
        th = dc._t_halos(x, lat, mesh, True, r_axis)
        for variant, src, extra in (("ext", dc._t_halos(x, lat, mesh, True, r_axis, ext=True), {}),
                                    ("int", x, {}), ("bnd", x, {"th": th}),
                                    ("all", x, {"th": th})):
            outs = [fn(fg.ug_even, src, 0, lat, mesh, variant, torch.zeros_like(x), mh=mh,
                       gcomp=fg.gcomp, r_axis=r_axis, **extra)
                    for fn in (dc.hopping_slab_split, dc.hopping_slab_split_plain)]
            assert _close(*outs), (variant, r_axis)
        for hs in (True, False):
            for ov in (True, False):
                for p, ug in ((0, fg.ug_even), (1, fg.ug_odd)):
                    n = dict(dc.hopping_slab_split.launches)
                    out = dc.hopping_shard(ug, x, p, lat, dataclasses.replace(
                        mesh, halfspinor=hs, overlap=ov), fg.gcomp, r_axis)
                    if r_axis is None:
                        whole = dc.hopping_split(ug, x, p, lat, gcomp=fg.gcomp)
                    else:
                        whole = dc.hopping_split_rhs(ug, x, p, lat, gcomp=fg.gcomp,
                                                     r_axis=r_axis)
                    err = float((out - whole).abs().max())
                    assert err <= 1e-6 * float(whole.abs().max()), (hs, ov, r_axis, p, err)
                    ran = {k: v - n[k] for k, v in dc.hopping_slab_split.launches.items()}
                    # with overlap KH and K3-I+K4; without it K3, or K1-T on t
                    # slabs alone
                    assert ran == ({"K3": 0, "K3-I": 0, "K4": 0, "K1-T": 0, "K3-I+K4": 1} if ov
                                   else {"K3": int(shape[1] > 1), "K3-I": 0, "K4": 0,
                                         "K1-T": int(shape[1] == 1), "K3-I+K4": 0})


def test_tshard_kernel_matches_plain_and_k1(cuda):
    """K1-T (t slabs with concatenated halos, the y hops wrapping inside the
    slab) against its plain version and K1."""
    from tmlqcd_tpu_torch import parallel

    lat, u, (psi, _, _) = _setup((16, 8, 8, 8), cuda)
    fg = wf.make_fast_gauge(u, PARAMS, lat)
    for t_shards in (2, 4, 8):
        mesh = parallel.Mesh(t_shards, 1, device=cuda)
        n = dc.hopping_slab_split.launches["K1-T"]
        out = dc.hopping_tshard(fg.ug_odd, psi, 1, lat, mesh, fg.gcomp)
        assert dc.hopping_slab_split.launches["K1-T"] == n + 1
        ref = dc.hopping_slab_split_plain(fg.ug_odd, dc._t_halos(psi, lat, mesh, ext=True), 1,
                                          lat, mesh, "ext", torch.zeros_like(psi), gcomp=fg.gcomp)
        assert _close(out, ref)
        whole = dc.hopping_split(fg.ug_odd, psi, 1, lat, gcomp=fg.gcomp)
        assert float((out - whole).abs().max()) <= 1e-6 * float(whole.abs().max())


def test_sharded_trajectory_kernel_path_matches_plain_path(cuda):
    """One 8^4 twisted-mass Hasenbusch trajectory with every solve on the
    slab kernels of a (2, 2) mesh (T_loc = 4: KH and K3-I+K4), on CUDA tensors
    and on CPU tensors (the plain versions) with the same draws; |ddH| <=
    3e-3 as for the unsharded 8^4 trajectory of chip_smoke.py (f32 rounding
    of |H| ~ 2.4e5 in two summation orders); the same iteration counts."""
    import dataclasses

    from tmlqcd_tpu_torch import parallel

    lat = Lattice((8, 8, 8, 8))
    cfg = nf2_twisted_mass_hasenbusch(lat, beta=5.3, kappa=0.13, mu=0.01, mu_hasenbusch=0.1,
                                      steps=(1, 1, 2), acc_tol=1e-10, force_tol=1e-10)
    mesh = parallel.Mesh(2, 2, device=cuda)
    cfg = dataclasses.replace(cfg, mesh=mesh, monomials=tuple(
        dataclasses.replace(m, mesh=mesh) if hasattr(m, "mesh") else m for m in cfg.monomials))
    key = rng.Key(17)
    u = su3.random_su3(rng.generator(key.fold(0), "cpu"), (4,) + lat.site_shape)
    mom = rng.random_momenta(key.fold(1), u.shape[2:], "cpu")
    etas = [None] + [rng.normal_spinor(key.fold(2, i), (4, 3) + lat.eo_site_shape, "cpu")
                     for i in (1, 2)]
    out = {}
    for dev in (cuda, torch.device("cpu")):
        dc.reset_counters()
        d = Draws(mom.to(dev), [e if e is None else e.to(dev) for e in etas], 0.5)
        _, out[dev.type] = hmc_trajectory(cfg, u.to(dev), key, draws=d)
        if dev.type == "cuda":
            assert dc.hopping_slab_split.launches["K3-I+K4"] > 0
            assert dc.halo_pack.launches == dc.hopping_slab_split.launches["K3-I+K4"]
            assert dc.hopping_slab_split_plain.calls == 0 and dc.halo_pack.plain_calls == 0
    assert abs(out["cuda"].delta_h - out["cpu"].delta_h) <= 3e-3
    assert out["cuda"].acc_iterations == out["cpu"].acc_iterations


@pytest.mark.parametrize("mesh_shape,overlap", [((2, 2), True), ((2, 1), False)],
                         ids=["2x2", "2x1-K1T"])
def test_batched_inversion_runs_the_multirhs_slabs(cuda, mesh_shape, overlap):
    """invert_eo_rhs under a mesh at 8^4 on CUDA tensors: the batched CG on
    the multi-RHS slab kernels (KH and K3-I+K4, or K1-T on t slabs without the
    overlap); no plain version is called; the true residual |M x - b| / |b|
    <= 1e-5 (tol 1e-7) and the solution within 2e-5 of the CPU plain path's."""
    from tmlqcd_tpu_torch import parallel
    from tmlqcd_tpu_torch.inverter import invert_eo_rhs
    from tmlqcd_tpu_torch.ops.wilson import d_full

    lat, u, _ = _setup((8, 8, 8, 8), cuda)
    g = np.random.default_rng(12)
    bs = bridge.sources_from_numpy(bridge.numpy_spinor(g, (4, 4, 3) + lat.site_shape), lat)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        mesh = parallel.Mesh(*mesh_shape, device=dev, overlap=overlap)
        dc.reset_counters()
        out[dev.type] = invert_eo_rhs(u.to(dev), bs.to(dev), PARAMS, lat, tol=1e-7, maxiter=500,
                                      mesh=mesh)
        if dev.type == "cuda":
            assert dc.hopping_split_plain.calls == dc.hopping_split_rhs_plain.calls == 0
            assert dc.hopping_slab_split_plain.calls == 0
            assert dc.hopping_slab_split.rhs_launches > 0
    x = out["cuda"].x
    for r in range(4):
        res = torch.linalg.vector_norm(d_full(u, x[r], PARAMS, lat) - bs[r].to(cuda))
        assert float(res / torch.linalg.vector_norm(bs[r])) <= 1e-5
    assert float((x.cpu() - out["cpu"].x).abs().max()) <= 2e-5


def test_overlap_qw_on_k1_matches_plain(cuda):
    """The overlap's Q_W on K1 (two launches, the mhat epilogue on both
    parities) against gamma5 d_full, and sign_q / D_ov on K1 against the
    plain route on the card (degree 16, 2 modes, 4^4)."""
    from tmlqcd_tpu_torch.ops import overlap as ov

    lat = Lattice((4, 4, 4, 4))
    gen = np.random.default_rng(7)
    u = bridge.gauge_from_numpy(bridge.numpy_smooth_su3(gen, (4,) + lat.site_shape), lat, cuda)
    psi = torch.as_tensor(bridge.numpy_spinor(gen, (4, 3) + lat.site_shape), device=cuda)
    params = ov.OverlapParams(rho=1.4, m=0.1, degree=16, n_ev=2)
    fg = wf.make_fast_gauge(u, params.kernel, lat)
    n0 = dc.hopping_split.launches
    y = ov.from_pair(ov.qw_split(fg, ov.to_pair(psi, lat), params.kernel.kappa, lat), lat)
    assert dc.hopping_split.launches == n0 + 2
    assert _close(y, ov.qw_plain(u, psi, params, lat))
    s = ov.make_overlap(u, params, lat)
    d_k1, d_plain = ov.dov_psi(s, psi), ov.dov_psi(s, psi, plain=True)
    assert float(torch.linalg.vector_norm(d_k1 - d_plain) / torch.linalg.vector_norm(psi)) < 1e-5
