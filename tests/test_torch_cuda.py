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

import numpy as np
import pytest
import torch

from tmlqcd_tpu_torch import bridge, rng, su3
from tmlqcd_tpu_torch.hmc import Draws, hmc_trajectory
from tmlqcd_tpu_torch.lattice import Lattice
from tmlqcd_tpu_torch.models.suites import nf2_twisted_mass_hasenbusch
from tmlqcd_tpu_torch.ops import dslash_cuda as dc
from tmlqcd_tpu_torch.ops import wilson_fast as wf
from tmlqcd_tpu_torch.ops.wilson import DiracParams

torch.set_num_threads(1)

pytestmark = pytest.mark.gpu

RTOL = 1e-5
PARAMS = DiracParams(kappa=0.15, mu=0.03)
EPIS = [("none",), ("mee_inv", PARAMS.mutld, 1.0), ("mee_inv", PARAMS.mutld, -1.0),
        ("mhat", PARAMS.mutld, 1.0, PARAMS.kappa ** 2, True),
        ("mhat", PARAMS.mutld, -1.0, PARAMS.kappa ** 2, True),
        ("mhat", PARAMS.mutld, 1.0, PARAMS.kappa ** 2, False)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _close(out, ref):
    scale = max(1.0, float(ref.abs().max()))
    return float((out - ref).abs().max()) <= RTOL * scale


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
    for p, ug in ((0, fg.ug_even), (1, fg.ug_odd)):
        for epi in EPIS:
            kw = dict(epi=epi, psi_o=psi_o if epi[0] == "mhat" else None, gcomp=fg.gcomp)
            n = dc.hopping_split.launches
            out = dc.hopping_split(ug, psi, p, lat, **kw)
            assert dc.hopping_split.launches == n + 1
            assert _close(out, dc.hopping_split_plain(ug, psi, p, lat, **kw)), (p, epi)


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
