"""The HMC invariants of the reference's `tests/test_hmc.py` on the port
alone (no reference compile): dH ~ dt^2 for leapfrog and 2MNPOSITION, 2MN
beating leapfrog at equal force evaluations, reversibility (also with the
Schrödinger functional's frozen links), and, marked slow as the reference's
is, <exp(-dH)> = 1 with the strong-coupling plaquette beta/18.

4^4, pure gauge (beta 5.7; the SF case beta 6), a hot start from a seeded
torch generator, complex64 on the CPU.  Bounds are the reference's: the
ratios of |dH| at halved steps in (3, 5) (leapfrog) and (2.5, 6)
(2MNPOSITION), |ddH| < 1e-3 and max|dU| < 1e-4 after forward and back.
"""

import numpy as np
import pytest
import torch

from tmlqcd_tpu_torch import rng, su3
from tmlqcd_tpu_torch.hmc import (
    GaugeMonomial,
    HMCConfig,
    IntegratorConfig,
    Level,
    SFGaugeMonomial,
    hmc_trajectory,
    reversibility_check,
)
from tmlqcd_tpu_torch.lattice import Lattice
from tmlqcd_tpu_torch.ops import sf

torch.set_num_threads(1)

LAT = Lattice((4, 4, 4, 4))
MONO = GaugeMonomial(lat=LAT, beta=5.7)


def _u0(seed: int = 7) -> torch.Tensor:
    return su3.random_su3(rng.generator(rng.Key(seed), "cpu"), (4,) + LAT.site_shape)


def _dh(scheme: str, n: int, key: int, mono=MONO, u=None) -> float:
    cfg = HMCConfig(LAT, (mono,), IntegratorConfig(tau=1.0, levels=(Level(scheme, n),)))
    with torch.no_grad():
        _, st = hmc_trajectory(cfg, _u0() if u is None else u, rng.Key(key))
    return st.delta_h


def test_dh_scales_as_dt_squared():
    dh = {n: _dh("leapfrog", n, 42) for n in (5, 10, 20)}
    assert 3.0 < dh[5] / dh[10] < 5.0, dh
    assert 3.0 < dh[10] / dh[20] < 5.0, dh


def test_2mn_beats_leapfrog():
    """Omelyan at equal force evaluations gives a much smaller |dH|."""
    assert abs(_dh("2mn", 10, 1)) < abs(_dh("leapfrog", 20, 1))


def test_2mnposition_second_order_and_comparable_to_2mn():
    dh = {n: _dh("2mnposition", n, 42) for n in (5, 10)}
    assert 2.5 < dh[5] / dh[10] < 6.0, dh
    assert abs(dh[10]) < 10.0 * abs(_dh("2mn", 10, 42)) + 1e-6


@pytest.mark.parametrize("case", ["gauge", "sf"])
def test_reversibility(case):
    """Forward, flip the momenta, back: |ddH| and max|dU| at f32 roundoff;
    with the SF's momenta mask the frozen links come back bit-equal (they
    never move)."""
    if case == "gauge":
        cfg = HMCConfig(LAT, (MONO,), IntegratorConfig(tau=1.0, levels=(Level("2mn", 10),)))
        u = _u0()
    else:
        cfg = HMCConfig(LAT, (SFGaugeMonomial(lat=LAT, beta=6.0, eta=0.1),),
                        IntegratorConfig(tau=1.0, levels=(Level("2mn", 10),)),
                        momenta_mask=sf.sf_momenta_mask(LAT))
        u = _u0().clone()
        u[:, :, 1:4, 0] = sf.sf_classical_background(LAT, 0.1)[:, :, 1:4, 0]
    with torch.no_grad():
        ddh, du = reversibility_check(cfg, u, rng.Key(3))
    assert ddh < 1e-3
    assert du < 1e-4


def test_sf_trajectory_keeps_boundary_frozen():
    """A masked SF trajectory moves the dynamical links and leaves the
    frozen ones bit-equal, three times over (the reference's
    test_sf_hmc_keeps_boundary_frozen)."""
    cfg = HMCConfig(LAT, (SFGaugeMonomial(lat=LAT, beta=6.0, eta=0.1),),
                    IntegratorConfig(tau=1.0, levels=(Level("2mn", 12),)),
                    momenta_mask=sf.sf_momenta_mask(LAT))
    u = sf.sf_classical_background(LAT, 0.1)
    frozen0 = u[:, :, 1:4, 0].clone()
    moved = False
    with torch.no_grad():
        for i in range(3):
            u_new, st = hmc_trajectory(cfg, u, rng.Key(0).fold(i))
            assert np.isfinite(st.delta_h) and abs(st.delta_h) < 1.0
            moved |= st.accepted
            u = u_new
            assert torch.equal(u[:, :, 1:4, 0], frozen0)
    assert moved


@pytest.mark.slow
def test_creutz_equality_and_strong_coupling_plaquette():
    """<exp(-dH)> = 1 within errors, and <plaq> ~ beta/18 at small beta."""
    beta = 1.0
    cfg = HMCConfig(LAT, (GaugeMonomial(lat=LAT, beta=beta),),
                    IntegratorConfig(tau=1.0, levels=(Level("2mn", 12),)))
    u = _u0()
    exps, plaqs = [], []
    with torch.no_grad():
        for i in range(20):
            u, _ = hmc_trajectory(cfg, u, rng.Key(100 + i))
        for i in range(60):
            u, st = hmc_trajectory(cfg, u, rng.Key(1000 + i))
            exps.append(st.exp_mdh)
            plaqs.append(st.plaquette)
    e, se = np.mean(exps), np.std(exps) / np.sqrt(len(exps))
    assert abs(e - 1.0) < max(4 * se, 0.02), (e, se)
    assert abs(np.mean(plaqs) - beta / 18.0) < 0.012, (np.mean(plaqs), beta / 18.0)
