"""Gauge-invariance and covariance oracles of the PyTorch port on random
(non-abelian) fields: the port of tests/test_gauge_invariance.py for what the
port carries.

These catch loop-ordering mistakes (U against U^+, swapped operands in a
plaquette, a staple or a clover leaf) that every self-consistent test misses:
force against finite difference, dH conservation and reversibility hold for
any smooth "action".  Under U_mu(x) -> g(x) U_mu(x) g(x+mu)^+ :

  - closed-loop traces (plaquette, rectangle, gauge action) are invariant,
  - the gauge force and the clover term transform in the adjoint at x,
    F -> g F g^+, T -> g T g^+, so the trlog of the clover blocks is
    invariant,
  - the Dirac operators are covariant: D[U^g](g psi) = g (D[U] psi), for the
    full twisted-mass operator and for the even/odd Qhat_pm and Qsw_pm with g
    restricted to the odd sites.

All in complex128, so the bounds are rounding of f64 sums: 1e-12 on
quantities of O(1), 1e-10 where ~100 such terms add up.
"""

import itertools

import numpy as np
import pytest
import torch

from tmlqcd_tpu_torch import rng, su3
from tmlqcd_tpu_torch.lattice import Lattice, eo_pack, pack_gauge_eo, shift_full
from tmlqcd_tpu_torch.ops import clover as cl
from tmlqcd_tpu_torch.ops import wilson as w
from tmlqcd_tpu_torch.ops.gauge_action import gauge_action, gauge_force, plaquette, rectangle

torch.set_num_threads(1)

LAT = Lattice((4, 4, 4, 4))
DT = torch.complex128


def _rotate(g, m):
    """g m g^+ on colour matrices [3, 3, *sites]."""
    return su3.mul(su3.mul(g, m), su3.adj(g))


@pytest.fixture(scope="module")
def fields():
    u = su3.random_su3(rng.generator(rng.Key(0), "cpu"), (4,) + LAT.site_shape, DT)
    g = su3.random_su3(rng.generator(rng.Key(1), "cpu"), LAT.site_shape, DT)
    ug = torch.stack([su3.mul(su3.mul(g, u[:, :, mu]), su3.adj(shift_full(g, mu, +1, LAT)))
                      for mu in range(4)], dim=2)
    assert float(su3.unitarity_defect(ug).max()) < 1e-12
    return u, ug, g


def test_plaquette_and_rectangle_invariant(fields):
    u, ug, _ = fields
    assert abs(float(plaquette(u, LAT) - plaquette(ug, LAT))) < 1e-12
    assert abs(float(rectangle(u, LAT) - rectangle(ug, LAT))) < 1e-12


def test_gauge_action_invariant(fields):
    u, ug, _ = fields
    for c1 in (0.0, -1.0 / 12.0):
        s0 = float(gauge_action(u, 5.7, LAT, c1))
        s1 = float(gauge_action(ug, 5.7, LAT, c1))
        assert abs(s0 - s1) / abs(s0) < 1e-12


def test_plaquette_matches_brute_force():
    """A fully independent dense-loop construction on a 2^4 lattice."""
    lat = Lattice((2, 2, 2, 2))
    u = su3.random_su3(rng.generator(rng.Key(5), "cpu"), (4,) + lat.site_shape, DT)
    links = u.numpy()
    t_, x_, y_, z_ = lat.dims

    def link(mu, t, x, y, z):
        return links[:, :, mu, t % t_, x % x_, (y % y_) * z_ + (z % z_)]

    tot, n = 0.0, 0
    for pos in itertools.product(range(t_), range(x_), range(y_), range(z_)):
        for mu in range(4):
            for nu in range(mu + 1, 4):
                def pp(m):
                    return [pos[i] + (1 if i == m else 0) for i in range(4)]

                tot += np.trace(link(mu, *pos) @ link(nu, *pp(mu))
                                @ link(mu, *pp(nu)).conj().T @ link(nu, *pos).conj().T).real
                n += 1
    assert abs(float(plaquette(u, lat)) - tot / (3 * n)) < 1e-12


@pytest.mark.parametrize("c1", [0.0, -1.0 / 12.0], ids=["wilson", "tlsym"])
def test_gauge_force_covariant(fields, c1):
    """F_mu(x) = TA(U_mu(x) staple-sum) lives at x: F[U^g] = g F[U] g^+."""
    u, ug, g = fields
    f, fg = gauge_force(u, 5.7, LAT, c1), gauge_force(ug, 5.7, LAT, c1)
    assert float(f.abs().max()) > 1.0
    for mu in range(4):
        assert float((fg[:, :, mu] - _rotate(g, f[:, :, mu])).abs().max()) < 1e-10


def test_dirac_operator_covariant(fields):
    u, ug, g = fields
    params = w.DiracParams(kappa=0.13, mu=0.05, theta=(1.0, 0.0, 0.0, 0.0))
    psi = rng.normal_spinor(rng.Key(2), (4, 3) + LAT.site_shape, "cpu", DT)
    lhs = w.d_full(ug, w.color_apply(g, psi), params, LAT)
    rhs = w.color_apply(g, w.d_full(u, psi, params, LAT))
    assert float((lhs - rhs).abs().max()) < 1e-12


def test_q_hat_pm_covariant(fields):
    """The even/odd Schur operator on odd sites: Qhat_pm[U^g](g_o psi) =
    g_o Qhat_pm[U] psi."""
    u, ug, g = fields
    params = w.DiracParams(kappa=0.13, mu=0.05)
    ph = w.boundary_phases(params, LAT)
    _, g_o = eo_pack(g, LAT)
    psi = rng.normal_spinor(rng.Key(3), (4, 3) + LAT.eo_site_shape, "cpu", DT)
    lhs = w.q_hat_pm(pack_gauge_eo(ug, LAT), w.color_apply(g_o, psi), params, LAT, ph)
    rhs = w.color_apply(g_o, w.q_hat_pm(pack_gauge_eo(u, LAT), psi, params, LAT, ph))
    assert float(rhs.abs().max()) > 1.0
    assert float((lhs - rhs).abs().max()) < 1e-12


def test_sw_blocks_covariant_and_logdet_invariant(fields):
    """Every clover leaf starts and ends at x, so T(x) -> g(x) T(x) g(x)^+ in
    colour, block by block; the determinants of 1 + T + i mu g5 do not move."""
    u, ug, g = fields
    kappa, c_sw, mutld = 0.14, 1.74, 0.05
    sw, swg = cl.sw_blocks(u, kappa, c_sw, LAT), cl.sw_blocks(ug, kappa, c_sw, LAT)
    assert float(sw.abs().max()) > 0.05
    for b, s, sp in itertools.product(range(2), repeat=3):
        assert float((swg[b, s, sp] - _rotate(g, sw[b, s, sp])).abs().max()) < 1e-12
    for gm, gm_g in zip(cl.field_strength(u, LAT), cl.field_strength(ug, LAT)):
        assert float((gm_g - _rotate(g, gm)).abs().max()) < 1e-12
    sw_e, _ = eo_pack(sw, LAT)
    swg_e, _ = eo_pack(swg, LAT)
    ld, ldg = float(cl.sw_logdet(sw_e, mutld)), float(cl.sw_logdet(swg_e, mutld))
    assert abs(ld) > 1.0 and abs(ld - ldg) < 1e-10


def test_q_hat_pm_clover_covariant(fields):
    u, ug, g = fields
    params = w.DiracParams(kappa=0.14, mu=0.05, c_sw=1.74)
    ph = w.boundary_phases(params, LAT)
    _, g_o = eo_pack(g, LAT)
    psi = rng.normal_spinor(rng.Key(4), (4, 3) + LAT.eo_site_shape, "cpu", DT)

    def qsw(uu, x):
        sw_e, sw_o = cl.sw_blocks_eo(uu, params.kappa, params.c_sw, LAT)
        return cl.q_hat_pm_clover(pack_gauge_eo(uu, LAT), sw_e, sw_o, x, params, LAT, ph)

    lhs, rhs = qsw(ug, w.color_apply(g_o, psi)), w.color_apply(g_o, qsw(u, psi))
    assert float(rhs.abs().max()) > 1.0
    assert float((lhs - rhs).abs().max()) < 1e-12
