"""Known-answer tests of the port on the free (U = 1) field: the Wilson
twisted-mass operator against its exact momentum-space form at every
momentum, and the inverter and the pion contraction against the analytic
propagator.  They depend on neither package's operators: the answer is
algebra (the port of the inverter-related part of tests/test_free_field.py).

With boundary phases ph_mu = exp(i pi theta_mu / L_mu) folded into the hops,

    M(k) = (1 - 2 kappa sum_mu cos q_mu) + i mutld gamma5
           + 2 i kappa sum_mu gamma_mu sin q_mu,
    q_mu = 2 pi k_mu / L_mu + pi theta_mu / L_mu,

and with A = 1 - 2 kappa sum cos q, B_mu = 2 kappa sin q_mu,

    M(k)^{-1} = (A - i mutld gamma5 - i sum B_mu gamma_mu) / (A^2 + mutld^2 + sum B_mu^2).

Tolerances: the operator runs in complex128 and matches to 1e-12.  The
inverter runs f32 split fields (its only route) at tol 1e-7: propagator
entries of O(1) to 1e-6 (measured 2.0e-8), the correlator, a sum of squares,
to 1e-6 relative (measured 2.8e-8).
"""

import numpy as np
import pytest
import torch

from tmlqcd_tpu_torch.gamma import GAMMA, GAMMA5
from tmlqcd_tpu_torch.inverter import invert_eo
from tmlqcd_tpu_torch.lattice import Lattice
from tmlqcd_tpu_torch.meas.correlators import pion_correlator
from tmlqcd_tpu_torch.meas.sources import point_source
from tmlqcd_tpu_torch.ops import wilson as w

torch.set_num_threads(1)

LAT = Lattice((8, 4, 4, 4))
PARAMS = w.DiracParams(kappa=0.11, mu=0.03)


def _unit_gauge(dtype):
    return torch.eye(3, dtype=dtype).reshape(3, 3, 1, 1, 1, 1).expand(
        (3, 3, 4) + LAT.site_shape).contiguous()


def _m_of_k():
    """M(k) and its inverse, [T,X,Y,Z,4,4]."""
    dims = LAT.dims
    ks = np.meshgrid(*[np.arange(n) for n in dims], indexing="ij")
    q = [2.0 * np.pi * ks[mu] / dims[mu] + np.pi * PARAMS.theta[mu] / dims[mu] for mu in range(4)]
    kappa, mutld = PARAMS.kappa, PARAMS.mutld
    a = 1.0 - 2.0 * kappa * sum(np.cos(q_mu) for q_mu in q)
    eye = np.eye(4)
    m = a[..., None, None] * eye + 1j * mutld * GAMMA5
    m_inv = a[..., None, None] * eye - 1j * mutld * GAMMA5
    denom = a ** 2 + mutld ** 2
    for mu in range(4):
        b_mu = 2.0 * kappa * np.sin(q[mu])
        m = m + 1j * b_mu[..., None, None] * GAMMA[mu]
        m_inv = m_inv - 1j * b_mu[..., None, None] * GAMMA[mu]
        denom = denom + b_mu ** 2
    return m, m_inv / denom[..., None, None]


def _to_txyz(psi):
    return np.asarray(psi).reshape((4, 3) + LAT.dims)


def test_operator_on_plane_waves_matches_momentum_form():
    u = _unit_gauge(torch.complex128)
    m_k, m_inv = _m_of_k()
    np.testing.assert_allclose(m_k @ m_inv, np.broadcast_to(np.eye(4), m_k.shape), atol=1e-12)
    t, x, y, z = LAT.dims
    gen = np.random.default_rng(11)
    grid = np.meshgrid(*[np.arange(n) for n in LAT.dims], indexing="ij")
    for k in [(0, 0, 0, 0), (1, 0, 0, 0), (0, 1, 2, 3), (5, 3, 1, 2), (4, 2, 2, 2)]:
        phase = np.exp(2j * np.pi * sum(grid[mu] * k[mu] / LAT.dims[mu] for mu in range(4)))
        chi = gen.normal(size=(4, 3)) + 1j * gen.normal(size=(4, 3))
        psi = (chi[:, :, None, None, None, None] * phase).reshape((4, 3) + LAT.site_shape)
        out = _to_txyz(w.d_full(u, torch.as_tensor(psi), PARAMS, LAT))
        expect = (m_k[k] @ chi)[:, :, None, None, None, None] * phase
        np.testing.assert_allclose(out, expect, atol=1e-12)


@pytest.fixture(scope="module")
def free_propagator_columns():
    """Point-source propagator columns (4 spins, colour 0) from the even/odd
    inverter on the unit gauge field."""
    u = _unit_gauge(torch.complex64)
    cols = []
    for s0 in range(4):
        res = invert_eo(u, point_source(LAT, s0, 0, device="cpu"), PARAMS, LAT, tol=1e-7, maxiter=2000)
        assert res.iterations < 2000
        cols.append(res.x)
    return cols


def test_point_propagator_matches_analytic_all_momenta(free_propagator_columns):
    _, m_inv = _m_of_k()
    s_x = np.fft.ifftn(m_inv, axes=(0, 1, 2, 3))  # (1/V) sum_k e^{ipx} M(k)^{-1}
    for s0, col in enumerate(free_propagator_columns):
        num = _to_txyz(col)
        np.testing.assert_allclose(num[:, 0], np.moveaxis(s_x[..., s0], -1, 0), atol=1e-6)
        np.testing.assert_allclose(num[:, 1:], 0.0, atol=1e-6)  # the free field is colour-diagonal


def test_free_pion_correlator_time_dependence(free_propagator_columns):
    _, m_inv = _m_of_k()
    s_x = np.fft.ifftn(m_inv, axes=(0, 1, 2, 3))
    c_analytic = np.sum(np.abs(s_x) ** 2, axis=(1, 2, 3, 4, 5))
    c_num = sum(pion_correlator(col, LAT, 0).numpy() for col in free_propagator_columns)
    np.testing.assert_allclose(c_num, c_analytic, rtol=1e-6)
    assert c_num[1] < c_num[0]
    np.testing.assert_allclose(c_num[1:], c_num[1:][::-1], rtol=1e-6)  # time-symmetric
