"""Gauge observables and the gradient flow of the port, port-only (no
reference compile): the known answers of tests/test_meas.py on the port's
`meas/gauge_obs.py` and `meas/gradient_flow.py`, at 4^4 on the CPU.

Oracles: the Polyakov loop of a unit and of a constant-phase field, unit
oriented plaquettes, the free-field decay exp(-t phat^2) of a transverse
plane wave (which pins the flow's normalisation and sign), a monotone flow
energy, and the clover topological charge of an abelian flux (an exact
closed form) and of the unit field.  complex128 fields where the answer is
exact, so the bounds are those of the reference's tests.
"""

import math

import numpy as np
import torch

from tmlqcd_tpu_torch import bridge, rng, su3
from tmlqcd_tpu_torch.lattice import Lattice
from tmlqcd_tpu_torch.meas import (
    energy_clover,
    energy_plaq,
    oriented_plaquettes,
    polyakov_loop,
    t0_scale,
    topological_charge,
    wilson_flow,
    wilson_flow_adaptive,
    wilson_flow_step,
)

torch.set_num_threads(1)

LAT = Lattice((4, 4, 4, 4))
DT = torch.complex128


def _unit(lat=LAT, dtype=DT):
    eye = torch.eye(3, dtype=dtype).reshape(3, 3, 1, 1, 1, 1)
    return eye.expand((3, 3, 4) + lat.site_shape).contiguous()


def test_polyakov_unit_field():
    u = _unit()
    for d in range(4):
        assert abs(complex(polyakov_loop(u, LAT, d)) - 1.0) < 1e-12


def test_polyakov_constant_phase():
    """U_0 = diag(e^{i a}, e^{-i a}, 1) everywhere: P = tr(U_0^T) / 3."""
    phase = np.exp(2j * np.pi / (3 * LAT.dims[0]))
    m = np.diag([phase, phase.conjugate(), 1.0]).astype(np.complex128)
    u = _unit().clone()
    u[:, :, 0] = torch.as_tensor(m).reshape(3, 3, 1, 1, 1)
    expect = np.trace(np.linalg.matrix_power(m, LAT.dims[0])) / 3.0
    assert abs(complex(polyakov_loop(u, LAT, 0)) - expect) < 1e-12


def test_oriented_plaquettes_unit():
    op = oriented_plaquettes(_unit(), LAT)
    assert op.shape == (6,) and op.dtype == torch.float64
    np.testing.assert_allclose(op.numpy(), 1.0, atol=1e-14)


def test_flow_free_field_decay():
    """Linearised Wilson flow: a transverse plane wave A_2(x) ~
    cos(2 pi n x / L) along lambda = diag(1, -1, 0) decays as
    exp(-t phat^2), phat^2 = 4 sin^2(pi n / L); pins Z's normalisation and
    sign to 2 %."""
    n, amp = 1, 1e-4
    x_ = LAT.dims[1]
    theta = amp * np.cos(2 * np.pi * n * np.arange(x_) / x_)
    u = _unit().clone()
    for ix in range(x_):
        u[:, :, 2, :, ix, :] = torch.as_tensor(
            np.diag(np.exp(1j * theta[ix] * np.array([1.0, -1.0, 0.0])))).reshape(3, 3, 1, 1)
    eps, steps = 0.01, 10
    v = u
    for _ in range(steps):
        v = wilson_flow_step(v, eps, LAT)

    def amplitude(w):
        ph = (np.angle(w[0, 0, 2].numpy()) - np.angle(w[1, 1, 2].numpy())) / 2
        return 2 * np.mean(ph[0, :, 0] * np.cos(2 * np.pi * n * np.arange(x_) / x_))

    expect = np.exp(-eps * steps * 4 * np.sin(np.pi * n / x_) ** 2)
    ratio = amplitude(v) / amplitude(u)
    assert abs(ratio - expect) < 0.02 * expect, (ratio, expect)


def test_flow_monotone_energy():
    """t^2 E grows from ~0, E_plaq falls step by step (the Wilson flow is
    the gradient flow of the Wilson action, which E_plaq is up to a
    constant; E_clover of a hot field can rise at first, as the clover
    leaves line up), and the flow keeps the links in SU(3); t0 interpolates
    between the bracketing steps."""
    u = bridge.gauge_from_numpy(bridge.numpy_su3(np.random.default_rng(5),
                                                 (4,) + LAT.site_shape), LAT)
    res = wilson_flow(u, LAT, eps=0.02, n_steps=5)
    t2e = res.t2e_plaq.numpy()
    assert res.times.dtype == torch.float64
    np.testing.assert_allclose(res.times.numpy(), 0.02 * np.arange(1, 6), rtol=1e-15)
    assert np.all(np.isfinite(t2e)) and np.all(t2e > 0)
    e = np.concatenate([[float(energy_plaq(u, LAT))], t2e / res.times.numpy() ** 2])
    assert np.all(np.diff(e) < 0), e
    assert float(energy_clover(u, LAT)) > 0 and np.all(res.t2e_clover.numpy() > 0)
    assert float(su3.unitarity_defect(res.v)) < 1e-5
    target = 0.5 * (t2e[2] + t2e[3])
    assert res.times[2] < t0_scale(res.times, t2e, target) < res.times[3]
    assert math.isnan(t0_scale(res.times, t2e, 10.0))


def test_flow_adaptive_matches_fixed_steps():
    """The adaptive flow reaches t_max and agrees with small fixed steps."""
    u = su3.random_su3(rng.generator(rng.Key(3), "cpu"), (4,) + LAT.site_shape)
    v, times, t2e = wilson_flow_adaptive(u, LAT, t_max=0.06, eps0=0.02, tol=1e-4)
    assert abs(times[-1] - 0.06) < 1e-12 and len(times) == len(t2e)
    ref = wilson_flow(u, LAT, eps=0.01, n_steps=6)
    assert float((v - ref.v).abs().max()) < 1e-3
    assert abs(t2e[-1] - float(ref.t2e_plaq[-1])) < 1e-3 * float(ref.t2e_plaq[-1])


def test_topological_charge_abelian_flux():
    """An abelian torus flux with fluxes (n1, n2) in the (t, x) and (y, z)
    planes along lambda = diag(1, -1, 0): the clover charge is exactly
    2 n1 n2 (sin f1 / f1)(sin f2 / f2), the continuum 2 n1 n2 as a -> 0."""
    T, X, Y, Z = LAT.dims
    n1, n2 = 1, 1
    t = np.arange(T).reshape(T, 1, 1)
    x = np.arange(X).reshape(1, X, 1)
    m = np.arange(Y * Z).reshape(1, 1, Y * Z)
    y, z = m // Z, m % Z
    th = np.zeros((4, T, X, Y * Z))
    th[1] = 2 * np.pi * n1 * t / (T * X) + 0 * (x + m)
    th[0] = np.where(t == T - 1, -2 * np.pi * n1 * x / X, 0.0) + 0 * m
    th[3] = 2 * np.pi * n2 * y / (Y * Z) + 0 * (t + x)
    th[2] = np.where(y == Y - 1, -2 * np.pi * n2 * z / Z, 0.0) + 0 * (t + x)
    u = np.zeros((3, 3, 4, T, X, Y * Z), np.complex128)
    for c, e in enumerate([1.0, -1.0, 0.0]):
        u[c, c] = np.exp(1j * e * th)
    q = topological_charge(torch.as_tensor(u), LAT)
    assert q.dtype == torch.float64
    f1, f2 = 2 * np.pi * n1 / (T * X), 2 * np.pi * n2 / (Y * Z)
    expect = 2.0 * n1 * n2 * (np.sin(f1) / f1) * (np.sin(f2) / f2)
    assert abs(float(q) - expect) < 1e-3 * abs(expect), (float(q), expect)


def test_topological_charge_unit_field_zero():
    assert abs(float(topological_charge(_unit(), LAT))) < 1e-10
