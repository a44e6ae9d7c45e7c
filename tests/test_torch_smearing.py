"""Jacobi source smearing, APE and stout link smearing and the polar SU(3)
projection of the port (meas/smearing.py, su3.project_su3_polar), port-only:
the cases of tests/test_smearing.py at 4^4 on the CPU, and the inverter's
smearing options end to end.  tests/test_torch_smearing_ref.py holds the
comparisons with the reference.

Oracles: gauge covariance (which pins every index and adjoint of the
covariant Laplacian and the staples), exact fixed points and support of
the Jacobi sweep, SU(3) closure, and the smoothing the smearings exist for.
"""

import numpy as np
import pytest
import torch

from tmlqcd_tpu_torch import rng, su3
from tmlqcd_tpu_torch.lattice import Lattice, shift_full
from tmlqcd_tpu_torch.meas.smearing import ape_smear_spatial, jacobi_smear, stout_smear
from tmlqcd_tpu_torch.meas.sources import point_source, z2_timeslice_source
from tmlqcd_tpu_torch.ops.gauge_action import plaquette, plaquette_field

torch.set_num_threads(1)

LAT = Lattice((4, 4, 4, 4))


def _gen(seed):
    return rng.generator(rng.Key(seed), "cpu")


def _random_gauge(seed, lat=LAT):
    return su3.random_su3(_gen(seed), (4,) + lat.site_shape)


def _warm_gauge(seed):
    """exp of a scaled algebra element: a field with smooth structure."""
    return su3.expm_ta(0.6 * su3.random_momenta(_gen(seed), (4,) + LAT.site_shape))


def _gauge_rotation(seed):
    """g(x) in SU(3) per site, and its action on links and spinors."""
    g = su3.random_su3(_gen(seed), LAT.site_shape)

    def on_links(u):
        return torch.stack([su3.mul(su3.mul(g, u[:, :, mu]), su3.adj(shift_full(g, mu, +1, LAT)))
                            for mu in range(4)], dim=2)

    def on_spinor(psi):
        return torch.stack([su3.matvec(g, psi[s]) for s in range(4)])

    return on_links, on_spinor


def _rel(a, b) -> float:
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(a))


def test_jacobi_unit_links_constant_fixed_point():
    """With U = 1 a spatially constant timeslice source is an eigenvector
    (eigenvalue 1) of the Jacobi sweep."""
    u = torch.eye(3, dtype=torch.complex64).reshape(3, 3, 1, 1, 1, 1).expand(
        (3, 3, 4) + LAT.site_shape)
    src = torch.zeros((4, 3) + LAT.site_shape, dtype=torch.complex64)
    src[0, 0, 2] = 1.0
    out = jacobi_smear(src, u, LAT, kappa=0.3, n_iter=6)
    assert float((out - src).abs().max()) < 1e-5


def test_jacobi_timeslice_support_preserved():
    out = jacobi_smear(z2_timeslice_source(LAT, 1, rng.Key(1), device="cpu"), _random_gauge(0),
                       LAT, kappa=0.21, n_iter=4)
    mask = torch.arange(LAT.dims[0]) != 1
    assert float(out[:, :, mask].abs().max()) == 0.0
    assert float(torch.linalg.vector_norm(out)) > 0.1


def test_jacobi_gauge_covariance():
    u = _random_gauge(2)
    psi = rng.normal_spinor(rng.Key(3), (4, 3) + LAT.site_shape, "cpu")
    on_links, on_spinor = _gauge_rotation(4)
    a = on_spinor(jacobi_smear(psi, u, LAT, kappa=0.21, n_iter=3))
    b = jacobi_smear(on_spinor(psi), on_links(u), LAT, kappa=0.21, n_iter=3)
    assert _rel(a, b) < 1e-5


def test_jacobi_point_source_spreads():
    out = jacobi_smear(point_source(LAT, 0, 0, (0, 0, 0, 0), device="cpu"), _random_gauge(8),
                       LAT, kappa=0.15, n_iter=3)
    m0 = float(out[0, :, 0, 1, 0].abs().max())
    assert m0 > 1e-4 and float(out[:, :, 0, 0, 0].abs().max()) > m0


def test_ape_gauge_covariance_and_su3():
    u = _random_gauge(5)
    on_links, _ = _gauge_rotation(6)
    a = on_links(ape_smear_spatial(u, LAT, alpha=0.5, n_iter=2))
    b = ape_smear_spatial(on_links(u), LAT, alpha=0.5, n_iter=2)
    assert _rel(a, b) < 1e-5
    assert float(su3.unitarity_defect(b)) < 1e-5


def _spatial_plaquette(u) -> float:
    vals = [float(torch.mean(su3.re_trace(plaquette_field(u, mu, nu, LAT)).double())) / 3.0
            for mu in range(1, 4) for nu in range(mu + 1, 4)]
    return sum(vals) / len(vals)


def test_ape_smooths_and_keeps_temporal_links():
    u = _warm_gauge(7)
    sm1 = ape_smear_spatial(u, LAT, alpha=0.5, n_iter=1)
    sm4 = ape_smear_spatial(u, LAT, alpha=0.5, n_iter=4)
    assert float((sm4[:, :, 0] - u[:, :, 0]).abs().max()) == 0.0
    p0, p1, p4 = _spatial_plaquette(u), _spatial_plaquette(sm1), _spatial_plaquette(sm4)
    assert p1 > p0 + 0.05 and p4 > p1, (p0, p1, p4)


def test_polar_projection_covariant_and_special_unitary():
    """P(g m h^+) = g P(m) h^+, det P = 1, and SU(3) links are fixed points."""
    u = _random_gauge(9)[:, :, 0]
    m = 1.3 * u + 0.4 * _random_gauge(10)[:, :, 0]
    g, h = _random_gauge(11)[:, :, 0], _random_gauge(12)[:, :, 0]
    p = su3.project_su3_polar(m)
    assert float(su3.unitarity_defect(p)) < 1e-5
    det = su3.inv3(p)[1]
    assert float((det - 1).abs().max()) < 1e-5
    a = su3.mul(su3.mul(g, p), su3.adj(h))
    b = su3.project_su3_polar(su3.mul(su3.mul(g, m), su3.adj(h)))
    assert _rel(a, b) < 1e-5
    assert float((su3.project_su3_polar(u) - u).abs().max()) < 1e-5


def test_stout_su3_and_gauge_covariance():
    u = _random_gauge(10)
    on_links, _ = _gauge_rotation(11)
    a = on_links(stout_smear(u, LAT, rho=0.12, n_iter=2))
    b = stout_smear(on_links(u), LAT, rho=0.12, n_iter=2)
    assert _rel(a, b) < 1e-5
    assert float(su3.unitarity_defect(b)) < 1e-5


def test_stout_rho0_identity_and_smooths():
    u = _warm_gauge(12)
    assert float((stout_smear(u, LAT, rho=0.0, n_iter=2) - u).abs().max()) < 1e-6
    p0 = float(plaquette(u, LAT))
    p1 = float(plaquette(stout_smear(u, LAT, rho=0.1, n_iter=1), LAT))
    p3 = float(plaquette(stout_smear(u, LAT, rho=0.1, n_iter=3), LAT))
    assert p1 > p0 + 0.05 and p3 > p1, (p0, p1, p3)


def test_stout_spatial_only_keeps_temporal():
    u = _random_gauge(13)
    sm = stout_smear(u, LAT, rho=0.15, n_iter=2, spatial_only=True)
    assert float((sm[:, :, 0] - u[:, :, 0]).abs().max()) == 0.0
    assert float((sm[:, :, 1] - u[:, :, 1]).abs().max()) > 1e-3


def test_stout_differentiable_vs_fd():
    """autograd through the smearing (the reference's hand-derived
    stout_force): the directional derivative of plaquette(stout(U))
    against central finite differences, complex128."""
    lat = Lattice((2, 2, 2, 2))
    u = su3.random_su3(_gen(14), (4,) + lat.site_shape, torch.complex128)
    h = su3.random_momenta(_gen(15), (4,) + lat.site_shape, torch.complex128)

    def f(eps):
        return plaquette(stout_smear(su3.mul(su3.expm_ta(eps * h), u), lat, rho=0.1, n_iter=2),
                         lat)

    e = torch.zeros((), dtype=torch.float64, requires_grad=True)
    (g,) = torch.autograd.grad(f(e), e)
    fd = float((f(torch.tensor(1e-4, dtype=torch.float64))
                - f(torch.tensor(-1e-4, dtype=torch.float64))) / 2e-4)
    assert abs(float(g) - fd) < 1e-6 * max(1.0, abs(fd)), (float(g), fd)


@pytest.mark.parametrize("stout", [False, True], ids=["source", "stout+source"])
def test_invert_cli_smearing(tmp_path, stout):
    """`cli.invert --cpu` with UseSourceSmearing (and UseStoutSmearing): the
    smeared z2 wall source is solved on the (smeared) gauge; the propagator
    is the solution of the smeared source on the smeared links."""
    from tmlqcd_tpu_torch.cli.invert import main as invert_main
    from tmlqcd_tpu_torch.io.checkpoint import save_checkpoint
    from tmlqcd_tpu_torch.ops.wilson import DiracParams, d_full

    u = _random_gauge(3)
    conf = save_checkpoint(str(tmp_path), u, 7, seed=11, lat=LAT)
    stout_keys = "UseStoutSmearing = yes\nStoutRho = 0.1\nStoutNoIterations = 2\n" if stout else ""
    inp = tmp_path / "invert.input"
    inp.write_text("T = 4\nLX = 4\nLY = 4\nLZ = 4\nSourceType = Timeslice\nSourceTimeslice = 1\n"
                   "UseSourceSmearing = 1\nJacobiKappa = 0.2\nJacobiIterations = 2\n"
                   "APEAlpha = 0.4\nAPEIterations = 1\n" + stout_keys +
                   "BeginOperator TMWILSON\n  kappa = 0.15\n  2KappaMu = 0.03\n  Solver = cg\n"
                   "  SolverPrecision = 1e-14\n  MaxSolverIterations = 300\nEndOperator\n")
    assert invert_main(["-f", str(inp), "-c", conf, "--format", "npz", "--cpu",
                        "-o", str(tmp_path)]) == 0
    with np.load(tmp_path / "propagator.00.000007.npz") as f:
        prop = torch.as_tensor(f["propagator"])
    assert prop.shape == (1, 4, 3) + LAT.site_shape and bool(torch.isfinite(prop).all())
    us = stout_smear(u, LAT, 0.1, 2) if stout else u
    src = jacobi_smear(z2_timeslice_source(LAT, 1, rng.Key(171), device="cpu"),
                       ape_smear_spatial(us, LAT, 0.4, 1), LAT, 0.2, 2)
    params = DiracParams(kappa=0.15, mu=0.03 / 0.3)
    res = torch.linalg.vector_norm(d_full(us, prop[0], params, LAT) - src)
    assert float(res / torch.linalg.vector_norm(src)) < 1e-5
