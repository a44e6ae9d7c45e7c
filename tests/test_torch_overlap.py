"""The port's overlap operator, Lanczos and SUMR on their own (no reference
compile), the reference's `tests/test_overlap.py` checks, and the OVERLAP
operator block read by both packages' input readers.

4^4, a weakly fluctuating gauge (`bridge.numpy_smooth_su3`, scale 0.3) so
that a degree-48 Chebyshev approximates the sign of the Wilson kernel; the
fields are complex64 and every Q_W runs on K1's plain version (CPU tensors),
so the bounds carry an f32 floor where the reference's complex128 test has
1e-8 .. 1e-9:
* sign involution |sign(Q)^2 psi - psi| / |psi| <= 5 (sign_err + ev_resid)
  + 1e-5, the GW defect <= 10 (sign_err + ev_resid) + 1e-5, deflated
  against undeflated <= 10 (both sign errors + ev_resid) + 1e-5 (the
  reference's bounds, + 1e-5 for f32 over ~200 operator applications);
* gamma5-hermiticity <phi, D psi> = <D^+ phi, psi> to 1e-5 relative (exact
  in exact arithmetic: the sign is hermitian by construction);
* the dense SUMR and Lanczos checks in complex128, the reference's bounds.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tmlqcd_tpu import config_tmlqcd as jconfig_tmlqcd
from tmlqcd_tpu_torch import bridge, config_tmlqcd
from tmlqcd_tpu_torch.lattice import Lattice
from tmlqcd_tpu_torch.ops import dslash_cuda as dc
from tmlqcd_tpu_torch.ops import overlap as ov
from tmlqcd_tpu_torch.solvers.lanczos import lowest_eigenpairs
from tmlqcd_tpu_torch.solvers.sumr import sumr

torch.set_num_threads(1)

LAT = Lattice((4, 4, 4, 4))
PARAMS = ov.OverlapParams(rho=1.0, m=0.3, degree=48, n_ev=4)
F32 = 1e-5


def _rel(a, b) -> float:
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


@pytest.fixture(scope="module")
def setup():
    gen = np.random.default_rng(7)
    u = bridge.gauge_from_numpy(bridge.numpy_smooth_su3(gen, (4,) + LAT.site_shape), LAT)
    v0 = torch.as_tensor(bridge.numpy_spinor(gen, (4, 3) + LAT.site_shape))
    s = ov.make_overlap(u, PARAMS, LAT, v0=v0)
    psi = torch.as_tensor(bridge.numpy_spinor(gen, (4, 3) + LAT.site_shape))
    phi = torch.as_tensor(bridge.numpy_spinor(gen, (4, 3) + LAT.site_shape))
    return s, psi, phi


def test_sign_involution_and_launch_count(setup):
    """sign(Q)^2 psi == psi up to the Chebyshev accuracy; one sign is
    4 (degree + 1) + 2 K1 calls (here K1's plain version)."""
    s, psi, _ = setup
    dc.reset_counters()
    s1 = ov.sign_q(s, psi)
    assert dc.hopping_split_plain.calls == ov.k1_launches_per_sign(PARAMS.degree) == 198
    assert dc.hopping_split.launches == 0
    rel = _rel(ov.sign_q(s, s1), psi)
    assert rel < 5.0 * (s.sign_err + s.ev_resid) + F32, rel


def test_ginsparg_wilson_relation(setup):
    s, psi, _ = setup
    defect = ov.gw_defect(s, psi)
    assert defect < 10.0 * (s.sign_err + s.ev_resid) + F32, defect


def test_gamma5_hermiticity_and_routes(setup):
    """D_ov^+ = gamma5 D_ov gamma5 to f32 rounding, and the kernel route
    (K1) against the reference's route (gamma5 d_full) on one vector."""
    s, psi, phi = setup
    d_psi = ov.dov_psi(s, psi)
    lhs = torch.vdot(phi.flatten().cdouble(), d_psi.flatten().cdouble())
    rhs = torch.vdot(ov.dov_dagger_psi(s, phi).flatten().cdouble(), psi.flatten().cdouble())
    assert abs(complex(lhs - rhs)) < F32 * abs(complex(lhs))
    assert _rel(d_psi, ov.dov_psi(s, psi, plain=True)) < F32


def test_deflation_matches_undeflated(setup):
    s, psi, _ = setup
    s0 = ov.make_overlap(s.u, dataclasses.replace(PARAMS, n_ev=0, degree=160), LAT,
                         v0=torch.as_tensor(bridge.numpy_spinor(np.random.default_rng(8),
                                                                (4, 3) + LAT.site_shape)))
    assert s0.evecs.shape[0] == 0
    rel = _rel(ov.sign_q(s, psi), ov.sign_q(s0, psi))
    assert rel < 10.0 * (s.sign_err + s0.sign_err + s.ev_resid) + F32, rel


def test_eps_picks_the_smallest_degree(setup):
    """make_overlap(eps=...) takes the smallest power of two from 16 whose
    sign error on [lo, hi] is below eps (the reference's degree search)."""
    from tmlqcd_tpu_torch.solvers.chebyshev import chebyshev_coeffs, chebyshev_eval

    s, _, _ = setup
    s_eps = ov.make_overlap(s.u, PARAMS, LAT, v0=torch.as_tensor(
        bridge.numpy_spinor(np.random.default_rng(7), (4, 3) + LAT.site_shape)), eps=1e-3)
    degree = len(s_eps.coeffs) - 1
    assert degree >= 16 and degree & (degree - 1) == 0 and s_eps.sign_err <= 1e-3
    x = np.sqrt(np.linspace(s_eps.lo2, s_eps.hi2, 4001))
    half = chebyshev_coeffs(lambda t: 1.0 / np.sqrt(t), degree // 2, s_eps.lo2, s_eps.hi2)
    assert np.max(np.abs(x * chebyshev_eval(half, x * x, s_eps.lo2, s_eps.hi2) - 1.0)) > 1e-3


def test_sumr_dense_unitary():
    """SUMR == dense solve for (zeta + rho U) x = b with a random unitary U
    (complex128): real shifts, as the reference's test, and a complex or
    negative rho, which the reference's recurrence gets wrong (relative
    residual 0.39 and 1.9 at these shifts) and the port rotates to |rho|."""
    gen = np.random.default_rng(0)
    n = 40
    q, _ = np.linalg.qr(gen.normal(size=(n, n)) + 1j * gen.normal(size=(n, n)))
    b = gen.normal(size=n) + 1j * gen.normal(size=n)
    ut = torch.as_tensor(q)
    for zeta, rho in ((0.9, 0.6), ((0.9, 0.2), (0.5, -0.3)), (0.9, -0.6)):
        m = complex(*np.atleast_1d(zeta)) * np.eye(n) + complex(*np.atleast_1d(rho)) * q
        res = sumr(lambda x: ut @ x, torch.as_tensor(b), zeta=zeta, rho=rho, tol=1e-10,
                   maxiter=2 * n)
        x = res.x.numpy()
        assert np.linalg.norm(m @ x - b) / np.linalg.norm(b) < 1e-9
        assert np.linalg.norm(x - np.linalg.solve(m, b)) / np.linalg.norm(x) < 1e-8
        assert 0 < res.iterations <= 2 * n and res.residual_sq <= 1e-20 * np.vdot(b, b).real


def test_lanczos_lowest_eigenpairs_dense():
    """Lanczos Ritz pairs match numpy eigh on a random hermitian matrix,
    lowest by value and by magnitude (complex128)."""
    gen = np.random.default_rng(3)
    n = 60
    a = gen.normal(size=(n, n)) + 1j * gen.normal(size=(n, n))
    h = (a + a.conj().T) / 2.0
    ht = torch.as_tensor(h)
    v0 = torch.as_tensor(gen.normal(size=n) + 1j * gen.normal(size=n))
    w = np.linalg.eigvalsh(h)
    out = lowest_eigenpairs(lambda x: ht @ x, v0, n_ev=4, steps=n)
    np.testing.assert_allclose(out.values, w[:4], atol=1e-8)
    assert np.all(out.residuals < 1e-7)
    mag = lowest_eigenpairs(lambda x: ht @ x, v0, n_ev=3, steps=n, by_magnitude=True)
    np.testing.assert_allclose(np.sort(np.abs(mag.values)), np.sort(np.abs(w))[:3], atol=1e-8)


def test_overlap_operator_block_reads_as_the_reference():
    """Both readers give every OverlapSpec field the same value, the keys
    DegreeOfSignFunction and NoEigenvalues included, and their defaults
    (128, 8) when the block leaves them out."""
    text = ("ThetaT = 1.0\nBeginOperator OVERLAP\n m = 0.05\n s = 0.4\n"
            " DegreeOfSignFunction = 96\n NoEigenvalues = 6\n SolverPrecision = 1e-14\n"
            " MaxSolverIterations = 300\n PropagatorPrecision = 32\nEndOperator\n"
            "BeginOperator OVERLAP\n m = 0.1\nEndOperator\n")
    mine = config_tmlqcd.parse_input(text).operators
    ref = jconfig_tmlqcd.parse_input(text).operators
    assert len(mine) == len(ref) == 2
    for a, b in zip(mine, ref):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert (mine[0].sign_degree, mine[0].sign_n_ev, mine[0].overlap_s) == (96, 6, 0.4)
    assert (mine[1].sign_degree, mine[1].sign_n_ev, mine[1].solver) == (128, 8, "sumr")


def test_cli_invert_overlap_cpu(tmp_path):
    """`cli.invert --cpu` with an OVERLAP block (an unknown solver name runs
    SUMR, as in the reference): the setup line, one point column, its true
    residual |D_ov x - b| / |b| on the same setup (the CLI draws the Lanczos
    start from the default key) at the solver's tolerance 1e-5 (measured
    5.4e-6), and the npz propagator."""
    from tmlqcd_tpu_torch.cli import invert as cli
    from tmlqcd_tpu_torch.io.checkpoint import save_checkpoint
    from tmlqcd_tpu_torch.meas.sources import point_source

    u = bridge.gauge_from_numpy(bridge.numpy_smooth_su3(np.random.default_rng(5),
                                                        (4,) + LAT.site_shape), LAT)
    conf = save_checkpoint(str(tmp_path), u, 3, 1, LAT)
    inp = tmp_path / "ov.input"
    inp.write_text("L = 4\nT = 4\nBeginOperator OVERLAP\n m = 0.3\n s = 0.0\n"
                   " DegreeOfSignFunction = 16\n NoEigenvalues = 2\n SolverPrecision = 1e-10\n"
                   " Solver = bogus\nEndOperator\n")
    out = tmp_path / "props"
    assert cli.main(["-f", str(inp), "-c", conf, "--format", "npz", "--columns", "1", "-o",
                     str(out), "--cpu"]) == 0
    with np.load(out / "propagator.00.000003.npz") as z:
        x = z["propagator"]
    assert x.shape == (1, 4, 3) + LAT.site_shape
    s = ov.make_overlap(u, ov.OverlapParams(rho=1.0, m=0.3, degree=16, n_ev=2), LAT)
    b = point_source(LAT, 0, 0, (0, 0, 0, 0), device="cpu")
    assert _rel(ov.dov_psi(s, torch.as_tensor(x[0])), b) <= 1e-5
