"""Parity of the port's rational solves with the JAX reference
(tmlqcd_tpu), on the CPU: the multishift CG on the doublet, the spectral
bounds with the interval check, and the correction monomial NDRATCOR.  The
rational approximation and the lowering of the rational monomials are in
tests/test_torch_rat.py; these compile the reference's solvers and have a
file of their own so that the test runner's workers share the load.

Inputs come from seeded numpy generators through `bridge`, or are the
reference's own draws re-derived from its keys, and go to both packages as
numpy arrays.  The port runs its plain path (CPU tensors): split f32 fields,
every hop of a doublet through the plain multi-RHS version.  The reference
runs its complex jnp operators, as it does on the CPU.

Tolerances, each stated where it is used:
* multishift solutions: 1e-5 absolute on entries of O(1..10); equal
  iteration counts (f64 norms on both sides); actions to 1e-6 relative.
* Rayleigh quotients from the same start vector: 1e-4 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmlqcd_tpu import rng as jrng
from tmlqcd_tpu.hmc import rational_monomials as jrat
from tmlqcd_tpu.lattice import Lattice as JLattice
from tmlqcd_tpu.lattice import pack_gauge_eo as j_pack
from tmlqcd_tpu.ops import ndoublet as jnd
from tmlqcd_tpu.ops import wilson as jw
from tmlqcd_tpu.solvers import eigen as jeigen
from tmlqcd_tpu.solvers.multishift import cg_multishift as j_cg_multishift
from tmlqcd_tpu_torch import bridge, rng
from tmlqcd_tpu_torch.hmc import rational_monomials as rat
from tmlqcd_tpu_torch.hmc.validate import check_rational_intervals
from tmlqcd_tpu_torch.lattice import Lattice
from tmlqcd_tpu_torch.ops import ndoublet as nd
from tmlqcd_tpu_torch.ops import wilson as w
from tmlqcd_tpu_torch.ops import wilson_fast as wf
from tmlqcd_tpu_torch.solvers import eigen, rational
from tmlqcd_tpu_torch.solvers.multishift import cg_multishift

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _quick_reference_compiles():
    """XLA's backend optimisations off while this module runs: the
    reference's programs here take far longer to compile than to run."""
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", False)


DIMS = (4, 4, 4, 4)
JL, LAT = JLattice(DIMS), Lattice(DIMS)
ND = dict(kappa=0.13, mubar=0.35, epsbar=0.4)
RATIONAL = dict(order=6, s_min=0.01, s_max=4.7, acc_tol=1e-9, force_tol=1e-9, maxiter=1000)


def _maxdiff(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


@pytest.fixture(scope="module")
def gauge():
    u = bridge.numpy_su3(np.random.default_rng(70), (4,) + JL.site_shape)
    return u, bridge.gauge_from_numpy(u, LAT)


# ---------------------------------------------------------------------------
# multishift CG and the spectral bounds on Q_nd^2
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def doublet_system(gauge):
    u, ut = gauge
    jp, tp = jnd.NDParams(**ND), nd.NDParams(**ND)
    b = bridge.numpy_spinor(np.random.default_rng(71), (2, 4, 3) + JL.eo_site_shape)
    jueo, jph = j_pack(jnp.asarray(u), JL), jw.boundary_phases(jp.wilson, JL)
    # compiled once: the reference's solvers trace their operator at every
    # call site, which a jitted function serves from its trace cache
    jmv = jax.jit(lambda x: jnd.q_nd_sq(jueo, x, jp, JL, jph))
    fg = wf.make_fast_gauge(ut, tp.wilson, LAT)
    mv = lambda x2: wf.q_nd_sq_fast(fg, x2, tp, LAT)  # noqa: E731
    return dict(b=b, jmv=jmv, mv=mv, b2=wf.to_split(bridge.doublet_from_numpy(b, LAT)))


def test_cg_multishift_matches_reference(doublet_system):
    """Shifted solutions on Q_nd^2 to 1e-5, the same iteration count, and
    every shifted residual checked with the port's operator."""
    shifts = rational.rational_invsqrt(6, 0.01, 4.7).sigma
    ref = jax.jit(lambda b: j_cg_multishift(doublet_system["jmv"], b, jnp.asarray(shifts),
                                            tol=1e-8, maxiter=500))(jnp.asarray(doublet_system["b"]))
    b2, mv = doublet_system["b2"], doublet_system["mv"]
    out = cg_multishift(mv, b2, shifts, tol=1e-8, maxiter=500)
    assert out.iterations == int(ref.iterations) and 10 < out.iterations < 500
    assert tuple(out.x.shape) == (6,) + tuple(b2.shape)
    assert abs(out.residual_sq - float(ref.residual_sq)) < 1e-3 * float(ref.residual_sq)
    bnorm = float(torch.linalg.vector_norm(b2))
    for j, sigma in enumerate(shifts):
        assert _maxdiff(wf.from_split(out.x[j]), ref.x[j]) < 1e-5
        res = mv(out.x[j]) + float(sigma) * out.x[j] - b2
        # f32 fields: a few 1e-7 |b| beyond the requested 1e-8
        assert float(torch.linalg.vector_norm(res)) < 2e-6 * bnorm
    # the largest shift converges first: its solution is the smallest
    norms = [float(torch.linalg.vector_norm(out.x[j])) for j in range(6)]
    assert norms == sorted(norms, reverse=True)
    capped = cg_multishift(mv, b2, shifts, tol=1e-8, maxiter=3)
    assert capped.iterations == 3 and capped.residual_sq > out.residual_sq
    absolute = cg_multishift(mv, b2, shifts, tol=1e-3 * bnorm, maxiter=500, rel_prec=False)
    assert absolute.iterations == cg_multishift(mv, b2, shifts, tol=1e-3, maxiter=500).iterations


def test_spectral_bounds_match_reference(doublet_system):
    """Power iteration (20 steps) and inverse iteration (one CG solve) from
    the reference's own start vector: the Rayleigh quotients agree to 1e-4
    (f32 fields, f64 quotients).  The full estimates bracket those and every
    other Rayleigh quotient."""
    shape = (2, 4, 3) + LAT.eo_site_shape
    mv, jmv = doublet_system["mv"], doublet_system["jmv"]
    key = jax.random.key(72)
    v0 = torch.as_tensor(np.array(jrng.normal_spinor(key, shape, jnp.complex64)))
    ref_max = float(jax.jit(lambda k: jeigen.lambda_max(jmv, shape, k, iters=20))(key))
    ref_min = float(jax.jit(lambda k: jeigen.lambda_min(jmv, shape, k, iters=1))(key))
    out_max = eigen.lambda_max(mv, shape, rng.Key(0), device="cpu", iters=20, split=True, v0=v0)
    out_min = eigen.lambda_min(mv, shape, rng.Key(0), device="cpu", iters=1, split=True, v0=v0)
    assert abs(out_max - ref_max) < 1e-4 * ref_max and abs(out_min - ref_min) < 1e-4 * ref_min
    lmin, lmax = eigen.spectral_bounds(mv, shape, rng.Key(72), device="cpu", safety=1.0, split=True)
    assert 0.0 < lmin <= out_min * (1 + 1e-6) and out_max <= lmax * (1 + 1e-6)
    b2 = doublet_system["b2"]
    rq = float(wf.dot_re_f64_split(b2, mv(b2)) / wf.dot_re_f64_split(b2, b2))
    assert lmin < rq < lmax < 1.1 * out_max
    padded = eigen.spectral_bounds(mv, shape, rng.Key(72), device="cpu", safety=1.3, split=True)
    assert padded == (lmin / 1.3, lmax * 1.3)


# ---------------------------------------------------------------------------
# the correction monomial, the reweighting samples, the interval check
# ---------------------------------------------------------------------------


def test_ndratcor_action_matches_reference(gauge):
    """The correction monomial at n_terms = 2: the action phi^+ Z^{-1/2} phi
    and its summed iteration count on the port's heatbath field phi = Z^{1/4}
    eta against the reference's action on the same field (S = |eta|^2 to the
    series' truncation); zero force."""
    u, ut = gauge
    kw = dict(RATIONAL, n_terms=2)
    jm = jrat.NDRatCorMonomial(lat=JL, params=jnd.NDParams(**ND), **kw)
    m = rat.NDRatCorMonomial(lat=LAT, params=nd.NDParams(**ND), **kw)
    eta = bridge.doublet_from_numpy(
        bridge.numpy_spinor(np.random.default_rng(73), (2, 4, 3) + LAT.eo_site_shape), LAT)
    phi2, s0 = m.heatbath(ut, None, eta)
    eta_sq = float(torch.sum(torch.view_as_real(eta).double() ** 2))
    assert abs(float(s0) - eta_sq) < 1e-9 * eta_sq
    s, iters = jax.jit(jm.action_info)(jnp.asarray(u),
                                       jnp.asarray(bridge.to_numpy(wf.from_split(phi2))))
    out_s, out_iters = m.action_info(ut, phi2)
    assert out_iters == int(iters) and out_iters > 40  # four multishift solves
    assert abs(float(out_s) - float(s)) < 1e-6 * float(s)
    assert abs(float(out_s) - float(s0)) < 1e-4 * float(s0)
    f, fiters = m.force_info(ut, phi2)
    assert fiters == 0 and float(f.abs().max()) == 0.0 and m.name == "ndratcor"
    with pytest.raises(ValueError, match="requires mu == 0"):
        rat.RatMonomial(lat=LAT, params=w.DiracParams(kappa=0.13, mu=0.1))


def test_ndrat_correction_samples_are_small(gauge):
    """The reweighting exponent of an order-6 rational against order 8 is of
    the size of its relative error times |eta|^2."""
    _, ut = gauge
    m = rat.NDRatMonomial(lat=LAT, params=nd.NDParams(**ND), **RATIONAL)
    s = rat.ndrat_correction_samples(m, ut, rng.Key(75), n_samples=1, order_hi=8)
    assert tuple(s.shape) == (1,) and s.dtype == torch.float64
    # |eta|^2 ~ 2 * 12 * V / 2 complex components
    assert float(s.abs().max()) < 10 * m.rat.max_rel_err * 12 * LAT.volume
    assert float(s.abs().max()) > 0.0


def test_interval_check_reports_and_raises(gauge, capsys):
    _, ut = gauge
    good = rat.NDRatMonomial(lat=LAT, params=nd.NDParams(**ND), **RATIONAL)
    bad = dataclasses.replace(good, s_min=1.0, name="narrow")
    one = rat.RatMonomial(lat=LAT, params=w.DiracParams(kappa=0.13, mu=0.0), **RATIONAL)
    res = check_rational_intervals([good, bad, one, object()], ut)
    out = capsys.readouterr().out
    assert [r.ok for r in res] == [True, False, True] and [r.name for r in res] == \
        ["ndrat", "narrow", "rat"]
    assert "[validate] ndrat: spec(Q^2) ~ [" in out and "WARNING: monomial narrow" in out
    assert 0.01 < res[0].lambda_min < res[0].lambda_max < 4.7
    with pytest.raises(ValueError, match="NOT bracketed"):
        check_rational_intervals([bad], ut, strict=True)
