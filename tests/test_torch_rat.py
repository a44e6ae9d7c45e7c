"""Parity of the port's rational machinery with the JAX reference
(tmlqcd_tpu), on the CPU: the Zolotarev-type rational approximation and the
lowering of the rational monomials from an input file.  The multishift CG,
the spectral bounds with the interval check and NDRATCOR are in
test_torch_rat_spectrum.py; the monomials' heatbath, action and force in
test_torch_rat_monomials.py.

Tolerance: rational coefficients 1e-14 relative (the same f64 numpy
arithmetic).
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from tmlqcd_tpu import config as jconfig
from tmlqcd_tpu import config_tmlqcd as jconfig_tmlqcd
from tmlqcd_tpu.solvers import rational as jrational
from tmlqcd_tpu_torch import bridge, config, config_tmlqcd
from tmlqcd_tpu_torch.solvers import rational

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _quick_reference_compiles():
    """XLA's backend optimisations off while this module runs: the
    reference's programs here take far longer to compile than to run."""
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", False)
SAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "sample-input")


# ---------------------------------------------------------------------------
# the rational approximation (host f64)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("order, s_min, s_max", [(6, 0.01, 4.7), (10, 0.01, 4.7), (12, 1e-4, 4.0)])
def test_rational_invsqrt_matches_reference(order, s_min, s_max):
    """The port's copy of the construction: every coefficient to 1e-14."""
    ref = jrational.rational_invsqrt(order, s_min, s_max)
    out = rational.rational_invsqrt(order, s_min, s_max)
    for name in ("sigma", "rho", "a_roots"):
        np.testing.assert_allclose(getattr(out, name), getattr(ref, name), rtol=1e-14, atol=0)
    assert abs(out.rho_lead - ref.rho_lead) <= 1e-14 * ref.rho_lead
    assert abs(out.max_rel_err - ref.max_rel_err) <= 1e-14
    for a, b in zip(out.heatbath_parts(), ref.heatbath_parts()):
        np.testing.assert_allclose(a, b, rtol=1e-14, atol=0)
    xs = np.geomspace(s_min, s_max, 101)
    assert np.max(np.abs(np.sqrt(xs) * out(xs) - 1.0)) <= out.max_rel_err * (1 + 1e-9)
    assert out.max_rel_err < 3e-3
    assert bridge.rational_from(ref).sigma.tolist() == out.sigma.tolist()


def test_elliptic_functions_match_reference():
    """At the moduli the two intervals above give, kappa^2 = 1 - m / M."""
    for m, bigm in ((0.01, 4.7), (1e-4, 4.0)):
        k = float(np.sqrt(1.0 - m / bigm))
        bigk = rational.elliptic_k(k)
        assert bigk == jrational.elliptic_k(k) and bigk > np.pi / 2
        for u in (0.1 * bigk, 0.5 * bigk, 0.9 * bigk):
            sn, cn, dn = rational.jacobi_sn_cn_dn(u, k)
            assert (sn, cn, dn) == jrational.jacobi_sn_cn_dn(u, k)
            assert abs(sn * sn + cn * cn - 1.0) < 1e-12
            assert abs(dn * dn + k * k * sn * sn - 1.0) < 1e-12
    assert rational.jacobi_sn_cn_dn(0.3, 0.0) == (float(np.sin(0.3)), float(np.cos(0.3)), 1.0)
    with pytest.raises(ValueError, match="diverges"):
        rational.elliptic_k(1.0)
    with pytest.raises(ValueError, match="s_min < s_max"):
        rational.rational_invsqrt(4, 1.0, 0.5)


# ---------------------------------------------------------------------------
# input
# ---------------------------------------------------------------------------

_TYPES = ["NDRAT", "NDCLOVERRAT", "NDRATCOR", "NDCLOVERRATCOR", "RAT", "CLOVERRAT", "RATCOR",
          "CLOVERRATCOR"]


@pytest.mark.parametrize("ty", _TYPES)
def test_rational_monomials_lower_like_the_reference(ty):
    text = (f"L = 4\nT = 4\nNumberOfTimescales = 2\nBeginMonomial GAUGE\n Timescale = 0\n"
            f"EndMonomial\nBeginMonomial {ty}\n Timescale = 1\n kappa = 0.13\n CSW = 1.2\n"
            f" 2Kappamubar = 0.1\n 2Kappaepsbar = 0.12\n DegreeOfRational = 7\n StildeMin = 0.02\n"
            f" StildeMax = 4.5\n AcceptancePrecision = 1e-18\n ForcePrecision = 1e-14\n"
            f" MaxSolverIterations = 700\nEndMonomial\n")
    out = config.build_hmc(config_tmlqcd.parse_input(text)).monomials[1]
    ref = jconfig.build_hmc(jconfig_tmlqcd.parse_input(text)).monomials[1]
    assert type(out).__name__ == type(ref).__name__
    for field in ("order", "s_min", "s_max", "timescale", "acc_tol", "force_tol", "maxiter", "name"):
        assert getattr(out, field) == getattr(ref, field)
    assert getattr(out, "n_terms", None) == getattr(ref, "n_terms", None)
    assert dataclasses.asdict(out.params) == dataclasses.asdict(ref.params)
    assert out.params.c_sw == 1.2 and not hasattr(out, "chrono_init_state")


def test_hmc3_lowers_to_the_reference_monomials():
    """hmc3 as shipped, its GRADIENTFLOW block included, builds the
    reference's monomials."""
    with open(os.path.join(SAMPLES, "hmc3-nf211-clover.input")) as f:
        text = f.read()
    cfg = config_tmlqcd.parse_input(text)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jconfig_tmlqcd.parse_input(text))
    assert [(m.type, m.frequency, m.flow_eps, m.flow_steps) for m in cfg.meas] == \
        [("GRADIENTFLOW", 10, 0.02, 50)]
    out = config.build_hmc(cfg)
    ref = jconfig.build_hmc(jconfig_tmlqcd.parse_input(text))
    assert out.lat.dims == ref.lat.dims == (48, 24, 24, 24)
    assert [type(m).__name__ for m in out.monomials] == [type(m).__name__ for m in ref.monomials] \
        == ["GaugeMonomial", "CloverTrlogMonomial", "CloverDetMonomial", "NDRatMonomial"]
    mo, mr = out.monomials[3], ref.monomials[3]
    assert dataclasses.asdict(mo.params) == dataclasses.asdict(mr.params)
    assert (mo.order, mo.s_min, mo.s_max, mo.timescale) == (10, 0.01, 4.7, 2)
    assert (mo.acc_tol, mo.force_tol, mo.maxiter) == (mr.acc_tol, mr.force_tol, mr.maxiter)
    assert [(lv.scheme, lv.steps) for lv in out.integrator.levels] == \
        [(lv.scheme, lv.steps) for lv in ref.integrator.levels] == [("2mn", 2), ("2mn", 3),
                                                                    ("2mn", 6)]
