"""The HMC monomials with the mixed-precision solvers (`Solver = mixedcg |
rgmixedcg`, the low operator on the bf16 gauge copy) against the port's own
CG route, on the CPU at 4^4: heatbath, action and force of DET, DETRATIO
and CLOVERDET, and one GAUGE + DETRATIO trajectory with the same
draws.  The CG route is held to the JAX reference by
tests/test_torch_hmc.py and tests/test_torch_clover_hmc.py.

Tolerances: both routes stop at |r| <= 2e-7 |b|, just above where the true
residual of f32 fields floors (|r| / |b| ~ 1e-7 here, ~1.3e-7 for the
clover operator; below it the defect correction runs to its 50 outer steps
and the reliable updates to maxiter), so their solutions differ by ~2e-7
relative times the condition number of the light operator (mu = 0.05):
actions and forces agree to 1e-5 relative.  The trajectory's |ddH| <= 1e-4 at |H| ~ 1e4: the same
difference carried through the force and acceptance solves, against O(1) for
a wrong operator.
"""

import numpy as np
import pytest
import torch

from tmlqcd_tpu_torch import bridge, config, config_tmlqcd, rng
from tmlqcd_tpu_torch.hmc import Draws, hmc_trajectory, monomials
from tmlqcd_tpu_torch.lattice import Lattice
from tmlqcd_tpu_torch.ops import dslash_cuda as dc
from tmlqcd_tpu_torch.ops import wilson as w

torch.set_num_threads(1)

LAT = Lattice((4, 4, 4, 4))
LIGHT = dict(kappa=0.13, mu=0.05)
HEAVY = dict(kappa=0.13, mu=0.2)
TOLS = dict(acc_tol=2e-7, force_tol=2e-7, maxiter=1000)


def _rel(a, b) -> float:
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    return float((a - b).abs().max() / b.abs().max())


@pytest.fixture(scope="module")
def state():
    u = bridge.gauge_from_numpy(bridge.numpy_su3(np.random.default_rng(60),
                                                 (4,) + LAT.site_shape), LAT)
    eta = torch.as_tensor(bridge.numpy_spinor(np.random.default_rng(61),
                                              (4, 3) + LAT.eo_site_shape))
    return u, eta


def _monomial(kind, solver):
    if kind == "det":
        return monomials.DetMonomial(lat=LAT, params=w.DiracParams(**LIGHT), solver=solver,
                                     chrono_n=0, **TOLS)
    if kind == "detratio":
        return monomials.DetRatioMonomial(lat=LAT, params1=w.DiracParams(**LIGHT),
                                          params2=w.DiracParams(**HEAVY), solver=solver,
                                          chrono_n=0, **TOLS)
    return monomials.CloverDetMonomial(lat=LAT, params=w.DiracParams(**LIGHT, c_sw=1.2),
                                       solver=solver, chrono_n=0, **TOLS)


@pytest.fixture(scope="module")
def cg_route(state):
    """Heatbath field, action, iterations and force of each monomial on the
    CG route, computed once for both mixed solvers."""
    u, eta = state
    out = {}
    for kind in ("det", "detratio", "cloverdet"):
        m = _monomial(kind, "cg")
        phi, s0 = m.heatbath(u, None, eta)
        s, n = m.action_info(u, phi)
        out[kind] = dict(phi=phi, s0=float(s0), s=float(s), n=n, f=m.force(u, phi))
    return out


@pytest.mark.parametrize("solver", ["mixedcg", "rgmixedcg"])
@pytest.mark.parametrize("kind", ["det", "detratio", "cloverdet"])
def test_mixed_monomial_matches_cg_route(state, cg_route, kind, solver):
    u, eta = state
    ref, mixed = cg_route[kind], _monomial(kind, solver)
    dc.reset_counters()
    phi, s0 = mixed.heatbath(u, None, eta)
    assert _rel(phi, ref["phi"]) < 1e-5 and float(s0) == ref["s0"]
    calls = dc.hopping_split_plain.calls
    s, n = mixed.action_info(u, ref["phi"])
    assert abs(float(s) - ref["s"]) < 1e-5 * abs(ref["s"])
    assert n >= ref["n"] > 5  # inner iterations on the bf16 copy, at least CG's
    assert dc.hopping_split_plain.calls - calls >= 4 * n
    assert _rel(mixed.force(u, ref["phi"]), ref["f"]) < 1e-5


_TRAJ_INPUT = """L = 4
T = 4
beta = 5.3
tau = 1.0
NumberOfTimescales = 2
BeginMonomial GAUGE
  Timescale = 0
  IntegrationSteps = 1
EndMonomial
BeginMonomial DETRATIO
  Timescale = 1
  kappa = 0.13
  2KappaMu = 0.0026
  2KappaMu2 = 0.026
  AcceptancePrecision = 1e-14
  ForcePrecision = 1e-14
  MaxSolverIterations = 1000
  Solver = {solver}
  IntegrationSteps = 1
EndMonomial
"""


def test_mixedcg_trajectory_matches_cg_trajectory(state):
    """One GAUGE + DETRATIO trajectory lowered from the same input with
    Solver = mixedcg and Solver = cg, the same draws: |ddH| <= 1e-4, the
    same plaquette."""
    u, _ = state
    key = rng.Key(7)
    cfgs = {s: config.build_hmc(config_tmlqcd.parse_input(_TRAJ_INPUT.format(solver=s)))
            for s in ("cg", "mixedcg")}
    assert [m.solver for m in cfgs["mixedcg"].monomials[1:]] == ["mixedcg"]
    shape = (4, 3) + LAT.eo_site_shape
    draws = Draws(rng.random_momenta(key.fold(0), u.shape[2:], "cpu"),
                  [None, rng.normal_spinor(key.fold(1, 1), shape, "cpu")],
                  rng.uniform(key.fold(2), "cpu"))
    out = {}
    for s, cfg in cfgs.items():
        with torch.no_grad():
            out[s] = hmc_trajectory(cfg, u, key, draws=draws)
    (u_cg, st_cg), (u_mx, st_mx) = out["cg"], out["mixedcg"]
    assert abs(st_mx.delta_h - st_cg.delta_h) < 1e-4
    assert abs(st_mx.plaquette - st_cg.plaquette) < 1e-6
    assert float((u_mx - u_cg).abs().max()) < 1e-5
    assert all(m >= c for m, c in zip(st_mx.force_iterations, st_cg.force_iterations))
