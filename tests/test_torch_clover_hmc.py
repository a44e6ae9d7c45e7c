"""The port's twisted-clover monomials (CLOVERDET, CLOVERDETRATIO,
CLOVERTRLOG) on the CPU: each force against the finite difference of its
action, and the clover state the monomials share.  Their heatbath, action
and force against the JAX reference (tmlqcd_tpu) are in
test_torch_clover_monomials.py (the reference's program for them compiles
for about a minute), the clover inversions and the inverter CLI in
test_torch_clover_invert.py, the clover trajectory and the sample input in
test_torch_clover_traj.py (the reference's trajectory alone compiles for
most of two minutes): files of their own let the test runner's workers
share the load.

The port runs its plain path (CPU tensors): every Dirac application through
the plain clov_inv / clov_mhat epilogues.  The heatbaths run on the
reference's draw of eta.

Tolerance: a force against the central finite difference of the port's own
action along a random algebra direction, eps = 3e-3: 2e-3 relative.  The
action is an f64 sum of f32 fields, so the difference quotient carries
~1e-7 |S| / eps of noise beside its O(eps^2) truncation (measured 1e-4 ..
9e-4).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tmlqcd_tpu import rng as jrng
from tmlqcd_tpu.lattice import Lattice as JLattice
from tmlqcd_tpu_torch import bridge, rng, su3
from tmlqcd_tpu_torch.hmc import monomials
from tmlqcd_tpu_torch.lattice import Lattice
from tmlqcd_tpu_torch.ops import wilson as w
from tmlqcd_tpu_torch.ops import wilson_fast as wf

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
LIGHT = dict(kappa=0.14, mu=0.04, c_sw=1.3)
HEAVY = dict(kappa=0.14, mu=0.3, c_sw=1.3)
TOLS = dict(acc_tol=1e-9, force_tol=1e-9, maxiter=1000)
NAMES = ("cloverdet", "cloverdetratio", "clovertrlog")


def _monomials(mod, lat, params_cls):
    light, heavy = params_cls(**LIGHT), params_cls(**HEAVY)
    return {"cloverdet": mod.CloverDetMonomial(lat=lat, params=light, **TOLS),
            "cloverdetratio": mod.CloverDetRatioMonomial(lat=lat, params1=light, params2=heavy,
                                                         **TOLS),
            "clovertrlog": mod.CloverTrlogMonomial(lat=lat, params=light)}


@pytest.fixture(scope="module")
def gauge():
    u = bridge.numpy_su3(np.random.default_rng(50), (4,) + JL.site_shape)
    return u, bridge.gauge_from_numpy(u, LAT)


@pytest.fixture(scope="module")
def ported(gauge):
    """The port's monomials, their heatbaths on the reference's draw of eta
    (the draw of tests/test_torch_clover_monomials.py)."""
    u, ut = gauge
    mons = _monomials(monomials, LAT, w.DiracParams)
    eta = bridge.spinor_from_numpy(np.asarray(jrng.normal_spinor(
        jax.random.key(51), (4, 3) + JL.eo_site_shape, u.dtype)), LAT)
    out = {}
    for name in ("cloverdet", "cloverdetratio"):
        phi2, s0 = mons[name].heatbath(ut, None, eta)
        out[name] = dict(m=mons[name], phi2=phi2, s0=float(s0))
    out["clovertrlog"] = dict(m=mons["clovertrlog"], phi2=None,
                              s0=float(mons["clovertrlog"].heatbath(ut, None)[1]))
    return out


# ---------------------------------------------------------------------------
# monomials
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_clover_force_matches_finite_difference_of_the_action(gauge, ported, name):
    """dS/dt along dU/dt = P U is -Re<P, F> (H = |P|^2 + S is conserved with
    dP/dt = F / 2)."""
    _, ut = gauge
    m, phi2 = ported[name]["m"], ported[name]["phi2"]
    if name != "clovertrlog":  # solve well below the difference quotient's noise
        m = dataclasses.replace(m, acc_tol=1e-10, force_tol=1e-10)
    mom = rng.random_momenta(rng.Key(52), ut.shape[2:], "cpu")
    pred = -float(torch.sum((torch.conj_physical(mom) * m.force(ut, phi2)).real.double()))
    eps = 3e-3
    s_pm = [float(m.action_info(su3.project_su3(su3.mul(su3.expm_ta(e * mom), ut)), phi2)[0])
            for e in (eps, -eps)]
    fd = (s_pm[0] - s_pm[1]) / (2 * eps)
    assert abs(pred) > 0.5
    assert abs(fd - pred) < 2e-3 * abs(pred)


def test_clover_monomials_share_and_check_their_blocks(gauge):
    _, ut = gauge
    with pytest.raises(ValueError, match="kappa/c_sw must match"):
        monomials.CloverDetRatioMonomial(lat=LAT, params1=w.DiracParams(**LIGHT),
                                         params2=w.DiracParams(kappa=0.14, mu=0.3, c_sw=1.0))
    # Solver = mixedcg is carried: a zero pseudofermion has zero action and
    # needs no iteration; an unknown solver name is refused
    m = monomials.CloverDetMonomial(lat=LAT, params=w.DiracParams(**LIGHT), solver="mixedcg")
    s, iters = m.action_info(ut, torch.zeros((2, 4, 3) + LAT.eo_site_shape))
    assert float(s) == 0.0 and iters == 0
    with pytest.raises(ValueError, match="unknown solver"):
        monomials.CloverDetMonomial(lat=LAT, params=w.DiracParams(**LIGHT), solver="nope") \
            .action_info(ut, torch.zeros((2, 4, 3) + LAT.eo_site_shape))
    # one state serves both operators of the ratio: same gauge copy, the
    # blocks of each mu from one clover term
    st = monomials._CloverState(ut, w.DiracParams(**LIGHT), LAT, grad=False)
    fc1, fc2 = st.fast(w.DiracParams(**LIGHT)), st.fast(w.DiracParams(**HEAVY))
    assert fc1.fg is fc2.fg
    ref = wf.make_fast_clover(ut, w.DiracParams(**HEAVY), LAT)
    assert torch.equal(fc2.moo_m, ref.moo_m) and torch.equal(fc2.mee_inv_p, ref.mee_inv_p)
    assert torch.equal(fc2.fg.ug_odd, ref.fg.ug_odd) and fc2.fg.gcomp == ref.fg.gcomp
