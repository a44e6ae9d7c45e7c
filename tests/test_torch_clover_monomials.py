"""Parity of the port's twisted-clover monomials (CLOVERDET,
CLOVERDETRATIO, CLOVERTRLOG) with the JAX reference (tmlqcd_tpu), on the
CPU: heatbath, action with its acceptance-solve iteration count, and force
on one gauge field, the reference's draws injected.  The finite-difference
check of the forces, the inversions and the inverter CLI are in
test_torch_clover_hmc.py.

The port runs its plain path (CPU tensors): every Dirac application through
the plain clov_inv / clov_mhat epilogues.  The reference runs its complex
jnp clover operator, as it does on the CPU.

Tolerances: heatbath fields and forces 1e-5 absolute on entries of
O(1..10) (f32 operators, f64 sums; measured 1.1e-6 .. 1.2e-6); S_0 =
|eta|^2 to 1e-9 (both f64 sums of the same f32 numbers); actions to 1e-6
relative (f32 CG solutions in an f64 dot).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmlqcd_tpu import rng as jrng
from tmlqcd_tpu.hmc import monomials as jmono
from tmlqcd_tpu.lattice import Lattice as JLattice
from tmlqcd_tpu.ops import wilson as jw
from tmlqcd_tpu_torch import bridge
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


def _maxdiff(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


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
def reference(gauge):
    """The reference's heatbath draws and fields, actions with their
    iteration counts and forces of the three clover monomials on one gauge
    field, in one compiled program (jax.grad through sw_blocks compiles
    slowly on the CPU, so it is compiled once for all tests)."""
    u, _ = gauge
    mons = _monomials(jmono, JL, jw.DiracParams)

    def run(u, key):
        out = {}
        for name in ("cloverdet", "cloverdetratio"):
            m = mons[name]
            eta = jrng.normal_spinor(key, (4, 3) + JL.eo_site_shape, u.dtype)
            phi, s0 = m.heatbath(u, key)
            s, iters = m.action_info(u, phi)
            out[name] = dict(eta=eta, phi=phi, s0=s0, s=s, iters=iters, force=m.force(u, phi))
        m = mons["clovertrlog"]
        out["clovertrlog"] = dict(s=m.action(u, None), force=m.force(u, None))
        return out

    res = jax.jit(run)(jnp.asarray(u), jax.random.key(51))
    return jax.tree_util.tree_map(np.asarray, res)


@pytest.fixture(scope="module")
def ported(gauge, reference):
    """The port's monomials with the reference's eta injected."""
    _, ut = gauge
    mons = _monomials(monomials, LAT, w.DiracParams)
    out = {}
    for name in ("cloverdet", "cloverdetratio"):
        eta = bridge.spinor_from_numpy(reference[name]["eta"], LAT)
        phi2, s0 = mons[name].heatbath(ut, None, eta)
        out[name] = dict(m=mons[name], phi2=phi2, s0=float(s0))
    out["clovertrlog"] = dict(m=mons["clovertrlog"], phi2=None,
                              s0=float(mons["clovertrlog"].heatbath(ut, None)[1]))
    return out


# ---------------------------------------------------------------------------
# monomials
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES[:2])
def test_clover_heatbath_matches_reference(reference, ported, name):
    ref, out = reference[name], ported[name]
    assert _maxdiff(wf.from_split(out["phi2"]), ref["phi"]) < 1e-5
    eta2 = float(np.sum(np.abs(ref["eta"].astype(np.complex128)) ** 2))
    assert abs(out["s0"] - eta2) < 1e-9 * eta2
    assert abs(float(ref["s0"]) - eta2) < 1e-9 * eta2


@pytest.mark.parametrize("name", NAMES)
def test_clover_action_matches_reference(gauge, reference, ported, name):
    """Action and acceptance-solve iteration count on the reference's phi."""
    _, ut = gauge
    ref, m = reference[name], ported[name]["m"]
    if name == "clovertrlog":
        s, iters = m.action_info(ut, None)
        assert iters == 0 and abs(ported[name]["s0"] - float(s)) == 0.0
    else:
        phi2 = wf.to_split(bridge.spinor_from_numpy(ref["phi"], LAT))
        s, iters = m.action_info(ut, phi2)
        assert iters == int(ref["iters"]) and 10 < iters < 1000
        # S = |eta|^2 again: phi was drawn from this gauge field
        assert abs(float(s) - ported[name]["s0"]) < 1e-5 * ported[name]["s0"]
    assert abs(float(ref["s"])) > 1.0
    assert abs(float(s) - float(ref["s"])) < 1e-6 * abs(float(ref["s"]))


@pytest.mark.parametrize("name", NAMES)
def test_clover_force_matches_reference(gauge, reference, ported, name):
    _, ut = gauge
    ref, m = reference[name], ported[name]["m"]
    phi2 = None if name == "clovertrlog" else wf.to_split(
        bridge.spinor_from_numpy(ref["phi"], LAT))
    out = m.force(ut, phi2)
    assert float(np.max(np.abs(ref["force"]))) > 0.01
    assert _maxdiff(out, ref["force"]) < 1e-5
