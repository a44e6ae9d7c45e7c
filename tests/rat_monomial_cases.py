"""Shared cases of tests/test_torch_rat_monomials.py and
tests/test_torch_rat_clover.py: the port's rational monomials against the JAX
reference (tmlqcd_tpu) on the CPU, heatbath, action and force.  Not a test
file itself: each of the two files imports the fixtures and tests below and
names its monomials in a `name` fixture, so that the reference's programs,
which compile for a minute per monomial, are spread over two files.

Inputs come from seeded numpy generators through `bridge`, or are the
reference's own draws re-derived from its keys, and go to both packages as
numpy arrays.  The port runs its plain path (CPU tensors): split f32 fields,
every hop of a doublet through the plain multi-RHS version.  The reference
runs its complex jnp operators, as it does on the CPU.

Tolerances, each stated where it is used:
* heatbath fields: 1e-5 absolute on entries of O(1..10); S_0 = |eta|^2 to
  1e-9; actions to 1e-6 relative; equal iteration counts (f64 norms on both
  sides).
* forces: 1e-5 against the reference; against the central finite difference
  of the port's own action along a random algebra direction, eps = 3e-3:
  2e-3 relative (the action is an f64 sum of f32 fields, so the quotient
  carries ~1e-7 |S| / eps of noise beside its O(eps^2) truncation).
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
from tmlqcd_tpu.ops import clover as jcl
from tmlqcd_tpu.ops import ndoublet as jnd
from tmlqcd_tpu.ops.gauge_action import ta_force_from_grad as j_ta_force_from_grad
from tmlqcd_tpu.ops import wilson as jw
from tmlqcd_tpu_torch import bridge, rng, su3
from tmlqcd_tpu_torch.hmc import rational_monomials as rat
from tmlqcd_tpu_torch.lattice import Lattice
from tmlqcd_tpu_torch.ops import ndoublet as nd
from tmlqcd_tpu_torch.ops import wilson as w
from tmlqcd_tpu_torch.ops import wilson_fast as wf

torch.set_num_threads(1)

DIMS = (4, 4, 4, 4)
JL, LAT = JLattice(DIMS), Lattice(DIMS)
ND = dict(kappa=0.13, mubar=0.35, epsbar=0.4)
RATIONAL = dict(order=6, s_min=0.01, s_max=4.7, acc_tol=1e-9, force_tol=1e-9, maxiter=1000)


def _maxdiff(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


def _monomial(name, mod, lat, nd_cls, dirac_cls):
    if name == "ndrat":  # order 4: the reference's own force_info is compiled pole by pole
        return mod.NDRatMonomial(lat=lat, params=nd_cls(**ND), **dict(RATIONAL, order=4))
    if name == "ndcloverrat":
        return mod.NDRatMonomial(lat=lat, params=nd_cls(c_sw=1.3, **ND), **RATIONAL)
    return mod.RatMonomial(lat=lat, params=dirac_cls(kappa=0.13, mu=0.0), **RATIONAL)


@pytest.fixture(scope="module")
def gauge():
    u = bridge.numpy_su3(np.random.default_rng(70), (4,) + JL.site_shape)
    return u, bridge.gauge_from_numpy(u, LAT)


# ---------------------------------------------------------------------------
# the monomials
# ---------------------------------------------------------------------------


def _reference_clover_force(m, u, phi):
    """The reference's NDCLOVERRAT force from the reference's own pieces with
    the clover term built once: its multishift solutions x_j, y_j = Q x_j and
    the surrogate -2 sum_j rho_j Re<y_j, Q(U) x_j> with its complex operator
    under jax.vmap over the poles, then jax.grad and its ta_force_from_grad.
    Its `force_info` is the same sum written pole by pole, each pole with its
    own copy of the clover term, which compiles for minutes on the CPU."""
    rat_ = m.rat
    p = m.params
    xs, iters = m._mms_info(u, phi, rat_.sigma, m.force_tol)
    xs = jax.lax.stop_gradient(xs)
    ys = jax.lax.stop_gradient(jax.vmap(lambda x: m._q(u, x))(xs))

    def surrogate(uu):
        ueo, ph = j_pack(uu, JL), jw.boundary_phases(p.wilson, JL)
        sw_e, sw_o = jcl.sw_blocks_eo(uu, p.kappa, p.c_sw, JL)
        q = jax.vmap(lambda x: jcl.q_nd_clover(ueo, sw_e, sw_o, x, p, JL, ph))(xs)
        dots = jnp.sum((ys.real * q.real + ys.imag * q.imag).astype(jnp.float64),
                       axis=tuple(range(1, q.ndim)))
        return -2.0 * jnp.sum(jnp.asarray(rat_.rho, jnp.float64) * dots)

    return j_ta_force_from_grad(u, jax.grad(surrogate)(u)), iters


@pytest.fixture(scope="module")
def reference(gauge, name):
    """The reference's heatbath draw and field, action with its iteration
    count and force with its, of the monomial `name` in one compiled
    program."""
    u, _ = gauge
    m = _monomial(name, jrat, JL, jnd.NDParams, jw.DiracParams)
    shape = (4, 3) + JL.eo_site_shape if name == "rat" else (2, 4, 3) + JL.eo_site_shape

    def run(u, key):
        eta = jrng.normal_spinor(key, shape, u.dtype)
        phi, s0 = m.heatbath(u, key)
        s, iters = m.action_info(u, phi)
        if name == "ndcloverrat":
            force, fiters = _reference_clover_force(m, u, phi)
        else:
            force, fiters = m.force_info(u, phi)
        return dict(eta=eta, phi=phi, s0=s0, s=s, iters=iters, force=force, fiters=fiters)

    res = jax.jit(run)(jnp.asarray(u), jax.random.key(73))
    return jax.tree_util.tree_map(np.array, res)


@pytest.fixture(scope="module")
def ported(gauge, reference, name):
    """The port's monomial with the reference's eta injected."""
    _, ut = gauge
    m = _monomial(name, rat, LAT, nd.NDParams, w.DiracParams)
    phi2, s0 = m.heatbath(ut, None, torch.as_tensor(reference["eta"]))
    return dict(m=m, phi2=phi2, s0=float(s0))


def test_rational_heatbath_matches_reference(reference, ported):
    """phi = B(Q) eta with the complex factors gamma_l (-i alpha_l) and
    i beta_N as split-field rotations."""
    ref, out = reference, ported
    assert out["phi2"].dtype == torch.float32 and out["phi2"].shape[0] == 2
    assert float(np.max(np.abs(ref["phi"]))) > 1.0
    assert _maxdiff(wf.from_split(out["phi2"]), ref["phi"]) < 1e-5
    eta2 = float(np.sum(np.abs(ref["eta"].astype(np.complex128)) ** 2))
    assert abs(out["s0"] - eta2) < 1e-9 * eta2
    assert abs(float(ref["s0"]) - eta2) < 1e-9 * eta2


def test_rational_action_matches_reference(gauge, reference, ported):
    """Action and multishift iteration count on the reference's phi; S = S_0
    to the rational's own error, since phi was drawn on this gauge field."""
    _, ut = gauge
    ref, m = reference, ported["m"]
    phi2 = wf.to_split(torch.as_tensor(ref["phi"]))
    s, iters = m.action_info(ut, phi2)
    assert iters == int(ref["iters"]) and 10 < iters < 1000
    assert abs(float(s) - float(ref["s"])) < 1e-6 * abs(float(ref["s"]))
    assert abs(float(s) - ported["s0"]) < 1e-5 * ported["s0"]
    assert float(m.action(ut, phi2)) == float(s)


def test_rational_force_matches_reference(gauge, reference, ported):
    _, ut = gauge
    ref, m = reference, ported["m"]
    phi2 = wf.to_split(torch.as_tensor(ref["phi"]))
    out, fiters = m.force_info(ut, phi2)
    assert fiters == int(ref["fiters"]) and fiters > 10
    assert float(np.max(np.abs(ref["force"]))) > 0.01
    assert _maxdiff(out, ref["force"]) < 1e-5
    assert torch.equal(m.force(ut, phi2), out)


def test_rational_force_matches_finite_difference_of_the_action(gauge, ported):
    """dS/dt along dU/dt = P U is -Re<P, F>."""
    _, ut = gauge
    m = dataclasses.replace(ported["m"], acc_tol=1e-10, force_tol=1e-10)
    phi2 = ported["phi2"]
    mom = rng.random_momenta(rng.Key(74), ut.shape[2:], "cpu")
    pred = -float(torch.sum((torch.conj_physical(mom) * m.force(ut, phi2)).real.double()))
    eps = 3e-3
    s_pm = [float(m.action_info(su3.project_su3(su3.mul(su3.expm_ta(e * mom), ut)), phi2)[0])
            for e in (eps, -eps)]
    fd = (s_pm[0] - s_pm[1]) / (2 * eps)
    assert abs(pred) > 0.5
    assert abs(fd - pred) < 2e-3 * abs(pred)
