"""The measurements of the port on the ranks of a distributed mesh (4
spawned gloo ranks on the CPU, mesh (2, 2), `tests/dist_ranks.observables`)
against the JAX reference's own jnp functions on the same numpy field, at
4^4: the ranks' whole-lattice values (and their gathered flowed links)
against one process of the reference.  The ranks import no JAX; this
module compiles the reference's small jnp programs with XLA's backend
optimisations off.

Tolerances: the observables are f64 volume sums of f32 link products
(~1e-7 per site), the flow 2 RK3 steps of f32 arithmetic in another order,
the correlators f64 sums of f32 products: each to 1e-5 (relative for t^2 E
and the SF action, absolute for the rest), as tests/test_torch_flow.py and
tests/test_torch_meas.py hold the one-process port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dist_ranks import observables, run_ranks
from tmlqcd_tpu.lattice import Lattice as JLattice
from tmlqcd_tpu.meas import correlators as jcorr
from tmlqcd_tpu.meas import gauge_obs as jobs
from tmlqcd_tpu.meas import gradient_flow as jflow
from tmlqcd_tpu.ops import sf as jsf
from tmlqcd_tpu_torch import bridge

torch.set_num_threads(1)

DIMS = (4, 4, 4, 4)
JL = JLattice(DIMS)
SHAPE = (2, 2)
SEED = 81
SF = dict(beta=6.0, eta=0.3, nu=0.1, ct=1.2)
T0 = 3


@pytest.fixture(scope="module", autouse=True)
def _quick_reference_compiles():
    """XLA's backend optimisations off while this module runs: the
    reference's programs here take far longer to compile than to run."""
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", False)


@pytest.fixture(scope="module")
def fields():
    """The numpy gauge and propagator the ranks build from SEED."""
    gen = np.random.default_rng(SEED)
    u = np.ascontiguousarray(bridge.numpy_su3(gen, (4,) + JL.site_shape))
    return jnp.asarray(u), jnp.asarray(bridge.numpy_spinor(gen, (4, 3) + JL.site_shape))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(observables, SHAPE[0] * SHAPE[1], tmp_path_factory.mktemp("meas_ref"),
                     SHAPE, DIMS, SEED, SF, T0)


def test_polyakov_loops_match_reference(ranks, fields):
    """Along t and y, the two axes the (2, 2) ranks cut."""
    ju = fields[0]
    ref = [complex(jax.jit(lambda u, d=d: jobs.polyakov_loop(u, JL, d))(ju)) for d in (0, 2)]
    assert min(abs(v) for v in ref) > 1e-4
    for r in ranks:
        assert max(abs(a - b) for a, b in zip(r["polyakov"], ref)) < 1e-5


def test_oriented_plaquettes_and_field_strength_match_reference(ranks, fields):
    """The six oriented plaquettes, and E_plaq, E_clover and Q."""
    ju = fields[0]
    plaq = np.asarray(jax.jit(lambda u: jobs.oriented_plaquettes(u, JL))(ju))
    fs = [float(v) for v in jax.jit(lambda u: jobs.field_strength_observables(u, JL))(ju)]
    for r in ranks:
        np.testing.assert_allclose(r["plaquettes"], plaq, atol=1e-5)
        np.testing.assert_allclose(r["field_strength"], fs, atol=1e-5)


def test_wilson_flow_matches_reference(ranks, fields):
    """2 RK3 steps: t^2 E_plaq and t^2 E_clover on every rank, and the
    flowed links the ranks gather."""
    ref = jax.jit(lambda u: jflow.wilson_flow(u, JL, eps=0.02, n_steps=2))(fields[0])
    for r in ranks:
        ep, ec, v = r["flow"]
        np.testing.assert_allclose(ep, np.asarray(ref.t2e_plaq), rtol=1e-5)
        np.testing.assert_allclose(ec, np.asarray(ref.t2e_clover), rtol=1e-5)
        assert float(np.abs(v - np.asarray(ref.v)).max()) < 1e-5


def test_sf_observables_match_reference(ranks, fields):
    """The SF action, dS/deta and k, with the boundary at x0 = 0 on the
    ranks of t = 0 and x0 = T on the ranks of t = 1.  dS/deta against the
    reference on the field in complex128: the port sums its boundary terms
    in f64 (5.6e-8 from it here), the reference's complex64 sum over the
    boundary sites in f32 (1.7e-5 from it)."""
    ref = jax.jit(lambda u: jsf.sf_observables(u, lat=JL, **SF))(fields[0])
    exact = jax.jit(lambda u: jsf.sf_dS_deta(u, lat=JL, **SF))(fields[0].astype(jnp.complex128))
    for r in ranks:
        a, ds, k = r["sf"]
        assert abs(a - float(ref["action"])) < 1e-5 * abs(float(ref["action"]))
        assert abs(ds - float(exact)) < 1e-5 and abs(k - float(ref["k"])) < 1e-12 * float(ref["k"])


def test_correlator_contractions_match_reference(ranks, fields):
    """C_PP and C_PA of an injected propagator, index 0 at t0 = 3: each
    rank's per-timeslice sums placed at its t offset and summed over the
    ranks."""
    psi = fields[1]
    pp = np.asarray(jcorr.pion_correlator(psi, JL, T0))
    pa = np.asarray(jcorr.pa_correlator(psi, JL, T0))
    for r in ranks:
        np.testing.assert_allclose(r["correlators"][0], pp, rtol=1e-5)
        np.testing.assert_allclose(r["correlators"][1], pa, atol=1e-5 * np.max(np.abs(pa)))
