"""Independent chains on one device (`parallel.chain_init`,
`parallel.parallel_chains`): the port's counterpart of the reference's
`tests/test_aux.py::test_parallel_chains_match_single`, and the chains
against the reference's vmapped `parallel_chains` with its draws injected.

4^4, GAUGE at beta 5.5, 2MN with 3 steps (the reference test's input).
Tolerances: the port's chains equal its single trajectories bit for bit
(the same calls in a loop); against the reference, which runs the same f32
trajectory in another summation order, |ddH| <= 1e-3 and the gauge to 1e-4
(the bounds of tests/test_torch_hmc_traj.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmlqcd_tpu import config as jconfig
from tmlqcd_tpu import parallel as jparallel
from tmlqcd_tpu import rng as jrng
from tmlqcd_tpu import su3 as jsu3
from tmlqcd_tpu.lattice import Lattice as JLattice
from tmlqcd_tpu_torch import config, parallel, rng, su3
from tmlqcd_tpu_torch.hmc import Draws, hmc_trajectory
from tmlqcd_tpu_torch.lattice import Lattice

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _quick_reference_compiles():
    """XLA's backend optimisations off while this module runs: the
    reference's programs here take far longer to compile than to run."""
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", False)


LAT, JL = Lattice((4, 4, 4, 4)), JLattice((4, 4, 4, 4))


def _run_config(mod):
    return mod.RunConfig(monomials=(mod.MonomialSpec(type="GAUGE"),),
                         integrator=mod.IntegratorSpec(tau=1.0, steps=(3,)), beta=5.5)


def test_parallel_chains_match_single():
    """Chain c with key k equals a single trajectory from the same (u, k)."""
    cfg = config.build_hmc(_run_config(config))
    us = parallel.chain_init(3, lambda k: su3.random_su3(rng.generator(k, "cpu"),
                                                         (4,) + LAT.site_shape), rng.Key(7))
    assert us.shape == (3, 3, 3, 4) + LAT.site_shape
    assert not torch.equal(us[0], us[1])
    keys = [rng.Key(8).fold(c) for c in range(3)]
    with torch.no_grad():
        u_out, stats = parallel.parallel_chains(cfg, us, keys)
        for c in (0, 2):
            u_c, st = hmc_trajectory(cfg, us[c], keys[c])
            assert torch.equal(u_out[c], u_c)
            assert stats.delta_h[c] == st.delta_h and stats.accepted[c] == st.accepted
    assert stats.delta_h.shape == (3,) and stats.acc_iterations.shape == (3, 1)


def test_parallel_chains_match_reference():
    """The reference's vmapped chains from its chain_init, and the port's
    loop from the same starts with the reference's draws injected."""
    cfg_ref = jconfig.build_hmc(_run_config(jconfig))
    us = jparallel.chain_init(2, lambda k: jsu3.random_su3(k, (4,) + JL.site_shape, jnp.complex64),
                              jax.random.key(7))
    keys = jax.random.split(jax.random.key(8), 2)

    def reference(us, keys):
        u_out, stats = jparallel.parallel_chains(cfg_ref, us, keys)
        # each chain's draws, re-derived from its key (hmc/trajectory.py:97-100)
        k3 = jax.vmap(lambda k: jax.random.split(k, 3))(keys)
        mom = jax.vmap(lambda k: jsu3.random_momenta(k, us.shape[3:], jnp.complex64))(k3[:, 0])
        return u_out, stats, mom, jax.vmap(jrng.uniform)(k3[:, 2])

    u_ref, st_ref, mom, uni = jax.jit(reference)(us, keys)
    draws = [Draws(torch.as_tensor(np.array(mom[c])), [None], float(uni[c])) for c in range(2)]
    cfg = config.build_hmc(_run_config(config))
    with torch.no_grad():
        u_out, stats = parallel.parallel_chains(cfg, torch.as_tensor(np.array(us)),
                                                [rng.Key(0)] * 2, draws=draws)
    np.testing.assert_allclose(stats.delta_h, np.asarray(st_ref.delta_h), rtol=0, atol=1e-3)
    np.testing.assert_array_equal(stats.accepted, np.asarray(st_ref.accepted))
    assert float(np.max(np.abs(u_out.numpy() - np.asarray(u_ref)))) <= 1e-4
