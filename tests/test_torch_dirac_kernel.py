"""The port's hopping kernel (epilogue none, 18-real), gauge-cotangent
kernel (K2) and differentiable hopping (`HoppingDiff`), their plain
versions, against the JAX reference's Pallas kernels in interpret mode, on
the CPU: one reference VJP of `hopping_diff` at 4^4, as the reference's own
tests run the kernels on the CPU.  The rest of the Dirac operator is in
tests/test_torch_dirac.py; the reference's interpret-mode build has a file
of its own so that the test runner's workers share the load.

Tolerance: ATOL = 1e-5 absolute on unit-normal inputs.  Both sides compute
in f32; an output component sums ~50 products of O(1) numbers in a
different order, so the two differ by f32 rounding of outputs of O(10)
(measured 1e-7 .. 2e-6), while an indexing, sign or phase error is O(1).
"""

import jax
import numpy as np
import pytest
import torch

from tmlqcd_tpu.lattice import Lattice as JLattice
from tmlqcd_tpu.ops import dslash_pallas as jdp
from tmlqcd_tpu.ops import wilson as jw
from tmlqcd_tpu.ops import wilson_fast as jwf
from tmlqcd_tpu_torch import bridge
from tmlqcd_tpu_torch.lattice import Lattice
from tmlqcd_tpu_torch.ops import dslash_cuda as dc

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _quick_reference_compiles():
    """XLA's backend optimisations off while this module runs: the
    reference's programs here take far longer to compile than to run."""
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", False)


ATOL = 1e-5
KAPPA, MU = 0.15, 0.03


def _maxdiff(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


def _gauge(seed, jl):
    return bridge.numpy_su3(np.random.default_rng(seed), (4,) + jl.site_shape)


def _spinor(seed, shape):
    return bridge.numpy_spinor(np.random.default_rng(seed), shape)


# ---------------------------------------------------------------------------
# K2 and HoppingDiff against the reference's hopping_diff VJP (interpret)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def hopping_vjp():
    """One reference VJP of hopping_diff at 4^4, parity 0: its forward is the
    Pallas K1 (none, 18-real), its ug cotangent is the Pallas K2."""
    jl, lat = JLattice((4, 4, 4, 4)), Lattice((4, 4, 4, 4))
    u = _gauge(9, jl)
    fg = jwf.make_fast_gauge(u, jw.DiracParams(kappa=KAPPA, mu=MU), jl, compress=False)
    psi2 = jwf.to_split(_spinor(10, (4, 3) + jl.eo_site_shape))
    g2 = jwf.to_split(_spinor(11, (4, 3) + jl.eo_site_shape))
    out, vjp = jax.vjp(lambda a, b: jdp.hopping_diff(a, fg.ug_odd, b, 0, jl, True),
                       fg.ug_even, psi2)
    dug, dpsi = vjp(g2)
    arrays = dict(ug_e=fg.ug_even, ug_o=fg.ug_odd, psi2=psi2, g2=g2, out=out, dug=dug, dpsi=dpsi)
    return lat, {k: np.array(v) for k, v in arrays.items()}


def test_hopping_plain_none_18real_matches_pallas_kernel(hopping_vjp):
    lat, a = hopping_vjp
    out = dc.hopping_split(torch.as_tensor(a["ug_e"]), torch.as_tensor(a["psi2"]), 0, lat)
    assert _maxdiff(out, a["out"]) < ATOL


def test_ug_vjp_plain_matches_pallas_kernel(hopping_vjp):
    lat, a = hopping_vjp
    out = dc.hopping_ug_vjp(torch.as_tensor(a["g2"]), torch.as_tensor(a["psi2"]), 0, lat)
    assert _maxdiff(out, a["dug"]) < ATOL


def test_hopping_diff_gradients_match_reference_vjp(hopping_vjp):
    lat, a = hopping_vjp
    ug_e = torch.tensor(a["ug_e"], requires_grad=True)
    psi2 = torch.tensor(a["psi2"], requires_grad=True)
    out = dc.HoppingDiff.apply(ug_e, torch.as_tensor(a["ug_o"]), psi2, 0, lat)
    dug, dpsi = torch.autograd.grad(out, (ug_e, psi2), torch.as_tensor(a["g2"]))
    assert _maxdiff(out.detach(), a["out"]) < ATOL
    assert _maxdiff(dug, a["dug"]) < ATOL
    assert _maxdiff(dpsi, a["dpsi"]) < ATOL
