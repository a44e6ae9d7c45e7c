"""The inverter's mixed solvers, incremental eigCG and the clover
inverter's solver names against the JAX reference (tmlqcd_tpu) on the
CPU.  The deflation preconditioner, the deflated solvers and `cli.invert
--cpu` with each solver are in tests/test_torch_deflation.py, on the same
system.

The reference solves the odd-site system of its invert_eo (its steps 1 and
2, then its cg) on jitted operators; the port's whole `invert_eo` is
compared on the odd sites, and its full-lattice solution by its true
residual.  `fastmixed` runs the bf16 copy where the reference runs
complex64 off the TPU, so it is held to the reference's CG solution.

Tolerances: solutions 1e-5 absolute on entries of O(1) (the inverter bound
of tests/test_torch_invert.py); true residuals |M x - b| / |b| <= 1e-5 at
tol 1e-7 on f32 fields.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmlqcd_tpu.gamma import apply_gamma5 as j_gamma5
from tmlqcd_tpu.lattice import Lattice as JLattice
from tmlqcd_tpu.lattice import eo_pack as j_eo_pack
from tmlqcd_tpu.lattice import pack_gauge_eo as j_pack
from tmlqcd_tpu.ops import wilson as jw
from tmlqcd_tpu.solvers.cg import cg as j_cg
from tmlqcd_tpu_torch import bridge
from tmlqcd_tpu_torch.inverter import invert_clover_eo, invert_eo, invert_eo_increigcg
from tmlqcd_tpu_torch.lattice import Lattice, eo_pack
from tmlqcd_tpu_torch.ops import clover as cl
from tmlqcd_tpu_torch.ops import dslash_cuda as dc
from tmlqcd_tpu_torch.ops import wilson as w

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
P = dict(kappa=0.15, mu=0.01)
JP, TP = jw.DiracParams(**P), w.DiracParams(**P)
TOL = 1e-7


def _maxdiff(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


def _true_residual(ut, x, b, params=TP) -> float:
    return float(torch.linalg.vector_norm(w.d_full(ut, x, params, LAT) - b)
                 / torch.linalg.vector_norm(b))


@pytest.fixture(scope="module")
def system():
    """The system of tests/test_torch_deflation.py (gauge seed 40, a point
    source) and the reference's CG solution of its odd-site system."""
    u = bridge.numpy_su3(np.random.default_rng(40), (4,) + JL.site_shape)
    src = np.zeros((4, 3) + JL.site_shape, np.complex64)
    src[1, 2, 0, 0, 0] = 1.0
    ueo, ph = j_pack(u, JL), jw.boundary_phases(JP, JL)
    ut = bridge.gauge_from_numpy(u, LAT)
    # the reference's odd-site system, as its invert_eo builds it (steps 1
    # and 2: bhat = b_o + kappa H_oe Mee^-1 b_e, and Qhat_- g5 bhat for CG),
    # solved by its cg on Qhat_pm
    qpm = jax.jit(lambda x: jw.q_hat_pm(ueo, x, JP, JL, ph))

    @jax.jit
    def odd_system(b):
        b_e, b_o = j_eo_pack(b, JL)
        bhat = b_o + JP.kappa * jw.dslash_packed(ueo, jw.mee_inv_packed(b_e, JP.mutld, 1.0), 1,
                                                 JL, ph)
        rhs = jw.q_hat(ueo, j_gamma5(bhat), JP, JL, ph, -1.0)
        return j_cg(qpm, rhs, tol=TOL, maxiter=500)

    return dict(u=u, ut=ut, src=src, b=bridge.sources_from_numpy(src, LAT),
                ref_cg=odd_system(jnp.asarray(src)))


def _odd(x) -> torch.Tensor:
    """The odd sites of a full-lattice solution: the odd solve's x_o."""
    return eo_pack(x, LAT)[1]


@pytest.mark.parametrize("solver", ["fastmixed", "mixedcg"])
def test_mixed_invert_eo_matches_reference_cg(system, solver):
    """mixedcg (both levels f32) and fastmixed (inner solves on the bf16
    copy) against the reference's CG solution."""
    dc.reset_counters()
    out = invert_eo(system["ut"], system["b"], TP, LAT, tol=TOL, maxiter=500, solver=solver)
    ref = system["ref_cg"]
    assert out.iterations >= int(ref.iterations) > 5
    assert _maxdiff(_odd(out.x), ref.x) < 1e-5
    assert _true_residual(system["ut"], out.x, system["b"]) < 1e-5
    # the CPU path ran the plain hop, on bf16 links for fastmixed's inner solves
    assert dc.hopping_split.launches == 0 and dc.hopping_split_plain.calls > 4 * out.iterations


def test_increigcg_matches_reference_cg(system):
    """Three columns in sequence: the first is plain CG (the reference's
    count), later ones start from the accumulated basis.  Every column's
    count equals the reference's `invert_eo_increigcg` on the same three
    sources (here 24 on each: on this rough 4^4 gauge the basis of two
    columns' Ritz vectors buys no iteration, in both packages)."""
    from tmlqcd_tpu.inverter import invert_eo_increigcg as j_increigcg

    src2 = np.roll(system["src"], 1, axis=2)
    src3 = bridge.numpy_spinor(np.random.default_rng(42), (4, 3) + JL.site_shape)
    srcs = (system["src"], src2, src3)
    bs = [system["b"]] + [bridge.sources_from_numpy(s, LAT) for s in (src2, src3)]
    outs = invert_eo_increigcg(system["ut"], bs, TP, LAT, tol=TOL, maxiter=500, nev=2, m=8,
                               max_vectors=8)
    ref = system["ref_cg"]
    assert outs[0].iterations == int(ref.iterations)
    assert _maxdiff(_odd(outs[0].x), ref.x) < 1e-5
    for out, b in zip(outs, bs):
        assert _true_residual(system["ut"], out.x, b) < 1e-5
    refs = j_increigcg(jnp.asarray(system["u"]), [jnp.asarray(s) for s in srcs], JP, JL, tol=TOL,
                       maxiter=500, nev=2, m=8, max_vectors=8)
    assert [o.iterations for o in outs] == [int(r.iterations) for r in refs]


def test_clover_solver_names(system):
    """invert_clover_eo carries cg, fastcg and mixedcg; any other carried
    name runs CG (the reference's else), and says so."""
    params = w.DiracParams(kappa=0.13, mu=0.04, c_sw=1.2)
    ut, b = system["ut"], system["b"]
    cg_ = invert_clover_eo(ut, b, params, LAT, tol=TOL, maxiter=500)
    mixed = invert_clover_eo(ut, b, params, LAT, tol=TOL, maxiter=500, solver="mixedcg")
    assert _maxdiff(mixed.x, cg_.x) < 1e-5 and mixed.iterations >= cg_.iterations
    sw = cl.sw_blocks(ut, params.kappa, params.c_sw, LAT)
    res = (cl.sw_apply(sw, mixed.x, params.mutld, +1.0)
           - params.kappa * w.dslash_full(ut, mixed.x, w.boundary_phases(params, LAT), LAT))
    assert float(torch.linalg.vector_norm(res - b) / torch.linalg.vector_norm(b)) < 1e-5
    other = invert_clover_eo(ut, b, params, LAT, tol=TOL, maxiter=500, solver="dflgcr")
    assert torch.equal(other.x, cg_.x) and other.iterations == cg_.iterations
    with pytest.raises(ValueError, match="unknown solver"):
        invert_clover_eo(ut, b, params, LAT, solver="nope")
