"""The cases of tests/test_solvers.py on the port (CPU) and mixed-precision
CG on the bf16 low operator.  The port's solvers against the JAX reference
(tmlqcd_tpu): mixed-precision CG (both variants), BiCGstab, CGS, GCR and
MR, each on the reference's complex jnp operator and on the port's split
operator for the same gauge and right-hand side, and incremental eigCG,
are in tests/test_torch_solvers_ref.py; the cases of
tests/test_deflation.py and test_dflgcr.py and the dispatch seam, on one
deflation setup, in tests/test_torch_solvers_dfl.py (seconds each: each
file holds at most 8 tests, so that the test runner queues it behind
tests/test_multirhs.py; FGMRES is held to the reference's with the
deflation preconditioner, in tests/test_torch_deflation.py).  `_system`
builds both packages' operators for the three files.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmlqcd_tpu.lattice import Lattice as JLattice
from tmlqcd_tpu.lattice import pack_gauge_eo as j_pack
from tmlqcd_tpu.ops import wilson as jw
from tmlqcd_tpu_torch import bridge
from tmlqcd_tpu_torch.lattice import Lattice
from tmlqcd_tpu_torch.ops import wilson as w
from tmlqcd_tpu_torch.ops import wilson_fast as wf
from tmlqcd_tpu_torch.solvers.bicgstab import bicgstab
from tmlqcd_tpu_torch.solvers.cg import cg
from tmlqcd_tpu_torch.solvers.cgs import cgs
from tmlqcd_tpu_torch.solvers.krylov import cdot
from tmlqcd_tpu_torch.solvers.mixed_cg import mixed_cg, rg_mixed_cg

torch.set_num_threads(1)


DIMS = (4, 4, 4, 4)
JL, LAT = JLattice(DIMS), Lattice(DIMS)
ATOL = 1e-5


def _maxdiff(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


def _system(kappa, mu, seed):
    """Qhat_pm and Mhat of both packages on one gauge, and one source."""
    u = bridge.numpy_su3(np.random.default_rng(seed), (4,) + JL.site_shape)
    b = bridge.numpy_spinor(np.random.default_rng(seed + 1), (4, 3) + JL.eo_site_shape)
    jp, tp = jw.DiracParams(kappa=kappa, mu=mu), w.DiracParams(kappa=kappa, mu=mu)
    ueo, ph = j_pack(u, JL), jw.boundary_phases(jp, JL)
    fg = wf.make_fast_gauge(bridge.gauge_from_numpy(u, LAT), tp, LAT)
    # the reference's operators compiled once: its solvers trace the operator
    # at every call site of their loops, which a jitted function serves from
    # its trace cache (the same program, traced once)
    return dict(
        jqpm=jax.jit(lambda x: jw.q_hat_pm(ueo, x, jp, JL, ph)),
        jmhat=jax.jit(lambda x: jw.m_hat(ueo, x, jp, JL, ph, +1.0)),
        qpm=lambda x2: wf.q_hat_pm_fast(fg, x2, tp, LAT),
        mhat=lambda x2: wf.m_hat_fast(fg, x2, tp, LAT, +1.0),
        mhat_batch=lambda x2: wf.m_hat_fast(fg, x2, tp, LAT, +1.0, r_axis=3),
        fg=fg, tp=tp, jb=jnp.asarray(b), b2=wf.to_split(torch.as_tensor(b)))


@pytest.fixture(scope="module")
def easy():
    """kappa = 0.12, mu = 0.05 (tests/test_solvers.py's point)."""
    return _system(0.12, 0.05, 0)


@pytest.fixture(scope="module")
def light():
    """kappa = 0.16, mu = 0.005 (tests/test_deflation.py's point): Mhat
    ill-conditioned, where restarts and deflation matter."""
    return _system(0.16, 0.005, 2)


def test_complex_dot_of_split_fields():
    """<a, b> = sum conj(a) b from the split planes, sign of Im included."""
    g = np.random.default_rng(5)
    a = g.standard_normal((2, 3, 7)).astype(np.float32)
    b = g.standard_normal((2, 3, 7)).astype(np.float32)
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    ref = np.vdot(a64[0] + 1j * a64[1], b64[0] + 1j * b64[1])
    out = complex(cdot(torch.as_tensor(a), torch.as_tensor(b)))
    assert abs(out - ref) < 1e-10 * abs(ref)


@pytest.mark.parametrize("variant", ["mixed_cg", "rg_mixed_cg"])
def test_mixed_cg_with_the_bf16_low_operator_converges(easy, variant):
    """The low operator on the bf16 gauge copy: the outer loop (or the
    reliable updates) bring the true residual to the requested tolerance
    all the same."""
    fg16 = wf.sloppy_gauge(easy["fg"])
    lo = lambda x2: wf.q_hat_pm_fast(fg16, x2, easy["tp"], LAT)  # noqa: E731
    solve = mixed_cg if variant == "mixed_cg" else rg_mixed_cg
    out = solve(easy["qpm"], easy["b2"], matvec_lo=lo, tol=1e-7)
    ref = cg(easy["qpm"], easy["b2"], tol=1e-7, maxiter=500)
    b_sq = float(torch.sum(easy["b2"].double() ** 2))
    # mixed_cg stops on the true residual; rg_mixed_cg on the iterated one,
    # which stays within one replacement interval (delta = 0.01) of it
    assert float(out.residual_sq) <= (1.0 if variant == "mixed_cg" else 10.0) * 1e-14 * b_sq
    assert out.outer_iterations > 1 and out.inner_iterations >= ref.iterations
    assert _maxdiff(out.x, ref.x) < ATOL


# ---------------------------------------------------------------------------
# the cases of tests/test_solvers.py
# ---------------------------------------------------------------------------


def _rel(matvec, x, b) -> float:
    return float(torch.linalg.vector_norm(matvec(x) - b) / torch.linalg.vector_norm(b))


def test_cg_converges_and_absolute_precision(easy):
    res = cg(easy["qpm"], easy["b2"], tol=1e-6, maxiter=500)
    assert _rel(easy["qpm"], res.x, easy["b2"]) < 5e-6 and res.iterations < 100
    res = cg(easy["qpm"], easy["b2"], tol=1e-4, maxiter=500, rel_prec=False)
    assert float(res.residual_sq) <= 1e-8


def test_bicgstab_and_cgs_nonhermitian(easy):
    for solve in (bicgstab, cgs):
        res = solve(easy["mhat"], easy["b2"], tol=1e-6, maxiter=500)
        assert _rel(easy["mhat"], res.x, easy["b2"]) < 5e-6


def test_cg_with_initial_guess(easy):
    full = cg(easy["qpm"], easy["b2"], tol=1e-6, maxiter=500)
    warm = cg(easy["qpm"], easy["b2"], x0=full.x, tol=1e-6, maxiter=500)
    assert warm.iterations <= 2
