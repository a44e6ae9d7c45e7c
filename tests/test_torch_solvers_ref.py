"""The port's solvers against the JAX reference (tmlqcd_tpu) on the CPU:
mixed-precision CG (both variants), BiCGstab, CGS, GCR and MR, each on the
reference's complex jnp operator and on the port's split operator (the
plain version of the hopping kernel) for the same gauge and right-hand
side; and incremental eigCG on a dense matrix.  Seconds each, so they
have a file of at most 8 tests, which the test runner queues behind
tests/test_multirhs.py; the systems are those of
tests/test_torch_solvers.py (its fixtures, imported).

Tolerances: the two sides run the same recurrences in f32 fields with f64
(or complex128) scalars on operators that differ by f32 summation order
(~1e-7 relative), so the iteration counts are equal and the solutions agree
to 1e-5 absolute (|x| ~ 1 .. 10; the stopping tolerances 1e-6 .. 1e-7 stay
above the f32 floor, where a count could flip).
"""

import importlib

import jax
import numpy as np
import pytest
import torch

from test_torch_solvers import ATOL, _maxdiff, _rel, easy, light  # noqa: F401  (fixtures)
from tmlqcd_tpu_torch.ops import wilson_fast as wf
from tmlqcd_tpu_torch.solvers.bicgstab import bicgstab
from tmlqcd_tpu_torch.solvers.cgs import cgs
from tmlqcd_tpu_torch.solvers.eigcg import incr_eigcg_solve
from tmlqcd_tpu_torch.solvers.krylov import gcr, mr
from tmlqcd_tpu_torch.solvers.mixed_cg import mixed_cg, rg_mixed_cg

# the reference's solver modules (its package namespace re-exports functions
# under the same names)
J = {n: importlib.import_module(f"tmlqcd_tpu.solvers.{n}")
     for n in ("mixed_cg", "bicgstab", "cgs", "krylov")}

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _quick_reference_compiles():
    """XLA's backend optimisations off while this module runs: the
    reference's programs here take far longer to compile than to run."""
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", False)


# (port solver, reference solver, operator, keyword arguments, iteration field)
CASES = {
    "mixed_cg": (mixed_cg, lambda: J["mixed_cg"].mixed_cg, "qpm",
                 dict(tol=1e-7, max_inner=500), "inner_iterations"),
    "rg_mixed_cg": (rg_mixed_cg, lambda: J["mixed_cg"].rg_mixed_cg, "qpm", dict(tol=1e-7),
                    "inner_iterations"),
    "bicgstab": (bicgstab, lambda: J["bicgstab"].bicgstab, "mhat",
                 dict(tol=1e-6, maxiter=500), "iterations"),
    "cgs": (cgs, lambda: J["cgs"].cgs, "mhat", dict(tol=1e-6, maxiter=500), "iterations"),
    "mr": (mr, lambda: J["krylov"].mr, "mhat", dict(tol=1e-6, maxiter=500), "iterations"),
    "gcr": (gcr, lambda: J["krylov"].gcr, "mhat", dict(tol=1e-6, restart=5, max_restarts=40),
            "iterations"),
}


@pytest.mark.parametrize("name", list(CASES))
def test_solver_matches_reference(easy, light, name):
    port, ref, op, kw, field = CASES[name]
    sysm = light if name == "gcr" else easy
    r = ref()(sysm["j" + op], sysm["jb"], **kw)
    out = port(sysm[op], sysm["b2"], **kw)
    n = getattr(out, field)
    assert n == int(getattr(r, field)) and n > 1
    assert _maxdiff(wf.from_split(out.x), r.x) < ATOL
    if name.endswith("mixed_cg"):
        assert out.outer_iterations == int(r.outer_iterations) > 1
    np.testing.assert_allclose(float(out.residual_sq), float(r.residual_sq), rtol=0.2)
    res = sysm[op](out.x) - sysm["b2"]
    bnorm = float(torch.linalg.vector_norm(sysm["b2"]))
    assert float(torch.linalg.vector_norm(res)) < 5 * kw["tol"] * bnorm


def test_incr_eigcg_dense():
    """Ritz pairs harvested from earlier solves deflate later right-hand
    sides: iterations drop substantially across the sequence (a dense
    hermitian matrix with 8 small eigenvalues, on split f64 fields)."""
    g = np.random.default_rng(1)
    n = 400
    q, _ = np.linalg.qr(g.normal(size=(n, n)) + 1j * g.normal(size=(n, n)))
    ev = np.concatenate([np.linspace(1e-3, 5e-3, 8), np.linspace(0.5, 10.0, n - 8)])
    a = (q * ev) @ q.conj().T
    a = torch.as_tensor((a + a.conj().T) / 2)

    def mv(x2):
        y = a @ torch.complex(x2[0], x2[1])
        return torch.stack([y.real, y.imag])

    bs = [torch.as_tensor(g.normal(size=(2, n))) for _ in range(5)]
    xs, iters, basis = incr_eigcg_solve(mv, bs, nev=6, m=30, max_vectors=24, tol=1e-8,
                                        maxiter=3000)
    for b, x in zip(bs, xs):
        assert _rel(mv, x, b) < 1e-7
    assert iters[-1] < 0.5 * iters[0], iters
    assert len(basis.vectors) > 0
