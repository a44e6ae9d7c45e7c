"""The port's remaining solvers against the JAX reference (tmlqcd_tpu) on
the CPU: mixed-precision CG (both variants), BiCGstab, CGS, GCR and MR, each on the reference's complex jnp operator and on the port's split
operator (the plain version of the hopping kernel) for the same gauge and
right-hand side (FGMRES is held to the reference's with the deflation
preconditioner, in tests/test_torch_deflation.py); then the cases
of tests/test_solvers.py, test_deflation.py and test_dflgcr.py on the port,
and its dispatch seam.

Tolerances: the two sides run the same recurrences in f32 fields with f64
(or complex128) scalars on operators that differ by f32 summation order
(~1e-7 relative), so the iteration counts are equal and the solutions agree
to 1e-5 absolute (|x| ~ 1 .. 10; the stopping tolerances 1e-6 .. 1e-7 stay
above the f32 floor, where a count could flip).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmlqcd_tpu.lattice import Lattice as JLattice
from tmlqcd_tpu.lattice import pack_gauge_eo as j_pack
from tmlqcd_tpu.ops import wilson as jw
from tmlqcd_tpu_torch import bridge, rng
from tmlqcd_tpu_torch.lattice import Lattice
from tmlqcd_tpu_torch.ops import wilson as w
from tmlqcd_tpu_torch.ops import wilson_fast as wf
from tmlqcd_tpu_torch.solvers import dispatch
from tmlqcd_tpu_torch.solvers.bicgstab import bicgstab
from tmlqcd_tpu_torch.solvers.cg import cg
from tmlqcd_tpu_torch.solvers.cgs import cgs
from tmlqcd_tpu_torch.solvers.deflation import deflated_fgmres, setup_deflation, vcycle
from tmlqcd_tpu_torch.solvers.eigcg import incr_eigcg_solve
from tmlqcd_tpu_torch.solvers.krylov import cdot, fgmres, gcr, mr
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
# the cases of tests/test_solvers.py, test_deflation.py, test_dflgcr.py
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


@pytest.fixture(scope="module")
def light_setup(light):
    return setup_deflation(light["mhat_batch"], (4, 3) + LAT.eo_site_shape, rng.Key(2),
                           device="cpu", n_vectors=6, blocks=(2, 2, 2), inv_iters=3,
                           smooth_iters=4)


def test_deflated_fgmres_converges_and_beats_plain(light, light_setup):
    plain = fgmres(light["mhat"], light["b2"], tol=1e-7, restart=10, max_restarts=40)
    defl = deflated_fgmres(light["mhat"], light["b2"], light_setup, tol=1e-7, restart=10,
                           max_restarts=40)
    assert _rel(light["mhat"], defl.x, light["b2"]) < 1e-6
    assert defl.iterations <= plain.iterations


def test_vcycle_reduces_residual(light, light_setup):
    c = vcycle(light_setup, light["mhat"], light["b2"])
    assert _rel(light["mhat"], c, light["b2"]) < 1.0


def test_dflgcr_via_dispatch_converges(light, light_setup):
    x, iters, _ = dispatch.solve_degenerate(light["mhat"], light["b2"], solver="dflgcr",
                                            tol=1e-7, maxiter=400,
                                            deflation_setup=light_setup, restart=10)
    assert _rel(light["mhat"], x, light["b2"]) < 1e-6 and iters >= 1


def test_dispatch_carries_every_route(easy, light, light_setup):
    """Every name of the reference's seam resolves here; the deflated ones
    need their setup; the mixed ones take the low operator."""
    assert sorted(dispatch.SOLVERS) == sorted(
        ["cg", "mixedcg", "rgmixedcg", "bicgstab", "cgs", "fgmres", "gmres", "gcr", "mr",
         "dfl", "dflfgmres", "dflgcr"])
    for name in ("cg", "mixedcg", "rgmixedcg"):
        x, iters, rs = dispatch.solve_degenerate(easy["qpm"], easy["b2"], solver=name.upper(),
                                                 tol=1e-6, maxiter=500)
        assert _rel(easy["qpm"], x, easy["b2"]) < 5e-6 and iters > 0
    for name in ("bicgstab", "cgs", "fgmres", "gmres", "gcr", "mr"):
        x, iters, rs = dispatch.solve_degenerate(easy["mhat"], easy["b2"], solver=name,
                                                 tol=1e-6, maxiter=500)
        assert _rel(easy["mhat"], x, easy["b2"]) < 5e-6 and iters > 0
    for name in ("dfl", "dflfgmres", "dflgcr"):
        with pytest.raises(ValueError, match="deflation_setup"):
            dispatch.solve_degenerate(light["mhat"], light["b2"], solver=name)
        x, _, _ = dispatch.solve_degenerate(light["mhat"], light["b2"], solver=name, tol=1e-7,
                                            maxiter=400, deflation_setup=light_setup,
                                            restart=5)
        assert _rel(light["mhat"], x, light["b2"]) < 1e-6
    seen = []
    lo = lambda x2: seen.append(1) or easy["qpm"](x2)  # noqa: E731
    dispatch.solve_degenerate(easy["qpm"], easy["b2"], solver="mixedcg", tol=1e-6,
                              maxiter=500, matvec_lo=lo)
    assert seen
    with pytest.raises(ValueError, match="unknown solver"):
        dispatch.solve_degenerate(easy["qpm"], easy["b2"], solver="no-such-solver")
