"""Monomials of the Nf=2 twisted-mass and twisted-clover Hasenbusch
actions: GAUGE, SFGAUGE (the Schrödinger-functional gauge action), DET,
DETRATIO, CLOVERDET, CLOVERTRLOG and CLOVERDETRATIO.

Port of the main-path parts of `tmlqcd_tpu/hmc/monomials.py`.  Each monomial
exposes

    heatbath(u, key, eta=None) -> (aux, S_initial)
    action_info(u, aux, hist)  -> (S_final, acceptance-solve iterations)
    force_chrono(u, aux, hist) -> (F, hist', force-solve iterations)

Pseudofermions live in the split f32 layout [2, 4, 3, T, X, M] and every
Dirac application — heatbath, acceptance, the DETRATIO psi = Qhat_+(mu2) phi
and every CG iteration — is a K1 call through `ops/wilson_fast` (the CUDA
kernel for CUDA tensors, its plain version for CPU tensors).  The reference
runs the heatbath and the DETRATIO psi through its jnp operator even on the
TPU; the results differ only by f32 rounding.

Forces: the implicit-function identity turns dS into the gradient of a
linear surrogate at stopped solves, e.g. S = phi^+ (Qhat_pm)^{-1} phi gives
-2 Re<Y, Qhat_+(U) X> with X = Qhat_pm^{-1} phi, Y = Qhat_+ X.  The surrogate
runs on `HoppingDiff` (K1 forward, K2 + adjoint K1 backward) and autograd
carries the chain rule through the gauge copy.  PyTorch's gradient with
respect to the complex gauge is the conjugate of the reference's convention,
hence `torch_grad_to_jax` before `ta_force_from_grad`.

Mixed solvers (`Solver = mixedcg | rgmixedcg`): the low operator is the
same Qhat_pm or Qsw_pm on the bf16 copy of the gauge (`wf.sloppy_gauge`,
K1 on a bf16 gauge: K1-B), the high one on the f32 copy, and the chrono
guess is the outer solve's start.  The reference keeps complex64 for both
levels off the TPU; the port runs the bf16 copy on the CPU too (the plain
hop on the bf16-rounded links).

Clover monomials: the same routing with the clover epilogues of K1
(`wf.q_hat_clover_fast`) for every Dirac application and
`wf.q_hat_clover_diff` for every force surrogate, where the reference runs
the heatbaths and the whole CLOVERDETRATIO force through its complex jnp
operator.  The clover-term part of a force is autograd through
`ops/clover.sw_blocks` -> `mee_blocks` / `mee_inv_blocks` / `sw_logdet`.
Each call builds the gauge copy and the clover term once (`_CloverState`)
and shares them between its operators; nothing is cached across calls.

Domain decomposition: a monomial built with `mesh` (a `parallel.Mesh`, from
NrTProcs x NrYProcs) runs every CG solve — acceptance, force, heatbath, and
the mixed solvers' low operator on the bf16 copy — on the sharded operators
(`wf.q_hat_pm_fast_shard`, `wf.q_hat_pm_clover_fast_shard`: the slab
kernels K3-I and K4), as the reference routes its solves under an active
mesh.  The heatbath's Qhat, the y = Qhat_+ x of a force and the force
surrogates stay on the whole-lattice kernels (K1, and K1 / K2 through
`HoppingDiff`): the reference takes jnp autodiff for the surrogates under a
mesh, a GSPMD choice; on one device the fields stay whole.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from tmlqcd_tpu_torch import rng
from tmlqcd_tpu_torch.lattice import Lattice
from tmlqcd_tpu_torch.ops import clover as cl
from tmlqcd_tpu_torch.ops import wilson_fast as wf
from tmlqcd_tpu_torch.ops.gauge_action import (
    gauge_action,
    gauge_force,
    ta_force_from_grad,
    torch_grad_to_jax,
)
from tmlqcd_tpu_torch.ops.sf import sf_gauge_action
from tmlqcd_tpu_torch.ops.wilson import DiracParams
from tmlqcd_tpu_torch.solvers import dispatch
from tmlqcd_tpu_torch.solvers.chrono import ChronoHistory, chrono_guess, chrono_init, chrono_push

__all__ = ["GaugeMonomial", "SFGaugeMonomial", "DetMonomial", "DetRatioMonomial",
           "CloverDetMonomial", "CloverTrlogMonomial", "CloverDetRatioMonomial", "SolveOut",
           "eo_spinor_shape"]


def eo_spinor_shape(lat: Lattice) -> tuple:
    """[4 spin, 3 colour, T, X, M] — packed pseudofermion shape."""
    return (4, 3) + lat.eo_site_shape


class SolveOut(NamedTuple):
    """One solve through the dispatch seam: split solution, iteration count,
    and the updated chrono history (None when chrono is off)."""

    x: torch.Tensor
    iterations: int
    hist: ChronoHistory | None


_MIXED = ("mixedcg", "rgmixedcg")


def _resolve_solver(solver: str) -> str:
    """'auto' -> plain CG, as in the reference."""
    return "cg" if solver == "auto" else solver.lower()


def _seam_solve(mv, mv_lo, b2, solver, tol, maxiter, hist) -> SolveOut:
    """One solve of the hermitian operator `mv` through the dispatch seam,
    seeded by the chronological guess of `hist` and pushing the solution into
    it; `mv_lo()` builds the low operator of the mixed solvers."""
    name = _resolve_solver(solver)
    kw = {}
    if hist is not None:
        kw["x0"] = chrono_guess(hist, mv, b2)
    if name in _MIXED:
        kw["matvec_lo"] = mv_lo()
    x2, iters, _ = dispatch.solve_degenerate(mv, b2, solver=name, tol=tol, maxiter=maxiter, **kw)
    return SolveOut(x2, int(iters), chrono_push(hist, x2) if hist is not None else None)


def _solve_qpm(fg: wf.FastGauge, b2: torch.Tensor, params: DiracParams, lat: Lattice,
               tol: float, maxiter: int, solver: str = "auto",
               hist: ChronoHistory | None = None, mesh=None) -> SolveOut:
    """Solve Qhat_pm x = b (split fields) through the dispatch seam; the
    mixed solvers' low operator runs on the bf16 copy of `fg`.  With `mesh`
    both operators are the sharded ones."""
    return _seam_solve(wf.q_hat_pm_operator(fg, params, lat, mesh),
                       lambda: wf.q_hat_pm_operator(wf.sloppy_gauge(fg), params, lat, mesh), b2,
                       solver, tol, maxiter, hist)


def _surrogate_force(u: torch.Tensor, surrogate) -> torch.Tensor:
    """F = TA(U G^T) with G the gradient of the real surrogate S(U)."""
    with torch.enable_grad():
        uu = u.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(surrogate(uu), uu)
    return ta_force_from_grad(u, torch_grad_to_jax(g))


def _force_from_surrogate(u_leaf: torch.Tensor, surrogate: torch.Tensor) -> torch.Tensor:
    """F = TA(U G^T), G the gradient of the real surrogate with respect to
    the leaf `u_leaf` it was built on."""
    (g,) = torch.autograd.grad(surrogate, u_leaf)
    return ta_force_from_grad(u_leaf.detach(), torch_grad_to_jax(g))


def _eta2(key, lat: Lattice, u: torch.Tensor, eta) -> torch.Tensor:
    if eta is None:
        eta = rng.normal_spinor(key, eo_spinor_shape(lat), u.device)
    return wf.to_split(eta)


@dataclasses.dataclass(frozen=True)
class GaugeMonomial:
    """S_g = beta * sum [c0 (1 - ReTr P/3) + c1 (1 - ReTr R/3)]."""

    lat: Lattice
    beta: float
    c1: float = 0.0
    timescale: int = 0
    name: str = "gauge"

    def heatbath(self, u, key, eta=None):
        return None, gauge_action(u, self.beta, self.lat, self.c1)

    def action_info(self, u, aux, hist=None):
        return gauge_action(u, self.beta, self.lat, self.c1), 0

    def force(self, u, aux):
        return gauge_force(u, self.beta, self.lat, self.c1)


@dataclasses.dataclass(frozen=True)
class SFGaugeMonomial:
    """Schrödinger-functional Wilson gauge action: Dirichlet boundaries in
    time with the abelian background W(eta, nu) frozen at x0 = 0 and T
    (reference: sf_gauge_monomial.c).  The force is the autograd gradient of
    the SF action, exactly zero on the frozen links because they never enter
    it; pair it with `HMCConfig.momenta_mask = ops.sf.sf_momenta_mask(lat)`
    so that the drift keeps the frozen links fixed too."""

    lat: Lattice
    beta: float
    eta: float = 0.0
    nu: float = 0.0
    ct: float = 1.0
    timescale: int = 0
    name: str = "sfgauge"

    def _s(self, u):
        return sf_gauge_action(u, self.beta, self.lat, self.eta, self.nu, self.ct)

    def heatbath(self, u, key, eta=None):
        return None, self._s(u)

    def action_info(self, u, aux, hist=None):
        return self._s(u), 0

    def force(self, u, aux):
        with torch.enable_grad():
            uu = u.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(self._s(uu), uu)
        return ta_force_from_grad(u, torch_grad_to_jax(g))


@dataclasses.dataclass(frozen=True)
class DetMonomial:
    """Two-flavour pseudofermion S = phi^+ (Qhat_pm)^{-1} phi.
    heatbath: phi = Qhat_- eta, so S_0 = |eta|^2."""

    lat: Lattice
    params: DiracParams
    timescale: int = 1
    acc_tol: float = 1e-8
    force_tol: float = 1e-7
    maxiter: int = 1000
    solver: str = "auto"
    chrono_n: int = 3
    name: str = "det"
    mesh: object = None  # parallel.Mesh: the solves on the slab kernels

    def heatbath(self, u, key, eta=None):
        eta2 = _eta2(key, self.lat, u, eta)
        fg = wf.make_fast_gauge(u, self.params, self.lat)
        return wf.q_hat_fast(fg, eta2, self.params, self.lat, -1.0), wf.dot_re_f64_split(eta2, eta2)

    def chrono_init_state(self, device):
        if self.chrono_n <= 0:
            return None
        return chrono_init(self.chrono_n, (2,) + eo_spinor_shape(self.lat), torch.float32, device)

    def action_info(self, u, phi2, hist=None):
        fg = wf.make_fast_gauge(u, self.params, self.lat)
        res = _solve_qpm(fg, phi2, self.params, self.lat, self.acc_tol, self.maxiter,
                         self.solver, hist, self.mesh)
        return wf.dot_re_f64_split(phi2, res.x), res.iterations

    def force_chrono(self, u, phi2, hist):
        fg = wf.make_fast_gauge(u, self.params, self.lat)
        res = _solve_qpm(fg, phi2, self.params, self.lat, self.force_tol, self.maxiter,
                         self.solver, hist, self.mesh)
        x2 = res.x
        y2 = wf.q_hat_fast(fg, x2, self.params, self.lat, +1.0)

        def surrogate(uu):
            ug_e, ug_o = wf.split_gauge_pair(uu, self.params, self.lat)
            qx = wf.q_hat_diff(ug_e, ug_o, x2, self.params, self.lat, +1.0)
            return -2.0 * wf.dot_re_f64_split(y2, qx)

        return _surrogate_force(u, surrogate), res.hist, res.iterations

    def force(self, u, phi2):
        return self.force_chrono(u, phi2, None)[0]


@dataclasses.dataclass(frozen=True)
class DetRatioMonomial:
    """Hasenbusch ratio S = phi^+ Qhat_-(mu2) Qhat_pm(mu1)^{-1} Qhat_+(mu2) phi.
    params1: the light (target) operator; params2: the heavy preconditioner
    (same kappa and boundary phases, so one gauge copy serves both).
    heatbath: phi = Qhat_+(2)^{-1} Qhat_-(1) eta, so S_0 = |eta|^2."""

    lat: Lattice
    params1: DiracParams
    params2: DiracParams
    timescale: int = 1
    acc_tol: float = 1e-8
    force_tol: float = 1e-7
    maxiter: int = 1000
    solver: str = "auto"
    chrono_n: int = 3
    name: str = "detratio"
    mesh: object = None  # parallel.Mesh: the solves on the slab kernels

    def heatbath(self, u, key, eta=None):
        # phi = Qhat_pm(2)^{-1} Qhat_-(2) b with b = Qhat_-(1) eta
        eta2 = _eta2(key, self.lat, u, eta)
        fg = wf.make_fast_gauge(u, self.params1, self.lat)
        b = wf.q_hat_fast(fg, eta2, self.params1, self.lat, -1.0)
        b2 = wf.q_hat_fast(fg, b, self.params2, self.lat, -1.0)
        phi2 = _solve_qpm(fg, b2, self.params2, self.lat, self.acc_tol, self.maxiter,
                          self.solver, mesh=self.mesh).x
        return phi2, wf.dot_re_f64_split(eta2, eta2)

    def chrono_init_state(self, device):
        if self.chrono_n <= 0:
            return None
        return chrono_init(self.chrono_n, (2,) + eo_spinor_shape(self.lat), torch.float32, device)

    def action_info(self, u, phi2, hist=None):
        fg = wf.make_fast_gauge(u, self.params1, self.lat)
        psi2 = wf.q_hat_fast(fg, phi2, self.params2, self.lat, +1.0)
        res = _solve_qpm(fg, psi2, self.params1, self.lat, self.acc_tol, self.maxiter,
                         self.solver, hist, self.mesh)
        return wf.dot_re_f64_split(psi2, res.x), res.iterations

    def force_chrono(self, u, phi2, hist):
        fg = wf.make_fast_gauge(u, self.params1, self.lat)
        psi2 = wf.q_hat_fast(fg, phi2, self.params2, self.lat, +1.0)
        res = _solve_qpm(fg, psi2, self.params1, self.lat, self.force_tol, self.maxiter,
                         self.solver, hist, self.mesh)
        x2 = res.x
        y2 = wf.q_hat_fast(fg, x2, self.params1, self.lat, +1.0)

        def surrogate(uu):
            # dS = 2Re<x, dQhat_+(2) phi> - 2Re<y, dQhat_+(1) x>
            ug_e, ug_o = wf.split_gauge_pair(uu, self.params1, self.lat)
            t2 = wf.q_hat_diff(ug_e, ug_o, phi2, self.params2, self.lat, +1.0)
            t1 = wf.q_hat_diff(ug_e, ug_o, x2, self.params1, self.lat, +1.0)
            return 2.0 * wf.dot_re_f64_split(x2, t2) - 2.0 * wf.dot_re_f64_split(y2, t1)

        return _surrogate_force(u, surrogate), res.hist, res.iterations

    def force(self, u, phi2):
        return self.force_chrono(u, phi2, None)[0]


# ---------------------------------------------------------------------------
# clover monomials
# ---------------------------------------------------------------------------


def _solve_qsw(fc: wf.FastClover, b2: torch.Tensor, params: DiracParams, lat: Lattice,
               tol: float, maxiter: int, solver: str = "auto",
               hist: ChronoHistory | None = None, mesh=None) -> SolveOut:
    """Solve Qsw_pm x = b (split fields) through the dispatch seam; the
    mixed solvers' low operator runs on the bf16 copy of the gauge of `fc`
    (the clover blocks stay f32).  With `mesh` both operators are the
    sharded ones."""
    return _seam_solve(wf.q_hat_pm_clover_operator(fc, params, lat, mesh),
                       lambda: wf.q_hat_pm_clover_operator(wf.sloppy_clover(fc), params, lat, mesh),
                       b2, solver, tol, maxiter, hist)


class _CloverState:
    """The gauge copy and the clover term at one U, built once per call of a
    monomial: differentiable (for a force) or not.  `fast(params)` gives the
    FastClover of one twisted mass from them; `blocks(params)` the
    differentiable split (moo, mee_inv) blocks of Qsw(+)."""

    def __init__(self, u: torch.Tensor, params: DiracParams, lat: Lattice, grad: bool):
        self.lat = lat
        with torch.enable_grad() if grad else torch.no_grad():
            self.u = u.detach().requires_grad_(True) if grad else u
            self.ug_e, self.ug_o = wf.split_gauge_pair(self.u, params, lat)
            self.sw_e, self.sw_o = cl.sw_blocks_eo(self.u, params.kappa, params.c_sw, lat)
        self.fg = wf.fast_gauge_from_pair(self.ug_e, self.ug_o, params, lat)

    def fast(self, params: DiracParams) -> wf.FastClover:
        return wf.fast_clover_from(self.fg, self.sw_e, self.sw_o, params.mutld)

    def q_plus_diff(self, psi2: torch.Tensor, params: DiracParams) -> torch.Tensor:
        moo, mee_inv = wf.split_clover_blocks(self.sw_e, self.sw_o, params.mutld, +1.0)
        return wf.q_hat_clover_diff(self.ug_e, self.ug_o, moo, mee_inv, psi2, params, self.lat)

    def force(self, surrogate: torch.Tensor) -> torch.Tensor:
        """F = TA(U G^T), G the gradient of the real surrogate built on this
        state."""
        return _force_from_surrogate(self.u, surrogate)


@dataclasses.dataclass(frozen=True)
class CloverDetMonomial:
    """Two-flavour twisted-clover pseudofermion S = phi^+ (Qsw_pm)^{-1} phi.
    heatbath: phi = Qsw_- eta, so S_0 = |eta|^2.  Pair with
    CloverTrlogMonomial for the det(M_ee) factor."""

    lat: Lattice
    params: DiracParams
    timescale: int = 1
    acc_tol: float = 1e-8
    force_tol: float = 1e-7
    maxiter: int = 1000
    solver: str = "auto"
    chrono_n: int = 3
    name: str = "cloverdet"
    mesh: object = None  # parallel.Mesh: the solves on the slab kernels

    def heatbath(self, u, key, eta=None):
        eta2 = _eta2(key, self.lat, u, eta)
        fc = wf.make_fast_clover(u, self.params, self.lat)
        return (wf.q_hat_clover_fast(fc, eta2, self.params, self.lat, -1.0),
                wf.dot_re_f64_split(eta2, eta2))

    def chrono_init_state(self, device):
        if self.chrono_n <= 0:
            return None
        return chrono_init(self.chrono_n, (2,) + eo_spinor_shape(self.lat), torch.float32, device)

    def action_info(self, u, phi2, hist=None):
        fc = wf.make_fast_clover(u, self.params, self.lat)
        res = _solve_qsw(fc, phi2, self.params, self.lat, self.acc_tol, self.maxiter,
                         self.solver, hist, self.mesh)
        return wf.dot_re_f64_split(phi2, res.x), res.iterations

    def force_chrono(self, u, phi2, hist):
        st = _CloverState(u, self.params, self.lat, grad=True)
        fc = st.fast(self.params)
        res = _solve_qsw(fc, phi2, self.params, self.lat, self.force_tol, self.maxiter,
                         self.solver, hist, self.mesh)
        x2 = res.x
        y2 = wf.q_hat_clover_fast(fc, x2, self.params, self.lat, +1.0)
        with torch.enable_grad():
            s = -2.0 * wf.dot_re_f64_split(y2, st.q_plus_diff(x2, self.params))
        return st.force(s), res.hist, res.iterations

    def force(self, u, phi2):
        return self.force_chrono(u, phi2, None)[0]


@dataclasses.dataclass(frozen=True)
class CloverTrlogMonomial:
    """S = -sum_{even sites} log |det M_ee(+mu)|^2: the even/even factor of
    the even/odd-preconditioned two-flavour clover determinant.  Exact action
    (no solve); force by autograd through the closed-form block
    determinants."""

    lat: Lattice
    params: DiracParams
    timescale: int = 0
    name: str = "clovertrlog"

    def _action(self, u):
        sw_e, _ = cl.sw_blocks_eo(u, self.params.kappa, self.params.c_sw, self.lat)
        return -cl.sw_logdet(sw_e, self.params.mutld, +1.0)

    def heatbath(self, u, key, eta=None):
        return None, self._action(u)

    def action_info(self, u, aux, hist=None):
        return self._action(u), 0

    def force(self, u, aux):
        return _surrogate_force(u, self._action)


@dataclasses.dataclass(frozen=True)
class CloverDetRatioMonomial:
    """Hasenbusch ratio of the twisted-clover operator,
    S = phi^+ Qsw_-(mu2) Qsw_pm(mu1)^{-1} Qsw_+(mu2) phi.  params1: the light
    (target) operator; params2: the heavy preconditioner.  kappa and c_sw are
    shared, so the gauge copy and the clover term are built once per call and
    serve both operators.
    heatbath: phi = Qsw_+(2)^{-1} Qsw_-(1) eta, so S_0 = |eta|^2."""

    lat: Lattice
    params1: DiracParams
    params2: DiracParams
    timescale: int = 1
    acc_tol: float = 1e-8
    force_tol: float = 1e-7
    maxiter: int = 1000
    solver: str = "auto"
    chrono_n: int = 3
    name: str = "cloverdetratio"
    mesh: object = None  # parallel.Mesh: the solves on the slab kernels

    def __post_init__(self):
        if (self.params1.kappa, self.params1.c_sw) != (self.params2.kappa, self.params2.c_sw):
            raise ValueError("cloverdetratio: kappa/c_sw must match between operators")

    def heatbath(self, u, key, eta=None):
        # phi = Qsw_pm(2)^{-1} Qsw_-(2) b with b = Qsw_-(1) eta; the reference
        # runs this solve as a plain CG whatever `solver` says
        eta2 = _eta2(key, self.lat, u, eta)
        st = _CloverState(u, self.params1, self.lat, grad=False)
        fc1, fc2 = st.fast(self.params1), st.fast(self.params2)
        b = wf.q_hat_clover_fast(fc1, eta2, self.params1, self.lat, -1.0)
        b2 = wf.q_hat_clover_fast(fc2, b, self.params2, self.lat, -1.0)
        phi2 = _solve_qsw(fc2, b2, self.params2, self.lat, self.acc_tol, self.maxiter, "cg",
                          mesh=self.mesh).x
        return phi2, wf.dot_re_f64_split(eta2, eta2)

    def chrono_init_state(self, device):
        if self.chrono_n <= 0:
            return None
        return chrono_init(self.chrono_n, (2,) + eo_spinor_shape(self.lat), torch.float32, device)

    def action_info(self, u, phi2, hist=None):
        st = _CloverState(u, self.params1, self.lat, grad=False)
        fc1, fc2 = st.fast(self.params1), st.fast(self.params2)
        psi2 = wf.q_hat_clover_fast(fc2, phi2, self.params2, self.lat, +1.0)
        res = _solve_qsw(fc1, psi2, self.params1, self.lat, self.acc_tol, self.maxiter,
                         self.solver, hist, self.mesh)
        return wf.dot_re_f64_split(psi2, res.x), res.iterations

    def force_chrono(self, u, phi2, hist):
        st = _CloverState(u, self.params1, self.lat, grad=True)
        fc1, fc2 = st.fast(self.params1), st.fast(self.params2)
        psi2 = wf.q_hat_clover_fast(fc2, phi2, self.params2, self.lat, +1.0)
        res = _solve_qsw(fc1, psi2, self.params1, self.lat, self.force_tol, self.maxiter,
                         self.solver, hist, self.mesh)
        x2 = res.x
        y2 = wf.q_hat_clover_fast(fc1, x2, self.params1, self.lat, +1.0)
        with torch.enable_grad():
            # dS = 2Re<x, dQsw_+(2) phi> - 2Re<y, dQsw_+(1) x>
            s = (2.0 * wf.dot_re_f64_split(x2, st.q_plus_diff(phi2, self.params2))
                 - 2.0 * wf.dot_re_f64_split(y2, st.q_plus_diff(x2, self.params1)))
        return st.force(s), res.hist, res.iterations

    def force(self, u, phi2):
        return self.force_chrono(u, phi2, None)[0]
