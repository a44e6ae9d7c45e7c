"""Monomials of the Nf=2 twisted-mass Hasenbusch action: GAUGE, DET and
DETRATIO.

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
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from tmlqcd_tpu_torch import rng
from tmlqcd_tpu_torch.lattice import Lattice
from tmlqcd_tpu_torch.ops import wilson_fast as wf
from tmlqcd_tpu_torch.ops.gauge_action import (
    gauge_action,
    gauge_force,
    ta_force_from_grad,
    torch_grad_to_jax,
)
from tmlqcd_tpu_torch.ops.wilson import DiracParams
from tmlqcd_tpu_torch.solvers import dispatch
from tmlqcd_tpu_torch.solvers.chrono import ChronoHistory, chrono_guess, chrono_init, chrono_push

__all__ = ["GaugeMonomial", "DetMonomial", "DetRatioMonomial", "SolveOut", "eo_spinor_shape"]


def eo_spinor_shape(lat: Lattice) -> tuple:
    """[4 spin, 3 colour, T, X, M] — packed pseudofermion shape."""
    return (4, 3) + lat.eo_site_shape


class SolveOut(NamedTuple):
    """One solve through the dispatch seam: split solution, iteration count,
    and the updated chrono history (None when chrono is off)."""

    x: torch.Tensor
    iterations: int
    hist: ChronoHistory | None


def _resolve_solver(solver: str) -> str:
    """'auto' -> plain CG, as in the reference."""
    return "cg" if solver == "auto" else solver.lower()


def _solve_qpm(fg: wf.FastGauge, b2: torch.Tensor, params: DiracParams, lat: Lattice,
               tol: float, maxiter: int, solver: str = "auto",
               hist: ChronoHistory | None = None) -> SolveOut:
    """Solve Qhat_pm x = b (split fields) through the dispatch seam, seeded
    by the chronological guess of `hist` and pushing the solution into it."""
    mv = lambda x2: wf.q_hat_pm_fast(fg, x2, params, lat)  # noqa: E731
    kw = {}
    if hist is not None:
        kw["x0"] = chrono_guess(hist, mv, b2)
    x2, iters, _ = dispatch.solve_degenerate(mv, b2, solver=_resolve_solver(solver),
                                             tol=tol, maxiter=maxiter, **kw)
    return SolveOut(x2, int(iters), chrono_push(hist, x2) if hist is not None else None)


def _surrogate_force(u: torch.Tensor, surrogate) -> torch.Tensor:
    """F = TA(U G^T) with G the gradient of the real surrogate S(U)."""
    with torch.enable_grad():
        uu = u.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(surrogate(uu), uu)
    return ta_force_from_grad(u, torch_grad_to_jax(g))


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
                         self.solver, hist)
        return wf.dot_re_f64_split(phi2, res.x), res.iterations

    def force_chrono(self, u, phi2, hist):
        fg = wf.make_fast_gauge(u, self.params, self.lat)
        res = _solve_qpm(fg, phi2, self.params, self.lat, self.force_tol, self.maxiter,
                         self.solver, hist)
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

    def heatbath(self, u, key, eta=None):
        # phi = Qhat_pm(2)^{-1} Qhat_-(2) b with b = Qhat_-(1) eta
        eta2 = _eta2(key, self.lat, u, eta)
        fg = wf.make_fast_gauge(u, self.params1, self.lat)
        b = wf.q_hat_fast(fg, eta2, self.params1, self.lat, -1.0)
        b2 = wf.q_hat_fast(fg, b, self.params2, self.lat, -1.0)
        phi2 = _solve_qpm(fg, b2, self.params2, self.lat, self.acc_tol, self.maxiter,
                          self.solver).x
        return phi2, wf.dot_re_f64_split(eta2, eta2)

    def chrono_init_state(self, device):
        if self.chrono_n <= 0:
            return None
        return chrono_init(self.chrono_n, (2,) + eo_spinor_shape(self.lat), torch.float32, device)

    def action_info(self, u, phi2, hist=None):
        fg = wf.make_fast_gauge(u, self.params1, self.lat)
        psi2 = wf.q_hat_fast(fg, phi2, self.params2, self.lat, +1.0)
        res = _solve_qpm(fg, psi2, self.params1, self.lat, self.acc_tol, self.maxiter,
                         self.solver, hist)
        return wf.dot_re_f64_split(psi2, res.x), res.iterations

    def force_chrono(self, u, phi2, hist):
        fg = wf.make_fast_gauge(u, self.params1, self.lat)
        psi2 = wf.q_hat_fast(fg, phi2, self.params2, self.lat, +1.0)
        res = _solve_qpm(fg, psi2, self.params1, self.lat, self.force_tol, self.maxiter,
                         self.solver, hist)
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
