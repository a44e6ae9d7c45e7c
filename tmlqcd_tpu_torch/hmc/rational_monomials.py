"""Rational (RHMC) monomials: the non-degenerate doublet's det weight
det(Q_nd^2)^{1/2} = |det Q_nd| of the strange/charm sector (NDRAT,
NDCLOVERRAT), the one-flavour det(Qhat_pm)^{1/2} (RAT, CLOVERRAT) and their
accept/reject corrections (*COR).

Port of `tmlqcd_tpu/hmc/rational_monomials.py`.  With the rational
approximation of `solvers.rational`,

    S = phi^+ R(Q^2) phi,   R(x) = sum_j rho_j / (x + sigma_j) ~ x^{-1/2},

the sampled weight is det R(Q^2)^{-1} ~ det(Q^2)^{1/2}.  One multishift CG
per heatbath, acceptance and force:

  * heatbath: phi = B(Q) eta with B^+ B = R^{-1} exactly (first-order
    factorisation), so S_0 = |eta|^2.
  * acceptance: S = sum_j rho_j <phi, (Q^2 + sigma_j)^{-1} phi>.
  * force: dS = -sum_j rho_j 2 Re<y_j, dQ x_j>, x_j = (Q^2 + sigma_j)^{-1} phi,
    y_j = Q x_j — the gradient of a surrogate that is linear in Q(U) at
    stopped x_j, y_j; the poles are summed into one scalar before the one
    `autograd.grad`, so the gauge copy and the clover term are walked once.

Routing, as for the other monomials of the port: pseudofermions live in the
split f32 layout (a doublet is [2(re/im), 2(flavour), 4, 3, T, X, M]) and
every Dirac application — multishift iterations, the heatbath's Q, the y_j —
runs through `ops/wilson_fast`: for CUDA tensors the hopping kernels (one
K1-SD launch per Q_nd or Q_nd^2 for ND, K1-S / K1 for RAT / CLOVERRAT), for
CPU tensors their plain versions.  Every force surrogate runs on `HoppingDiff` (K1 forward, K2
and the adjoint K1 backward); the clover-term part is autograd through
`ops/clover`.  The reference runs its complex jnp operator for the heatbath's
Q and, off the TPU, everywhere; the results differ by f32 rounding.  Each
call builds the gauge copy (and the clover blocks) once (`_NDOps`,
`_RatOps`); nothing is cached across calls.  Under a mesh (the monomial's
`mesh`, a `parallel.Mesh`) the multishift operator A runs on the sharded
operators (`q_nd_sq_fast_shard`, `q_nd_sq_clover_fast_shard`: the doublet on
the multi-RHS slab kernels with flavour as the R axis; `q_hat_pm_fast_shard`,
`q_hat_pm_clover_fast_shard` for RAT), as the reference routes its
multishift solves (reference :103-118, :301-316); Q, the y_j and the
surrogates stay on the whole-lattice kernels, except on a distributed mesh,
where everything runs on the rank's slab (`wilson_fast`).  PyTorch's gradient with respect
to the complex gauge is the conjugate of the reference's convention, hence
`torch_grad_to_jax` before `ta_force_from_grad` (`_force_from_surrogate`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tmlqcd_tpu_torch import rng
from tmlqcd_tpu_torch.comm import global_sum
from tmlqcd_tpu_torch.hmc.monomials import _CloverState, _force_from_surrogate, eo_spinor_shape
from tmlqcd_tpu_torch.lattice import Lattice
from tmlqcd_tpu_torch.ops import clover as cl
from tmlqcd_tpu_torch.ops import ndoublet as nd
from tmlqcd_tpu_torch.ops import split_diag as sd
from tmlqcd_tpu_torch.ops import wilson_fast as wf
from tmlqcd_tpu_torch.solvers.cg import cg
from tmlqcd_tpu_torch.solvers.multishift import cg_multishift
from tmlqcd_tpu_torch.solvers.rational import RationalApprox, rational_invsqrt

__all__ = ["NDRatMonomial", "RatMonomial", "RatCorMonomial", "NDRatCorMonomial",
           "ndrat_correction_samples"]


def _nd_spinor_shape(lat: Lattice) -> tuple:
    return (2, 4, 3) + lat.eo_site_shape


class _NDOps:
    """Q_nd (with or without clover) at one U: the gauge copy and the clover
    blocks built once, differentiable (for a force) or not.  `q` and `a` run
    the kernel operator, `q_diff` the HoppingDiff surrogate."""

    def __init__(self, u: torch.Tensor, params: nd.NDParams, lat: Lattice, grad: bool,
                 mesh=None):
        self.params, self.lat, self.mesh = params, lat, mesh
        self.clover = params.c_sw != 0.0
        with torch.enable_grad() if grad else torch.no_grad():
            self.u = u.detach().requires_grad_(True) if grad else u
            self.ug_e, self.ug_o = wf.split_gauge_pair(self.u, params.wilson, lat)
            if self.clover:
                sw_e, sw_o = cl.sw_blocks_eo(self.u, params.kappa, params.c_sw, lat)
                self.blocks = wf._nd_clover_block_tuple(sw_e, sw_o, params)
        fg = wf.fast_gauge_from_pair(self.ug_e, self.ug_o, params.wilson, lat)
        self.fast = fg
        if self.clover:
            self.fast = wf.FastCloverND(fg, *(b.detach() for b in self.blocks),
                                        epsbar_t=params.epsbar_t)

    def q(self, x2: torch.Tensor) -> torch.Tensor:
        if self.clover:
            return wf.q_nd_clover_fast(self.fast, x2, self.params, self.lat)
        return wf.q_nd_fast(self.fast, x2, self.params, self.lat)

    def a(self, x2: torch.Tensor) -> torch.Tensor:
        if self.mesh is not None:
            if self.clover:
                return wf.q_nd_sq_clover_fast_shard(self.fast, x2, self.params, self.lat,
                                                    self.mesh)
            return wf.q_nd_sq_fast_shard(self.fast, x2, self.params, self.lat, self.mesh)
        # one K1-SD launch per multishift iteration
        if self.clover:
            return wf.q_nd_sq_clover_fast(self.fast, x2, self.params, self.lat)
        return wf.q_nd_sq_fast(self.fast, x2, self.params, self.lat)

    def q_diff(self, x2: torch.Tensor) -> torch.Tensor:
        if self.clover:
            return wf.q_nd_clover_diff(self.ug_e, self.ug_o, *self.blocks, x2, self.params,
                                       self.lat)
        return wf.q_nd_diff(self.ug_e, self.ug_o, x2, self.params, self.lat)

    def force(self, surrogate: torch.Tensor) -> torch.Tensor:
        return _force_from_surrogate(self.u, surrogate)


class _RatOps:
    """Qhat(+) = gamma5 Mhat at mu = 0 (with or without clover) at one U, as
    `_NDOps`: `q` is Qhat_+, `a` is Qhat_pm = Qhat_- Qhat_+."""

    def __init__(self, u: torch.Tensor, params, lat: Lattice, grad: bool, mesh=None):
        self.params, self.lat, self.mesh = params, lat, mesh
        self.clover = params.c_sw != 0.0
        if self.clover:
            self.st = _CloverState(u, params, lat, grad)
            self.u = self.st.u
            self.fast = self.st.fast(params)
            return
        with torch.enable_grad() if grad else torch.no_grad():
            self.u = u.detach().requires_grad_(True) if grad else u
            self.ug_e, self.ug_o = wf.split_gauge_pair(self.u, params, lat)
        self.fast = wf.fast_gauge_from_pair(self.ug_e, self.ug_o, params, lat)

    def q(self, x2: torch.Tensor) -> torch.Tensor:
        if self.clover:
            return wf.q_hat_clover_fast(self.fast, x2, self.params, self.lat, +1.0)
        return wf.q_hat_fast(self.fast, x2, self.params, self.lat, +1.0)

    def a(self, x2: torch.Tensor) -> torch.Tensor:
        op = wf.q_hat_pm_clover_operator if self.clover else wf.q_hat_pm_operator
        return op(self.fast, self.params, self.lat, self.mesh)(x2)

    def q_diff(self, x2: torch.Tensor) -> torch.Tensor:
        if self.clover:
            return self.st.q_plus_diff(x2, self.params)
        return wf.q_hat_diff(self.ug_e, self.ug_o, x2, self.params, self.lat, +1.0)

    def force(self, surrogate: torch.Tensor) -> torch.Tensor:
        return _force_from_surrogate(self.u, surrogate)


def _combine(coef: np.ndarray, xs: torch.Tensor) -> torch.Tensor:
    """sum_l coef[l] xs[l] for complex coefficients on split fields
    [n, 2, ...]: the real parts scale, the imaginary parts scale i x."""
    c = torch.as_tensor(np.stack([coef.real, coef.imag]), dtype=xs.dtype, device=xs.device)
    re, im = torch.tensordot(c, xs, dims=1)
    return re + sd.i_mul_nd(im)


def _weighted_sum(rho: np.ndarray, xs: torch.Tensor) -> torch.Tensor:
    """sum_j rho[j] xs[j] in the fields' dtype."""
    return torch.tensordot(torch.as_tensor(rho, dtype=xs.dtype, device=xs.device), xs, dims=1)


class _RationalBase:
    """heatbath / action / force shared by the degenerate and non-degenerate
    rational monomials, written on the operator state of `_ops`."""

    @property
    def rat(self) -> RationalApprox:
        return rational_invsqrt(self.order, self.s_min, self.s_max)

    def _mms_info(self, ops, b2: torch.Tensor, shifts: np.ndarray, tol: float):
        """Multishift solve (A + shift_k) x_k = b for all k, zero start."""
        res = cg_multishift(ops.a, b2, shifts, tol=tol, maxiter=self.maxiter)
        return res.x, res.iterations

    def q2_operator(self, u: torch.Tensor):
        """(A on split fields, complex field shape) at U: the operator whose
        spectrum [s_min, s_max] must bracket."""
        return self._ops(u, False).a, self._eta_shape()

    def heatbath(self, u, key, eta=None):
        rat = self.rat
        alpha, gamma, beta_n, rho_lead = rat.heatbath_parts()
        if eta is None:
            eta = rng.normal_spinor(key, self._eta_shape(), u.device, lat=self.lat)
        eta2 = wf.to_split(eta)
        ops = self._ops(u, False)
        # x_l = (Q^2 + alpha_l^2)^{-1} eta; the shifts alpha^2 are the numerator roots
        xs, _ = self._mms_info(ops, eta2, rat.a_roots, self.acc_tol)
        # v = eta + sum_l gamma_l (Q - i alpha_l) x_l
        v = eta2 + ops.q(_combine(gamma, xs)) + _combine(gamma * (-1j) * alpha, xs)
        # phi = (Q + i beta_N) v / sqrt(rhoL)
        phi2 = (ops.q(v) + float(beta_n) * sd.i_mul_nd(v)) * float(1.0 / np.sqrt(rho_lead))
        return phi2, wf.dot_re_f64_split(eta2, eta2)

    def action_info(self, u, phi2, hist=None):
        rat = self.rat
        xs, iters = self._mms_info(self._ops(u, False), phi2, rat.sigma, self.acc_tol)
        dots = global_sum((xs.double() * phi2.double()).flatten(1).sum(dim=1))
        rho = torch.as_tensor(rat.rho, dtype=torch.float64, device=dots.device)
        return torch.dot(rho, dots), iters

    def action(self, u, phi2):
        return self.action_info(u, phi2)[0]

    def force_info(self, u, phi2):
        """(F, multishift iterations)."""
        rat = self.rat
        ops = self._ops(u, True)
        xs, iters = self._mms_info(ops, phi2, rat.sigma, self.force_tol)
        with torch.enable_grad():
            s = torch.zeros((), dtype=torch.float64, device=u.device)
            for j in range(rat.order):
                s = s - 2.0 * float(rat.rho[j]) * wf.dot_re_f64_split(ops.q(xs[j]),
                                                                      ops.q_diff(xs[j]))
        return ops.force(s), iters

    def force(self, u, phi2):
        return self.force_info(u, phi2)[0]


@dataclasses.dataclass(frozen=True)
class NDRatMonomial(_RationalBase):
    """Nf=1+1 rational monomial (BeginMonomial NDRAT / NDCLOVERRAT with
    2Kappamubar / 2Kappaepsbar, DegreeOfRational, StildeMin / StildeMax);
    `params.c_sw != 0` selects the clover doublet."""

    lat: Lattice
    params: nd.NDParams
    order: int = 12
    s_min: float = 1e-4  # lower spectral bound of Q_nd^2 (2-kappa normalised)
    s_max: float = 4.0  # upper spectral bound
    timescale: int = 1
    acc_tol: float = 1e-9
    force_tol: float = 1e-8
    maxiter: int = 2000
    name: str = "ndrat"
    mesh: object = None  # parallel.Mesh: the multishift operator on the slab kernels

    def _eta_shape(self) -> tuple:
        return _nd_spinor_shape(self.lat)

    def _ops(self, u, grad: bool) -> _NDOps:
        return _NDOps(u, self.params, self.lat, grad, self.mesh)


@dataclasses.dataclass(frozen=True)
class RatMonomial(_RationalBase):
    """One-flavour degenerate rational monomial — det weight
    det(Qhat_pm)^{1/2} = |det Qhat| of a single Wilson(-clover) flavour
    (types RAT / CLOVERRAT).

    The scheme of NDRatMonomial on single-flavour odd spinors with
    A = Qhat_pm.  The exact first-order heatbath factorisation needs a
    hermitian Q with Q^2 = A, which holds iff mu == 0 (Q = gamma5 Mhat), so
    `params.mu` must be 0.  A twisted one-flavour determinant is an
    NDRatMonomial with epsbar = 0."""

    lat: Lattice
    params: object  # ops.wilson.DiracParams with mu == 0
    order: int = 12
    s_min: float = 1e-4
    s_max: float = 4.0
    timescale: int = 1
    acc_tol: float = 1e-9
    force_tol: float = 1e-8
    maxiter: int = 2000
    name: str = "rat"
    mesh: object = None  # parallel.Mesh: the multishift operator on the slab kernels

    def __post_init__(self):
        if getattr(self.params, "mu", 0.0) != 0.0:
            raise ValueError("RatMonomial requires mu == 0 (hermitian Q = gamma5 Mhat for the "
                             "exact heatbath); use NDRatMonomial with epsbar=0 for a twisted "
                             "one-flavor determinant")

    def _eta_shape(self) -> tuple:
        return eo_spinor_shape(self.lat)

    def _ops(self, u, grad: bool) -> _RatOps:
        return _RatOps(u, self.params, self.lat, grad, self.mesh)


# ---------------------------------------------------------------------------
# Accept/reject-coupled correction monomials.  The RAT / NDRAT monomial
# samples det R^{-1}(Q^2); the correction multiplies in the missing factor
#
#     det[(Q^2)^{1/2} R(Q^2)] = det(Z)^{1/2},   Z = Q^2 R(Q^2)^2 ~ 1,
#
# through a pseudofermion S_cor = phi^+ Z^{-1/2} phi (heatbath phi = Z^{1/4}
# eta, so S_0 = |eta|^2).  Z^{+1/4} and Z^{-1/2} are applied with the binomial
# series (1 + u)^p = sum_k C(p, k) u^k in u = Z - 1, ||u|| <= delta (the
# rational's relative error).  Each Z application costs two multishift solves
# and one Q^2.  The correction acts through the Hamiltonian only; its MD
# force is zero and exactness is restored by the Metropolis step.
# ---------------------------------------------------------------------------


def _binom_coeffs(p: float, n: int) -> np.ndarray:
    """C(p, k), k = 0..n, for the (1 + u)^p series (host f64)."""
    c = np.ones(n + 1)
    for k in range(1, n + 1):
        c[k] = c[k - 1] * (p - (k - 1)) / k
    return c


def _apply_z(mono, ops, v2, tol):
    """(Z v, solver iterations): Z = Q^2 R(Q^2)^2, two multishifts and one
    Q^2; the iteration count is summed over both solves."""
    rat = mono.rat
    xs, it1 = mono._mms_info(ops, v2, rat.sigma, tol)
    xs, it2 = mono._mms_info(ops, _weighted_sum(rat.rho, xs), rat.sigma, tol)
    return ops.a(_weighted_sum(rat.rho, xs)), it1 + it2


def _apply_z_pow(mono, ops, v2, p: float, n_terms: int, tol):
    """(Z^p v, total solver iterations) by the binomial series in Z - 1."""
    coeffs = _binom_coeffs(p, n_terms)
    acc = term = v2
    its = 0
    for k in range(1, n_terms + 1):
        zv, it_k = _apply_z(mono, ops, term, tol)
        term = zv - term
        its += it_k
        acc = acc + float(coeffs[k]) * term
    return acc, its


class _RatCorMixin:
    """heatbath / action / force overrides shared by the degenerate and the
    non-degenerate correction monomials (the base class supplies `_ops`,
    `rat` and the spinor shape)."""

    def heatbath(self, u, key, eta=None):
        if eta is None:
            eta = rng.normal_spinor(key, self._eta_shape(), u.device, lat=self.lat)
        eta2 = wf.to_split(eta)
        phi2, _ = _apply_z_pow(self, self._ops(u, False), eta2, +0.25, self.n_terms, self.acc_tol)
        return phi2, wf.dot_re_f64_split(eta2, eta2)

    def action_info(self, u, phi2, hist=None):
        # iterations: all multishift iterations of the series application
        w2, iters = _apply_z_pow(self, self._ops(u, False), phi2, -0.5, self.n_terms,
                                 self.acc_tol)
        return wf.dot_re_f64_split(phi2, w2), iters

    def force_info(self, u, phi2):
        # accept/reject only: the integrator sees a zero force and no solve
        return torch.zeros_like(u), 0


@dataclasses.dataclass(frozen=True)
class RatCorMonomial(_RatCorMixin, RatMonomial):
    """Correction to RatMonomial: det[(Q^2)^{1/2} R(Q^2)] by accept/reject
    (types RATCOR / CLOVERRATCOR).  Pair it with a RatMonomial of the same
    kappa, c_sw, order and interval."""

    n_terms: int = 4
    name: str = "ratcor"


@dataclasses.dataclass(frozen=True)
class NDRatCorMonomial(_RatCorMixin, NDRatMonomial):
    """Correction to NDRatMonomial: det[(Q_nd^2)^{1/2} R(Q_nd^2)] by
    accept/reject (types NDRATCOR / NDCLOVERRATCOR)."""

    n_terms: int = 4
    name: str = "ndratcor"


def ndrat_correction_samples(mono: NDRatMonomial, u, key: rng.Key, n_samples: int = 6,
                             order_hi: int | None = None) -> torch.Tensor:
    """Stochastic estimate of the rational-approximation correction factor
    as reweighting samples: exponents s_i with det(M)^{-1} = E[exp(s_i)],
    M = R_lo(Q^2) / R_hi(Q^2), where R_hi (order_hi, default twice the
    order) stands in for the exact x^{-1/2}.  One multishift CG per rational
    application; eta_i is drawn from `key.fold(i)`."""
    hi = rational_invsqrt(order_hi or 2 * mono.order, mono.s_min, mono.s_max)
    lo = mono.rat
    with torch.no_grad():
        ops = mono._ops(u, False)

        def apply_rat(rat, v2):
            xs, _ = mono._mms_info(ops, v2, rat.sigma, mono.acc_tol)
            return _weighted_sum(rat.rho, xs)

        samples = []
        for i in range(n_samples):
            eta2 = wf.to_split(rng.normal_spinor(key.fold(i), mono._eta_shape(), u.device,
                                                     lat=mono.lat))
            # R_hi^{-1} eta by CG on R_hi (hermitian positive, well conditioned)
            w2 = cg(lambda x: apply_rat(hi, x), eta2, tol=mono.acc_tol, maxiter=mono.maxiter).x
            m_eta = apply_rat(lo, w2)
            samples.append(wf.dot_re_f64_split(eta2, eta2) - wf.dot_re_f64_split(eta2, m_eta))
    return torch.stack(samples)
