"""Overlap (Neuberger) fermions: the chirally exact Dirac operator through
the matrix sign function of the hermitian Wilson kernel.

Port of `tmlqcd_tpu/ops/overlap.py` (reference: operator/Dov_psi.c,
solver/eigenvalues.c):

    D_ov(m) = (rho + m/2) + (rho - m/2) gamma5 sign(Q_W)
    Q_W     = gamma5 D_W(-rho),   kappa = 1/(8 - 2 rho), mu = 0

sign(Q_W) psi is exact on the n_ev lowest modes of Q_W (Lanczos on Q_W^2,
signs from Q_W's Rayleigh quotients) and Q_W p(Q_W^2) psi on their
complement, p the Chebyshev approximation of 1/sqrt on [lo^2, hi^2].  The
polynomial part is re-projected onto the complement, so the approximate
sign is exactly hermitian for any subspace quality.

Routing.  The reference applies Q_W with the jnp `d_full` on the full
lattice.  Here every Q_W runs on K1 (`wilson_fast.hop_fast`, the port of
`_dslash_kernel`): on the even/odd split pair x = (x_e, x_o) each parity
half is one K1 launch with the `mhat` epilogue at mutld = 0, k2 = kappa and
gamma5 on, whose `psi_o` argument is the same-parity half of x:

    (Q_W x)_p = gamma5 (x_p - kappa H_{p,1-p} x_{1-p})

two launches per Q_W, four per Q_W^2, on the gauge copy of
`make_fast_gauge(u, params.kernel, lat)` (the boundary phases of `theta`
baked in).  `sign_q` converts its field to the split pair once on entry and
back once on exit, so the 2 (degree + 1) Q_W^2 of the Clenshaw sum and the
final Q_W are K1 launches back to back: 4 (degree + 1) + 2 per application.
On CPU tensors K1 is its plain version.  `sign_q` and `dov_psi` take
`plain=True` for the reference's route instead, gamma5 `wilson.d_full` on
complex fields: the check of the kernel route on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from tmlqcd_tpu_torch import rng
from tmlqcd_tpu_torch.gamma import apply_gamma5
from tmlqcd_tpu_torch.lattice import EVEN, ODD, Lattice, eo_pack, eo_unpack
from tmlqcd_tpu_torch.ops import wilson_fast as wf
from tmlqcd_tpu_torch.ops.wilson import DiracParams, d_full
from tmlqcd_tpu_torch.solvers.chebyshev import chebyshev_apply, chebyshev_coeffs, chebyshev_eval

__all__ = [
    "OverlapParams",
    "OverlapSetup",
    "make_overlap",
    "qw_split",
    "qw_plain",
    "to_pair",
    "from_pair",
    "sign_q",
    "dov_psi",
    "dov_dagger_psi",
    "gw_defect",
    "invert_overlap",
    "k1_launches_per_sign",
]


@dataclasses.dataclass(frozen=True)
class OverlapParams:
    """Static overlap parameters: the Ginsparg-Wilson radius rho in (0, 2)
    (= 1 + s of the input), the bare mass m, the Chebyshev degree of the
    1/sqrt approximation and the number of exactly treated low modes."""

    rho: float = 1.0
    m: float = 0.0
    degree: int = 64
    n_ev: int = 0
    lanczos_steps: Optional[int] = None  # default max(8 n_ev, 60)
    theta: tuple = (1.0, 0.0, 0.0, 0.0)  # boundary phases (antiperiodic t)

    @property
    def kernel(self) -> DiracParams:
        """Negative-mass Wilson kernel D_W(-rho): kappa = 1/(8 - 2 rho)."""
        return DiracParams(kappa=1.0 / (8.0 - 2.0 * self.rho), mu=0.0, theta=self.theta)


@dataclasses.dataclass(frozen=True)
class OverlapSetup:
    """Per-gauge-configuration overlap state: the gauge field and K1's copy
    of it, the deflation subspace of Q_W and the Chebyshev data."""

    u: torch.Tensor  # full gauge [3,3,4,T,X,Mf] complex64
    fg: wf.FastGauge  # K1's gauge copy with the kernel's boundary phases
    evecs: torch.Tensor  # [n_ev, 4, 3, T, X, Mf] unit Ritz vectors of Q_W
    ev_signs: torch.Tensor  # [n_ev] sign(lambda_i), f32
    coeffs: tuple
    lo2: float
    hi2: float
    params: OverlapParams
    lat: Lattice
    ev_resid: float = 0.0
    lanczos_steps: int = 0  # Lanczos steps taken (for the launch count)

    @property
    def sign_err(self) -> float:
        """max |x p(x^2) - 1| over the approximation interval: the sign
        function's (= chirality's) accuracy off the deflated subspace."""
        x = np.sqrt(np.linspace(self.lo2, self.hi2, 4001))
        return float(np.max(np.abs(
            x * chebyshev_eval(np.asarray(self.coeffs), x * x, self.lo2, self.hi2) - 1.0)))


def k1_launches_per_sign(degree: int) -> int:
    """K1 launches of one `sign_q` on the kernel route: the Clenshaw sum's
    degree + 1 applications of Q_W^2 (4 each) and the final Q_W (2)."""
    return 4 * (degree + 1) + 2


def to_pair(psi: torch.Tensor, lat: Lattice) -> torch.Tensor:
    """Full complex spinor [4,3,T,X,Mf] -> the split even/odd pair
    [2 parity, 2 re/im, 4, 3, T, X, M] f32, contiguous."""
    e, o = eo_pack(psi, lat)
    return torch.stack([wf.to_split(e), wf.to_split(o)])


def from_pair(x: torch.Tensor, lat: Lattice) -> torch.Tensor:
    """Inverse of `to_pair` (complex64)."""
    return eo_unpack(wf.from_split(x[EVEN]), wf.from_split(x[ODD]), lat)


def qw_split(fg: wf.FastGauge, x: torch.Tensor, kappa: float, lat: Lattice) -> torch.Tensor:
    """Q_W on the split pair: one K1 launch per parity with the mhat
    epilogue (mutld 0, k2 = kappa, gamma5), psi_o the same-parity half."""
    epi = ("mhat", 0.0, 1.0, float(kappa), True)
    out_e = wf.hop_fast(fg, x[ODD], EVEN, lat, epi, psi_o=x[EVEN])
    out_o = wf.hop_fast(fg, x[EVEN], ODD, lat, epi, psi_o=x[ODD])
    return torch.stack([out_e, out_o])


def qw_plain(u: torch.Tensor, psi: torch.Tensor, params: OverlapParams,
             lat: Lattice) -> torch.Tensor:
    """Q_W = gamma5 D_W(-rho) on the full lattice, the reference's route."""
    return apply_gamma5(d_full(u, psi, params.kernel, lat))


def make_overlap(u: torch.Tensor, params: OverlapParams, lat: Lattice, v0=None,
                 key: rng.Key | None = None, eps: float | None = None) -> OverlapSetup:
    """Per-configuration setup: Lanczos low modes of Q_W, the spectral
    interval of the complement, Chebyshev coefficients of 1/sqrt.

    The Lanczos start vector is `v0` (complex [4,3,T,X,Mf]), else a gaussian
    drawn from `key` (default `rng.Key(11)`).  `eps` overrides the degree
    with the smallest power of two from 16 whose sign error on [lo, hi] is
    below eps."""
    from tmlqcd_tpu_torch.solvers.lanczos import _dot, lanczos_herm, ritz_rotation, ritz_vectors

    shape = (4, 3) + lat.site_shape
    fg = wf.make_fast_gauge(u, params.kernel, lat)
    if v0 is None:
        v0 = rng.normal_spinor(key if key is not None else rng.Key(11), shape, u.device)
    # (Q_W, Q_W^2) on full complex fields for the Lanczos steps and the
    # Ritz signs, on K1: one conversion each way per call
    kappa = params.kernel.kappa
    q = lambda x: qw_split(fg, x, kappa, lat)  # noqa: E731
    qw = lambda x: from_pair(q(to_pair(x, lat)), lat)  # noqa: E731
    q2 = lambda x: from_pair(q(q(to_pair(x, lat))), lat)  # noqa: E731

    # Lanczos on Q^2 (not Q): the sign-relevant smallest-|lambda| modes are
    # interior eigenvalues of the indefinite Q but extremal ones of Q^2
    steps = params.lanczos_steps or max(8 * params.n_ev, 60)
    with torch.no_grad():
        alphas, betas, basis = lanczos_herm(q2, v0.to(u.dtype), steps)
        theta2, s = ritz_rotation(alphas, betas)
        order = np.argsort(theta2)  # Q^2 >= 0: ascending == ascending magnitude

        n_ev = min(params.n_ev, max(len(theta2) - 1, 0))
        ev_resid = 0.0
        if n_ev:
            evecs = ritz_vectors(s[:, order[:n_ev]], basis)
            nrm = torch.sqrt(torch.sum(torch.abs(evecs) ** 2, dim=tuple(range(1, evecs.ndim)),
                                       keepdim=True))
            evecs = evecs / nrm.to(evecs.dtype)
            # signs from Rayleigh quotients of Q; |Q v - <v,Qv> v| measures
            # how invariant the deflated subspace is
            signs_l, resid_l = [], []
            for i in range(n_ev):
                vi = evecs[i]
                qv = qw(vi)
                th = float(_dot(vi, qv).real)
                resid_l.append(float(torch.linalg.vector_norm(qv - th * vi)))
                signs_l.append(np.sign(th) if th != 0.0 else 1.0)
            signs = torch.as_tensor(np.asarray(signs_l), dtype=torch.float32, device=u.device)
            ev_resid = float(np.max(resid_l))
        else:
            evecs = torch.zeros((0,) + shape, dtype=u.dtype, device=u.device)
            signs = torch.zeros((0,), dtype=torch.float32, device=u.device)

    # complement interval on Q^2: the first undeflated Ritz value (biased
    # high: pad down hard) to the top Ritz value (biased low: pad up)
    th_sorted = theta2[order]
    lo2 = float(max(th_sorted[n_ev], 0.0) * 0.5) if len(th_sorted) > n_ev else 1e-6
    lo2 = max(lo2, 1e-12)
    hi2 = float(np.max(th_sorted) * 1.5)

    inv_sqrt = lambda x: 1.0 / np.sqrt(x)  # noqa: E731
    if eps is not None:
        degree, err = 8, np.inf
        while degree < 4096 and err > eps:
            degree *= 2
            c = chebyshev_coeffs(inv_sqrt, degree, lo2, hi2)
            x = np.sqrt(np.linspace(lo2, hi2, 4001))
            err = np.max(np.abs(x * chebyshev_eval(c, x * x, lo2, hi2) - 1.0))
        coeffs = c
    else:
        coeffs = chebyshev_coeffs(inv_sqrt, params.degree, lo2, hi2)

    return OverlapSetup(u=u, fg=fg, evecs=evecs, ev_signs=signs,
                        coeffs=tuple(float(c) for c in coeffs), lo2=lo2, hi2=hi2, params=params,
                        lat=lat, ev_resid=ev_resid, lanczos_steps=len(alphas))


def _defl_project(setup: OverlapSetup, psi: torch.Tensor):
    """(coefficients <v_i, psi>, psi - V V^+ psi), or (None, psi)."""
    if setup.evecs.shape[0] == 0:
        return None, psi
    axes = tuple(range(1, setup.evecs.ndim))
    c = torch.sum(torch.conj(setup.evecs) * psi[None], dim=axes)  # [n_ev]
    shape = (-1,) + (1,) * psi.ndim
    return c, psi - torch.sum(c.reshape(shape) * setup.evecs, dim=0)


def sign_q(setup: OverlapSetup, psi: torch.Tensor, plain: bool = False) -> torch.Tensor:
    """sign(Q_W) psi (complex [4,3,T,X,Mf]): exact on the deflated low
    modes, Q p(Q^2) on the complement.  The polynomial runs on K1 on the
    split pair (converted once each way), or on `d_full` with `plain`."""
    p, lat = setup.params, setup.lat
    coeffs = np.asarray(setup.coeffs)
    c, perp = _defl_project(setup, psi)
    if plain:
        qw = lambda x: qw_plain(setup.u, x, p, lat)  # noqa: E731
        s = qw(chebyshev_apply(lambda x: qw(qw(x)), coeffs, perp, setup.lo2, setup.hi2))
    else:
        kappa = p.kernel.kappa
        qw = lambda x: qw_split(setup.fg, x, kappa, lat)  # noqa: E731
        t = chebyshev_apply(lambda x: qw(qw(x)), coeffs, to_pair(perp, lat), setup.lo2,
                            setup.hi2)
        s = from_pair(qw(t), lat)
    if c is not None:
        # P_perp Q p(Q^2) P_perp + sum_i sign_i v_i v_i^+: exactly hermitian
        # for any subspace quality (the residual costs sign accuracy only)
        _, s = _defl_project(setup, s)
        sc = c * setup.ev_signs.to(c.real.dtype)
        s = s + torch.sum(sc.reshape((-1,) + (1,) * psi.ndim) * setup.evecs, dim=0)
    return s


def dov_psi(setup: OverlapSetup, psi: torch.Tensor, plain: bool = False) -> torch.Tensor:
    """D_ov(m) psi = (rho + m/2) psi + (rho - m/2) gamma5 sign(Q_W) psi."""
    p = setup.params
    return ((p.rho + 0.5 * p.m) * psi
            + (p.rho - 0.5 * p.m) * apply_gamma5(sign_q(setup, psi, plain)))


def dov_dagger_psi(setup: OverlapSetup, psi: torch.Tensor) -> torch.Tensor:
    """D_ov^+ = gamma5 D_ov gamma5 (sign(Q_W) is hermitian)."""
    return apply_gamma5(dov_psi(setup, apply_gamma5(psi)))


def gw_defect(setup: OverlapSetup, psi: torch.Tensor) -> float:
    """|{gamma5, D} psi - D gamma5 D psi / rho| / |psi| at m = 0: the
    Ginsparg-Wilson violation of the approximate sign function."""
    s0 = dataclasses.replace(setup, params=dataclasses.replace(setup.params, m=0.0))
    d = lambda x: dov_psi(s0, x)  # noqa: E731
    d_psi = d(psi)
    lhs = apply_gamma5(d_psi) + d(apply_gamma5(psi))
    rhs = d(apply_gamma5(d_psi)) / setup.params.rho
    return float(torch.linalg.vector_norm(lhs - rhs) / torch.linalg.vector_norm(psi))


def invert_overlap(setup: OverlapSetup, b: torch.Tensor, tol: float = 1e-8, maxiter: int = 500,
                   solver: str = "sumr"):
    """Solve D_ov(m) x = b on the full lattice (no even/odd Schur complement:
    the sign function is dense).  'sumr': the shifted-unitary solver on
    zeta + rho_s gamma5 sign(Q), one sign per iteration; 'cgne': CG on
    D^+ D x = D^+ b, two signs per iteration."""
    p = setup.params
    with torch.no_grad():
        if solver == "sumr":
            from tmlqcd_tpu_torch.solvers.sumr import sumr

            return sumr(lambda x: apply_gamma5(sign_q(setup, x)), b, zeta=p.rho + 0.5 * p.m,
                        rho=p.rho - 0.5 * p.m, tol=tol, maxiter=maxiter)
        from tmlqcd_tpu_torch.solvers.cg import cg

        return cg(lambda x: dov_dagger_psi(setup, dov_psi(setup, x)), dov_dagger_psi(setup, b),
                  tol=tol, maxiter=maxiter)
