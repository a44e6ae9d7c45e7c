"""SUMR — minimal-residual solver for shifted unitary systems
(zeta I + rho U) x = b with U unitary.

Port of `tmlqcd_tpu/solvers/sumr.py` (reference: solver/sumr.c).  The
overlap operator D_ov = zeta + rho (gamma5 sign(Q_W)) is shifted unitary, and
SUMR converges on it with ONE application of U per iteration and short
recurrences (five field vectors, no stored basis).

The recurrence is the reference's (Gragg's coupled two-term isometric
Arnoldi with Schur parameters gamma_j = <w_j, U v_j>, sigma_j =
sqrt(1 - |gamma_j|^2), and a running Givens QR collapsed to the scalars
phi_j, W_j and the rotated right-hand side g).  The reference's
`lax.while_loop` is a Python loop here, and its (re, im) f64 scalar pairs are
Python complex numbers (complex128 on the host): one host read per iteration,
gamma_j, after which every scalar and the stopping test |g|^2 are host
arithmetic.  Fields stay in the dtype of b.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

__all__ = ["sumr", "SUMRResult"]


class SUMRResult(NamedTuple):
    x: torch.Tensor
    iterations: int
    residual_sq: float  # |b - (zeta + rho U) x|^2 estimate (f64)


def _dot(a: torch.Tensor, b: torch.Tensor) -> complex:
    """<a, b> (conjugate-linear in a), f64 accumulation, read to the host."""
    return complex(torch.vdot(a.reshape(-1).to(torch.complex128),
                              b.reshape(-1).to(torch.complex128)))


def _cplx(z) -> complex:
    return complex(z[0], z[1]) if isinstance(z, tuple) else complex(float(z), 0.0)


def sumr(matvec_u: Callable, b: torch.Tensor, zeta, rho, tol: float = 1e-8,
         maxiter: int = 500, rel_prec: bool = True) -> SUMRResult:
    """Solve (zeta + rho U) x = b, U unitary; `matvec_u` applies U only.
    zeta and rho are real floats (the overlap mass case) or complex shifts
    as (re, im) tuples; a negative or complex rho is rotated to |rho| first.
    Stops at |r|^2 <= tol^2 |b|^2 (rel_prec) or |r|^2 <= tol^2, or after
    `maxiter` iterations."""
    zt, rh = _cplx(zeta), _cplx(rho)
    if rh.imag != 0.0 or rh.real < 0.0:
        # the recurrence takes the subdiagonal |rho| sigma_j as real and
        # non-negative, which holds for rho > 0 only: solve
        # (zeta/ph + |rho| U) x = b/ph, ph = rho/|rho|, instead (the
        # reference returns a wrong x for a negative or complex rho)
        ph = rh / abs(rh)
        zt, rh, b = zt / ph, complex(abs(rh)), b * (1.0 / ph)
    b_sq = float(torch.sum(torch.view_as_real(b).double() ** 2))
    delta = math.sqrt(b_sq)
    target_sq = tol * tol * (b_sq if rel_prec else 1.0)

    v = b / delta
    w = v  # w_1 = v_1
    x = torch.zeros_like(b)
    m_prev = torch.zeros_like(b)
    wvec = torch.zeros_like(b)
    phi_p = 0j  # phi_0 (unused; phi_1 is forced by gamma_0 = -1)
    gam_p = -1 + 0j  # gamma_0 = -1  => phi_1 = 1
    sig_p = 0.0
    c_p = 1.0
    s_p = 0j
    g = complex(delta)  # g_1 = |b|
    rn2 = b_sq
    j = 0
    while j < maxiter and rn2 > target_sq:
        t = matvec_u(v)  # U v_j — the one matvec
        gam = _dot(w, t)  # the one host read
        sig = math.sqrt(max(1.0 - abs(gam) ** 2, 0.0))
        inv_sig = 1.0 / sig if sig > 1e-14 else 0.0
        v_next = (t - gam * w) * inv_sig
        w_next = (w - gam.conjugate() * t) * inv_sig

        # phi_j = -sigma_{j-1} conj(s_{j-1}) phi_{j-1} - conj(gamma_{j-1}) c_{j-1}
        phi = -sig_p * s_p.conjugate() * phi_p - c_p * gam_p.conjugate()
        # W_j = sigma_{j-1} W_{j-1}
        #       + (sigma_{j-1} c_{j-1} phi_{j-1} - conj(gamma_{j-1}) s_{j-1}) m_{j-1}
        wcoef = sig_p * c_p * phi_p - gam_p.conjugate() * s_p
        wv = wvec * sig_p + wcoef * m_prev
        # u_j = zeta s_{j-1} m_{j-1} + rho gamma_j W_j
        u_vec = (zt * s_p) * m_prev + (rh * gam) * wv

        # pre-rotation diagonal and (real, >= 0) subdiagonal; Givens with c_j real
        dtil = c_p * zt + rh * gam * phi
        sub = abs(rh) * sig
        ad = abs(dtil)
        rr = math.sqrt(ad * ad + sub * sub)
        safe_rr = rr if rr > 0 else 1.0
        c_j = ad / safe_rr
        ph_d = dtil / ad if ad > 0 else 1 + 0j
        s_j = (sub / safe_rr) * ph_d
        r_jj = safe_rr * ph_d

        m_j = (v - u_vec) * (1.0 / r_jj)
        x = x + (c_j * g) * m_j
        g = -s_j.conjugate() * g
        rn2 = abs(g) ** 2

        v, w, m_prev, wvec = v_next, w_next, m_j, wv
        phi_p, gam_p, sig_p, c_p, s_p = phi, gam, sig, c_j, s_j
        j += 1
    return SUMRResult(x=x, iterations=j, residual_sq=rn2)
