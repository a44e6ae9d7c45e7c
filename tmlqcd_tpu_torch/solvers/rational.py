"""Optimal rational approximation of x^{-1/2} (Zolotarev-type) for RHMC.

The port's own copy of `tmlqcd_tpu/solvers/rational.py` (numpy only, host
f64): the partial-fraction form (shifts `sigma`, residues `rho`) parameterises
the acceptance and force multishift solves, the first-order-factored form
(`heatbath_parts`) the exact pseudofermion heatbath.

Construction here: the elliptic integral representation

    x^{-1/2} = (2/pi) * Integral_0^inf dt / (x + t^2)

with the substitution t = sqrt(m) * sc(u; kappa), kappa^2 = 1 - m/M, mapped
to u in (0, K(kappa)) and discretized by the N-point midpoint rule:

    R(x) = sum_j rho_j / (x + sigma_j),
    sigma_j = m * sc^2(u_j; kappa),  rho_j = (2 K sqrt(m) / (pi N)) dn_j/cn_j^2,
    u_j = (j - 1/2) K / N.

This midpoint/elliptic construction attains the same exponential convergence
rate exp(-c N / log(M/m)) as Zolotarev's closed-form optimum (it is the
classical optimal-ADI-shift construction; Zolotarev's equioscillating
solution differs only by a bounded factor in the constant), all residues and
shifts are positive, and a final scalar rebalancing (`_balance`) centres the
relative error, measured on the interval as `max_rel_err`.  Elliptic
K and Jacobi sn/cn/dn are implemented with AGM + descending Landen in pure
numpy f64 (reference: rational/elliptic.c does the same job).

Exact heatbath factorization (reference: rat.nu/rat.rnu usage in
monomial/ndrat_monomial.c): with R(x) = p(x)/q(x), q = prod(x + sigma_j),
the roots -a_l of p interlace the poles, all a_l > 0, and

    B(Q) = rhoL^{-1/2} * prod_j (Q + i sqrt(sigma_j)) / prod_l (Q + i sqrt(a_l))

satisfies B^+ B = R(Q^2)^{-1} for hermitian Q (|Q + i c|^2 = Q^2 + c^2), so
phi = B eta gives exactly S_0 = phi^+ R(Q^2) phi = |eta|^2.  `heatbath_parts`
returns the partial-fraction data for applying B with ONE multishift CG.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["RationalApprox", "rational_invsqrt", "elliptic_k", "jacobi_sn_cn_dn"]


def elliptic_k(k: float) -> float:
    """Complete elliptic integral K(k) (modulus k) via AGM:
    K = pi / (2 agm(1, k')), k' = sqrt(1 - k^2)."""
    a, b = 1.0, float(np.sqrt(max(1.0 - k * k, 0.0)))
    if b == 0.0:
        raise ValueError("K diverges at k=1")
    while abs(a - b) > 1e-16 * a:
        a, b = 0.5 * (a + b), float(np.sqrt(a * b))
    return float(np.pi / (2.0 * a))


def jacobi_sn_cn_dn(u: float, k: float) -> tuple[float, float, float]:
    """Jacobi elliptic sn, cn, dn at argument u, modulus k — AGM descending
    Landen (Abramowitz & Stegun 16.4/17.6; reference: rational/elliptic.c)."""
    m = k * k
    if m < 1e-14:
        return float(np.sin(u)), float(np.cos(u)), 1.0
    a_list, c_list = [1.0], [k]
    b = float(np.sqrt(1.0 - m))
    a = 1.0
    while abs(c_list[-1]) > 1e-16 * a:
        a, b, c = 0.5 * (a + b), float(np.sqrt(a * b)), 0.5 * (a - b)
        a_list.append(a)
        c_list.append(c)
    n = len(a_list) - 1
    phi = (2.0**n) * a_list[n] * u
    for i in range(n, 0, -1):
        s = np.clip(c_list[i] / a_list[i] * np.sin(phi), -1.0, 1.0)
        phi = 0.5 * (phi + np.arcsin(s))
    sn = float(np.sin(phi))
    cn = float(np.cos(phi))
    dn = float(np.sqrt(max(1.0 - m * sn * sn, 1e-300)))
    return sn, cn, dn


@dataclasses.dataclass(frozen=True)
class RationalApprox:
    """R(x) = sum_j rho[j]/(x + sigma[j]) ~ x^{-1/2} on [s_min, s_max].

    All arrays are host numpy f64 constants; they parameterise the
    multishift solves.
    """

    order: int
    s_min: float
    s_max: float
    sigma: np.ndarray  # [N] positive shifts (poles at -sigma)
    rho: np.ndarray  # [N] positive residues
    a_roots: np.ndarray  # [N-1] positive numerator roots (zeros at -a)
    rho_lead: float  # leading numerator coefficient = sum(rho)
    max_rel_err: float  # measured max |sqrt(x) R(x) - 1| on the interval

    def __call__(self, x):
        x = np.asarray(x, np.float64)[..., None]
        return np.sum(self.rho / (x + self.sigma), axis=-1)

    def heatbath_parts(self):
        """Partial-fraction data for B(Q) with B^+B = R(Q^2)^{-1}:

            B(Q) = (Q + i beta_N)/sqrt(rhoL) * [eta + sum_l gamma_l/(Q + i alpha_l)]

        Returns (alpha [N-1] real, gamma [N-1] complex, beta_last real, rhoL).
        The solves (Q + i alpha_l)^{-1} = (Q - i alpha_l)(Q^2 + alpha_l^2)^{-1}
        need one multishift CG with shifts alpha_l^2 = a_roots.
        """
        beta = np.sqrt(self.sigma)  # zeros of B's numerator: -i beta_j
        alpha = np.sqrt(self.a_roots)  # poles of B: -i alpha_l
        n = self.order
        gamma = np.zeros(n - 1, np.complex128)
        for el in range(n - 1):
            q = -1j * alpha[el]
            num = np.prod(q + 1j * beta[: n - 1])
            den = np.prod(np.delete(q + 1j * alpha, el))
            gamma[el] = num / den
        return alpha, gamma, float(beta[-1]), float(self.rho_lead)


def _balance(sigma: np.ndarray, rho: np.ndarray, s_min: float, s_max: float):
    """Rescale rho so the relative error e(x) = sqrt(x) R(x) - 1 is centred
    (optimal constant for fixed poles), and measure max |e|."""
    xs = np.geomspace(s_min, s_max, 20001)
    e = np.sqrt(xs) * np.sum(rho / (xs[:, None] + sigma), axis=-1)
    scale = 2.0 / (e.max() + e.min())
    rho = rho * scale
    e = e * scale - 1.0
    return rho, float(np.max(np.abs(e)))


def _numerator_roots(sigma: np.ndarray, rho: np.ndarray) -> np.ndarray:
    """Roots -a_l of the numerator p(x) of R = p/q: exactly one sign change
    of R between consecutive poles on the negative axis (all rho > 0);
    bisection per gap — numerically safe for any order."""

    def r_of(x):
        return float(np.sum(rho / (x + sigma)))

    s_sorted = np.sort(sigma)
    roots = []
    for j in range(len(s_sorted) - 1):
        lo, hi = -s_sorted[j + 1], -s_sorted[j]  # R(lo+) = -inf, R(hi-) = +inf
        pad = 1e-12 * (hi - lo)
        lo, hi = lo + pad, hi - pad
        flo = r_of(lo)
        for _ in range(200):
            mid = 0.5 * (lo + hi)
            fm = r_of(mid)
            if (fm < 0.0) == (flo < 0.0):
                lo, flo = mid, fm
            else:
                hi = mid
        roots.append(-0.5 * (lo + hi))  # a_l = -root > 0
    return np.asarray(roots, np.float64)


def rational_invsqrt(order: int, s_min: float, s_max: float) -> RationalApprox:
    """Build the order-N rational approximation of x^{-1/2} on [s_min, s_max]
    (reference: init_rational with np=order, interval [eps*smax, smax])."""
    if not (0 < s_min < s_max):
        raise ValueError("need 0 < s_min < s_max")
    m, bigm = float(s_min), float(s_max)
    kappa = float(np.sqrt(1.0 - m / bigm))
    bigk = elliptic_k(kappa)
    sigma = np.empty(order, np.float64)
    rho = np.empty(order, np.float64)
    for j in range(order):
        u = (j + 0.5) * bigk / order
        sn, cn, dn = jacobi_sn_cn_dn(u, kappa)
        sigma[j] = m * (sn / cn) ** 2
        rho[j] = (2.0 * bigk * np.sqrt(m) / (np.pi * order)) * dn / (cn * cn)
    rho, err = _balance(sigma, rho, m, bigm)
    a_roots = _numerator_roots(sigma, rho)
    return RationalApprox(
        order=order,
        s_min=m,
        s_max=bigm,
        sigma=sigma,
        rho=rho,
        a_roots=a_roots,
        rho_lead=float(np.sum(rho)),
        max_rel_err=err,
    )
