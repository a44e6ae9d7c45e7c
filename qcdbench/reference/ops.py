"""Plain PyTorch reference of the lattice-QCD operators the benchmark holds
the port to: gauge action and plaquette, the full twisted-mass and
twisted-clover Wilson operators, the even/odd Schur complement of the
twisted-mass operator, and CG.

Written from the published definitions (tmLQCD's 2-kappa normalisation, its
chiral gamma basis, boundary phases exp(i pi theta_mu / L_mu) on every hop)
in a layout of its own: gauge [3, 3, 4 mu, T, X, Y, Z], spinors
[..., 4 spin, 3 colour, T, X, Y, Z].  The spin projectors act on half
spinors; colour products are broadcast multiply-adds, so no matrix-multiply
library call (and no TF32) is involved.  Imports nothing of the program.

    M psi = (1 + T + i mutld gamma5) psi
            - kappa sum_mu [ ph_mu (1 - gamma_mu) U_mu(x) psi(x + mu)
                           + ph_mu^* (1 + gamma_mu) U_mu(x - mu)^+ psi(x - mu) ]
    T     = -kappa c_sw sum_{mu<nu} sigma_munu G_munu,
    G     = -i/8 (Q - Q^+) traceless, Q the four clover leaves at x
    S_g   = beta sum_x [ c0 sum_{mu<nu} (1 - Re tr P / 3)
                       + c1 sum_{mu!=nu} (1 - Re tr R / 3) ],  c0 = 1 - 8 c1
"""

from __future__ import annotations

import numpy as np
import torch

_i = 1j
GAMMA = np.array(
    [
        [[0, 0, -1, 0], [0, 0, 0, -1], [-1, 0, 0, 0], [0, -1, 0, 0]],
        [[0, 0, 0, -_i], [0, 0, -_i, 0], [0, _i, 0, 0], [_i, 0, 0, 0]],
        [[0, 0, 0, -1], [0, 0, 1, 0], [0, 1, 0, 0], [-1, 0, 0, 0]],
        [[0, 0, -_i, 0], [0, 0, 0, _i], [_i, 0, 0, 0], [0, -_i, 0, 0]],
    ],
    dtype=np.complex128,
)
G5 = (1.0, 1.0, -1.0, -1.0)
PLANES = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
SIGMA = {(mu, nu): 0.5j * (GAMMA[mu] @ GAMMA[nu] - GAMMA[nu] @ GAMMA[mu]) for mu, nu in PLANES}

# site axes are the last four (T, X, Y, Z); colour at -5, spin at -6
_SITE = 4


def _half_spinor_maps():
    """(1 - s gamma_mu) = B A with A its first two rows (2x4) and B (4x2),
    per (mu, s), as numpy arrays."""
    maps = {}
    for mu in range(4):
        for s in (+1, -1):
            p = np.eye(4) - s * GAMMA[mu]
            a = p[0:2]
            c = p[2:4] @ np.linalg.pinv(a)
            if not np.allclose(c @ a, p[2:4]):
                raise AssertionError("projector is not rank 2")
            maps[mu, s] = (a, np.vstack([np.eye(2), c]))
    return maps


_MAPS = _half_spinor_maps()


def _spin(m: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A spin matrix [n, k] shaped to act on axis -6 of `like`: [n, k, 1, 1, 1, 1, 1]."""
    return torch.as_tensor(m, dtype=like.dtype, device=like.device).reshape(
        m.shape + (1,) * (_SITE + 1))


def shift(f: torch.Tensor, mu: int, d: int) -> torch.Tensor:
    """Value at x + d mu_hat (periodic) of a field whose last four axes are sites."""
    return torch.roll(f, -d, dims=f.ndim - _SITE + mu)


def adj(m: torch.Tensor) -> torch.Tensor:
    return torch.conj(m.transpose(0, 1))


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """3x3 products over the two leading axes (a broadcast product summed
    over the inner index)."""
    return (a.unsqueeze(2) * b.unsqueeze(0)).sum(1)


def retrace(m: torch.Tensor) -> torch.Tensor:
    return (m[0, 0] + m[1, 1] + m[2, 2]).real


def _colour(u: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """out[..., r, i] = sum_j u[i, j] h[..., r, j] (colour axis -5)."""
    return (u * h.unsqueeze(-6)).sum(-5)


def phases(theta, dims) -> list:
    return [complex(np.exp(1j * np.pi * theta[mu] / dims[mu])) for mu in range(4)]


def back_links(u: torch.Tensor) -> list:
    """U_mu(x - mu)^+ for each mu."""
    return [adj(shift(u[:, :, mu], mu, -1)) for mu in range(4)]


def hop(u: torch.Tensor, psi: torch.Tensor, ph: list, back: list | None = None) -> torch.Tensor:
    """H psi: the hopping sum of M without kappa and the diagonal.  Each
    term projects to two spin components (A), multiplies by the link and
    reconstructs four (B)."""
    back = back_links(u) if back is None else back
    out = None
    for mu in range(4):
        for s, link, z in ((+1, u[:, :, mu], ph[mu]), (-1, back[mu], ph[mu].conjugate())):
            a, b = _MAPS[mu, s]
            src = shift(psi, mu, s)
            half = (_spin(a * z, psi) * src.unsqueeze(-7)).sum(-6)
            term = (_spin(b, psi) * _colour(link, half).unsqueeze(-7)).sum(-6)
            out = term if out is None else out + term
    return out


def gamma5(psi: torch.Tensor) -> torch.Tensor:
    sign = torch.tensor(G5, dtype=psi.real.dtype, device=psi.device)
    return psi * sign.reshape((4, 1) + (1,) * _SITE)


def twist(psi: torch.Tensor, mutld: float, sign: float = +1.0) -> torch.Tensor:
    """(1 + i sign mutld gamma5) psi."""
    return psi + (1j * sign * mutld) * gamma5(psi)


# ---------------------------------------------------------------------------
# clover term
# ---------------------------------------------------------------------------


def clover_leaves(u: torch.Tensor, mu: int, nu: int) -> torch.Tensor:
    umu, unu = u[:, :, mu], u[:, :, nu]
    umu_m = shift(umu, mu, -1)
    unu_n = shift(unu, nu, -1)
    l1 = mul(mul(umu, shift(unu, mu, +1)), adj(mul(unu, shift(umu, nu, +1))))
    l2 = mul(mul(unu, adj(shift(umu_m, nu, +1))), mul(adj(shift(unu, mu, -1)), umu_m))
    l3 = mul(mul(adj(umu_m), adj(shift(shift(unu, mu, -1), nu, -1))),
             mul(shift(umu_m, nu, -1), unu_n))
    l4 = mul(mul(adj(unu_n), shift(umu, nu, -1)), mul(shift(unu_n, mu, +1), adj(umu)))
    return l1 + l2 + l3 + l4


def clover_g(u: torch.Tensor) -> list:
    """G_munu = -i/8 (Q - Q^+), traceless, one [3, 3, *sites] per plane."""
    out = []
    eye = torch.eye(3, dtype=u.dtype, device=u.device).reshape((3, 3) + (1,) * _SITE)
    for mu, nu in PLANES:
        q = clover_leaves(u, mu, nu)
        a = q - adj(q)
        a = a - ((a[0, 0] + a[1, 1] + a[2, 2]) / 3.0) * eye
        out.append(-0.125j * a)
    return out


def clover_apply(g: list, psi: torch.Tensor, kappa: float, c_sw: float) -> torch.Tensor:
    """T psi with T = -kappa c_sw sum_planes sigma_munu (x) G_munu."""
    out = [0.0] * 4
    for (mu, nu), gp in zip(PLANES, g):
        sig = SIGMA[mu, nu]
        cp = _colour(gp, psi)
        for k in range(4):
            for j in range(4):
                if abs(sig[k, j]) > 1e-12:
                    out[k] = out[k] + (-kappa * c_sw * complex(sig[k, j])) * cp.select(-6, j)
    return torch.stack(out, dim=-6)


class Operator:
    """The full twisted-mass (c_sw = 0) or twisted-clover operator M on a
    gauge field [3, 3, 4, T, X, Y, Z], applied to spinors [..., 4, 3, T, X, Y, Z]."""

    def __init__(self, u: torch.Tensor, kappa: float, mutld: float, c_sw: float = 0.0,
                 theta=(1.0, 0.0, 0.0, 0.0)):
        self.u, self.kappa, self.mutld, self.c_sw = u, float(kappa), float(mutld), float(c_sw)
        self.ph = phases(theta, u.shape[-4:])
        self.back = back_links(u)
        self.g = clover_g(u) if c_sw != 0.0 else None

    def __call__(self, psi: torch.Tensor) -> torch.Tensor:
        out = twist(psi, self.mutld) - self.kappa * hop(self.u, psi, self.ph, self.back)
        if self.g is not None:
            out = out + clover_apply(self.g, psi, self.kappa, self.c_sw)
        return out

    def dagger(self, psi: torch.Tensor) -> torch.Tensor:
        """M^+ = gamma5 M(-mutld) gamma5."""
        flip = Operator.__new__(Operator)
        flip.__dict__.update(self.__dict__, mutld=-self.mutld)
        return gamma5(flip(gamma5(psi)))


# ---------------------------------------------------------------------------
# gauge action and plaquette
# ---------------------------------------------------------------------------


def plaquette_sum(u: torch.Tensor) -> torch.Tensor:
    acc = torch.zeros((), dtype=torch.float64, device=u.device)
    for mu, nu in PLANES:
        umu, unu = u[:, :, mu], u[:, :, nu]
        p = mul(mul(umu, shift(unu, mu, +1)), adj(mul(unu, shift(umu, nu, +1))))
        acc = acc + retrace(p).double().sum()
    return acc


def rectangle_sum(u: torch.Tensor) -> torch.Tensor:
    """Re tr of the 1x2 rectangles, two steps along mu and one along nu,
    summed over the 12 ordered planes."""
    acc = torch.zeros((), dtype=torch.float64, device=u.device)
    for mu in range(4):
        for nu in range(4):
            if nu == mu:
                continue
            umu, unu = u[:, :, mu], u[:, :, nu]
            umu_f = shift(umu, mu, +1)
            top = mul(mul(umu, umu_f), shift(shift(unu, mu, +1), mu, +1))
            umu_n = shift(umu, nu, +1)
            bottom = mul(mul(unu, umu_n), shift(umu_n, mu, +1))
            acc = acc + retrace(mul(top, adj(bottom))).double().sum()
    return acc


def volume(u: torch.Tensor) -> int:
    return int(np.prod(u.shape[-4:]))


def plaquette(u: torch.Tensor) -> float:
    """<Re tr P / 3> over the six planes."""
    return float(plaquette_sum(u) / (18.0 * volume(u)))


def gauge_action(u: torch.Tensor, beta: float, c1: float) -> torch.Tensor:
    v = volume(u)
    s = (1.0 - 8.0 * c1) * (6.0 * v - plaquette_sum(u) / 3.0)
    if c1 != 0.0:
        s = s + c1 * (12.0 * v - rectangle_sum(u) / 3.0)
    return beta * s


# ---------------------------------------------------------------------------
# even/odd Schur complement of the twisted-mass operator (odd sites)
# ---------------------------------------------------------------------------


def odd_mask(dims, device) -> torch.Tensor:
    t, x, y, z = (torch.arange(n, device=device) for n in dims)
    s = t[:, None, None, None] + x[None, :, None, None] + y[None, None, :, None] + z
    return (s % 2 == 1)


class Schur:
    """Mhat(+-) = M_oo - M_oe M_ee^{-1} M_eo and Qhat(+-) = gamma5 Mhat(+-)
    of the twisted-mass operator, on full-lattice fields that vanish on the
    even sites; differentiable in u."""

    def __init__(self, u: torch.Tensor, kappa: float, mutld: float, theta=(1.0, 0.0, 0.0, 0.0)):
        self.u, self.kappa, self.mutld = u, float(kappa), float(mutld)
        self.ph = phases(theta, u.shape[-4:])
        self.back = back_links(u)
        odd = odd_mask(u.shape[-4:], u.device)
        self.odd, self.even = odd.to(u.real.dtype), (~odd).to(u.real.dtype)

    def m_hat(self, x: torch.Tensor, sign: float, mutld: float | None = None,
              u: torch.Tensor | None = None) -> torch.Tensor:
        mt = self.mutld if mutld is None else mutld
        uu, back = (self.u, self.back) if u is None else (u, back_links(u))
        tmp = hop(uu, x, self.ph, back) * self.even
        tmp = (tmp - (1j * sign * mt) * gamma5(tmp)) / (1.0 + mt * mt)
        tmp = hop(uu, tmp, self.ph, back) * self.odd
        return twist(x, mt, sign) - (self.kappa * self.kappa) * tmp

    def q_hat(self, x, sign, mutld=None, u=None):
        return gamma5(self.m_hat(x, sign, mutld, u))

    def q_pm(self, x, mutld=None):
        return self.q_hat(self.q_hat(x, +1.0, mutld), -1.0, mutld)


# ---------------------------------------------------------------------------
# CG
# ---------------------------------------------------------------------------


def dot_re(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Re <a, b> summed in f64 over every axis."""
    return (a.real.double() * b.real.double() + a.imag.double() * b.imag.double()).sum()


def cg(matvec, b: torch.Tensor, tol: float, maxiter: int, rnd=None):
    """CG on a hermitian positive operator, |r| <= tol |b|; f64 dots; `rnd`
    rounds every stored vector (the control's lower precision).  Returns
    (x, iterations)."""
    rnd = rnd or (lambda v: v)
    x = torch.zeros_like(b)
    r = rnd(b.clone())
    p = r
    rs = dot_re(r, r)
    target = tol * tol * rs
    k = 0
    while k < maxiter and rs > target:
        ap = rnd(matvec(p))
        alpha = float(rs / dot_re(p, ap))
        x = rnd(x + alpha * p)
        r = rnd(r - alpha * ap)
        rs_new = dot_re(r, r)
        p = rnd(r + float(rs_new / rs) * p)
        rs = rs_new
        k += 1
    return x, k
