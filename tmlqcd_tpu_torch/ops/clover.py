"""Clover (Sheikholeslami-Wohlert) term: field strength, 6x6 spin-block
algebra, the degenerate and non-degenerate twisted-clover even/odd operators,
and the trlog.

Port of `tmlqcd_tpu/ops/clover.py`.  The
O(a)-improvement term adds to the Wilson diagonal

    T(x) = - kappa c_sw sum_{mu<nu} sigma_munu G_munu(x),
    G_munu = -i/8 [ Q_munu - Q_munu^+ ]   (hermitian, traceless),

with Q_munu the sum of the four clover-leaf plaquettes around x, so the
twisted-clover diagonal is M_pp = 1 + T + i mutld gamma5 on both parities.
sigma_munu commutes with gamma5, so T is two hermitian 6x6 (2 spin x 3
colour) blocks per site, one per chirality.  The inverse is the closed-form
Schur complement of 3x3 colour blocks with 3x3 inverses by adjugate over
determinant: plain tensor expressions over the site axes, differentiable,
so the clover-term force is autograd through `sw_blocks` -> `mee_blocks` /
`mee_inv_blocks` / `sw_logdet`.

Block storage: sw [2 chirality, 2, 2, 3, 3, T, X, M], small axes leading.

Non-degenerate doublet: M_ee^nd = C (x) 1_f + i mubar gamma5 tau3 + epsbar
tau1 with C = 1 + T.  [T, gamma5] = 0, so all flavour blocks commute and the
inverse is [[C - i mu g5, -eps], [-eps, C + i mu g5]] / D with
D = C^2 + mu^2 - eps^2 per chirality.
"""

from __future__ import annotations

import numpy as np
import torch

from tmlqcd_tpu_torch import su3
from tmlqcd_tpu_torch.gamma import SIGMA_MUNU, apply_gamma5
from tmlqcd_tpu_torch.comm import global_sum
from tmlqcd_tpu_torch.lattice import EVEN, ODD, Lattice, eo_pack, shift_full
from tmlqcd_tpu_torch.ops.wilson import DiracParams, dslash_packed

__all__ = [
    "PLANES",
    "clover_leaves",
    "field_strength",
    "sw_blocks",
    "sw_blocks_eo",
    "sw_apply",
    "sw_inv_apply",
    "sw_logdet",
    "m_hat_clover",
    "q_hat_clover",
    "q_hat_pm_clover",
    "mee_blocks",
    "mee_inv_blocks",
    "blocks_apply",
    "mee_nd_clover",
    "mee_inv_nd_clover",
    "sw_logdet_nd",
    "m_hat_nd_clover",
    "q_nd_clover",
    "mee_inv_nd_blocks",
]

PLANES = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]

# sigma_munu restricted to the two chirality blocks (2x2 constants per plane)
_SIGMA_UP = np.stack([SIGMA_MUNU[mu, nu][0:2, 0:2] for mu, nu in PLANES])
_SIGMA_DN = np.stack([SIGMA_MUNU[mu, nu][2:4, 2:4] for mu, nu in PLANES])

# (chirality block, first spin of the block, sign of gamma5 on it)
_CHIRALITIES = ((0, 0, +1.0), (1, 2, -1.0))


def clover_leaves(u: torch.Tensor, mu: int, nu: int, lat: Lattice) -> torch.Tensor:
    """Q_munu(x): the sum of the four oriented plaquette leaves in the
    (mu, nu) plane that touch x.  u: [3, 3, 4, T, X, Mf]."""
    umu, unu = u[:, :, mu], u[:, :, nu]

    def s(f, d, dd):
        return shift_full(f, d, dd, lat)

    # leaf 1: x -> x+mu -> x+mu+nu -> x+nu -> x
    l1 = su3.mul(su3.mul(umu, s(unu, mu, +1)), su3.adj(su3.mul(unu, s(umu, nu, +1))))
    umu_mm = s(umu, mu, -1)  # U_mu(x-mu)
    unu_mn = s(unu, nu, -1)  # U_nu(x-nu)
    # leaf 2: U_nu(x) U_mu(x-mu+nu)^+ U_nu(x-mu)^+ U_mu(x-mu)
    l2 = su3.mul(su3.mul(unu, su3.adj(s(umu_mm, nu, +1))),
                 su3.mul(su3.adj(s(unu, mu, -1)), umu_mm))
    # leaf 3: U_mu(x-mu)^+ U_nu(x-mu-nu)^+ U_mu(x-mu-nu) U_nu(x-nu)
    l3 = su3.mul(su3.mul(su3.adj(umu_mm), su3.adj(s(s(unu, mu, -1), nu, -1))),
                 su3.mul(s(umu_mm, nu, -1), unu_mn))
    # leaf 4: U_nu(x-nu)^+ U_mu(x-nu) U_nu(x+mu-nu) U_mu(x)^+
    l4 = su3.mul(su3.mul(su3.adj(unu_mn), s(umu, nu, -1)),
                 su3.mul(s(unu_mn, mu, +1), su3.adj(umu)))
    return l1 + l2 + l3 + l4


def _eye(like: torch.Tensor) -> torch.Tensor:
    """The 3x3 identity broadcasting against `like` [3, 3, *sites]."""
    return torch.eye(3, dtype=like.dtype, device=like.device).reshape(
        (3, 3) + (1,) * (like.ndim - 2))


def field_strength(u: torch.Tensor, lat: Lattice) -> list:
    """Hermitian traceless clover field strength G_munu = -i/8 (Q - Q^+),
    one [3, 3, T, X, Mf] tensor per plane in PLANES order."""
    gs = []
    for mu, nu in PLANES:
        q = clover_leaves(u, mu, nu, lat)
        ah = q - su3.adj(q)
        ah = ah - (su3.trace(ah) / 3.0) * _eye(ah)
        gs.append(torch.complex(ah.imag / 8.0, -ah.real / 8.0))
    return gs


def sw_blocks(u: torch.Tensor, kappa: float, c_sw: float, lat: Lattice) -> torch.Tensor:
    """The clover term T as two chirality blocks per site:

        sw[b, s, s'] = -kappa c_sw sum_planes sigma_b[plane][s, s'] G_plane

    Returns [2, 2, 2, 3, 3, T, X, Mf] on the full lattice; hermitian,
    sw[b, s, s']^+ = sw[b, s', s].  Differentiable in u."""
    gs = field_strength(u, lat)
    coeff = -kappa * c_sw
    blocks = []
    for sig in (_SIGMA_UP, _SIGMA_DN):
        blk = []
        for s in range(2):
            row = []
            for sp in range(2):
                acc = None
                for ip in range(len(PLANES)):
                    z = complex(sig[ip][s, sp])
                    if z == 0.0:
                        continue
                    term = (coeff * z) * gs[ip]
                    acc = term if acc is None else acc + term
                row.append(torch.zeros_like(gs[0]) if acc is None else acc)
            blk.append(torch.stack(row))
        blocks.append(torch.stack(blk))
    return torch.stack(blocks)


def sw_blocks_eo(u: torch.Tensor, kappa: float, c_sw: float, lat: Lattice):
    """(sw_even, sw_odd): the clover blocks packed to the two parities."""
    return eo_pack(sw_blocks(u, kappa, c_sw, lat), lat)


def _block66(sw_b: torch.Tensor, mutld_term: complex):
    """A = (1 + mutld_term) I + T_b as 2x2 of 3x3 colour blocks (P, Q, R, S)."""
    diag = (1.0 + mutld_term) * _eye(sw_b[0, 0])
    return sw_b[0, 0] + diag, sw_b[0, 1], sw_b[1, 0], sw_b[1, 1] + diag


def sw_apply(sw: torch.Tensor, psi: torch.Tensor, mutld: float,
             sign: float = +1.0) -> torch.Tensor:
    """(1 + T + i sign mutld gamma5) psi for spinors [4, 3, *sites]: spins
    (0, 1) get +i mutld, spins (2, 3) get -i mutld."""
    imu = 1j * sign * mutld
    rows = []
    for b, s0, pm in _CHIRALITIES:
        for s in range(2):
            acc = psi[s0 + s] + (pm * imu) * psi[s0 + s]
            for sp in range(2):
                acc = acc + su3.matvec(sw[b, s, sp], psi[s0 + sp])
            rows.append(acc)
    return torch.stack(rows)


def _schur_inv_apply(p, q, r, s, v0, v1):
    """Solve [[P, Q], [R, S]] [x0; x1] = [v0; v1] through the Schur
    complement of P; v0, v1 colour vectors [3, ...].  Returns (x0, x1, det)
    with det = det(P) det(S - R P^-1 Q)."""
    pinv, detp = su3.inv3(p)
    rpinv = su3.mul(r, pinv)
    stinv, dets = su3.inv3(s - su3.mul(rpinv, q))
    x1 = su3.matvec(stinv, v1 - su3.matvec(rpinv, v0))
    x0 = su3.matvec(pinv, v0 - su3.matvec(q, x1))
    return x0, x1, detp * dets


def sw_inv_apply(sw: torch.Tensor, psi: torch.Tensor, mutld: float,
                 sign: float = +1.0) -> torch.Tensor:
    """(1 + T + i sign mutld gamma5)^-1 psi: the clover M_ee inverse, one
    2x2-block Schur solve per chirality."""
    imu = 1j * sign * mutld
    outs = []
    for b, s0, pm in _CHIRALITIES:
        p, q, r, s = _block66(sw[b], pm * imu)
        x0, x1, _ = _schur_inv_apply(p, q, r, s, psi[s0], psi[s0 + 1])
        outs.extend([x0, x1])
    return torch.stack(outs)


def sw_logdet(sw: torch.Tensor, mutld: float, sign: float = +1.0) -> torch.Tensor:
    """sum_sites log |det (1 + T + i sign mutld gamma5)|^2, accumulated in
    f64: the trlog of the clover even/even block.  |.|^2 because the
    two-flavour weight is det M_ee(+mu) det M_ee(-mu) = |det M_ee(+mu)|^2."""
    imu = 1j * sign * mutld
    total = torch.zeros((), dtype=torch.float64, device=sw.device)
    for b, _, pm in _CHIRALITIES:
        p, q, r, s = _block66(sw[b], pm * imu)
        pinv, detp = su3.inv3(p)
        _, dets = su3.inv3(s - su3.mul(su3.mul(r, pinv), q))
        total = total + torch.sum(torch.log((detp * dets).abs().double() ** 2))
    return global_sum(total)


# ---------------------------------------------------------------------------
# even/odd twisted-clover operators on complex fields (the oracle of the
# split-field operators in ops/wilson_fast.py)
# ---------------------------------------------------------------------------


def m_hat_clover(ueo, sw_e, sw_o, psi_o, params: DiracParams, lat: Lattice, phases,
                 sign: float = +1.0):
    """Clover Schur complement on odd sites:
    Mhat(+-) = M_oo(+-) - kappa^2 H_oe M_ee(+-)^-1 H_eo, with
    M_pp = 1 + T_pp +- i mutld gamma5 (clover on both parities)."""
    tmp = dslash_packed(ueo, psi_o, EVEN, lat, phases)
    tmp = sw_inv_apply(sw_e, tmp, params.mutld, sign)
    tmp = dslash_packed(ueo, tmp, ODD, lat, phases)
    return sw_apply(sw_o, psi_o, params.mutld, sign) - (params.kappa * params.kappa) * tmp


def q_hat_clover(ueo, sw_e, sw_o, psi_o, params: DiracParams, lat: Lattice, phases,
                 sign: float = +1.0):
    """Qsw(+-) = gamma5 Mhat_sw(+-)."""
    return apply_gamma5(m_hat_clover(ueo, sw_e, sw_o, psi_o, params, lat, phases, sign))


def q_hat_pm_clover(ueo, sw_e, sw_o, psi_o, params: DiracParams, lat: Lattice, phases):
    """Qsw_pm = Qsw(-) Qsw(+): the hermitian positive CG operator."""
    tmp = q_hat_clover(ueo, sw_e, sw_o, psi_o, params, lat, phases, +1.0)
    return q_hat_clover(ueo, sw_e, sw_o, tmp, params, lat, phases, -1.0)


# ---------------------------------------------------------------------------
# materialised blocks for the block-matvec epilogues of the hopping kernel
# ---------------------------------------------------------------------------


def mee_blocks(sw: torch.Tensor, mutld: float, sign: float = +1.0) -> torch.Tensor:
    """M_pp(+-) = 1 + T +- i mutld gamma5 as explicit 6x6 blocks
    [2 chirality, 2, 2, 3, 3, *sites]."""
    rows = []
    for b, _, pm in _CHIRALITIES:
        p, q, r, s = _block66(sw[b], pm * 1j * sign * mutld)
        rows.append(torch.stack([torch.stack([p, q]), torch.stack([r, s])]))
    return torch.stack(rows)


def mee_inv_blocks(sw: torch.Tensor, mutld: float, sign: float = +1.0) -> torch.Tensor:
    """M_pp(+-)^-1 as explicit blocks in the layout of `mee_blocks`, by the
    2x2-of-3x3 Schur closed form; computed once per gauge field."""
    rows = []
    for b, _, pm in _CHIRALITIES:
        p, q, r, s = _block66(sw[b], pm * 1j * sign * mutld)
        pinv, _ = su3.inv3(p)
        rp = su3.mul(r, pinv)  # R P^-1
        sti, _ = su3.inv3(s - su3.mul(rp, q))
        qi = -su3.mul(su3.mul(pinv, q), sti)
        ri = -su3.mul(sti, rp)
        pi = pinv - su3.mul(qi, rp)
        rows.append(torch.stack([torch.stack([pi, qi]), torch.stack([ri, sti])]))
    return torch.stack(rows)


def blocks_apply(blocks: torch.Tensor, psi: torch.Tensor) -> torch.Tensor:
    """Apply materialised chirality blocks [2, 2, 2, 3, 3, *sites] to a
    spinor [4, 3, *sites]: out[s0 + s] = sum_s' blocks[b, s, s'] psi[s0 + s']."""
    outs = []
    for b, s0, _ in _CHIRALITIES:
        for s in range(2):
            outs.append(su3.matvec(blocks[b, s, 0], psi[s0])
                        + su3.matvec(blocks[b, s, 1], psi[s0 + 1]))
    return torch.stack(outs)


# ---------------------------------------------------------------------------
# non-degenerate (strange/charm) clover doublet
# ---------------------------------------------------------------------------


def _blk_mul(a, b):
    """Product of two 6x6 matrices in 2x2-of-3x3 block form (P, Q, R, S)."""
    return (su3.mul(a[0], b[0]) + su3.mul(a[1], b[2]),
            su3.mul(a[0], b[1]) + su3.mul(a[1], b[3]),
            su3.mul(a[2], b[0]) + su3.mul(a[3], b[2]),
            su3.mul(a[2], b[1]) + su3.mul(a[3], b[3]))


def _blk_inv(p, q, r, s):
    """Inverse of a 6x6 in 2x2-of-3x3 block form through the Schur complement."""
    pinv, _ = su3.inv3(p)
    rp = su3.mul(r, pinv)
    sti, _ = su3.inv3(s - su3.mul(rp, q))
    qi = -su3.mul(su3.mul(pinv, q), sti)
    ri = -su3.mul(sti, rp)
    return pinv - su3.mul(qi, rp), qi, ri, sti


def _d_blocks(sw_b: torch.Tensor, mubar_t: float, epsbar_t: float):
    """D = C^2 + mubar_t^2 - epsbar_t^2 of one chirality as (P, Q, R, S)."""
    c = _block66(sw_b, 0.0)
    d = list(_blk_mul(c, c))
    shift = (mubar_t * mubar_t - epsbar_t * epsbar_t) * _eye(d[0])
    d[0] = d[0] + shift
    d[3] = d[3] + shift
    return d


def mee_nd_clover(sw, chi, mubar_t: float, epsbar_t: float, sign: float = +1.0):
    """M_ee^nd chi = (C (x) 1_f + i sign mubar gamma5 tau3 + epsbar tau1) chi
    for doublets chi [2, 4, 3, *sites], C = 1 + T."""
    up = sw_apply(sw, chi[0], sign * mubar_t, +1.0)
    dn = sw_apply(sw, chi[1], sign * mubar_t, -1.0)
    return torch.stack([up + epsbar_t * chi[1], dn + epsbar_t * chi[0]])


def mee_inv_nd_clover(sw, chi, mubar_t: float, epsbar_t: float, sign: float = +1.0):
    """(M_ee^nd)^{-1} chi by the closed form of the module docstring: the
    numerators (C -+ i mu g5) chi_f - eps chi_f', then one Schur solve with
    D per chirality and flavour."""
    imu = 1j * sign * mubar_t
    outs_u, outs_d = [], []
    for b, s0, pm in _CHIRALITIES:
        mt = pm * imu
        p, q, r, s = _block66(sw[b], 0.0)

        def apply_c(v0, v1):
            return (su3.matvec(p, v0) + su3.matvec(q, v1), su3.matvec(r, v0) + su3.matvec(s, v1))

        cu = apply_c(chi[0, s0], chi[0, s0 + 1])
        cd = apply_c(chi[1, s0], chi[1, s0 + 1])
        nu = [cu[i] - mt * chi[0, s0 + i] - epsbar_t * chi[1, s0 + i] for i in range(2)]
        nd = [cd[i] + mt * chi[1, s0 + i] - epsbar_t * chi[0, s0 + i] for i in range(2)]
        d = _d_blocks(sw[b], mubar_t, epsbar_t)
        xu0, xu1, _ = _schur_inv_apply(*d, nu[0], nu[1])
        xd0, xd1, _ = _schur_inv_apply(*d, nd[0], nd[1])
        outs_u.extend([xu0, xu1])
        outs_d.extend([xd0, xd1])
    return torch.stack([torch.stack(outs_u), torch.stack(outs_d)])


def sw_logdet_nd(sw, mubar_t: float, epsbar_t: float) -> torch.Tensor:
    """sum_sites log det M_ee^nd = sum_chirality log det(C^2 + mu^2 - eps^2),
    accumulated in f64: the even/even factor of the nd clover determinant."""
    total = torch.zeros((), dtype=torch.float64, device=sw.device)
    for b, _, _ in _CHIRALITIES:
        p2, q2, r2, s2 = _d_blocks(sw[b], mubar_t, epsbar_t)
        pinv, detp = su3.inv3(p2)
        _, dets = su3.inv3(s2 - su3.mul(su3.mul(r2, pinv), q2))
        total = total + torch.sum(torch.log((detp * dets).abs().double()))
    return global_sum(total)


def m_hat_nd_clover(ueo, sw_e, sw_o, chi_o, params, lat: Lattice, phases, sign: float = +1.0):
    """Clover nd Schur complement on odd sites:
    Mhat = M_oo^nd - kappa^2 H_oe (M_ee^nd)^{-1} H_eo, H flavour-diagonal;
    params: `ops.ndoublet.NDParams`."""
    def hop(chi, p):
        return torch.stack([dslash_packed(ueo, chi[0], p, lat, phases),
                            dslash_packed(ueo, chi[1], p, lat, phases)])

    tmp = mee_inv_nd_clover(sw_e, hop(chi_o, EVEN), params.mubar_t, params.epsbar_t, sign)
    return (mee_nd_clover(sw_o, chi_o, params.mubar_t, params.epsbar_t, sign)
            - (params.kappa * params.kappa) * hop(tmp, ODD))


def q_nd_clover(ueo, sw_e, sw_o, chi_o, params, lat: Lattice, phases):
    """Q_nd^sw = gamma5 tau1 Mhat_nd^sw — hermitian."""
    m = m_hat_nd_clover(ueo, sw_e, sw_o, chi_o, params, lat, phases, +1.0)
    return torch.stack([apply_gamma5(m[1]), apply_gamma5(m[0])])


def mee_inv_nd_blocks(sw: torch.Tensor, mubar_t: float, epsbar_t: float, sign: float = +1.0):
    """The flavour-2x2 inverse of M_ee^nd as three chirality-block fields
    (A, B, E), each [2 chirality, 2, 2, 3, 3, *sites], computed once per
    gauge field:

        (M_ee^nd)^{-1} = [[A, -eps E], [-eps E, B]],
        A = (C - i sign mubar g5) D^{-1},  B = (C + i sign mubar g5) D^{-1},
        E = D^{-1},  D = C^2 + mubar^2 - eps^2   (per chirality; g5 = +-1)."""
    outs = []
    for b, _, pm in _CHIRALITIES:
        mt = pm * 1j * sign * mubar_t
        cp = _block66(sw[b], mt)  # C + i mu (this chirality)
        cm = _block66(sw[b], -mt)  # C - i mu
        d = list(_blk_mul(cp, cm))  # C^2 + mu^2
        e2 = (epsbar_t * epsbar_t) * _eye(d[0])
        d[0] = d[0] - e2
        d[3] = d[3] - e2
        e = _blk_inv(*d)
        pack = lambda t: torch.stack([torch.stack(t[:2]), torch.stack(t[2:])])  # noqa: E731
        outs.append((pack(_blk_mul(cm, e)), pack(_blk_mul(cp, e)), pack(e)))
    return tuple(torch.stack([outs[0][i], outs[1][i]]) for i in range(3))
