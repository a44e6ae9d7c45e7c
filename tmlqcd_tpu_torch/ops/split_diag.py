"""The site-diagonal pieces of the split-field operators in plain torch.

Split fields hold re and im on a leading axis: a spinor is [2, 4, 3, *sites],
a flavour doublet [2(re/im), 2(flavour), 4, 3, T, X, M].  Here are the
doublet's flavour-mixing diagonals (Mee_nd, Mee_nd^-1, gamma5, tau1 and
their clover block forms: the epilogues the doublet Schur kernel K1-SD
fuses, composed in torch by its plain version, the mesh operators and the
force surrogates) and the split chirality-block matvec.  Every constant
tensor they broadcast is made once per (values, dtype, device) and kept
(`const_like`), so no call copies a Python list to the device.
"""

from __future__ import annotations

import torch

__all__ = [
    "const_like",
    "tau1_split",
    "gamma5_nd",
    "i_mul_nd",
    "imu_g5_tau3_split",
    "mee_nd_split",
    "mee_inv_nd_split",
    "blocks_apply_split",
    "mee_nd_apply_split",
    "mee_inv_nd_apply_split",
]

_CONSTS: dict = {}


def const_like(values: tuple, like: torch.Tensor, ax: int) -> torch.Tensor:
    """`values` as a tensor broadcasting along the axis `ax` of `like`, made
    once per (values, dtype, device, rank) and kept (no host copy per call)."""
    key = (values, like.dtype, like.device, like.ndim - ax - 1)
    if key not in _CONSTS:
        _CONSTS[key] = torch.tensor(values, dtype=like.dtype, device=like.device).view(
            (len(values),) + (1,) * (like.ndim - ax - 1))
    return _CONSTS[key]


def tau1_split(chi2: torch.Tensor) -> torch.Tensor:
    """Flavour swap of a split doublet."""
    return chi2.flip(1)


def gamma5_nd(chi2: torch.Tensor) -> torch.Tensor:
    """gamma5 on both flavours (the spin axis is axis 2)."""
    return chi2 * const_like((1.0, 1.0, -1.0, -1.0), chi2, 2)


def i_mul_nd(chi2: torch.Tensor) -> torch.Tensor:
    """i chi on a split field."""
    return torch.stack([-chi2[1], chi2[0]])


def imu_g5_tau3_split(chi2: torch.Tensor, mu: float) -> torch.Tensor:
    """i mu gamma5 tau3 chi (tau3 = diag(+1, -1) in flavour)."""
    return const_like((mu, -mu), chi2, 1) * i_mul_nd(gamma5_nd(chi2))


def mee_nd_split(chi2: torch.Tensor, mubar_t: float, epsbar_t: float,
                 sign: float) -> torch.Tensor:
    """(1 + i sign mubar_t gamma5 tau3 + epsbar_t tau1) chi."""
    return chi2 + imu_g5_tau3_split(chi2, sign * mubar_t) + epsbar_t * tau1_split(chi2)


def mee_inv_nd_split(chi2: torch.Tensor, mubar_t: float, epsbar_t: float,
                     sign: float) -> torch.Tensor:
    """(1 - i sign mubar_t gamma5 tau3 - epsbar_t tau1) chi
    / (1 + mubar_t^2 - epsbar_t^2)."""
    inv = 1.0 / (1.0 + mubar_t * mubar_t - epsbar_t * epsbar_t)
    return (chi2 - imu_g5_tau3_split(chi2, sign * mubar_t)
            - epsbar_t * tau1_split(chi2)) * inv


def blocks_apply_split(blk2: torch.Tensor, psi2: torch.Tensor) -> torch.Tensor:
    """Split-complex chirality-block matvec: blk2 [2,2,2,2,3,3,*sites],
    psi2 [2,4,3,*sites] -> [2,4,3,*sites].  Plain tensor arithmetic: it
    carries the gradient with respect to the blocks in the force surrogate."""
    br, bi = blk2[0], blk2[1]  # [2, 2, 2, 3, 3, *sites]
    ext = (2, 2, 3) + tuple(psi2.shape[3:])
    pr, pi = psi2[0].reshape(ext), psi2[1].reshape(ext)  # [b, s', c', *sites]
    # out[b, s, c] = sum_{s', c'} blk[b, s, s', c, c'] psi[b, s', c']
    xr, xi = pr[:, None, :, None], pi[:, None, :, None]
    re = (br * xr - bi * xi).sum(dim=(2, 4))
    im = (br * xi + bi * xr).sum(dim=(2, 4))
    return torch.stack([re, im]).reshape(psi2.shape)


def mee_nd_apply_split(moo_u, moo_d, eps: float, chi2: torch.Tensor) -> torch.Tensor:
    """Flavour-2x2 M_oo = [[moo_u, eps], [eps, moo_d]] on raw split blocks."""
    up = blocks_apply_split(moo_u, chi2[:, 0]) + eps * chi2[:, 1]
    dn = blocks_apply_split(moo_d, chi2[:, 1]) + eps * chi2[:, 0]
    return torch.stack([up, dn], dim=1)


def mee_inv_nd_apply_split(minv_a, minv_b, minv_e, eps: float,
                           chi2: torch.Tensor) -> torch.Tensor:
    """Flavour-2x2 M_ee^{-1} = [[A, -eps E], [-eps E, B]] on raw split blocks."""
    up = blocks_apply_split(minv_a, chi2[:, 0]) - eps * blocks_apply_split(minv_e, chi2[:, 1])
    dn = blocks_apply_split(minv_b, chi2[:, 1]) - eps * blocks_apply_split(minv_e, chi2[:, 0])
    return torch.stack([up, dn], dim=1)
