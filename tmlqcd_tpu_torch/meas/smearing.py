"""Gauge-covariant source and link smearing: Jacobi, APE and stout.

Port of `tmlqcd_tpu/meas/smearing.py` (reference: jacobi.c, stout_smear.c).
The reference's `lax.scan` sweeps are Python loops here.  Definitions:

  Jacobi:  psi' = (1 + 6 kappa)^{-1} [psi + kappa H psi], iterated N times,
           H psi(x) = sum_{i=1..3} U_i(x) psi(x+i) + U_i(x-i)^+ psi(x-i)
  APE:     U_i' = P_SU3[(1 - alpha) U_i + (alpha/4) (up + down staples)],
           spatial links only, P_SU3 the covariant polar projection
           (`su3.project_su3_polar`); temporal links untouched
  stout:   U_mu' = exp(TA(rho C_mu U_mu^+)) U_mu, C_mu the staple sum

Jacobi and APE are purely spatial: a timeslice source stays on its
timeslice.  All three commute with gauge rotations.  Layouts: spinors
[4, 3, T, X, Y*Z] (full lattice), gauge [3, 3, 4, T, X, Y*Z].
"""

from __future__ import annotations

import torch

from tmlqcd_tpu_torch import su3
from tmlqcd_tpu_torch.lattice import Lattice, shift_full

__all__ = ["jacobi_smear", "ape_smear_spatial", "stout_smear"]


def _cov_fwd(u_i: torch.Tensor, psi: torch.Tensor, i: int, lat: Lattice) -> torch.Tensor:
    """U_i(x) psi(x+i) for a spinor [4, 3, T, X, Mf]."""
    nbr = shift_full(psi, i, +1, lat)
    return torch.stack([su3.matvec(u_i, nbr[s]) for s in range(4)])


def _cov_bwd(u_i: torch.Tensor, psi: torch.Tensor, i: int, lat: Lattice) -> torch.Tensor:
    """U_i(x-i)^+ psi(x-i)."""
    ud = su3.adj(shift_full(u_i, i, -1, lat))
    nbr = shift_full(psi, i, -1, lat)
    return torch.stack([su3.matvec(ud, nbr[s]) for s in range(4)])


def jacobi_smear(psi: torch.Tensor, u: torch.Tensor, lat: Lattice, kappa: float = 0.21,
                 n_iter: int = 5) -> torch.Tensor:
    """`n_iter` Jacobi sweeps (the covariant 3D-Laplacian source smearing) of
    a full-lattice spinor; usually on APE-smeared spatial links."""
    norm = 1.0 / (1.0 + 6.0 * kappa)
    for _ in range(n_iter):
        h = torch.zeros_like(psi)
        for i in (1, 2, 3):
            u_i = u[:, :, i]
            h = h + _cov_fwd(u_i, psi, i, lat) + _cov_bwd(u_i, psi, i, lat)
        psi = norm * (psi + kappa * h)
    return psi


def _staples(u: torch.Tensor, i: int, lat: Lattice, dirs) -> torch.Tensor:
    """Sum of the staples around U_i over the planes (i, j), j in dirs \\ {i}:
    up = U_j(x) U_i(x+j) U_j(x+i)^+, down = U_j(x-j)^+ U_i(x-j) U_j(x-j+i)."""
    u_i = u[:, :, i]
    acc = None
    for j in dirs:
        if j == i:
            continue
        u_j = u[:, :, j]
        up = su3.mul(su3.mul(u_j, shift_full(u_i, j, +1, lat)),
                     su3.adj(shift_full(u_j, i, +1, lat)))
        u_j_mj = shift_full(u_j, j, -1, lat)
        down = su3.mul(su3.mul(su3.adj(u_j_mj), shift_full(u_i, j, -1, lat)),
                       shift_full(u_j_mj, i, +1, lat))
        acc = up + down if acc is None else acc + up + down
    return acc


def ape_smear_spatial(u: torch.Tensor, lat: Lattice, alpha: float = 0.5,
                      n_iter: int = 4) -> torch.Tensor:
    """`n_iter` APE sweeps of the spatial links (temporal links pass
    through): U_i -> P_SU3[(1 - alpha) U_i + (alpha/4) staple sum]."""
    for _ in range(n_iter):
        new = [u[:, :, 0]]
        for i in (1, 2, 3):
            st = _staples(u, i, lat, (1, 2, 3))
            new.append(su3.project_su3_polar((1.0 - alpha) * u[:, :, i] + (alpha / 4.0) * st))
        u = torch.stack(new, dim=2)
    return u


def stout_smear(u: torch.Tensor, lat: Lattice, rho: float = 0.1, n_iter: int = 1,
                spatial_only: bool = False) -> torch.Tensor:
    """`n_iter` stout sweeps (Morningstar-Peardon; the UseStoutSmearing /
    StoutRho / StoutNoIterations input keys): Omega_mu = rho C_mu U_mu^+,
    U_mu -> exp(TA(Omega_mu)) U_mu.  No reunitarisation step: the map is
    smooth in U and autograd differentiates through it.  `spatial_only`
    smears the spatial links with spatial staples alone."""
    dirs = (1, 2, 3) if spatial_only else (0, 1, 2, 3)
    for _ in range(n_iter):
        new = []
        for mu in range(4):
            if spatial_only and mu == 0:
                new.append(u[:, :, 0])
                continue
            omega = su3.mul(rho * _staples(u, mu, lat, dirs), su3.adj(u[:, :, mu]))
            new.append(su3.mul(su3.expm_ta(su3.ta_project(omega)), u[:, :, mu]))
        u = torch.stack(new, dim=2)
    return u
