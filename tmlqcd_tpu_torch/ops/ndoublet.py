"""Non-degenerate twisted-mass flavour doublet (strange/charm) operators on
complex tensors — the oracle of the split-field doublet operators in
`ops/wilson_fast.py`.

Port of `tmlqcd_tpu/ops/ndoublet.py`.  The Nf=1+1 sector of an Nf=2+1+1 run,
weighted by det(Q_nd^2)^{1/2} through the rational (NDRAT) monomial.  In the
2-kappa normalisation of `ops/wilson.py`:

    D_h = (1 + i mubar_t gamma5 tau3 + epsbar_t tau1) - kappa H (x) 1_f

with mubar_t = 2 kappa mubar, epsbar_t = 2 kappa epsbar, H the hopping matrix
(flavour-diagonal) and tau_i the Pauli matrices in flavour space.  The
doublet is gamma5 tau1-hermitian, (gamma5 tau1) D_h (gamma5 tau1) = D_h^+,
so Q_nd = gamma5 tau1 Mhat_nd is hermitian (not positive) and the rational
monomial works on Q_nd^2 > 0.

Even/odd Schur preconditioning: M_ee = 1 + i mubar_t gamma5 tau3 +
epsbar_t tau1 with the closed-form inverse

    M_ee^{-1} = (1 - i mubar_t gamma5 tau3 - epsbar_t tau1)
                / (1 + mubar_t^2 - epsbar_t^2),

which needs 1 + mubar_t^2 > epsbar_t^2 (checked by `NDParams`).

Layout: doublet fields are [2 flavour, 4 spin, 3 colour, T, X, M]; works in
complex64 and complex128.
"""

from __future__ import annotations

import dataclasses

import torch

from tmlqcd_tpu_torch.gamma import apply_gamma5
from tmlqcd_tpu_torch.lattice import EVEN, ODD, Lattice
from tmlqcd_tpu_torch.ops.wilson import DiracParams, dslash_packed

__all__ = ["NDParams", "mee_nd", "mee_inv_nd", "m_hat_nd", "q_nd", "q_nd_sq", "tau1",
           "gamma5_tau1"]


@dataclasses.dataclass(frozen=True)
class NDParams:
    """Static parameters of the non-degenerate doublet operator (input keys
    2Kappamubar / 2Kappaepsbar of a DBTMWILSON operator or an NDRAT
    monomial)."""

    kappa: float
    mubar: float
    epsbar: float
    c_sw: float = 0.0
    theta: tuple[float, float, float, float] = (1.0, 0.0, 0.0, 0.0)

    def __post_init__(self):
        if 1.0 + self.mubar_t**2 <= self.epsbar_t**2:
            raise ValueError("non-degenerate doublet needs 1 + (2k mubar)^2 > (2k epsbar)^2")

    @property
    def mubar_t(self) -> float:
        return 2.0 * self.kappa * self.mubar

    @property
    def epsbar_t(self) -> float:
        return 2.0 * self.kappa * self.epsbar

    @property
    def wilson(self) -> DiracParams:
        """The flavour-diagonal hopping parameters (mu is not used there)."""
        return DiracParams(kappa=self.kappa, mu=0.0, c_sw=self.c_sw, theta=self.theta)


def tau1(chi: torch.Tensor) -> torch.Tensor:
    """Flavour swap tau1 chi for doublets [2, 4, 3, ...]."""
    return chi.flip(0)


def gamma5_tau1(chi: torch.Tensor) -> torch.Tensor:
    """gamma5 tau1 chi."""
    return torch.stack([apply_gamma5(chi[1]), apply_gamma5(chi[0])])


def _imu_g5_tau3(chi: torch.Tensor, mubar_t: float, sign: float) -> torch.Tensor:
    """sign * i mubar_t gamma5 tau3 chi (tau3 = diag(+1, -1) in flavour)."""
    imu = 1j * sign * mubar_t
    return torch.stack([imu * apply_gamma5(chi[0]), -imu * apply_gamma5(chi[1])])


def mee_nd(chi: torch.Tensor, mubar_t: float, epsbar_t: float,
           sign: float = +1.0) -> torch.Tensor:
    """M_ee(+-) chi = (1 +- i mubar_t gamma5 tau3 + epsbar_t tau1) chi (the
    same for M_oo)."""
    return chi + _imu_g5_tau3(chi, mubar_t, sign) + epsbar_t * tau1(chi)


def mee_inv_nd(chi: torch.Tensor, mubar_t: float, epsbar_t: float,
               sign: float = +1.0) -> torch.Tensor:
    """M_ee(+-)^{-1} chi, closed form (see the module docstring)."""
    inv = 1.0 / (1.0 + mubar_t * mubar_t - epsbar_t * epsbar_t)
    return (chi - _imu_g5_tau3(chi, mubar_t, sign) - epsbar_t * tau1(chi)) * inv


def _dslash_doublet(ueo, chi, p: int, lat: Lattice, phases) -> torch.Tensor:
    """Flavour-diagonal hopping on a doublet: H (x) 1_f."""
    return torch.stack([dslash_packed(ueo, chi[0], p, lat, phases),
                        dslash_packed(ueo, chi[1], p, lat, phases)])


def m_hat_nd(ueo, chi_o, params: NDParams, lat: Lattice, phases,
             sign: float = +1.0) -> torch.Tensor:
    """Schur complement on odd sites:
    Mhat_nd(+-) = M_oo(+-) - kappa^2 H_oe M_ee(+-)^{-1} H_eo."""
    tmp = _dslash_doublet(ueo, chi_o, EVEN, lat, phases)
    tmp = mee_inv_nd(tmp, params.mubar_t, params.epsbar_t, sign)
    tmp = _dslash_doublet(ueo, tmp, ODD, lat, phases)
    return (mee_nd(chi_o, params.mubar_t, params.epsbar_t, sign)
            - (params.kappa * params.kappa) * tmp)


def q_nd(ueo, chi_o, params: NDParams, lat: Lattice, phases) -> torch.Tensor:
    """Q_nd = gamma5 tau1 Mhat_nd — hermitian by gamma5-tau1-hermiticity."""
    return gamma5_tau1(m_hat_nd(ueo, chi_o, params, lat, phases, +1.0))


def q_nd_sq(ueo, chi_o, params: NDParams, lat: Lattice, phases) -> torch.Tensor:
    """Q_nd^2 — hermitian positive-definite; the multishift-CG operator of
    the rational monomial."""
    return q_nd(ueo, q_nd(ueo, chi_o, params, lat, phases), params, lat, phases)
