"""Wilson / twisted-mass Dirac operators on complex tensors — the port's
oracle for the kernels below it.

Port of `tmlqcd_tpu/ops/wilson.py` (tmLQCD 2-kappa normalisation):

    M psi = (1 + i mutld gamma5) psi
            - kappa * sum_mu [ ph_mu   (1 - gamma_mu) U_mu(x)      psi(x+mu)
                             + ph_mu^* (1 + gamma_mu) U_mu(x-mu)^+ psi(x-mu) ]

    Mhat(+-) = M_oo - M_oe M_ee^{-1} M_eo (odd sites),  Qhat = gamma5 Mhat,
    Qhat_pm = Qhat(-) Qhat(+).

Spin algebra here is the dense 4x4 projector acting after the SU(3)
matrix-vector product — deliberately a different arithmetic from the CUDA
kernel's half-spinor factorisation, so the two check each other.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

from tmlqcd_tpu_torch.gamma import GAMMA, apply_gamma5
from tmlqcd_tpu_torch.lattice import EVEN, ODD, Lattice, hop_packed

__all__ = [
    "DiracParams",
    "boundary_phases",
    "hop_projector",
    "dslash_packed",
    "mee_packed",
    "mee_inv_packed",
    "m_hat",
    "q_hat",
    "q_hat_pm",
]


@dataclasses.dataclass(frozen=True)
class DiracParams:
    """Physics parameters of one Wilson twisted-mass operator."""

    kappa: float
    mu: float = 0.0  # twisted mass
    c_sw: float = 0.0  # clover coefficient (the clover operators are not ported yet)
    theta: tuple[float, float, float, float] = (1.0, 0.0, 0.0, 0.0)

    @property
    def mutld(self) -> float:
        """2*kappa*mu — the twisted diagonal after 2-kappa rescaling."""
        return 2.0 * self.kappa * self.mu


def boundary_phases(params: DiracParams, lat: Lattice) -> np.ndarray:
    """Per-direction hopping phases exp(i pi theta_mu / L_mu) (numpy c128)."""
    return np.array(
        [np.exp(1j * np.pi * params.theta[mu] / lat.dims[mu]) for mu in range(4)],
        dtype=np.complex128,
    )


@lru_cache(maxsize=None)
def _projector(mu: int, fb: int, dtype: torch.dtype, device: str) -> torch.Tensor:
    p = np.eye(4) - GAMMA[mu] if fb == 0 else np.eye(4) + GAMMA[mu]
    return torch.as_tensor(p, dtype=dtype, device=device)


def hop_projector(mu: int, fb: int, like: torch.Tensor) -> torch.Tensor:
    """(1 - gamma_mu) for the forward hop (fb=0), (1 + gamma_mu) backward."""
    return _projector(mu, fb, like.dtype, str(like.device))


def spin_apply(pm: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """out[s] = sum_s' pm[s, s'] v[s'] for v [4, ...]."""
    ext = (1,) * (v.ndim - 1)
    return sum(pm[:, s].reshape((4,) + ext) * v[s][None] for s in range(4))


def color_apply(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """out[s, i] = sum_j u[i, j] v[s, j] for u [3, 3, *sites], v [4, 3, *sites]."""
    return (u[None, :, 0] * v[:, None, 0] + u[None, :, 1] * v[:, None, 1]
            + u[None, :, 2] * v[:, None, 2])


def dslash_packed(ueo: torch.Tensor, psi_q: torch.Tensor, p: int, lat: Lattice,
                  phases: np.ndarray) -> torch.Tensor:
    """Even/odd hopping H_{p,q} psi_q -> parity-p sites (q = 1-p).
    ueo: [2, 3, 3, 4, T, X, M]; psi_q: [4, 3, T, X, M] complex."""
    q = 1 - p
    out = None
    for mu in range(4):
        # forward: ph (1-g_mu) U_mu(x) psi(x+mu); U_mu(x) lives on parity p
        fwd = hop_packed(psi_q, p, mu, +1, lat)
        term = complex(phases[mu]) * spin_apply(
            hop_projector(mu, 0, psi_q), color_apply(ueo[p, :, :, mu], fwd))
        out = term if out is None else out + term
        # backward: ph^* (1+g_mu) U_mu(x-mu)^+ psi(x-mu); U_mu(x-mu) on parity q
        bwd = hop_packed(psi_q, p, mu, -1, lat)
        ub = hop_packed(ueo[q, :, :, mu], p, mu, -1, lat)
        ubd = torch.conj_physical(ub.transpose(0, 1))
        out = out + complex(np.conj(phases[mu])) * spin_apply(
            hop_projector(mu, 1, psi_q), color_apply(ubd, bwd))
    return out


def mee_packed(psi: torch.Tensor, mutld: float, sign: float = +1.0) -> torch.Tensor:
    """M_ee(+-) psi = (1 +- i mutld gamma5) psi (same for M_oo)."""
    return psi + (1j * sign * mutld) * apply_gamma5(psi)


def mee_inv_packed(psi: torch.Tensor, mutld: float, sign: float = +1.0) -> torch.Tensor:
    """M_ee(+-)^{-1} psi = (1 -+ i mutld gamma5) psi / (1 + mutld^2)."""
    return (psi - (1j * sign * mutld) * apply_gamma5(psi)) * (1.0 / (1.0 + mutld * mutld))


def m_hat(ueo, psi_o, params: DiracParams, lat: Lattice, phases, sign: float = +1.0):
    """Mhat(+-) psi = (1 +- i mutld g5) psi - kappa^2 H_oe M_ee(+-)^{-1} H_eo psi."""
    tmp = dslash_packed(ueo, psi_o, EVEN, lat, phases)
    tmp = mee_inv_packed(tmp, params.mutld, sign)
    tmp = dslash_packed(ueo, tmp, ODD, lat, phases)
    return mee_packed(psi_o, params.mutld, sign) - (params.kappa * params.kappa) * tmp


def q_hat(ueo, psi_o, params: DiracParams, lat: Lattice, phases, sign: float = +1.0):
    """Qhat(+-) = gamma5 Mhat(+-)."""
    return apply_gamma5(m_hat(ueo, psi_o, params, lat, phases, sign))


def q_hat_pm(ueo, psi_o, params: DiracParams, lat: Lattice, phases):
    """Qhat_pm = Qhat(-) Qhat(+) — the hermitian positive CG operator."""
    return q_hat(ueo, q_hat(ueo, psi_o, params, lat, phases, +1.0), params, lat, phases, -1.0)
