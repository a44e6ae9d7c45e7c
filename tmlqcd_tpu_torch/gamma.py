"""Dirac gamma matrices (tmLQCD chiral basis) and gamma5.

Port of `tmlqcd_tpu/gamma.py`.  gamma5 is diagonal (+,+,-,-).  The plain
operators apply the hop projectors (1 -/+ gamma_mu) as dense 4x4 matrices;
the CUDA kernel uses their {0, +-1, +-i} factorisation W W^+ (see
`ops/dslash_cuda.W`).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["GAMMA", "GAMMA5", "apply_gamma5", "gamma5_split"]

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

GAMMA5 = GAMMA[0] @ GAMMA[1] @ GAMMA[2] @ GAMMA[3]

_G5_SIGN = (1.0, 1.0, -1.0, -1.0)


def apply_gamma5(psi: torch.Tensor) -> torch.Tensor:
    """gamma5 psi for complex spinors [4 spin, 3 colour, *sites]."""
    sign = torch.tensor(_G5_SIGN, dtype=psi.real.dtype, device=psi.device)
    return psi * sign.reshape((4,) + (1,) * (psi.ndim - 1))


def gamma5_split(psi2: torch.Tensor) -> torch.Tensor:
    """gamma5 on split spinors [2(re/im), 4 spin, 3 colour, *sites]."""
    sign = torch.tensor(_G5_SIGN, dtype=psi2.dtype, device=psi2.device)
    return psi2 * sign.reshape((1, 4) + (1,) * (psi2.ndim - 2))
