"""Batched SU(3) / su(3) algebra in structure-of-arrays layout.

Port of `tmlqcd_tpu/su3.py`: matrices live on the two leading axes
([3, 3, *sites]); products are written as three broadcast multiply-adds so
no matrix-multiply library call (and no TF32 path) is involved.

Conventions: links U in SU(3); momenta P traceless anti-hermitian (P = iH);
kinetic energy sum tr(H^2) = sum |P_ij|^2, f64-accumulated.
"""

from __future__ import annotations

import torch

from tmlqcd_tpu_torch.comm import global_max, global_sum

__all__ = [
    "adj",
    "mul",
    "matvec",
    "trace",
    "re_trace",
    "ta_project",
    "expm_ta",
    "project_su3",
    "inv3",
    "project_su3_polar",
    "random_momenta",
    "momenta_from_gaussian",
    "kinetic_energy",
    "random_su3",
    "unitarity_defect",
]


def adj(m: torch.Tensor) -> torch.Tensor:
    """Hermitian conjugate on the leading two axes."""
    return torch.conj_physical(m.transpose(0, 1))


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """3x3 product over the leading axes: out[i, k] = sum_j a[i, j] b[j, k]."""
    return (a[:, 0, None] * b[None, 0] + a[:, 1, None] * b[None, 1]
            + a[:, 2, None] * b[None, 2])


def matvec(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """U v for colour vectors v [3, ...]: out[i] = sum_j u[i, j] v[j]."""
    return u[:, 0] * v[None, 0] + u[:, 1] * v[None, 1] + u[:, 2] * v[None, 2]


def trace(m: torch.Tensor) -> torch.Tensor:
    return m[0, 0] + m[1, 1] + m[2, 2]


def re_trace(m: torch.Tensor) -> torch.Tensor:
    return trace(m).real


def _eye_like(m: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=m.dtype, device=m.device).reshape((3, 3) + (1,) * (m.ndim - 2))


def ta_project(m: torch.Tensor) -> torch.Tensor:
    """TA(m) = (m - m^+)/2 - tr(m - m^+)/6 * I."""
    ah = 0.5 * (m - adj(m))
    return ah - (trace(ah) / 3.0) * _eye_like(m)


def expm_ta(a: torch.Tensor, order: int = 8, squarings: int = 4) -> torch.Tensor:
    """exp(a) for small-norm su(3) matrices by scaling-squaring + Taylor
    (the same fixed schedule as the reference; differentiable)."""
    eye = _eye_like(a)
    b = a / (2.0**squarings)
    acc = eye + b / order
    for k in range(order - 1, 0, -1):
        acc = eye + mul(b, acc) / k
    for _ in range(squarings):
        acc = mul(acc, acc)
    return acc


def project_su3(m: torch.Tensor) -> torch.Tensor:
    """Gram-Schmidt on the first two rows, third row = conj(r0 x r1)."""
    r0, r1 = m[0], m[1]
    u0 = r0 / torch.sqrt(torch.sum(r0.real**2 + r0.imag**2, dim=0, keepdim=True))
    proj = torch.sum(torch.conj_physical(u0) * r1, dim=0, keepdim=True)
    v1 = r1 - proj * u0
    u1 = v1 / torch.sqrt(torch.sum(v1.real**2 + v1.imag**2, dim=0, keepdim=True))
    u2 = torch.stack([u0[(j + 1) % 3] * u1[(j + 2) % 3] - u0[(j + 2) % 3] * u1[(j + 1) % 3]
                      for j in range(3)])
    return torch.stack([u0, u1, torch.conj_physical(u2)], dim=0)


def inv3(m: torch.Tensor):
    """Closed-form 3x3 inverse (adjugate / det) on the leading axes; returns
    (inverse, det)."""
    a, b, c = m[0, 0], m[0, 1], m[0, 2]
    d, e, f = m[1, 0], m[1, 1], m[1, 2]
    g, h, i = m[2, 0], m[2, 1], m[2, 2]
    co_a = e * i - f * h
    co_b = -(d * i - f * g)
    co_c = d * h - e * g
    det = a * co_a + b * co_b + c * co_c
    inv_det = 1.0 / det
    rows = [
        [co_a, -(b * i - c * h), (b * f - c * e)],
        [co_b, (a * i - c * g), -(a * f - c * d)],
        [co_c, -(a * h - b * g), (a * e - b * d)],
    ]
    return torch.stack([torch.stack([x * inv_det for x in r]) for r in rows]), det


def project_su3_polar(m: torch.Tensor, iters: int = 9) -> torch.Tensor:
    """Gauge-covariant projection onto SU(3): the unitary polar factor
    W = m (m^+ m)^{-1/2} by the Newton iteration X <- (X + (X^+)^{-1}) / 2
    after a Frobenius pre-scaling, then the determinant phase rotated out,
    W exp(-i angle(det W) / 3) (the principal branch of the cube root, as the
    reference takes it).  Unlike `project_su3` (Gram-Schmidt) it satisfies
    P(g m h^+) = g P(m) h^+, which link smearing needs."""
    n = torch.sqrt(torch.sum(m.real**2 + m.imag**2, dim=(0, 1)) / 3.0)
    x = m / n
    for _ in range(iters):
        x = 0.5 * (x + inv3(adj(x))[0])
    det = (x[0, 0] * (x[1, 1] * x[2, 2] - x[1, 2] * x[2, 1])
           - x[0, 1] * (x[1, 0] * x[2, 2] - x[1, 2] * x[2, 0])
           + x[0, 2] * (x[1, 0] * x[2, 1] - x[1, 1] * x[2, 0]))
    phase = torch.angle(det) / 3.0
    return x * torch.complex(torch.cos(phase), -torch.sin(phase)).to(x.dtype)


def random_momenta(gen: torch.Generator, batch_shape: tuple,
                   dtype=torch.complex64) -> torch.Tensor:
    """Gaussian su(3) momenta [3, 3, *batch_shape] with density
    exp(-sum tr H^2), drawn on the generator's device."""
    rdtype = torch.float32 if dtype == torch.complex64 else torch.float64
    shape = (3, 3) + tuple(batch_shape)
    s = 0.7071067811865476
    re = torch.randn(shape, generator=gen, dtype=rdtype, device=gen.device) * s
    im = torch.randn(shape, generator=gen, dtype=rdtype, device=gen.device) * s
    return momenta_from_gaussian(torch.complex(re, im))


def momenta_from_gaussian(m: torch.Tensor) -> torch.Tensor:
    """The su(3) momenta of `random_momenta` from its complex gaussian
    matrices m [3, 3, ...] (<|m_ij|^2> = 1): i times the traceless hermitian
    part."""
    h = 0.5 * (m + adj(m))
    h = h - (trace(h) / 3.0) * _eye_like(h)
    return torch.complex(-h.imag, h.real)


def kinetic_energy(p: torch.Tensor) -> torch.Tensor:
    """sum_links tr(H^2) = sum |P_ij|^2, f64-accumulated (over the ranks of
    a distributed run)."""
    return global_sum(torch.sum(p.real.double() ** 2 + p.imag.double() ** 2))


def random_su3(gen: torch.Generator, batch_shape: tuple, dtype=torch.complex64) -> torch.Tensor:
    """Random SU(3) field [3, 3, *batch_shape] for hot starts."""
    return project_su3(expm_ta(1.5 * random_momenta(gen, batch_shape, dtype)))


def unitarity_defect(u: torch.Tensor) -> torch.Tensor:
    """max_sites ||U^+U - 1||_F."""
    d = mul(adj(u), u) - _eye_like(u)
    return torch.sqrt(global_max(torch.max(torch.sum(d.real**2 + d.imag**2, dim=(0, 1)))))
