"""Reproducible random numbers keyed by (seed, trajectory, purpose).

Port of `tmlqcd_tpu/rng.py`.  A `Key` is a seed plus a path of integer tags;
`generator(key, device)` seeds a fresh `torch.Generator` from a hash of the
whole key, so every draw is a pure function of (seed, trajectory, purpose)
and the Markov chain is reproducible from the seed and the trajectory counter
alone (no generator state to checkpoint).  On one device the draw does not
depend on any decomposition.  torch and JAX give different numbers for the
same key; parity tests inject the reference's draws instead.
"""

from __future__ import annotations

import dataclasses
import hashlib

import torch

from tmlqcd_tpu_torch import su3

__all__ = ["Key", "generator", "normal_spinor", "uniform", "random_momenta"]


@dataclasses.dataclass(frozen=True)
class Key:
    seed: int
    path: tuple[int, ...] = ()

    def fold(self, *data: int) -> "Key":
        """Derive a subkey from integer tags (trajectory number, purpose id)."""
        return Key(self.seed, self.path + tuple(int(d) for d in data))


def generator(key: Key, device) -> torch.Generator:
    digest = hashlib.blake2b(repr((key.seed, key.path)).encode(), digest_size=8).digest()
    gen = torch.Generator(device=device)
    gen.manual_seed(int.from_bytes(digest, "little") & ((1 << 63) - 1))
    return gen


def normal_spinor(key: Key, shape: tuple, device, dtype=torch.complex64) -> torch.Tensor:
    """Complex gaussian field with <|eta|^2> = 1 per complex component."""
    rdtype = torch.float32 if dtype == torch.complex64 else torch.float64
    gen = generator(key, device)
    s = 0.7071067811865476
    re = torch.randn(shape, generator=gen, dtype=rdtype, device=device) * s
    im = torch.randn(shape, generator=gen, dtype=rdtype, device=device) * s
    return torch.complex(re, im)


def uniform(key: Key, device) -> float:
    """Scalar uniform [0, 1) in f32 for the Metropolis decision."""
    gen = generator(key, device)
    return float(torch.rand((), generator=gen, dtype=torch.float32, device=device))


def random_momenta(key: Key, batch_shape: tuple, device, dtype=torch.complex64) -> torch.Tensor:
    return su3.random_momenta(generator(key, device), batch_shape, dtype)
