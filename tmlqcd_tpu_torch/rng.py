"""Reproducible random numbers keyed by (seed, trajectory, purpose).

Port of `tmlqcd_tpu/rng.py`.  A `Key` is a seed plus a path of integer tags;
`generator(key, device)` seeds a fresh `torch.Generator` from a hash of the
whole key, so every draw is a pure function of (seed, trajectory, purpose)
and the Markov chain is reproducible from the seed and the trajectory counter
alone (no generator state to checkpoint).  torch and JAX give different
numbers for the same key; parity tests inject the reference's draws instead.

Draws that do not depend on the decomposition: given the `lat` of the field
(a whole lattice, or one rank's slab of a distributed run), `normal_spinor`,
`random_momenta` and `random_su3_field` draw their gaussians timeslice by
timeslice, each global timeslice t from its own generator `key.fold(t)`
([2, .., X, Y W] of the whole lattice's Y, W = Z/2 for a packed field and Z
for a full one: one generator and one launch a timeslice), of which the
slab keeps its own y rows.  A rank draws its own timeslices only, never the
whole lattice (NrYProcs times its share of each), and a one-process run
and a distributed run of one input draw the same numbers site by site.
Without `lat` a field is one draw from the key (the inverter's sources, the
solvers' start vectors).
"""

from __future__ import annotations

import dataclasses
import hashlib

import torch

from tmlqcd_tpu_torch import su3

__all__ = ["Key", "generator", "normal_spinor", "z2_spinor", "uniform", "randint",
           "random_momenta", "random_su3_field"]


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


def _gaussian_rows(key: Key, lat, shape: tuple, device, dtype) -> torch.Tensor:
    """Complex gaussians (<|z|^2> = 1) of `shape` [.., T, X, W] (W = Y Z/2
    packed or Y Z full, of `lat`'s slab), each global timeslice drawn as
    [2, .., X, Y W / Y_loc] reals from `key.fold(t)`, the slab's y rows kept."""
    t_loc, x, y_loc, _ = lat.dims
    lead, w = tuple(shape[:-3]), shape[-1] // y_loc
    if tuple(shape[-3:-1]) != (t_loc, x) or shape[-1] % y_loc:
        raise ValueError(f"field shape {tuple(shape)} is not a field of the lattice {lat.dims}")
    rdtype = torch.float32 if dtype == torch.complex64 else torch.float64
    t0, y0 = lat.offset
    y_all = lat.global_dims[2]
    rows = [torch.randn((2,) + lead + (x, y_all * w), dtype=rdtype, device=device,
                        generator=generator(key.fold(t0 + t), device))
            .narrow(-1, y0 * w, y_loc * w) for t in range(t_loc)]
    g = torch.stack(rows, dim=-3) * 0.7071067811865476
    return torch.complex(g[0], g[1])


def normal_spinor(key: Key, shape: tuple, device, dtype=torch.complex64,
                  lat=None) -> torch.Tensor:
    """Complex gaussian field with <|eta|^2> = 1 per complex component;
    with `lat`, drawn by timeslice (the module's note)."""
    if lat is not None:
        return _gaussian_rows(key, lat, shape, device, dtype)
    rdtype = torch.float32 if dtype == torch.complex64 else torch.float64
    gen = generator(key, device)
    s = 0.7071067811865476
    re = torch.randn(shape, generator=gen, dtype=rdtype, device=device) * s
    im = torch.randn(shape, generator=gen, dtype=rdtype, device=device) * s
    return torch.complex(re, im)


def z2_spinor(key: Key, shape: tuple, device, dtype=torch.complex64) -> torch.Tensor:
    """Z2 x Z2 noise, components (+-1 +- i) / sqrt(2)."""
    rdtype = torch.float32 if dtype == torch.complex64 else torch.float64
    gen = generator(key, device)
    bits = torch.randint(0, 2, (2,) + tuple(shape), generator=gen, device=device)
    signs = (2 * bits - 1).to(rdtype) * 0.7071067811865476
    return torch.complex(signs[0], signs[1])


def randint(key: Key, low: int, high: int) -> int:
    """One integer in [low, high), drawn on the host."""
    return int(torch.randint(low, high, (), generator=generator(key, "cpu")))


def uniform(key: Key, device) -> float:
    """Scalar uniform [0, 1) in f32 for the Metropolis decision."""
    gen = generator(key, device)
    return float(torch.rand((), generator=gen, dtype=torch.float32, device=device))


def random_momenta(key: Key, batch_shape: tuple, device, dtype=torch.complex64,
                   lat=None) -> torch.Tensor:
    """Gaussian su(3) momenta [3, 3, *batch_shape]; with `lat`, drawn by
    timeslice (batch_shape [4, T, X, Y Z] of `lat`)."""
    if lat is not None:
        return su3.momenta_from_gaussian(
            _gaussian_rows(key, lat, (3, 3) + tuple(batch_shape), device, dtype))
    return su3.random_momenta(generator(key, device), batch_shape, dtype)


def random_su3_field(key: Key, lat, device, dtype=torch.complex64) -> torch.Tensor:
    """A hot start [3, 3, 4, T, X, Y Z] of `lat` (`su3.random_su3`'s map of
    momenta drawn by timeslice)."""
    p = random_momenta(key, (4,) + lat.site_shape, device, dtype, lat=lat)
    return su3.project_su3(su3.expm_ta(1.5 * p))
