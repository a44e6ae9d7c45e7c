"""Gauge fields the benchmark makes itself, never from the program.

* `hot_field`: random SU(3) links from the seed (tmLQCD's StartCondition =
  hot), made on the device in a few large calls.
* `smooth_field`: a quenched field of the configuration's gauge action,
  thermalised by the benchmark's own pure-gauge molecular dynamics (2MN
  trajectories with fresh momenta, forces by autograd of
  `reference.ops.gauge_action`; every trajectory is kept, as in a
  thermalisation without Metropolis, whose O(eps^2) bias a field for
  timing propagators does not mind) from a cold start and a fixed seed
  named in the configuration file.  It is made
  once per checkout and cached under `qcdbench/.cache/fields/`, keyed by the
  configuration file and the generator's source; later runs load it.

Fields are returned in the program's layout [3, 3, 4, T, X, Y*Z] complex64.
"""

from __future__ import annotations

import hashlib
import os
import time

import torch

from reference import hmc as ref_hmc
from reference import ops

HERE = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(HERE, ".cache", "fields")


def generator(device, *tags) -> torch.Generator:
    """A torch.Generator on `device` seeded from a hash of the tags."""
    digest = hashlib.blake2b(repr(tags).encode(), digest_size=8).digest()
    gen = torch.Generator(device=device)
    gen.manual_seed(int.from_bytes(digest, "little") & ((1 << 63) - 1))
    return gen


def dims_of(cfg: dict) -> tuple:
    """(T, X, Y, Z) of the configuration."""
    lat = cfg["lattice"]
    return (lat["T"], lat["LX"], lat["LY"], lat["LZ"])


def to_program(u7: torch.Tensor) -> torch.Tensor:
    """[3, 3, 4, T, X, Y, Z] -> the program's [3, 3, 4, T, X, Y*Z]."""
    return u7.reshape(u7.shape[:-2] + (u7.shape[-2] * u7.shape[-1],)).contiguous()


def to_reference(u6: torch.Tensor, dims) -> torch.Tensor:
    return u6.reshape(u6.shape[:-1] + (dims[2], dims[3]))


def gaussian(shape, gen, device) -> torch.Tensor:
    """Complex gaussians with <|z|^2> = 1, complex64."""
    g = torch.randn((2,) + tuple(shape), generator=gen, device=device) * 0.7071067811865476
    return torch.complex(g[0], g[1])


def random_su3(shape, gen, device) -> torch.Tensor:
    """Haar-random SU(3) [3, 3, *shape]: Gram-Schmidt of gaussian rows, the
    third the conjugate cross product of the first two."""
    return ref_hmc.reunitarize(gaussian((3, 3) + tuple(shape), gen, device))


def momenta(shape, gen, device) -> torch.Tensor:
    """su(3) momenta with density exp(-sum |P_ij|^2): i times the traceless
    hermitian part of a gaussian matrix."""
    m = gaussian((3, 3) + tuple(shape), gen, device)
    h = 0.5 * (m + ops.adj(m))
    tr = (h[0, 0] + h[1, 1] + h[2, 2]) / 3.0
    eye = torch.eye(3, dtype=h.dtype, device=device).reshape((3, 3) + (1,) * len(shape))
    return 1j * (h - tr * eye)


def hot_field(dims, seed: int, device) -> torch.Tensor:
    """A hot start from the seed, in the program's layout."""
    return to_program(random_su3((4,) + tuple(dims), generator(device, "hot", seed), device))


def _quenched_hmc(cfg: dict, device, log) -> torch.Tensor:
    """The configuration's quenched field: `field.trajectories` pure-gauge
    MD trajectories of `field.steps` 2MN steps from a cold start."""
    f = cfg["field"]
    dims = dims_of(cfg)
    c1 = ref_hmc.GAUGE_C1[cfg["gauge"]["action"].lower()]
    beta = cfg["gauge"]["beta"]
    gen = generator(device, "quenched", f["seed"])
    eye = torch.eye(3, dtype=torch.complex64, device=device)
    u = eye.reshape(3, 3, 1, 1, 1, 1, 1).expand((3, 3, 4) + dims).contiguous()
    lam, n = ref_hmc.LAMBDA_2MN, f["steps"]
    eps = f["tau"] / n

    def force(uu):
        return ref_hmc._force(uu, lambda x: ops.gauge_action(x, beta, c1))

    s = ops.gauge_action(u, beta, c1)
    for k in range(f["trajectories"]):
        p = momenta((4,) + dims, gen, device)
        h_old = ref_hmc.kinetic(p) + s
        v = u
        p = p + 0.5 * lam * eps * force(v)
        for i in range(n):
            v = ref_hmc.drift(v, p, 0.5 * eps)
            p = p + 0.5 * (1.0 - 2.0 * lam) * eps * force(v)
            v = ref_hmc.drift(v, p, 0.5 * eps)
            p = p + 0.5 * (2.0 * lam if i < n - 1 else lam) * eps * force(v)
        u, s = v, ops.gauge_action(v, beta, c1)
        dh = float(ref_hmc.kinetic(p) + s - h_old)
        log(f"[fields] quenched trajectory {k + 1}/{f['trajectories']}: dH {dh:.4f} "
            f"plaquette {ops.plaquette(u):.6f}")
    return u


def _key(cfg_path: str) -> str:
    h = hashlib.sha256()
    for path in (cfg_path, __file__, ops.__file__, ref_hmc.__file__):
        with open(path, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:16]


def smooth_field(cfg: dict, cfg_path: str, device, log=print) -> torch.Tensor:
    """The configuration's smooth field (program layout), from the cache or
    made and cached."""
    name = os.path.join(CACHE, f"{cfg['name']}-{_key(cfg_path)}.pt")
    if os.path.exists(name):
        return torch.load(name, map_location=device)
    t0 = time.perf_counter()
    u = to_program(_quenched_hmc(cfg, device, log))
    log(f"[fields] {cfg['name']}: made in {time.perf_counter() - t0:.1f} s, "
        f"plaquette {ops.plaquette(to_reference(u, dims_of(cfg))):.6f}")
    os.makedirs(CACHE, exist_ok=True)
    tmp = name + ".part"
    torch.save(u.cpu(), tmp)
    os.replace(tmp, name)
    return u
