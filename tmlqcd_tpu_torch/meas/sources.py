"""Source generation for propagator inversions and online measurements.

Port of `tmlqcd_tpu/meas/sources.py` (point, timeslice-Z2, volume and gaussian
timeslice sources).  Stochastic sources draw from an `rng.Key`, never from a
global generator.  Every source takes its device as a required keyword.
"""

from __future__ import annotations

import torch

from tmlqcd_tpu_torch import rng
from tmlqcd_tpu_torch.lattice import Lattice

__all__ = ["point_source", "z2_timeslice_source", "volume_source", "gaussian_timeslice_source"]


def point_source(lat: Lattice, spin: int, color: int,
                 site: tuple[int, int, int, int] = (0, 0, 0, 0), *, device,
                 dtype=torch.complex64) -> torch.Tensor:
    """Delta source at (t, x, y, z) for one spin-colour component."""
    t, x, y, z = site
    src = torch.zeros((4, 3) + lat.site_shape, dtype=dtype, device=device)
    src[spin, color, t, x, y * lat.dims[3] + z] = 1.0
    return src


def _timeslice(noise: torch.Tensor, timeslice: int) -> torch.Tensor:
    src = torch.zeros_like(noise)
    src[:, :, timeslice] = noise[:, :, timeslice]
    return src


def z2_timeslice_source(lat: Lattice, timeslice: int, key: rng.Key, *, device,
                        dtype=torch.complex64, spin_dilute: int | None = None) -> torch.Tensor:
    """Z2 x Z2 stochastic wall source on one timeslice (the ONLINE
    measurement's source), optionally diluted to a single spin row."""
    src = _timeslice(rng.z2_spinor(key, (4, 3) + lat.site_shape, device, dtype), timeslice)
    if spin_dilute is not None:
        keep = torch.zeros_like(src)
        keep[spin_dilute] = src[spin_dilute]
        src = keep
    return src


def volume_source(lat: Lattice, key: rng.Key, *, device,
                  dtype=torch.complex64) -> torch.Tensor:
    """Z2 volume source."""
    return rng.z2_spinor(key, (4, 3) + lat.site_shape, device, dtype)


def gaussian_timeslice_source(lat: Lattice, timeslice: int, key: rng.Key, *, device,
                              dtype=torch.complex64) -> torch.Tensor:
    """Gaussian stochastic wall source on one timeslice."""
    return _timeslice(rng.normal_spinor(key, (4, 3) + lat.site_shape, device, dtype), timeslice)
