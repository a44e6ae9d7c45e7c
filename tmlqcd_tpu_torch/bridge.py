"""Numpy bridge between the JAX reference package and the port.

The two packages never import each other; tests move state between them as
numpy arrays in the shared layouts:

    gauge     complex64 [3, 3, 4, T, X, Y*Z]
    spinor    complex64 [4, 3, T, X, M]
    split     float32   [2, ...]          (re/im leading)
    FastGauge float32   ug_even/ug_odd [2, 8, 3|2, 3, T, X, M] + gcomp
    chrono    fields [n, ...field] + count

`numpy_su3` and `numpy_spinor` draw test inputs from a numpy Generator, so
both packages can be fed the same fields without either one's RNG.
"""

from __future__ import annotations

import numpy as np
import torch

from tmlqcd_tpu_torch.lattice import Lattice
from tmlqcd_tpu_torch.ops.wilson_fast import FastGauge
from tmlqcd_tpu_torch.solvers.chrono import ChronoHistory

__all__ = ["gauge_from_numpy", "spinor_from_numpy", "split_from_numpy",
           "fast_gauge_from_numpy", "chrono_from_numpy", "to_numpy", "numpy_su3",
           "numpy_spinor"]


def _as(arr, dtype: torch.dtype, shape_tail: tuple, device) -> torch.Tensor:
    t = torch.as_tensor(np.array(arr), device=device).to(dtype)
    if tuple(t.shape[-len(shape_tail):]) != tuple(shape_tail):
        raise ValueError(f"array of shape {tuple(t.shape)} does not end in {shape_tail}")
    return t


def gauge_from_numpy(arr, lat: Lattice, device="cpu") -> torch.Tensor:
    return _as(arr, torch.complex64, (3, 3, 4) + lat.site_shape, device)


def spinor_from_numpy(arr, lat: Lattice, device="cpu") -> torch.Tensor:
    return _as(arr, torch.complex64, (4, 3) + lat.eo_site_shape, device)


def split_from_numpy(arr, device="cpu") -> torch.Tensor:
    t = torch.as_tensor(np.array(arr), device=device).to(torch.float32)
    if t.shape[0] != 2:
        raise ValueError(f"split arrays lead with re/im, got shape {tuple(t.shape)}")
    return t


def fast_gauge_from_numpy(ug_even, ug_odd, gcomp=None, device="cpu") -> FastGauge:
    return FastGauge(split_from_numpy(ug_even, device), split_from_numpy(ug_odd, device),
                     None if gcomp is None else tuple(tuple(map(float, c)) for c in gcomp))


def chrono_from_numpy(fields, count: int, device="cpu") -> ChronoHistory:
    f = torch.as_tensor(np.array(fields), device=device)
    return ChronoHistory(f.to(torch.complex64 if f.is_complex() else torch.float32), int(count))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def numpy_su3(gen: np.random.Generator, batch_shape: tuple) -> np.ndarray:
    """Haar-like random SU(3) matrices [3, 3, *batch_shape] complex64 (QR of
    a complex gaussian matrix, phases fixed, determinant divided out)."""
    n = int(np.prod(batch_shape))
    z = (gen.standard_normal((n, 3, 3)) + 1j * gen.standard_normal((n, 3, 3))) / np.sqrt(2)
    q, r = np.linalg.qr(z)
    d = np.diagonal(r, axis1=1, axis2=2)
    q = q * (d / np.abs(d))[:, None, :]
    q = q / np.linalg.det(q)[:, None, None] ** (1.0 / 3.0)
    return np.moveaxis(q, 0, -1).reshape((3, 3) + tuple(batch_shape)).astype(np.complex64)


def numpy_spinor(gen: np.random.Generator, shape: tuple) -> np.ndarray:
    """Complex gaussian field, <|z|^2> = 1 per component, complex64."""
    return ((gen.standard_normal(shape) + 1j * gen.standard_normal(shape))
            / np.sqrt(2)).astype(np.complex64)
