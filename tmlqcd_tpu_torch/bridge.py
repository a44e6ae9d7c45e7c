"""Numpy bridge between the JAX reference package and the port.

The two packages never import each other; tests move state between them as
numpy arrays in the shared layouts:

    gauge     complex64 [3, 3, 4, T, X, Y*Z]
    spinor    complex64 [4, 3, T, X, M]
    source    complex64 [4, 3, T, X, Y*Z] or a batch [R, 4, 3, T, X, Y*Z]
    split     float32   [2, ...]          (re/im leading)
    FastGauge float32   ug_even/ug_odd [2, 8, 3|2, 3, T, X, M] + gcomp
    clover    complex64 sw_e/sw_o [2, 2, 2, 3, 3, T, X, M] (chirality blocks)
    FastClover          FastGauge + four float32 [2, 72, T, X, M] block fields
    doublet   complex64 [2 flavour, 4, 3, T, X, M]
    FastCloverND        FastGauge + five float32 [2, 2, 2, 2, 3, 3, T, X, M]
                        block fields + epsbar_t
    NDParams / RationalApprox: plain dataclasses, rebuilt field by field
    chrono    fields [n, ...field] + count
    OverlapSetup        gauge + evecs complex64 [n_ev, 4, 3, T, X, Y*Z],
                        ev_signs [n_ev], coeffs, lo2, hi2, ev_resid and the
                        OverlapParams fields; K1's gauge copy is rebuilt

`numpy_su3` and `numpy_spinor` draw test inputs from a numpy Generator, so
both packages can be fed the same fields without either one's RNG.
"""

from __future__ import annotations

import numpy as np
import torch

from tmlqcd_tpu_torch.inverter import InvertResult
from tmlqcd_tpu_torch.lattice import Lattice
from tmlqcd_tpu_torch.ops.ndoublet import NDParams
from tmlqcd_tpu_torch.ops.overlap import OverlapParams, OverlapSetup
from tmlqcd_tpu_torch.ops.wilson_fast import FastClover, FastCloverND, FastGauge
from tmlqcd_tpu_torch.solvers.chrono import ChronoHistory
from tmlqcd_tpu_torch.solvers.rational import RationalApprox

__all__ = ["gauge_from_numpy", "spinor_from_numpy", "sources_from_numpy",
           "split_from_numpy", "fast_gauge_from_numpy", "clover_blocks_from_numpy",
           "fast_clover_from_numpy", "fast_clover_to_numpy", "chrono_from_numpy",
           "invert_result_from_numpy", "to_numpy", "numpy_su3", "numpy_spinor",
           "doublet_from_numpy", "nd_params_from", "rational_from", "fast_clover_nd_from_numpy",
           "overlap_params_from", "overlap_setup_from_numpy", "numpy_smooth_su3"]


def _as(arr, dtype: torch.dtype, shape_tail: tuple, device) -> torch.Tensor:
    t = torch.as_tensor(np.array(arr), device=device).to(dtype)
    if tuple(t.shape[-len(shape_tail):]) != tuple(shape_tail):
        raise ValueError(f"array of shape {tuple(t.shape)} does not end in {shape_tail}")
    return t


def gauge_from_numpy(arr, lat: Lattice, device="cpu") -> torch.Tensor:
    return _as(arr, torch.complex64, (3, 3, 4) + lat.site_shape, device)


def spinor_from_numpy(arr, lat: Lattice, device="cpu") -> torch.Tensor:
    return _as(arr, torch.complex64, (4, 3) + lat.eo_site_shape, device)


def sources_from_numpy(arr, lat: Lattice, device="cpu") -> torch.Tensor:
    """One full-lattice source [4,3,T,X,Y*Z] or a batch [R,4,3,T,X,Y*Z]."""
    return _as(arr, torch.complex64, (4, 3) + lat.site_shape, device)


def invert_result_from_numpy(x, iterations, residual_sq, lat: Lattice,
                             device="cpu") -> InvertResult:
    """The reference's InvertResult fields (as numpy) -> the port's."""
    return InvertResult(x=sources_from_numpy(x, lat, device), iterations=int(iterations),
                        residual_sq=torch.as_tensor(np.array(residual_sq, np.float64),
                                                    device=device))


def split_from_numpy(arr, device="cpu") -> torch.Tensor:
    t = torch.as_tensor(np.array(arr), device=device).to(torch.float32)
    if t.shape[0] != 2:
        raise ValueError(f"split arrays lead with re/im, got shape {tuple(t.shape)}")
    return t


def fast_gauge_from_numpy(ug_even, ug_odd, gcomp=None, device="cpu") -> FastGauge:
    return FastGauge(split_from_numpy(ug_even, device), split_from_numpy(ug_odd, device),
                     None if gcomp is None else tuple(tuple(map(float, c)) for c in gcomp))


def clover_blocks_from_numpy(arr, lat: Lattice, device="cpu") -> torch.Tensor:
    """Packed clover term of one parity (`sw_e` or `sw_o`), or materialised
    blocks in the same layout: complex [2, 2, 2, 3, 3, T, X, M]."""
    return _as(arr, torch.complex64, (2, 2, 2, 3, 3) + lat.eo_site_shape, device)


def fast_clover_from_numpy(fg: FastGauge, moo_p, moo_m, mee_inv_p, mee_inv_m, lat: Lattice,
                           device="cpu") -> FastClover:
    """The reference's FastClover block fields (numpy, [2, 72, T, X, M]) on a
    FastGauge of the port."""
    blk = lambda a: _as(a, torch.float32, (2, 72) + lat.eo_site_shape, device).contiguous()  # noqa: E731
    return FastClover(fg, blk(moo_p), blk(moo_m), blk(mee_inv_p), blk(mee_inv_m))


def fast_clover_to_numpy(fc: FastClover) -> dict:
    """The port's FastClover as numpy arrays under the reference's field
    names (`fg` as ug_even / ug_odd / gcomp)."""
    return {"ug_even": to_numpy(fc.fg.ug_even), "ug_odd": to_numpy(fc.fg.ug_odd),
            "gcomp": fc.fg.gcomp, "moo_p": to_numpy(fc.moo_p), "moo_m": to_numpy(fc.moo_m),
            "mee_inv_p": to_numpy(fc.mee_inv_p), "mee_inv_m": to_numpy(fc.mee_inv_m)}


def doublet_from_numpy(arr, lat: Lattice, device="cpu") -> torch.Tensor:
    """A packed flavour doublet [2, 4, 3, T, X, M]."""
    return _as(arr, torch.complex64, (2, 4, 3) + lat.eo_site_shape, device)


def nd_params_from(ref) -> NDParams:
    """The reference's NDParams (any object with its fields) -> the port's."""
    return NDParams(kappa=float(ref.kappa), mubar=float(ref.mubar), epsbar=float(ref.epsbar),
                    c_sw=float(ref.c_sw), theta=tuple(float(t) for t in ref.theta))


def rational_from(ref) -> RationalApprox:
    """The reference's RationalApprox (numpy f64 fields) -> the port's."""
    return RationalApprox(order=int(ref.order), s_min=float(ref.s_min), s_max=float(ref.s_max),
                          sigma=np.array(ref.sigma, np.float64), rho=np.array(ref.rho, np.float64),
                          a_roots=np.array(ref.a_roots, np.float64),
                          rho_lead=float(ref.rho_lead), max_rel_err=float(ref.max_rel_err))


def fast_clover_nd_from_numpy(fg: FastGauge, moo_u, moo_d, minv_a, minv_b, minv_e,
                              epsbar_t: float, lat: Lattice, device="cpu") -> FastCloverND:
    """The reference's FastCloverND block fields (numpy, split
    [2, 2, 2, 2, 3, 3, T, X, M]) on a FastGauge of the port."""
    blk = lambda a: _as(a, torch.float32, (2, 2, 2, 2, 3, 3) + lat.eo_site_shape, device)  # noqa: E731
    return FastCloverND(fg, blk(moo_u), blk(moo_d), blk(minv_a), blk(minv_b), blk(minv_e),
                        float(epsbar_t))


def overlap_params_from(ref) -> OverlapParams:
    """The reference's OverlapParams (any object with its fields) -> the
    port's."""
    return OverlapParams(rho=float(ref.rho), m=float(ref.m), degree=int(ref.degree),
                         n_ev=int(ref.n_ev), lanczos_steps=ref.lanczos_steps,
                         theta=tuple(float(t) for t in ref.theta))


def overlap_setup_from_numpy(u, evecs, ev_signs, coeffs, lo2: float, hi2: float, params,
                             lat: Lattice, ev_resid: float = 0.0, device="cpu") -> OverlapSetup:
    """The reference's OverlapSetup carried across as numpy (the gauge, the
    Ritz vectors and signs, the Chebyshev data) -> the port's, with K1's
    gauge copy built from the gauge as `make_overlap` builds it."""
    from tmlqcd_tpu_torch.ops.wilson_fast import make_fast_gauge

    p = overlap_params_from(params)
    ut = gauge_from_numpy(u, lat, device)
    ev = _as(evecs, torch.complex64, (4, 3) + lat.site_shape, device) if np.size(evecs) else \
        torch.zeros((0, 4, 3) + lat.site_shape, dtype=torch.complex64, device=device)
    return OverlapSetup(u=ut, fg=make_fast_gauge(ut, p.kernel, lat), evecs=ev,
                        ev_signs=torch.as_tensor(np.array(ev_signs), device=device).float(),
                        coeffs=tuple(float(c) for c in np.asarray(coeffs)), lo2=float(lo2),
                        hi2=float(hi2), params=p, lat=lat, ev_resid=float(ev_resid))


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


def numpy_smooth_su3(gen: np.random.Generator, batch_shape: tuple,
                     scale: float = 0.3) -> np.ndarray:
    """Weakly fluctuating SU(3) matrices exp(i scale H), H a traceless
    hermitian gaussian [3, 3, *batch_shape] complex64: keeps the Wilson
    kernel gapped, so that small Chebyshev degrees approximate its sign."""
    n = int(np.prod(batch_shape))
    a = gen.standard_normal((n, 3, 3)) + 1j * gen.standard_normal((n, 3, 3))
    h = 0.5 * (a + np.conj(np.swapaxes(a, 1, 2)))
    h -= (np.trace(h, axis1=1, axis2=2) / 3.0)[:, None, None] * np.eye(3)
    lam, v = np.linalg.eigh(h)
    q = (v * np.exp(1j * scale * lam)[:, None, :]) @ np.conj(np.swapaxes(v, 1, 2))
    return np.moveaxis(q, 0, -1).reshape((3, 3) + tuple(batch_shape)).astype(np.complex64)


def numpy_spinor(gen: np.random.Generator, shape: tuple) -> np.ndarray:
    """Complex gaussian field, <|z|^2> = 1 per component, complex64."""
    return ((gen.standard_normal(shape) + 1j * gen.standard_normal(shape))
            / np.sqrt(2)).astype(np.complex64)
