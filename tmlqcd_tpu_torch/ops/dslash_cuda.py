"""The even/odd hopping kernel (K1) and its gauge-cotangent kernel (K2) on
Hopper, each beside its plain PyTorch version, plus the differentiable
hopping built from both.

Port of the main-path parts of `tmlqcd_tpu/ops/dslash_pallas.py`:

* `split_c`/`merge_c`, `gauge_copy`, `gauge_corr`, `compress_ug` — the split
  layout and the pre-gathered per-direction gauge copy (boundary phases
  folded into the forward link and the conjugated backward link).
* `hopping_split` (K1) replaces `hopping_pallas_split` and the Pallas kernel
  `_dslash_kernel` (dslash_pallas.py:520, built by `_build` :774 and
  `_build_tb` :599): out = H_{p,q} psi on parity-p sites with the
  twisted-mass epilogue `none`, `mee_inv` or `mhat` fused in, on the 18-real
  or 12-real gauge copy.  Bound by memory: 1320 flops/site against
  576 B (18-real) or 384 B (12-real) of gauge, 96 B per spinor read or
  written; `mhat` reads one spinor more.
* `hopping_ug_vjp` (K2) replaces `hopping_ug_vjp` and `_ug_vjp_kernel`
  (dslash_pallas.py:1489, built by `_build_ug_vjp` :1541): the cotangent of
  Re<g, H psi> with respect to ug[p].  Bound by memory: 96 B of g and 96 B of
  psi per site read, 576 B per site written.
* `HoppingDiff` replaces the custom VJP `hopping_diff` (:1608-1641).

Routing: the device of the tensors decides.  A CUDA tensor launches the
kernel (or raises); a CPU tensor takes the plain version.  There is no
fallback between the two.  Each wrapper counts its kernel launches in a
plain int attribute (`hopping_split.launches`, `hopping_ug_vjp.launches`);
each plain version counts its calls (`.calls`).

The kernels are compiled at first use from `tmlqcd_tpu_torch/csrc/` with
nvcc into a shared library with a plain C interface, loaded with ctypes;
see `_lib`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import numpy as np
import torch

from tmlqcd_tpu_torch.gamma import GAMMA, apply_gamma5, gamma5_split
from tmlqcd_tpu_torch.lattice import Lattice, hop_packed
from tmlqcd_tpu_torch.ops.wilson import (
    color_apply,
    hop_projector,
    mee_inv_packed,
    mee_packed,
    spin_apply,
)

__all__ = [
    "W",
    "split_c",
    "merge_c",
    "gauge_copy",
    "gauge_corr",
    "compress_ug",
    "hopping_split",
    "hopping_split_plain",
    "hopping_ug_vjp",
    "hopping_ug_vjp_plain",
    "HoppingDiff",
    "kernel_library",
    "reset_counters",
]

# W[d] (d = 2 mu + fb): the 4x2 half-spinor maps with entries in {0, +-1, +-i},
# (1 - gamma_mu) = W W^+ forward, (1 + gamma_mu) = W W^+ backward.  The CUDA
# source carries the same table as integer codes (its `W-TABLE` lines); a CPU
# test holds the two equal.
W = np.stack([
    np.ascontiguousarray(((np.eye(4) - GAMMA[mu]) if fb == 0 else (np.eye(4) + GAMMA[mu]))[:, :2])
    for mu in range(4) for fb in range(2)
])

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
_BUILD = os.path.join(_CSRC, "build")
_SOURCES = ("hopping.cu",)
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
               "-shared", "-Xcompiler", "-fPIC")
_lib_handle = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (on PATH or /usr/local/cuda/bin): the CUDA "
                           "kernels of tmlqcd_tpu_torch are built from source at first use")
    return path


def kernel_library(verbose: bool = False) -> ctypes.CDLL:
    """Build (once per source version) and load the kernel library.

    The library is named by a hash of the sources and flags, compiled into
    `csrc/build/` and moved into place atomically, so concurrent processes
    and stale builds cannot mix.  `verbose=True` adds `-Xptxas -v` and
    prints nvcc's report (registers, spills) on first build."""
    global _lib_handle
    with _lib_lock:
        if _lib_handle is not None:
            return _lib_handle
        h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
        for name in _SOURCES:
            with open(os.path.join(_CSRC, name), "rb") as f:
                h.update(f.read())
        so = os.path.join(_BUILD, f"libtmlqcd_kernels_{h.hexdigest()[:16]}.so")
        if not os.path.exists(so):
            os.makedirs(_BUILD, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
            os.close(fd)
            cmd = [_nvcc(), *_NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
                   "-o", tmp, *(os.path.join(_CSRC, n) for n in _SOURCES)]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
            if verbose:
                print(res.stderr, flush=True)
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.tm_hopping.argtypes = [vp, vp, vp, vp, i, i, i, i, i, i, i, i, f, f, f, vp, vp]
        lib.tm_hopping.restype = i
        lib.tm_hopping_ug_vjp.argtypes = [vp, vp, vp, i, i, i, i, i, vp]
        lib.tm_hopping_ug_vjp.restype = i
        _lib_handle = lib
        return lib


# ---------------------------------------------------------------------------
# split layout and the gauge copy
# ---------------------------------------------------------------------------


def split_c(x: torch.Tensor) -> torch.Tensor:
    """complex [..] -> real [2, ..] (re, im leading)."""
    return torch.stack([x.real, x.imag])


def merge_c(x2: torch.Tensor) -> torch.Tensor:
    """[2, ..] -> complex."""
    return torch.complex(x2[0], x2[1])


def gauge_copy(ueo: torch.Tensor, lat: Lattice, phases: np.ndarray) -> torch.Tensor:
    """Pre-gather the per-direction links for both output parities.

    ueo: [2, 3, 3, 4, T, X, M] complex -> ug [2(p), 8, 3, 3, T, X, M] with
      ug[p, 2mu]   = ka_mu   * U_mu(x)          (x on parity p)
      ug[p, 2mu+1] = ka_mu^* * U_mu(x-mu)^+     (pulled from parity 1-p).
    Differentiable (the force surrogates take gradients through it)."""
    out = []
    for p in (0, 1):
        q = 1 - p
        dirs = []
        for mu in range(4):
            ph = complex(phases[mu])
            dirs.append(ph * ueo[p, :, :, mu])
            ub = hop_packed(ueo[q, :, :, mu], p, mu, -1, lat)
            dirs.append(ph.conjugate() * torch.conj_physical(ub.transpose(0, 1)))
        out.append(torch.stack(dirs))
    return torch.stack(out)


def gauge_corr(phases: np.ndarray) -> tuple:
    """Per-direction row-2 constants of the 12-real copy: direction d stores
    c*U (c = ka_mu forward, conj(ka_mu) backward); conj(r0 x r1) of c*U is
    conj(c)^2 row2(U), so corr = c / conj(c)^2 restores row2(c*U).  With
    antiperiodic t the mu = 0 constants are not 1."""
    out = []
    for mu in range(4):
        for fb in range(2):
            c = complex(phases[mu]) if fb == 0 else complex(np.conj(phases[mu]))
            corr = c / np.conj(c) ** 2
            out.append((float(corr.real), float(corr.imag)))
    return tuple(out)


def compress_ug(ug_split: torch.Tensor) -> torch.Tensor:
    """Drop row 2 of a split per-parity copy [2,8,3,3,T,X,M] -> [2,8,2,3,T,X,M]."""
    return ug_split[:, :, :2].contiguous()


def _row2(ug: torch.Tensor, gcomp: tuple) -> torch.Tensor:
    """Complex [8, 2, 3, *sites] -> [8, 3, 3, *sites] with row 2 rebuilt as
    corr * conj(row0 x row1)."""
    r0, r1 = ug[:, 0], ug[:, 1]
    cross = torch.stack([r0[:, (j + 1) % 3] * r1[:, (j + 2) % 3]
                         - r0[:, (j + 2) % 3] * r1[:, (j + 1) % 3] for j in range(3)], dim=1)
    corr = torch.tensor([complex(*c) for c in gcomp], dtype=ug.dtype, device=ug.device)
    r2 = corr.reshape((8, 1) + (1,) * (ug.ndim - 3)) * torch.conj_physical(cross)
    return torch.stack([r0, r1, r2], dim=1)


# ---------------------------------------------------------------------------
# K1: hopping with fused twisted-mass epilogue
# ---------------------------------------------------------------------------

_EPI = {"none": 0, "mee_inv": 1, "mhat": 2}


def _check_fields(lat: Lattice, ug_p, psi_q, psi_o, epi, gcomp):
    site = lat.eo_site_shape
    rows = 2 if gcomp is not None else 3
    if epi[0] not in _EPI:
        raise ValueError(f"epilogue {epi[0]!r} is not on the ported path (have {sorted(_EPI)})")
    if gcomp is not None and len(gcomp) != 8:
        raise ValueError("gcomp must hold 8 (re, im) pairs")
    need = [("psi_q", psi_q, (2, 4, 3) + site), ("ug_p", ug_p, (2, 8, rows, 3) + site)]
    if epi[0] == "mhat":
        if psi_o is None:
            raise ValueError("the mhat epilogue needs psi_o")
        need.append(("psi_o", psi_o, (2, 4, 3) + site))
    for name, t, shape in need:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != psi_q.device:
            raise ValueError(f"{name} is on {t.device}, psi_q on {psi_q.device}")


def hopping_split(ug_p: torch.Tensor, psi_q: torch.Tensor, p: int, lat: Lattice,
                  epi: tuple = ("none",), psi_o=None,
                  gcomp: tuple | None = None) -> torch.Tensor:
    """K1: H_{p,q} psi_q on split f32 fields with a fused epilogue.

    epi forms (as in the reference):
      ("none",)                       out = H psi
      ("mee_inv", mutld, sign)        out = Mee(sign)^{-1} H psi
      ("mhat", mutld, sign, k2, g5)   out = [g5] (Mee(sign) psi_o - k2 H psi)
    ug_p: [2,8,3,3,T,X,M], or the 12-real [2,8,2,3,T,X,M] with gcomp set;
    psi_q, psi_o: [2,4,3,T,X,M]."""
    epi = tuple(epi)
    _check_fields(lat, ug_p, psi_q, psi_o, epi, gcomp)
    if psi_q.device.type == "cpu":
        return hopping_split_plain(ug_p, psi_q, p, lat, epi, psi_o, gcomp)
    if psi_q.device.type != "cuda":
        raise ValueError(f"no kernel for device {psi_q.device}")
    lib = kernel_library()
    kind = epi[0]
    mt = inv = k2 = 0.0
    g5 = 0
    if kind == "mee_inv":
        mutld, sign = float(epi[1]), float(epi[2])
        mt, inv = sign * mutld, 1.0 / (1.0 + mutld * mutld)
    elif kind == "mhat":
        mutld, sign, k2, g5 = float(epi[1]), float(epi[2]), float(epi[3]), int(bool(epi[4]))
        mt = sign * mutld
    corr = None
    if gcomp is not None:
        corr = (ctypes.c_float * 16)(*[v for pair in gcomp for v in pair])
    out = torch.empty_like(psi_q)
    t, x, _, _ = lat.dims
    with torch.cuda.device(psi_q.device):
        stream = torch.cuda.current_stream(psi_q.device).cuda_stream
        rc = lib.tm_hopping(
            psi_q.data_ptr(), ug_p.data_ptr(), psi_o.data_ptr() if kind == "mhat" else None,
            out.data_ptr(), t, x, lat.m, lat.zh, int(p), _EPI[kind], g5,
            int(gcomp is not None), mt, inv, k2,
            ctypes.cast(corr, ctypes.c_void_p) if corr is not None else None, stream)
    if rc != 0:
        raise RuntimeError(f"hopping kernel (K1) launch failed: CUDA error {rc}")
    hopping_split.launches += 1
    return out


hopping_split.launches = 0


def hopping_split_plain(ug_p: torch.Tensor, psi_q: torch.Tensor, p: int, lat: Lattice,
                        epi: tuple = ("none",), psi_o=None,
                        gcomp: tuple | None = None) -> torch.Tensor:
    """Plain PyTorch version of K1, written from the ops/wilson.py arithmetic
    (hop_packed rolls, SU(3) matrix-vector, dense spin projector)."""
    hopping_split_plain.calls += 1
    ug = merge_c(ug_p)
    if gcomp is not None:
        ug = _row2(ug, gcomp)
    psi = merge_c(psi_q)
    acc = None
    for d in range(8):
        mu, fb = d // 2, d % 2
        nbr = hop_packed(psi, p, mu, +1 if fb == 0 else -1, lat)
        term = spin_apply(hop_projector(mu, fb, psi), color_apply(ug[d], nbr))
        acc = term if acc is None else acc + term
    kind = epi[0]
    if kind == "none":
        out = acc
    elif kind == "mee_inv":
        _, mutld, sign = epi
        out = mee_inv_packed(acc, mutld, sign)
    else:
        _, mutld, sign, k2, g5 = epi
        out = mee_packed(merge_c(psi_o), mutld, sign) - k2 * acc
        if g5:
            out = apply_gamma5(out)
    return split_c(out)


hopping_split_plain.calls = 0


# ---------------------------------------------------------------------------
# K2: gauge cotangent of the hopping
# ---------------------------------------------------------------------------


def hopping_ug_vjp(g2: torch.Tensor, psi_q: torch.Tensor, p: int, lat: Lattice) -> torch.Tensor:
    """K2: d Re<g, H_{p,q}(ug) psi> / d ug[p] at fixed (g, psi) — the deriv_Sb
    outer product F_d[i,j] = sum_a ghat[a,i] conj(h[a,j]), ghat = W^+ g,
    h = W^+ psi_nbr.  g2, psi_q: [2,4,3,T,X,M] f32 -> [2,8,3,3,T,X,M] f32."""
    shape = (2, 4, 3) + lat.eo_site_shape
    for name, t in (("g2", g2), ("psi_q", psi_q)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != psi_q.device:
            raise ValueError(f"{name} is on {t.device}, psi_q on {psi_q.device}")
    if psi_q.device.type == "cpu":
        return hopping_ug_vjp_plain(g2, psi_q, p, lat)
    if psi_q.device.type != "cuda":
        raise ValueError(f"no kernel for device {psi_q.device}")
    lib = kernel_library()
    out = torch.empty((2, 8, 3, 3) + lat.eo_site_shape, dtype=torch.float32, device=psi_q.device)
    t, x, _, _ = lat.dims
    with torch.cuda.device(psi_q.device):
        stream = torch.cuda.current_stream(psi_q.device).cuda_stream
        rc = lib.tm_hopping_ug_vjp(g2.data_ptr(), psi_q.data_ptr(), out.data_ptr(), t, x,
                                   lat.m, lat.zh, int(p), stream)
    if rc != 0:
        raise RuntimeError(f"gauge-cotangent kernel (K2) launch failed: CUDA error {rc}")
    hopping_ug_vjp.launches += 1
    return out


hopping_ug_vjp.launches = 0


def hopping_ug_vjp_plain(g2: torch.Tensor, psi_q: torch.Tensor, p: int,
                         lat: Lattice) -> torch.Tensor:
    """Plain PyTorch version of K2: F_d[i,j] = sum_s g[s,i] conj((P_d nbr_d)[s,j])
    with P_d = (1 -/+ gamma_mu) the dense projector (= W W^+)."""
    hopping_ug_vjp_plain.calls += 1
    g = merge_c(g2)
    psi = merge_c(psi_q)
    out = []
    for d in range(8):
        mu, fb = d // 2, d % 2
        nbr = hop_packed(psi, p, mu, +1 if fb == 0 else -1, lat)
        pn = torch.conj_physical(spin_apply(hop_projector(mu, fb, psi), nbr))
        out.append(sum(g[s][:, None] * pn[s][None, :] for s in range(4)))
    return split_c(torch.stack(out))


hopping_ug_vjp_plain.calls = 0


def reset_counters() -> None:
    """Zero every launch and call counter of this module."""
    hopping_split.launches = 0
    hopping_ug_vjp.launches = 0
    hopping_split_plain.calls = 0
    hopping_ug_vjp_plain.calls = 0


# ---------------------------------------------------------------------------
# differentiable hopping
# ---------------------------------------------------------------------------


class HoppingDiff(torch.autograd.Function):
    """H_{p,q}(ug_p) psi_q, differentiable in ug_p and psi_q (all split f32).

    forward: K1 (epilogue none, 18-real).  backward: K2 for d ug_p and the
    adjoint identity H^+ = g5 H_{q,p} g5 on K1 for d psi_q; ug_q only
    parameterises the adjoint and receives no gradient (reference:
    `hopping_diff`, dslash_pallas.py:1608-1641)."""

    @staticmethod
    def forward(ctx, ug_p, ug_q, psi_q, p: int, lat: Lattice):
        ctx.save_for_backward(ug_q, psi_q)
        ctx.p = p
        ctx.lat = lat
        return hopping_split(ug_p, psi_q, p, lat)

    @staticmethod
    def backward(ctx, g2):
        ug_q, psi_q = ctx.saved_tensors
        g2 = g2.contiguous()
        p, lat = ctx.p, ctx.lat
        dug = hopping_ug_vjp(g2, psi_q, p, lat) if ctx.needs_input_grad[0] else None
        dpsi = None
        if ctx.needs_input_grad[2]:
            dpsi = gamma5_split(hopping_split(ug_q, gamma5_split(g2), 1 - p, lat))
        return dug, None, dpsi, None, None
