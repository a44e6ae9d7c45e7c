"""The even/odd hopping kernel (K1), its multi-right-hand-side form (K1-R),
the gauge-cotangent kernel (K2) and the slab kernels of the domain
decomposition (K3, K3-I, K4, K1-T) on Hopper, each beside its plain PyTorch
version, plus the differentiable hopping built from K1 and K2 and the halo
exchange of the sharded hop.

Port of the main-path parts of `tmlqcd_tpu/ops/dslash_pallas.py`:

* `split_c`/`merge_c`, `gauge_copy`, `gauge_corr`, `compress_ug` — the split
  layout and the pre-gathered per-direction gauge copy (boundary phases
  folded into the forward link and the conjugated backward link).
* `hopping_split` (K1) replaces `hopping_pallas_split` and the Pallas kernel
  `_dslash_kernel` (dslash_pallas.py:520, built by `_build` :774 and
  `_build_tb` :599): out = H_{p,q} psi on parity-p sites with the
  twisted-mass epilogue `none`, `mee_inv` or `mhat`, or the clover epilogue
  `clov_inv` or `clov_mhat` (`_apply_epilogue` :409-433 with the per-site
  2 x (6 x 6) complex block matvec `_blk_matvec` :311), fused in, on the
  18-real or 12-real gauge copy.  Bound by memory: 1320 flops/site against
  576 B (18-real) or 384 B (12-real) of gauge, 96 B per spinor read or
  written; `mhat` and `clov_mhat` read one spinor more, the clover epilogues
  576 B of blocks and 576 flops more.
* `hopping_split` on a bf16 gauge (K1-B) replaces the bf16 gauge of the same
  kernel (`_load_g` :186-195 and the upcast in `_stencil_accum` :263-265,
  reached from `make_fast_gauge(sloppy=True)`): the links are read as bf16,
  re and im of an element side by side in one 4-byte load (the copy holds
  re/im innermost in memory, the tensor's shape and bits are the f32 copy's
  cast), and upcast in registers; everything after the load is f32.  Bound
  by memory: 288 B (18-real) or 192 B (12-real) of gauge per site instead of
  576 / 384.  K1-R takes a bf16 gauge too (K1-RB, the bf16 instances of
  `_dslash_kernel_r`); K2 reads no gauge.
* `hopping_schur` (K1-S) replaces the K1 launches of one Schur operator
  (`m_hat_fast` / `q_hat_pm_fast` and the clover forms in the reference's
  ops/wilson_fast.py, each hop an `_dslash_kernel` :520): the two hops of
  Mhat or the four of Qhat_pm as phases of one cooperative launch,
  separated by grid-wide barriers, each phase K1's per-site work with its
  epilogue, bit for bit the K1 launches.  One wrapper call and one launch
  per operator instead of two or four; bound by memory as the hops summed
  (2 x 576 + 2 x 672 = 2496 B per site of one parity for Qhat_pm on the
  12-real f32 copy).
* `hopping_schur_nd` (K1-SD) replaces the K1-R-D launches and torch flavour
  diagonals of one Q_nd or Q_nd^2 of the non-degenerate doublet (the
  reference's `q_nd_fast` / `q_nd_sq_fast`, ops/wilson_fast.py:376-388, and
  the clover forms :609-622, each hop an `_dslash_kernel_r` :491 with r_pos
  1): the 2 or 4 hops of both flavours as phases of one cooperative launch,
  the flavour-mixing diagonals fused into their epilogues; the twisted-mass
  doublet bit for bit the route it replaced.  Bound by memory: 1728 B
  (Q_nd) or 3456 B (Q_nd^2) per site of one parity on the 12-real copy,
  5 x 576 B of clover blocks more per Q_nd.
* `hopping_split_rhs` (K1-R) replaces the same entry called with a 7-dim
  batch and the Pallas kernels `_dslash_kernel_r` (dslash_pallas.py:491) and
  `_dslash_kernel_tb_r` (:497): out[r] = epilogue(H_{p,q} psi[r]) for R
  right-hand sides [2,4,3,R,T,X,M] with the gauge read once for all of them.
  The batch axis is an explicit argument (`r_axis`), never inferred from a
  shape.  Bound by memory: G + R * (192 [+ 96 for mhat, clov_mhat]) bytes
  per site, G = 576 or 384, plus 576 for the blocks of a clover epilogue.
* `hopping_split_rhs(..., r_axis=1)` (K1-R-D) is the same kernel on the
  flavour doublet [2(re/im), 2(flavour), 4, 3, T, X, M] of the non-degenerate
  operator (`_build` with nrhs = 2, r_pos = 1 in the reference): flavour is
  the R axis, epilogue `none`, the gauge read once for both flavours.  The
  kernel addresses the field through three element strides; for the doublet
  they are 24 V (re/im), V (component: the colour axis' stride) and 12 V
  (flavour), V = T X M.  Bound by memory: G + 2 * 192 = 960 B (18-real) or
  768 B (12-real) per site, against 2 * (G + 192) for two K1 launches.
* `hopping_ug_vjp` (K2) replaces `hopping_ug_vjp` and `_ug_vjp_kernel`
  (dslash_pallas.py:1489, built by `_build_ug_vjp` :1541): the cotangent of
  Re<g, H psi> with respect to ug[p].  Bound by memory: 96 B of g and 96 B of
  psi per site read, 576 B per site written.
* `HoppingDiff` replaces the custom VJP `hopping_diff` (:1608-1641).
* `hopping_slab_split` (`csrc/hopping_slab.cu`) replaces the sharded Pallas
  kernels: K3 `_build_shard_ext` :1228 (`_shard_kernel` :1153 with the t
  halos concatenated; `_shard_kernel_r` for R > 0 or the doublet), K3-I
  `_build_shard_int` :1267 (the interior rows, no t halo), K4
  `_build_shard_bnd` :1307 (`_shard_bnd_kernel` :1173: the two surface rows
  of each slab) and K1-T `_build_ext` :997 (t slabs only, the y hops
  wrapping inside the slab).  One launch per variant covers every slab of a
  `parallel.Mesh` on one device; the output is the whole field, written at
  the variant's rows, so no assembly follows.  Epilogue none, f32 or bf16
  links, one spinor, R columns or the doublet.  Bound by memory as K1: the
  links of the variant's sites, psi's rows once, the halo buffers and the
  output.
* `halo_pack` (KH) replaces the halo exchange `_exchange` of
  `hopping_pallas_shard` (:1413): the y and t halos of every slab in one
  launch (half-spinor projection W^+ with the (1 -/+ gamma_2) and (1 -/+
  gamma_0) maps, the send a write into the receiving slab's slot, the
  rebuild 0.5 W s), element for element the torch exchange (`_y_halos`,
  `_t_halos`) it replaced.  Bound by memory: 96 B read and 96 B written per
  halo site and column.
* `hopping_shard` replaces `hopping_pallas_shard` (:1345-1480): with the
  overlap, KH then one slab launch over the interior and surface rows
  (K3-I+K4) in one C call (`tm_shard_hop`); without it the torch exchange
  and K3;
  `hopping_tshard` replaces `hopping_pallas_tshard` (:1065) on K1-T.  Both
  equal K1 on the whole lattice: the slab kernels run K1's per-site sum on
  the same neighbour values.
* On one rank of a distributed mesh (one process per slab, `parallel`),
  `hopping_rank` is `hopping_pallas_shard` with its `_exchange` (:1413)
  taken literally: KH-P (`halo_faces`, KH on the rank's own slab: at mesh
  (1, 1) its t rows are the two t faces, and the y faces are written with
  one local y slab) packs the four send faces, `comm.exchange` moves them
  between the ranks, K3-I (`_build_shard_int` :1267) runs the interior
  rows while the t faces travel and K4 (`_build_shard_bnd` :1307) the
  surface rows from the received faces; without the overlap K3 runs on the
  slab with its received t faces concatenated.  The result equals K1 on the
  whole lattice bit for bit, row for row.
* `hopping_ug_vjp_slab` (K2-S) is K2 on a rank's slab, its t and y
  neighbours at the slab's edge read from the faces the forward hop
  received (kept by `HoppingDiff`), so the backward exchanges nothing for
  it; the reference takes jnp autodiff under a mesh.

Routing: the device of the tensors decides.  A CUDA tensor launches the
kernel (or raises); a CPU tensor takes the plain version.  There is no
fallback between the two.  Each wrapper counts its kernel launches in a
plain int attribute (`hopping_split.launches`, `hopping_schur.launches`,
`hopping_split_rhs.launches`, `hopping_ug_vjp.launches`); each plain version
counts its calls (`.calls`).  `hopping_schur.hops` counts the K1 hops its
launches ran, `.clover_hops` and `.bf16_hops` those with a clover epilogue
and on a bf16 gauge.
`hopping_split.clover_launches` and `hopping_split_rhs.clover_launches` count
those of the launches that ran a clover epilogue, `hopping_split.bf16_launches`
those on a bf16 gauge,
`hopping_split_rhs.doublet_launches` those on the flavour-doublet axis,
`hopping_split_rhs.bf16_launches` those on a bf16 gauge (K1-RB);
`hopping_slab_split.launches` counts the slab kernels by name (K3, K3-I,
K4, K1-T, K3-I+K4), `.bf16_launches` and `.rhs_launches` those on a bf16
gauge and with an R axis; the sharded hop counts its launches there too.
`hopping_schur_nd.launches` counts K1-SD's launches, `.hops` the doublet
hops they ran and `.clover_launches` those on the clover doublet;
`halo_pack.launches` counts KH's and `halo_pack.plain_calls` the calls
its plain version (the torch exchange) served; `halo_faces.launches` counts
KH-P's, `hopping_rank.launches` the rank's slab launches by name (K3-I, K4,
K3-I+K4, K3, K1-T), `hopping_ug_vjp_slab.launches` K2-S's and
`gauge_force_cuda.launches` KG's (`reset_counters` also zeroes
`gauge_action.gauge_force_plain.calls`, the calls KG's plain version served).

`gauge_force_cuda` (KG, `csrc/gauge_force.cu`) is the MD gauge force of the
whole lattice in one launch: plaquette and rectangle staples, the TA
projection fused.  It replaces no TPU kernel (the reference's force is plain
jnp); its plain version is `gauge_action.gauge_force_plain`.

The kernels are compiled at first use from `tmlqcd_tpu_torch/csrc/`, one
nvcc process per source, into a shared library with a plain C interface,
loaded with ctypes; see `kernel_library`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import numpy as np
import torch

from tmlqcd_tpu_torch import comm
from tmlqcd_tpu_torch.gamma import GAMMA, apply_gamma5, gamma5_split
from tmlqcd_tpu_torch.lattice import Lattice, hop_packed
from tmlqcd_tpu_torch.ops import split_diag as sd
from tmlqcd_tpu_torch.ops.clover import blocks_apply
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
    "hopping_schur",
    "hopping_schur_plain",
    "hopping_split_rhs",
    "hopping_split_rhs_plain",
    "hopping_schur_nd",
    "hopping_schur_nd_plain",
    "schur_nd_kernel_info",
    "slab_kernel_info",
    "halo_pack",
    "halo_faces",
    "hopping_shard",
    "hopping_rank",
    "hopping_ug_vjp_slab",
    "hopping_ug_vjp_slab_plain",
    "hopping_ug_vjp",
    "hopping_ug_vjp_plain",
    "HoppingDiff",
    "blk_flatten",
    "blk_unflatten",
    "kernel_library",
    "kernel_info",
    "schur_kernel_info",
    "rhs_kernel_info",
    "gauge_force_cuda",
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
# each (source, part) is one nvcc process, all started together; the objects
# are linked into one library.  hopping.cu is built in five parts
# (-DTM_PART, see the note above its tm_part_* functions).
_JOBS = tuple(("hopping.cu", part) for part in range(5)) + (("hopping_slab.cu", None),
                                                            ("gauge_force.cu", None))
_HEADERS = ("hopping_common.cuh",)
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
               "-Xcompiler", "-fPIC")
_lib_handle = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (on PATH or /usr/local/cuda/bin): the CUDA "
                           "kernels of tmlqcd_tpu_torch are built from source at first use")
    return path


def _build(so: str, verbose: bool) -> None:
    """Compile every (source, part) in its own nvcc process, all at once,
    and link the objects into `so` (moved into place atomically)."""
    os.makedirs(_BUILD, exist_ok=True)
    tmpdir = tempfile.mkdtemp(dir=_BUILD)
    try:
        procs = []
        for name, part in _JOBS:
            obj = os.path.join(tmpdir, f"{name}.{part}.o")
            cmd = [_nvcc(), *_NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
                   *([f"-DTM_PART={part}"] if part is not None else []), "-c", "-o", obj,
                   os.path.join(_CSRC, name)]
            label = name if part is None else f"{name} part {part}"
            procs.append((label, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                       stderr=subprocess.PIPE, text=True)))
        failed = []
        for name, _, proc in procs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{name} ({proc.returncode}):\n{err}")
            elif verbose:
                print(f"[nvcc {name}]\n{err}", flush=True)
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        tmp = os.path.join(tmpdir, "lib.so")
        res = subprocess.run([_nvcc(), *_NVCC_FLAGS, "-shared", "-o", tmp,
                              *(obj for _, obj, _ in procs)], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stderr}")
        os.replace(tmp, so)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)


def kernel_library(verbose: bool = False) -> ctypes.CDLL:
    """Build (once per source version) and load the kernel library.

    The library is named by a hash of the sources and flags, compiled into
    `csrc/build/` and moved into place atomically, so concurrent processes
    and stale builds cannot mix; a file lock makes the ranks of one host
    wait for the first build instead of running nvcc each.  `verbose=True` adds `-Xptxas -v` and
    prints nvcc's report (registers, spills) on first build."""
    global _lib_handle
    with _lib_lock:
        if _lib_handle is not None:
            return _lib_handle
        h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode() + repr(_JOBS).encode())
        for name in tuple(dict.fromkeys(name for name, _ in _JOBS)) + _HEADERS:
            with open(os.path.join(_CSRC, name), "rb") as f:
                h.update(f.read())
        so = os.path.join(_BUILD, f"libtmlqcd_kernels_{h.hexdigest()[:16]}.so")
        if not os.path.exists(so):
            os.makedirs(_BUILD, exist_ok=True)
            with open(os.path.join(_BUILD, ".build.lock"), "w") as lock:
                fcntl.flock(lock, fcntl.LOCK_EX)
                if not os.path.exists(so):
                    _build(so, verbose)
        lib = ctypes.CDLL(so)
        vp, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
        lib.tm_hopping.argtypes = [vp, vp, vp, vp, vp, i, i, i, i, i, i, i, i, i, f, f, f, vp,
                                   vp]
        lib.tm_hopping.restype = i
        lib.tm_hopping_rhs.argtypes = [vp, vp, vp, vp, vp, i, i, i, i, i, i, i, i, i, f, f, f,
                                       vp, i, ll, ll, ll, vp]
        lib.tm_hopping_rhs.restype = i
        lib.tm_hopping_info.argtypes = [i, i, i, i, vp]
        lib.tm_hopping_info.restype = i
        lib.tm_hopping_rhs_info.argtypes = [i, i, i, i, i, vp]
        lib.tm_hopping_rhs_info.restype = i
        lib.tm_hopping_schur.argtypes = [vp] * 11 + [i] * 9 + [vp, vp, vp]
        lib.tm_hopping_schur.restype = i
        lib.tm_hopping_schur_info.argtypes = [i, i, i, i, vp]
        lib.tm_hopping_schur_info.restype = i
        lib.tm_hopping_ug_vjp.argtypes = [vp, vp, vp, i, i, i, i, i, vp]
        lib.tm_hopping_ug_vjp.restype = i
        lib.tm_hopping_slab.argtypes = ([vp, ll, ll, ll] * 3 + [vp, vp, ll, ll, ll]
                                        + [i] * 10 + [vp, i, vp])
        lib.tm_hopping_slab.restype = i
        lib.tm_halo_pack.argtypes = [vp, ll, ll, ll] * 3 + [i] * 8 + [vp]
        lib.tm_halo_pack.restype = i
        lib.tm_shard_hop.argtypes = [vp, ll, ll, ll] * 3 + [vp, vp] + [i] * 10 + [vp, i, vp]
        lib.tm_shard_hop.restype = i
        lib.tm_hopping_schur_nd.argtypes = [vp] * 8 + [i] * 7 + [vp, vp, vp]
        lib.tm_hopping_schur_nd.restype = i
        lib.tm_hopping_schur_nd_info.argtypes = [i, i, vp]
        lib.tm_hopping_schur_nd_info.restype = i
        lib.tm_slab_info.argtypes = [i, vp]
        lib.tm_slab_info.restype = i
        lib.tm_ug_vjp_slab.argtypes = [vp] * 5 + [i] * 5 + [vp]
        lib.tm_ug_vjp_slab.restype = i
        lib.tm_gauge_force.argtypes = [vp, vp, i, i, i, i, f, f, vp]
        lib.tm_gauge_force.restype = i
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
# K1: hopping with fused twisted-mass or clover epilogue
# ---------------------------------------------------------------------------

_EPI = {"none": 0, "mee_inv": 1, "mhat": 2, "clov_inv": 3, "clov_mhat": 4}
_NEEDS_PSI_O = ("mhat", "clov_mhat")
_NEEDS_BLOCKS = ("clov_inv", "clov_mhat")


def _check_fields(lat: Lattice, ug_p, psi_q, psi_o, epi, gcomp, nrhs: int | None = None,
                  blocks=None, r_axis: int = 3):
    """Raise on anything the kernels do not take; `nrhs` set means spinors
    carry an R axis of that extent at `r_axis`: 3, before the sites, or 1,
    the flavour axis of a doublet (the gauge and the clover blocks never
    carry one).  The gauge may be f32 or bf16."""
    site = lat.eo_site_shape
    if nrhs is None:
        spinor = (2, 4, 3) + site
    elif r_axis == 1:
        spinor = (2, nrhs, 4, 3) + site
    else:
        spinor = (2, 4, 3, nrhs) + site
    rows = 2 if gcomp is not None else 3
    if epi[0] not in _EPI:
        raise ValueError(f"unknown epilogue {epi[0]!r}: the kernels carry "
                         f"{', '.join(_EPI)}")
    if gcomp is not None and len(gcomp) != 8:
        raise ValueError("gcomp must hold 8 (re, im) pairs")
    need = [("psi_q", psi_q, spinor), ("ug_p", ug_p, (2, 8, rows, 3) + site)]
    if epi[0] in _NEEDS_PSI_O:
        if psi_o is None:
            raise ValueError(f"the {epi[0]} epilogue needs psi_o")
        need.append(("psi_o", psi_o, spinor))
    if epi[0] in _NEEDS_BLOCKS:
        if blocks is None:
            raise ValueError(f"the {epi[0]} epilogue needs blocks")
        need.append(("blocks", blocks, (2, 72) + site))
    _check_tensors(need, psi_q.device)


def _check_tensors(need, device) -> None:
    """(name, tensor, shape) triples: f32 (the gauge `ug_p`: f32 or bf16),
    that shape, contiguous (a bf16 gauge: re/im innermost, the layout of
    `wilson_fast.sloppy_gauge`), on `device`."""
    for name, t, shape in need:
        ok = (torch.float32, torch.bfloat16) if name == "ug_p" else (torch.float32,)
        if t.dtype not in ok:
            names = " or ".join(str(d).removeprefix("torch.") for d in ok)
            raise TypeError(f"{name} must be {names}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if t.dtype == torch.bfloat16:
            if not t.movedim(0, -1).is_contiguous():
                raise ValueError(f"{name}: a bf16 gauge holds re/im innermost in memory "
                                 f"(wilson_fast.sloppy_gauge)")
        elif not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, psi on {device}")


def _epilogue_args(epi: tuple) -> tuple:
    """epi -> (code, g5, mt, inv, k2) as the C entries take them."""
    kind = epi[0]
    mt = inv = k2 = 0.0
    g5 = 0
    if kind == "mee_inv":
        mutld, sign = float(epi[1]), float(epi[2])
        mt, inv = sign * mutld, 1.0 / (1.0 + mutld * mutld)
    elif kind == "mhat":
        mutld, sign, k2, g5 = float(epi[1]), float(epi[2]), float(epi[3]), int(bool(epi[4]))
        mt = sign * mutld
    elif kind == "clov_inv":
        inv = 1.0  # the kernel's scale factor
    elif kind == "clov_mhat":
        k2, g5 = float(epi[1]), int(bool(epi[2]))
    return _EPI[kind], g5, mt, inv, k2


def _ptr(t, wanted: bool):
    return t.data_ptr() if wanted else None


@functools.lru_cache(maxsize=64)
def _corr_cached(gcomp: tuple) -> tuple:
    corr = (ctypes.c_float * 16)(*[v for pair in gcomp for v in pair])
    return corr, ctypes.cast(corr, ctypes.c_void_p)


def _corr_arg(gcomp):
    """(keep-alive ctypes array, void pointer) of the 8 row-2 constants,
    made once per set of constants (one per gauge copy's boundary phases)
    and kept, so a launch builds no host array."""
    if gcomp is None:
        return None, None
    return _corr_cached(gcomp if isinstance(gcomp, tuple) else tuple(map(tuple, gcomp)))


def hopping_split(ug_p: torch.Tensor, psi_q: torch.Tensor, p: int, lat: Lattice,
                  epi: tuple = ("none",), psi_o=None,
                  gcomp: tuple | None = None, blocks=None) -> torch.Tensor:
    """K1: H_{p,q} psi_q on split f32 fields with a fused epilogue.

    epi forms (as in the reference):
      ("none",)                       out = H psi
      ("mee_inv", mutld, sign)        out = Mee(sign)^{-1} H psi
      ("mhat", mutld, sign, k2, g5)   out = [g5] (Mee(sign) psi_o - k2 H psi)
      ("clov_inv",)                   out = B (H psi), B = `blocks`, the
                                      M_ee^{-1} clover blocks of the even sites
      ("clov_mhat", k2, g5)           out = [g5] (B psi_o - k2 H psi), B = the
                                      M_oo clover blocks of the odd sites
    ug_p: [2,8,3,3,T,X,M], or the 12-real [2,8,2,3,T,X,M] with gcomp set,
    float32 or bfloat16 (the sloppy copy, K1-B: upcast to f32 on loading);
    psi_q, psi_o: [2,4,3,T,X,M] f32; blocks: [2,72,T,X,M] f32, the two 6 x 6
    complex blocks per site flattened as k = ((b 2 + s) 2 + s') 9 + 3 c + c'
    (`blk_flatten`)."""
    epi = tuple(epi)
    _check_fields(lat, ug_p, psi_q, psi_o, epi, gcomp, blocks=blocks)
    if psi_q.device.type == "cpu":
        return hopping_split_plain(ug_p, psi_q, p, lat, epi, psi_o, gcomp, blocks)
    if psi_q.device.type != "cuda":
        raise ValueError(f"no kernel for device {psi_q.device}")
    lib = kernel_library()
    code, g5, mt, inv, k2 = _epilogue_args(epi)
    corr, corr_ptr = _corr_arg(gcomp)
    bf16 = ug_p.dtype == torch.bfloat16
    out = torch.empty_like(psi_q)
    t, x, _, _ = lat.dims
    with torch.cuda.device(psi_q.device):
        stream = torch.cuda.current_stream(psi_q.device).cuda_stream
        rc = lib.tm_hopping(
            psi_q.data_ptr(), ug_p.data_ptr(), _ptr(psi_o, epi[0] in _NEEDS_PSI_O),
            _ptr(blocks, epi[0] in _NEEDS_BLOCKS), out.data_ptr(), t, x, lat.m, lat.zh, int(p),
            code, g5, int(gcomp is not None), int(bf16), mt, inv, k2, corr_ptr, stream)
    if rc != 0:
        raise RuntimeError(f"hopping kernel (K1) launch failed: CUDA error {rc}")
    hopping_split.launches += 1
    hopping_split.clover_launches += epi[0] in _NEEDS_BLOCKS
    hopping_split.bf16_launches += bf16
    return out


hopping_split.launches = 0
hopping_split.clover_launches = 0
hopping_split.bf16_launches = 0


# ---------------------------------------------------------------------------
# K1-S: the Schur operator in one persistent launch
# ---------------------------------------------------------------------------

# the (even, odd) epilogue pairs of one Schur application
_SCHUR_PAIRS = {("mee_inv", "mhat"): 0, ("clov_inv", "clov_mhat"): 1}


@functools.lru_cache(maxsize=256)
def _schur_consts(epis: tuple) -> tuple:
    """(keep-alive ctypes array, pointer) of the (mt, inv, k2) of the 4
    phases, from the stages' (even, odd) epilogues; made once per set of
    constants and kept."""
    vals = []
    for epi_e, epi_o in epis:
        for epi in (epi_e, epi_o):
            vals.extend(_epilogue_args(epi)[2:])
    vals.extend([0.0] * (12 - len(vals)))
    arr = (ctypes.c_float * 12)(*vals)
    return arr, ctypes.cast(arr, ctypes.c_void_p)


def _check_schur(ug_e, ug_o, psi, lat: Lattice, stages, gcomp) -> tuple:
    """Raise on anything K1-S does not take; -> (stages as tuples, the
    stages' epilogue pairs, clover?, g5?)."""
    stages = tuple(tuple(st) for st in stages)
    if len(stages) not in (1, 2):
        raise ValueError(f"K1-S runs 1 (Mhat) or 2 (Qhat_pm) Schur applications, got "
                         f"{len(stages)}")
    kinds, g5s, need = set(), set(), []
    site = lat.eo_site_shape
    for j, st in enumerate(stages):
        if len(st) != 4:
            raise ValueError("a Schur stage is (even epilogue, odd epilogue, even blocks, odd "
                             "blocks)")
        epi_e, epi_o, blk_e, blk_o = tuple(st[0]), tuple(st[1]), st[2], st[3]
        pair = (epi_e[0], epi_o[0])
        if pair not in _SCHUR_PAIRS:
            raise ValueError(f"K1-S runs the epilogue pairs (mee_inv, mhat) and (clov_inv, "
                             f"clov_mhat), got {pair}")
        kinds.add(_SCHUR_PAIRS[pair])
        g5s.add(bool(epi_o[-1]))
        if pair[0] == "clov_inv":
            for name, blk in ((f"stage {j} even blocks", blk_e), (f"stage {j} odd blocks", blk_o)):
                if blk is None:
                    raise ValueError(f"the clover stages need blocks: {name} missing")
                need.append(("blocks", blk, (2, 72) + site))
    if len(kinds) != 1 or len(g5s) != 1:
        raise ValueError("the stages of one K1-S launch share their epilogue pair and their "
                         "gamma5")
    if gcomp is not None and len(gcomp) != 8:
        raise ValueError("gcomp must hold 8 (re, im) pairs")
    rows = 2 if gcomp is not None else 3
    if ug_e.dtype != ug_o.dtype:
        raise TypeError(f"the two link copies differ in type: {ug_e.dtype}, {ug_o.dtype}")
    need += [("psi_q", psi, (2, 4, 3) + site), ("ug_p", ug_e, (2, 8, rows, 3) + site),
             ("ug_p", ug_o, (2, 8, rows, 3) + site)]
    _check_tensors(need, psi.device)
    epis = tuple((tuple(st[0]), tuple(st[1])) for st in stages)
    return stages, epis, kinds.pop() == 1, g5s.pop()


def hopping_schur(ug_e: torch.Tensor, ug_o: torch.Tensor, psi: torch.Tensor, lat: Lattice,
                  stages, gcomp: tuple | None = None) -> torch.Tensor:
    """K1-S: the even/odd Schur operator in one launch, equal bit for bit to
    the sequence of K1 launches it replaces.

    `stages`: 1 (Mhat, Qhat) or 2 (Qhat_pm) Schur applications, each
    (epi_even, epi_odd, blocks_even, blocks_odd) of `hopping_split`'s forms:
      (("mee_inv", mutld, sign), ("mhat", mutld, sign, k2, g5), None, None)
      (("clov_inv",), ("clov_mhat", k2, g5), M_ee^-1 blocks, M_oo blocks)
    Stage j runs tmp = K1(ug_e, x, even, epi_even) and then x = K1(ug_o,
    tmp, odd, epi_odd, psi_o=x), x the input for j = 0; the stages share
    their pair and their g5.  ug_e, ug_o: the even and odd link copies
    (FastGauge), f32 or bf16 (the sloppy copy's layout);
    psi: [2,4,3,T,X,M] f32."""
    stages, epis, clover, g5 = _check_schur(ug_e, ug_o, psi, lat, stages, gcomp)
    if psi.device.type == "cpu":
        return hopping_schur_plain(ug_e, ug_o, psi, lat, stages, gcomp)
    if psi.device.type != "cuda":
        raise ValueError(f"no kernel for device {psi.device}")
    lib = kernel_library()
    two = len(stages) == 2
    # every intermediate in a buffer of its own: a phase never writes a field
    # that an earlier phase of the launch read through the read-only cache
    e1 = torch.empty_like(psi)
    o1 = torch.empty_like(psi) if two else None
    e2 = torch.empty_like(psi) if two else None
    out = torch.empty_like(psi)
    blk = [st[k].data_ptr() if clover else None for st in stages for k in (2, 3)]
    blk += [None] * (4 - len(blk))
    bf16 = ug_e.dtype == torch.bfloat16
    _, consts = _schur_consts(epis)
    _, corr_ptr = _corr_arg(gcomp)
    t, x, _, _ = lat.dims
    args = (psi.data_ptr(), ug_e.data_ptr(), ug_o.data_ptr(), *blk, e1.data_ptr(),
            o1.data_ptr() if two else None, e2.data_ptr() if two else None, out.data_ptr(),
            t, x, lat.m, lat.zh, len(stages), int(clover), int(g5), int(gcomp is not None),
            int(bf16), consts, corr_ptr)
    if psi.device.index == torch.cuda.current_device():
        rc = lib.tm_hopping_schur(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(psi.device):
            rc = lib.tm_hopping_schur(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"Schur hopping kernel (K1-S) launch failed: CUDA error {rc}")
    hops = 2 * len(stages)
    hopping_schur.launches += 1
    hopping_schur.hops += hops
    hopping_schur.clover_hops += hops if clover else 0
    hopping_schur.bf16_hops += hops if bf16 else 0
    return out


hopping_schur.launches = 0
hopping_schur.hops = 0
hopping_schur.clover_hops = 0
hopping_schur.bf16_hops = 0


def hopping_schur_plain(ug_e: torch.Tensor, ug_o: torch.Tensor, psi: torch.Tensor, lat: Lattice,
                        stages, gcomp: tuple | None = None) -> torch.Tensor:
    """Plain PyTorch version of K1-S: the stages as the composition of
    `hopping_split_plain`, the even hop and then the odd one."""
    hopping_schur_plain.calls += 1
    x = psi
    for epi_e, epi_o, blk_e, blk_o in stages:
        tmp = hopping_split_plain(ug_e, x, 0, lat, epi_e, gcomp=gcomp, blocks=blk_e)
        x = hopping_split_plain(ug_o, tmp, 1, lat, epi_o, psi_o=x, gcomp=gcomp, blocks=blk_o)
    return x


hopping_schur_plain.calls = 0


def schur_kernel_info(clover: bool, g5: bool, gcomp: bool, bf16: bool) -> dict:
    """K1-S's instance as the card runs it, as `kernel_info`."""
    return _kernel_info(kernel_library().tm_hopping_schur_info, int(clover), int(g5),
                        int(gcomp), int(bf16))


def _kernel_info(entry, *args) -> dict:
    info = (ctypes.c_int * 4)()
    rc = entry(*args, info)
    if rc != 0:
        raise RuntimeError(f"kernel info query failed: CUDA error {rc}")
    return dict(zip(("blocks_per_sm", "registers", "local_bytes", "threads"), info))


def kernel_info(epi: tuple, gcomp: bool, bf16: bool) -> dict:
    """The K1 instance of an epilogue and link type as the card runs it:
    resident blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
    registers and local-memory bytes (spills, stack) per thread, threads
    per block."""
    code, g5, _, _, _ = _epilogue_args(tuple(epi))
    return _kernel_info(kernel_library().tm_hopping_info, code, g5, int(gcomp), int(bf16))


def rhs_kernel_info(epi: tuple, gcomp: bool, bf16: bool, nrhs: int) -> dict:
    """The K1-R instance of an epilogue and link type at `nrhs` columns
    (K1-R-D: epilogue none, nrhs 2) as the card runs it, as `kernel_info`."""
    code, g5, _, _, _ = _epilogue_args(tuple(epi))
    return _kernel_info(kernel_library().tm_hopping_rhs_info, code, g5, int(gcomp), int(bf16),
                        int(nrhs))


def blk_flatten(blk2: torch.Tensor) -> torch.Tensor:
    """Split blocks [2, 2, 2, 2, 3, 3, *sites] -> the kernels' [2, 72, *sites]
    layout (row-major over chirality, s, s', c, c'), contiguous."""
    return blk2.reshape((2, 72) + tuple(blk2.shape[6:])).contiguous()


def blk_unflatten(blk: torch.Tensor) -> torch.Tensor:
    """The kernels' [2, 72, *sites] block layout -> [2, 2, 2, 2, 3, 3, *sites]
    (re/im, chirality, s, s', c, c')."""
    return blk.reshape((2, 2, 2, 2, 3, 3) + tuple(blk.shape[2:]))


def _blocks_apply(blk: torch.Tensor, psi: torch.Tensor) -> torch.Tensor:
    """The flattened split blocks [2, 72, *sites] on a complex spinor
    [4, 3, (R,) *sites] with `ops/clover.blocks_apply`, the blocks broadcast
    over an R axis where the spinor has one."""
    blocks = merge_c(blk_unflatten(blk))  # [2, 2, 2, 3, 3, *sites]
    if psi.ndim == blocks.ndim - 2:  # [4, 3, R, *sites]: one block for every column
        blocks = blocks.unsqueeze(5)
    return blocks_apply(blocks, psi)


def _hop_epilogue(ug: torch.Tensor, psi: torch.Tensor, p: int, lat: Lattice, epi: tuple,
                  psi_o, blocks=None) -> torch.Tensor:
    """epilogue(sum_d P_d U_d psi(x + d)) on complex fields, split on the way
    out; ug [8, 3, 3, *sites] broadcasts against psi [4, 3, *sites]."""
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
    elif kind == "mhat":
        _, mutld, sign, k2, g5 = epi
        out = mee_packed(merge_c(psi_o), mutld, sign) - k2 * acc
        if g5:
            out = apply_gamma5(out)
    elif kind == "clov_inv":
        out = _blocks_apply(blocks, acc)
    else:
        _, k2, g5 = epi
        out = _blocks_apply(blocks, merge_c(psi_o)) - k2 * acc
        if g5:
            out = apply_gamma5(out)
    return split_c(out)


def hopping_split_plain(ug_p: torch.Tensor, psi_q: torch.Tensor, p: int, lat: Lattice,
                        epi: tuple = ("none",), psi_o=None,
                        gcomp: tuple | None = None, blocks=None) -> torch.Tensor:
    """Plain PyTorch version of K1, written from the ops/wilson.py arithmetic
    (hop_packed rolls, SU(3) matrix-vector, dense spin projector) and, for
    the clover epilogues, the complex block matvec of ops/clover.py.  A bf16
    gauge is upcast first, so row 2 of the 12-real copy is rebuilt from the
    rounded rows 0 and 1, as the kernel does."""
    hopping_split_plain.calls += 1
    ug = merge_c(ug_p.float())
    if gcomp is not None:
        ug = _row2(ug, gcomp)
    return _hop_epilogue(ug, merge_c(psi_q), p, lat, tuple(epi), psi_o, blocks)


hopping_split_plain.calls = 0


# ---------------------------------------------------------------------------
# K1-R: the hopping on R right-hand sides, one read of the gauge
# ---------------------------------------------------------------------------

_R_AXIS = 3  # the generic batch axis [2, 4, 3, R, T, X, M]
_DOUBLET_AXIS = 1  # the flavour doublet [2, 2, 4, 3, T, X, M]


def _check_r_axis(r_axis: int, psi_q: torch.Tensor, epi: tuple) -> int:
    """The extent of the R axis; raises for a position or a combination the
    kernel does not take.  The position is never read off a shape."""
    if r_axis not in (_R_AXIS, _DOUBLET_AXIS):
        raise ValueError(f"r_axis = {r_axis}: the multi-RHS kernel takes the batch axis "
                         f"{_R_AXIS} ([2,4,3,R,T,X,M]) or the flavour-doublet axis "
                         f"{_DOUBLET_AXIS} ([2,2,4,3,T,X,M])")
    if psi_q.ndim != 7:
        raise ValueError(f"psi_q has shape {tuple(psi_q.shape)}, expected 7 axes with R at "
                         f"{r_axis}")
    if r_axis == _DOUBLET_AXIS:
        if epi[0] != "none":
            raise ValueError(f"the flavour-doublet axis runs the epilogue 'none' only (the "
                             f"flavour-mixing diagonal is applied outside the kernel), got "
                             f"{epi[0]!r}")
        if psi_q.shape[1] != 2:
            raise ValueError(f"a flavour doublet has 2 flavours, got shape {tuple(psi_q.shape)}")
    return int(psi_q.shape[r_axis])


def hopping_split_rhs(ug_p: torch.Tensor, psi_q: torch.Tensor, p: int, lat: Lattice,
                      epi: tuple = ("none",), psi_o=None, gcomp: tuple | None = None,
                      r_axis: int = _R_AXIS, blocks=None) -> torch.Tensor:
    """K1-R: out[r] = epilogue(H_{p,q} psi_q[r]) for the R right-hand sides
    along `r_axis`, the gauge read once for all of them.

    `r_axis` = 3: psi_q, psi_o [2,4,3,R,T,X,M] f32; ug_p (f32, or bf16: K1-RB),
    blocks and epi as for `hopping_split` (the gauge and the clover blocks have no R axis;
    `mhat` and `clov_mhat` need psi_o with the same R axis).
    `r_axis` = 1 (K1-R-D): psi_q is a flavour doublet [2,2,4,3,T,X,M] f32,
    epilogue `none` only."""
    epi = tuple(epi)
    nrhs = _check_r_axis(r_axis, psi_q, epi)
    _check_fields(lat, ug_p, psi_q, psi_o, epi, gcomp, nrhs, blocks, r_axis)
    if psi_q.device.type == "cpu":
        return hopping_split_rhs_plain(ug_p, psi_q, p, lat, epi, psi_o, gcomp, r_axis, blocks)
    if psi_q.device.type != "cuda":
        raise ValueError(f"no kernel for device {psi_q.device}")
    lib = kernel_library()
    code, g5, mt, inv, k2 = _epilogue_args(epi)
    corr, corr_ptr = _corr_arg(gcomp)
    bf16 = ug_p.dtype == torch.bfloat16
    out = torch.empty_like(psi_q)
    t, x, _, _ = lat.dims
    # element strides of the contiguous field: re/im, component (the colour
    # axis: spin and colour are adjacent in both layouts) and right-hand side
    colour_axis = 2 if r_axis == _R_AXIS else 3
    im_stride, comp_stride, r_stride = (psi_q.stride(0), psi_q.stride(colour_axis),
                                        psi_q.stride(r_axis))
    with torch.cuda.device(psi_q.device):
        stream = torch.cuda.current_stream(psi_q.device).cuda_stream
        rc = lib.tm_hopping_rhs(
            psi_q.data_ptr(), ug_p.data_ptr(), _ptr(psi_o, epi[0] in _NEEDS_PSI_O),
            _ptr(blocks, epi[0] in _NEEDS_BLOCKS), out.data_ptr(), t, x, lat.m, lat.zh, int(p),
            code, g5, int(gcomp is not None), int(bf16), mt, inv, k2, corr_ptr, nrhs, im_stride,
            comp_stride, r_stride, stream)
    if rc != 0:
        raise RuntimeError(f"multi-RHS hopping kernel (K1-R) launch failed: CUDA error {rc}")
    hopping_split_rhs.launches += 1
    hopping_split_rhs.clover_launches += epi[0] in _NEEDS_BLOCKS
    hopping_split_rhs.doublet_launches += r_axis == _DOUBLET_AXIS
    hopping_split_rhs.bf16_launches += bf16
    return out


hopping_split_rhs.launches = 0
hopping_split_rhs.clover_launches = 0
hopping_split_rhs.doublet_launches = 0
hopping_split_rhs.bf16_launches = 0


def hopping_split_rhs_plain(ug_p: torch.Tensor, psi_q: torch.Tensor, p: int, lat: Lattice,
                            epi: tuple = ("none",), psi_o=None, gcomp: tuple | None = None,
                            r_axis: int = _R_AXIS, blocks=None) -> torch.Tensor:
    """Plain PyTorch version of K1-R: the arithmetic of `hopping_split_plain`
    with the links and the clover blocks broadcast over the R axis.  A
    flavour doublet (`r_axis` = 1) is viewed with its flavour axis behind
    the colour axis, where the batch axis sits, and viewed back."""
    hopping_split_rhs_plain.calls += 1
    epi = tuple(epi)
    _check_r_axis(r_axis, psi_q, epi)
    ug = merge_c(ug_p.float())
    if gcomp is not None:
        ug = _row2(ug, gcomp)
    ug = ug.unsqueeze(3)  # [8, 3, 3, 1, T, X, M]: one link for every column
    psi = merge_c(psi_q)
    if r_axis == _DOUBLET_AXIS:
        out = _hop_epilogue(ug, torch.movedim(psi, 0, 2), p, lat, epi, psi_o, blocks)
        return torch.movedim(out, 3, 1).contiguous()
    return _hop_epilogue(ug, psi, p, lat, epi, psi_o, blocks)


hopping_split_rhs_plain.calls = 0


# ---------------------------------------------------------------------------
# K1-SD: the doublet Schur operator in one persistent launch
# ---------------------------------------------------------------------------

# the (even, odd) epilogue pairs of one Q_nd application -> clover?
_ND_PAIRS = {("nd_mee_inv", "nd_mhat"): False, ("nd_clov_inv", "nd_clov_mhat"): True}


def _nd_phase_consts(epi: tuple) -> tuple:
    """The three floats a K1-SD phase reads: nd_mee_inv (mubar_t, epsbar_t,
    1 / (1 + mubar_t^2 - epsbar_t^2)), nd_mhat (mubar_t, epsbar_t, k2),
    nd_clov_inv (epsbar_t, 0, 0), nd_clov_mhat (epsbar_t, k2, 0); the
    reciprocal is formed in double, as `split_diag.mee_inv_nd_split` forms it."""
    kind = epi[0]
    if kind == "nd_mee_inv":
        mu, eps = float(epi[1]), float(epi[2])
        return mu, eps, 1.0 / (1.0 + mu * mu - eps * eps)
    if kind == "nd_mhat":
        return float(epi[1]), float(epi[2]), float(epi[3])
    if kind == "nd_clov_inv":
        return float(epi[1]), 0.0, 0.0
    return float(epi[1]), float(epi[2]), 0.0


@functools.lru_cache(maxsize=256)
def _schur_nd_consts(epi_e: tuple, epi_o: tuple) -> tuple:
    """(keep-alive ctypes array, pointer) of the even and the odd phase's
    constants, made once per set of constants and kept."""
    arr = (ctypes.c_float * 6)(*_nd_phase_consts(epi_e), *_nd_phase_consts(epi_o))
    return arr, ctypes.cast(arr, ctypes.c_void_p)


def _check_schur_nd(ug_e, ug_o, chi, lat: Lattice, stage, gcomp) -> tuple:
    """Raise on anything K1-SD does not take; -> (even epilogue, odd
    epilogue, even blocks, odd blocks, clover?)."""
    if len(stage) != 4:
        raise ValueError("a doublet Schur stage is (even epilogue, odd epilogue, even blocks, "
                         "odd blocks)")
    epi_e, epi_o, blk_e, blk_o = tuple(stage[0]), tuple(stage[1]), stage[2], stage[3]
    pair = (epi_e[0], epi_o[0])
    if pair not in _ND_PAIRS:
        raise ValueError(f"K1-SD runs the epilogue pairs (nd_mee_inv, nd_mhat) and "
                         f"(nd_clov_inv, nd_clov_mhat), got {pair}")
    if len(epi_e) != (3 if pair[0] == "nd_mee_inv" else 2) or len(epi_o) != (
            4 if pair[1] == "nd_mhat" else 3):
        raise ValueError(f"epilogue arguments {epi_e}, {epi_o}")
    clover = _ND_PAIRS[pair]
    need = []
    if clover:
        blk_shape = (2, 2, 2, 2, 3, 3) + lat.eo_site_shape
        for name, blks, count in (("even", blk_e, 3), ("odd", blk_o, 2)):
            if blks is None or len(blks) != count:
                raise ValueError(f"the clover doublet needs {count} {name} block fields")
            need += [("blocks", b, blk_shape) for b in blks]
    if gcomp is not None and len(gcomp) != 8:
        raise ValueError("gcomp must hold 8 (re, im) pairs")
    for name, ug in (("ug_e", ug_e), ("ug_o", ug_o)):
        if ug.dtype != torch.float32:
            raise TypeError(f"K1-SD takes f32 links, {name} is {ug.dtype}")
    rows = 2 if gcomp is not None else 3
    need += [("chi", chi, (2, 2, 4, 3) + lat.eo_site_shape),
             ("ug_p", ug_e, (2, 8, rows, 3) + lat.eo_site_shape),
             ("ug_p", ug_o, (2, 8, rows, 3) + lat.eo_site_shape)]
    _check_tensors(need, chi.device)
    return epi_e, epi_o, blk_e, blk_o, clover


def hopping_schur_nd(ug_e: torch.Tensor, ug_o: torch.Tensor, chi: torch.Tensor, lat: Lattice,
                     stage, gcomp: tuple | None = None, square: bool = False) -> torch.Tensor:
    """K1-SD: Q_nd = gamma5 tau1 Mhat_nd of the non-degenerate doublet, or
    with `square` Q_nd^2 (the same Q_nd applied twice), in one launch, each
    hop both flavours with its flavour-mixing epilogue fused; the
    twisted-mass doublet bit for bit the K1-R-D launches and torch
    diagonals it replaces.

    `stage` (epi_even, epi_odd, blocks_even, blocks_odd):
      (("nd_mee_inv", mubar_t, epsbar_t), ("nd_mhat", mubar_t, epsbar_t, k2), None, None)
      (("nd_clov_inv", epsbar_t), ("nd_clov_mhat", epsbar_t, k2),
       (minv_a, minv_b, minv_e), (moo_u, moo_d))
    Q_nd x: tmp = Mee_nd^-1 H_eo x (the clover doublet: [[A, -eps E],
    [-eps E, B]] H_eo x), then gamma5 tau1 (Mee_nd x - k2 H_oe tmp)
    ([[moo_u, eps], [eps, moo_d]] x for clover).  The block fields are
    FastCloverND's [2,2,2,2,3,3,T,X,M] f32.  ug_e, ug_o: the even and odd
    f32 link copies (18- or 12-real with gcomp); chi: [2, 2, 4, 3, T, X, M]
    f32."""
    epi_e, epi_o, blk_e, blk_o, clover = _check_schur_nd(ug_e, ug_o, chi, lat, stage, gcomp)
    if chi.device.type == "cpu":
        return hopping_schur_nd_plain(ug_e, ug_o, chi, lat, stage, gcomp, square)
    if chi.device.type != "cuda":
        raise ValueError(f"no kernel for device {chi.device}")
    lib = kernel_library()
    # every intermediate in a buffer of its own, as for K1-S
    e1 = torch.empty_like(chi)
    o1 = torch.empty_like(chi) if square else None
    e2 = torch.empty_like(chi) if square else None
    out = torch.empty_like(chi)
    blk = (ctypes.c_void_p * 5)(*([b.data_ptr() for b in (*blk_e, *blk_o)] if clover
                                  else [None] * 5))
    _, consts = _schur_nd_consts(epi_e, epi_o)
    _, corr_ptr = _corr_arg(gcomp)
    t, x, _, _ = lat.dims
    args = (chi.data_ptr(), ug_e.data_ptr(), ug_o.data_ptr(), blk, e1.data_ptr(),
            o1.data_ptr() if square else None, e2.data_ptr() if square else None,
            out.data_ptr(), t, x, lat.m, lat.zh, 2 if square else 1, int(clover),
            int(gcomp is not None), consts, corr_ptr)
    if chi.device.index == torch.cuda.current_device():
        rc = lib.tm_hopping_schur_nd(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(chi.device):
            rc = lib.tm_hopping_schur_nd(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"doublet Schur kernel (K1-SD) launch failed: CUDA error {rc}")
    hopping_schur_nd.launches += 1
    hopping_schur_nd.hops += 4 if square else 2
    hopping_schur_nd.clover_launches += clover
    return out


hopping_schur_nd.launches = 0
hopping_schur_nd.hops = 0
hopping_schur_nd.clover_launches = 0


def _q_nd_by(hop, ug_e, ug_o, x: torch.Tensor, lat: Lattice, stage, gcomp) -> torch.Tensor:
    """One doublet Schur stage with `hop` (K1-R-D or its plain version) for
    the two hops and the torch diagonals between and after them."""
    epi_e, epi_o, blk_e, blk_o = stage
    tmp = hop(ug_e, x, 0, lat, gcomp=gcomp, r_axis=_DOUBLET_AXIS)
    if epi_e[0] == "nd_clov_inv":
        tmp = sd.mee_inv_nd_apply_split(*blk_e, epi_e[1], tmp)
    else:
        tmp = sd.mee_inv_nd_split(tmp, epi_e[1], epi_e[2], +1.0)
    tmp = hop(ug_o, tmp, 1, lat, gcomp=gcomp, r_axis=_DOUBLET_AXIS)
    if epi_o[0] == "nd_clov_mhat":
        m = sd.mee_nd_apply_split(*blk_o, epi_o[1], x) - epi_o[2] * tmp
    else:
        m = sd.mee_nd_split(x, epi_o[1], epi_o[2], +1.0) - epi_o[3] * tmp
    return sd.gamma5_nd(sd.tau1_split(m))


def hopping_schur_nd_plain(ug_e: torch.Tensor, ug_o: torch.Tensor, chi: torch.Tensor,
                           lat: Lattice, stage, gcomp: tuple | None = None,
                           square: bool = False) -> torch.Tensor:
    """Plain PyTorch version of K1-SD: each Q_nd the two doublet hops of
    `hopping_split_rhs_plain` (`r_axis=1`) with the torch diagonals between
    and after them, as the doublet operators were composed before K1-SD."""
    hopping_schur_nd_plain.calls += 1
    x = _q_nd_by(hopping_split_rhs_plain, ug_e, ug_o, chi, lat, stage, gcomp)
    if square:
        x = _q_nd_by(hopping_split_rhs_plain, ug_e, ug_o, x, lat, stage, gcomp)
    return x


hopping_schur_nd_plain.calls = 0


def schur_nd_kernel_info(clover: bool, gcomp: bool) -> dict:
    """K1-SD's instance as the card runs it, as `kernel_info`."""
    return _kernel_info(kernel_library().tm_hopping_schur_nd_info, int(clover), int(gcomp))


# ---------------------------------------------------------------------------
# K3 / K3-I / K4 / K1-T: the slab kernels, and the halo exchange around them
# ---------------------------------------------------------------------------

_SLAB_VARIANTS = {"ext": 0, "int": 1, "bnd": 2, "all": 3}
# the counter name of each variant (ext: K3, or K1-T without y halos)
_SLAB_NAMES = {"int": "K3-I", "bnd": "K4", "all": "K3-I+K4"}


def _spinor_prefix(r_axis: int | None, nrhs: int | None) -> tuple:
    """The axes of a field before its sites: [2,4,3], [2,4,3,R] or [2,2,4,3]."""
    if r_axis is None:
        return (2, 4, 3)
    if r_axis == _DOUBLET_AXIS:
        return (2, 2, 4, 3)
    return (2, 4, 3, nrhs)


def _field_strides(t: torch.Tensor, r_axis: int | None) -> tuple:
    """(re/im, component, right-hand side) element strides of a field."""
    colour = 3 if r_axis == _DOUBLET_AXIS else 2
    return t.stride(0), t.stride(colour), (t.stride(r_axis) if r_axis is not None else 0)


def hopping_slab_split(ug_p: torch.Tensor, psi: torch.Tensor, p: int, lat: Lattice, mesh,
                       variant: str, out: torch.Tensor, th=None, mh=None,
                       gcomp: tuple | None = None, r_axis: int | None = None) -> torch.Tensor:
    """One slab kernel over every slab of `mesh` (`parallel.Mesh`): H_{p,q}
    psi at the rows of `variant`, written into `out` (the whole field,
    [.., T, X, M]), which is returned.

      "ext"  K3 (K1-T when `mh` is None): every row; psi is the extended
             field [.., tsh (T_loc + 2), X, M], slab row i holding [halo_lo |
             its T_loc rows | halo_hi];
      "int"  K3-I: rows 1 .. T_loc-2 of every slab (T_loc >= 4), psi the
             whole field [.., T, X, M]; no t halo is read;
      "bnd"  K4: rows 0 and T_loc-1, psi the whole field, the t halos `th`
             [.., 2 tsh, X, M] (row i below slab row i, row tsh + i above it);
      "all"  K3-I+K4: every row, psi the whole field, th as for "bnd" (the
             sharded hop's one launch after KH).
    `mh` [.., 2 T, X, msh zh]: the y halos, row t the y-row below
    the slab at columns [j zh, (j+1) zh), row T + t the one above; None
    (one y slab only) lets the y hops wrap inside the slab.
    Fields [2,4,3,..] f32, or with an R axis at `r_axis` (3: a batch, 1: a
    flavour doublet); ug_p [2,8,3|2,3,T,X,M] f32 or bf16 (gcomp as for K1)."""
    if variant not in _SLAB_VARIANTS:
        raise ValueError(f"unknown slab variant {variant!r}: have {', '.join(_SLAB_VARIANTS)}")
    loc = mesh.local(lat)
    t_loc = loc.dims[0]
    t, x, _, _ = lat.dims
    nrhs = None if r_axis is None else _check_r_axis(r_axis, psi, ("none",))
    pre = _spinor_prefix(r_axis, nrhs)
    if gcomp is not None and len(gcomp) != 8:
        raise ValueError("gcomp must hold 8 (re, im) pairs")
    rows = mesh.t * (t_loc + 2) if variant == "ext" else t
    need = [("psi", psi, pre + (rows, x, lat.m)),
            ("ug_p", ug_p, (2, 8, 2 if gcomp is not None else 3, 3) + lat.eo_site_shape),
            ("out", out, pre + lat.eo_site_shape)]
    if variant == "int" and t_loc < 4:
        raise ValueError(f"the interior kernel (K3-I) needs T_loc >= 4, have {t_loc}")
    if variant in ("bnd", "all"):
        if th is None:
            raise ValueError(f"the {_SLAB_NAMES[variant]} slab kernel needs the t halos `th`")
        need.append(("th", th, pre + (2 * mesh.t, x, lat.m)))
    if mh is None:
        if mesh.y > 1:
            raise ValueError(f"a mesh of {mesh.y} y slabs needs the y halos `mh`")
    else:
        need.append(("mh", mh, pre + (2 * t, x, mesh.y * lat.zh)))
    _check_tensors(need, psi.device)
    if psi.device.type == "cpu":
        return hopping_slab_split_plain(ug_p, psi, p, lat, mesh, variant, out, th, mh, gcomp,
                                        r_axis)
    if psi.device.type != "cuda":
        raise ValueError(f"no kernel for device {psi.device}")
    lib = kernel_library()
    corr, corr_ptr = _corr_arg(gcomp)
    bf16 = ug_p.dtype == torch.bfloat16

    def fld(f):
        return (None, 0, 0, 0) if f is None else (f.data_ptr(),) + _field_strides(f, r_axis)

    with torch.cuda.device(psi.device):
        stream = torch.cuda.current_stream(psi.device).cuda_stream
        rc = lib.tm_hopping_slab(
            *fld(psi), *fld(th if variant in ("bnd", "all") else None), *fld(mh), ug_p.data_ptr(),
            out.data_ptr(), *_field_strides(out, r_axis), t, x, lat.m, lat.zh, int(p), mesh.t,
            mesh.y, _SLAB_VARIANTS[variant], int(gcomp is not None), int(bf16), corr_ptr,
            nrhs or 0, stream)
    name = _SLAB_NAMES.get(variant, "K3" if mh is not None else "K1-T")
    if rc != 0:
        raise RuntimeError(f"slab hopping kernel ({name}) launch failed: CUDA error {rc}")
    hopping_slab_split.launches[name] += 1
    hopping_slab_split.bf16_launches += bf16
    hopping_slab_split.rhs_launches += r_axis is not None
    return out


hopping_slab_split.launches = {"K3": 0, "K3-I": 0, "K4": 0, "K1-T": 0, "K3-I+K4": 0}
hopping_slab_split.bf16_launches = 0
hopping_slab_split.rhs_launches = 0


def _canon(c: torch.Tensor, r_axis: int | None) -> torch.Tensor:
    """A complex field -> [4, 3, R', *sites] (R' = 1 without an R axis; a
    doublet's flavour axis moved behind colour)."""
    if r_axis is None:
        return c.unsqueeze(2)
    if r_axis == _DOUBLET_AXIS:
        return torch.movedim(c, 0, 2)
    return c


def _from_canon(c: torch.Tensor, r_axis: int | None) -> torch.Tensor:
    if r_axis is None:
        return split_c(c.squeeze(2))
    if r_axis == _DOUBLET_AXIS:
        return split_c(torch.movedim(c, 2, 0))
    return split_c(c)


def hopping_slab_split_plain(ug_p: torch.Tensor, psi: torch.Tensor, p: int, lat: Lattice, mesh,
                             variant: str, out: torch.Tensor, th=None, mh=None,
                             gcomp: tuple | None = None,
                             r_axis: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of the slab kernels, all slabs at once: the
    field is viewed slab by slab [.., tsh, T_loc, X, msh, m_loc] and each
    slab extended by its halos to [.., T_loc + 2, X, m_loc + 2 zh] (t halo
    rows below and above, y halo columns left and right); the stencil reads
    its neighbours by slicing that tensor, with no roll, and the arithmetic
    per direction is `hopping_split_plain`'s (link times spinor, then the
    dense projector).  The variant's rows of `out` are overwritten."""
    hopping_slab_split_plain.calls += 1
    tl, xx, _, _ = mesh.local(lat).dims
    ml, zh, tsh, msh = mesh.local(lat).m, lat.zh, mesh.t, mesh.y
    ug = merge_c(ug_p.float())
    if gcomp is not None:
        ug = _row2(ug, gcomp)
    # [8, 3, 3, 1 (every column), tsh, T_loc, X, msh, m_loc]
    ug = ug.unsqueeze(3).unflatten(-1, (msh, ml)).unflatten(-4, (tsh, tl))

    def slabs(f, rows):  # complex [4, 3, R', tsh, rows, X, msh, m']
        return _canon(merge_c(f), r_axis).unflatten(-1, (msh, -1)).unflatten(-4, (-1, rows))

    c_psi = slabs(psi, tl + 2 if variant == "ext" else tl)
    center = c_psi[..., 1:tl + 1, :, :, :] if variant == "ext" else c_psi
    e = center.new_zeros(center.shape[:-4] + (tl + 2, xx, msh, ml + 2 * zh))
    e[..., 1:tl + 1, :, :, zh:zh + ml] = center
    if variant == "ext":
        e[..., 0:1, :, :, zh:zh + ml] = c_psi[..., 0:1, :, :, :]
        e[..., tl + 1:, :, :, zh:zh + ml] = c_psi[..., tl + 1:, :, :, :]
    elif variant in ("bnd", "all"):
        c_th = _canon(merge_c(th), r_axis).unflatten(-1, (msh, ml)).unflatten(-4, (2, tsh))
        e[..., 0, :, :, zh:zh + ml] = c_th[..., 0, :, :, :, :]
        e[..., tl + 1, :, :, zh:zh + ml] = c_th[..., 1, :, :, :, :]
    if mh is None:
        e[..., 1:tl + 1, :, :, :zh] = center[..., ml - zh:]
        e[..., 1:tl + 1, :, :, zh + ml:] = center[..., :zh]
    else:
        # [4, 3, R', 2 (below / above), tsh, T_loc, X, msh, zh]
        c_mh = _canon(merge_c(mh), r_axis).unflatten(-1, (msh, zh)).unflatten(-4, (2, tsh, tl))
        e[..., 1:tl + 1, :, :, :zh] = c_mh[..., 0, :, :, :, :, :]
        e[..., 1:tl + 1, :, :, zh + ml:] = c_mh[..., 1, :, :, :, :, :]
    dev = psi.device
    rr = torch.tensor({"ext": list(range(tl)), "int": list(range(1, tl - 1)),
                       "bnd": [0, tl - 1], "all": list(range(tl))}[variant], device=dev)
    # slot (t + x + y + p) odd in slab coordinates [rows, X, 1, m_loc], z edges
    yl = torch.arange(ml, device=dev) // zh
    kk = torch.arange(ml, device=dev) % zh
    s1 = (rr.view(-1, 1, 1, 1) + torch.arange(xx, device=dev).view(1, -1, 1, 1) + yl + p) % 2 == 1
    s0 = ~s1
    last, first = kk == zh - 1, kk == 0

    rows = e.index_select(-4, rr + 1)  # the output rows, y halo columns included

    def win(off):
        return rows[..., zh + off:zh + off + ml]

    cur = win(0)
    nbrs = (e.index_select(-4, rr + 2)[..., zh:zh + ml], e.index_select(-4, rr)[..., zh:zh + ml],
            torch.cat([cur[..., 1:, :, :], cur[..., :1, :, :]], dim=-3),
            torch.cat([cur[..., -1:, :, :], cur[..., :-1, :, :]], dim=-3),
            win(zh), win(-zh),
            torch.where(s1 & last, win(-(zh - 1)), torch.where(s1, win(1), cur)),
            torch.where(s0 & first, win(zh - 1), torch.where(s0, win(-1), cur)))
    u = ug.index_select(-4, rr)
    acc = None
    for d in range(8):
        term = spin_apply(hop_projector(d // 2, d % 2, cur), color_apply(u[d], nbrs[d]))
        acc = term if acc is None else acc + term
    out.unflatten(-1, (msh, ml)).unflatten(-4, (tsh, tl))[..., rr, :, :, :] = _from_canon(
        acc, r_axis)
    return out


hopping_slab_split_plain.calls = 0


def _halo_maps() -> dict:
    """For the t and y directions d (0, 1: t forward / backward; 4, 5: y):
    W_d has, in column a, one lower row s_a with a real entry c_a = +-1, so
    W_d^+ x = (x_a + c_a x_{s_a})_a and 0.5 W_d h = (0.5 h, 0.5 c_a h_a at
    row s_a).  -> {d: (rows (s_0, s_1), (c_0, c_1))}."""
    maps = {}
    for d in (0, 1, 4, 5):
        rows, coef = [], []
        for a in range(2):
            (s,) = [s for s in (2, 3) if W[d][s, a] != 0]
            assert W[d][s, a].imag == 0 and abs(W[d][s, a].real) == 1
            rows.append(s)
            coef.append(float(W[d][s, a].real))
        maps[d] = (tuple(rows), tuple(coef))
    return maps


_HALO_MAPS = _halo_maps()


def _project_halo(x2: torch.Tensor, d: int, ax: int) -> torch.Tensor:
    """W_d^+ x on the spin axis `ax` of a split field, [.., 4, ..] -> [.., 2,
    ..]: h_a = x_a + c_a x_{s_a}, one rounding each, as the kernels form the
    half-spinor of direction d (the halfspinor halo: half the bytes)."""
    rows, coef = _HALO_MAPS[d]
    part = x2.narrow(ax, 2, 2)
    if rows != (2, 3):
        part = part.flip(ax)
    return torch.addcmul(x2.narrow(ax, 0, 2), part, sd.const_like(coef, x2, ax))


def _rebuild_halo(h2: torch.Tensor, d: int, ax: int, out: torch.Tensor) -> None:
    """0.5 W_d h into `out` (4 spin components at `ax`): the 4-spinor whose
    W_d^+ is h again exactly (W^+ W = 2; every product is exact)."""
    rows, coef = _HALO_MAPS[d]
    torch.mul(h2, 0.5, out=out.narrow(ax, 0, 2))
    half = tuple(0.5 * c for c in coef)
    if rows != (2, 3):  # row 2 takes a = 1, row 3 a = 0
        h2, half = h2.flip(ax), half[::-1]
    torch.mul(h2, sd.const_like(half, h2, ax), out=out.narrow(ax, 2, 2))


def _spin_axis(r_axis: int | None) -> int:
    return 2 if r_axis == _DOUBLET_AXIS else 1


def _send(x: torch.Tensor, shift: int, dim: int, d: int, ax: int, halfspinor: bool,
          out: torch.Tensor) -> None:
    """One halo: `x` projected by W_d^+ (with `halfspinor`), sent one slab
    along `dim` (a copy: `roll` by `shift`, the one-device counterpart of the
    reference's ppermute) and rebuilt into `out` on the receiving side."""
    if halfspinor:
        _rebuild_halo(torch.roll(_project_halo(x, d, ax), shift, dims=dim), d, ax, out)
    else:
        out.copy_(torch.roll(x, shift, dims=dim))


def _y_halos(psi: torch.Tensor, lat: Lattice, mesh, halfspinor: bool = True,
             r_axis: int | None = None, faces: bool = False) -> torch.Tensor | None:
    """The y exchange: mh [.., 2 T, X, msh zh] of `hopping_slab_split`.  Each
    slab column's last y-row goes up to column j+1 (projected for the y-1
    hop, direction 5), its first y-row down to j-1 (direction 4).  None with
    one y slab: the y hops then wrap inside the slab (the reference copies
    the slab's own rows into its halos; the values are the same) — unless
    `faces`: then with one y slab mh holds the slab's own two y faces, the
    ones a rank sends to its y neighbours."""
    if mesh.y == 1 and not faces:
        return None
    ml, zh = mesh.local(lat).m, lat.zh
    v = psi.unflatten(-1, (mesh.y, ml))
    lo, hi = v[..., ml - zh:], v[..., :zh]
    mh = torch.empty(lo.shape[:-4] + (2,) + lo.shape[-4:], dtype=psi.dtype, device=psi.device)
    ax = _spin_axis(r_axis)
    _send(lo, 1, -2, 5, ax, halfspinor, mh.select(-5, 0))
    _send(hi, -1, -2, 4, ax, halfspinor, mh.select(-5, 1))
    return mh.flatten(-5, -4).flatten(-2)


def _t_halos(psi: torch.Tensor, lat: Lattice, mesh, halfspinor: bool = True,
             r_axis: int | None = None, ext: bool = False) -> torch.Tensor:
    """The t exchange: each slab row's last timeslice goes up to row i+1
    (projected for the t-1 hop, direction 1), its first down to row i-1
    (direction 0).  Returns the halos th [.., 2 tsh, X, M] of the boundary
    kernel K4 (row i the halo below slab row i, tsh + i the one above), or
    with `ext` the extended field [.., tsh (T_loc + 2), X, M] of K3 and K1-T
    (each slab row with its halos concatenated)."""
    t_loc = mesh.local(lat).dims[0]
    v = psi.unflatten(-3, (mesh.t, t_loc))
    ax = _spin_axis(r_axis)
    if ext:
        buf = torch.empty(v.shape[:-3] + (t_loc + 2,) + v.shape[-2:], dtype=psi.dtype,
                          device=psi.device)
        buf[..., 1:t_loc + 1, :, :].copy_(v)
        lo_out, hi_out = buf.select(-3, 0), buf.select(-3, t_loc + 1)
    else:
        buf = torch.empty(v.shape[:-4] + (2,) + v.shape[-4:-3] + v.shape[-2:], dtype=psi.dtype,
                          device=psi.device)
        lo_out, hi_out = buf.select(-4, 0), buf.select(-4, 1)
    _send(v.select(-3, t_loc - 1), 1, -3, 1, ax, halfspinor, lo_out)
    _send(v.select(-3, 0), -1, -3, 0, ax, halfspinor, hi_out)
    return buf.flatten(-4, -3)


def _check_halo_field(psi: torch.Tensor, lat: Lattice, r_axis: int | None) -> int | None:
    nrhs = None if r_axis is None else _check_r_axis(r_axis, psi, ("none",))
    _check_tensors([("psi", psi, _spinor_prefix(r_axis, nrhs) + lat.eo_site_shape)], psi.device)
    return nrhs


def halo_pack(psi: torch.Tensor, lat: Lattice, mesh, r_axis: int | None = None,
              halfspinor: bool | None = None) -> tuple:
    """KH: the halos of one sharded hop over every slab of `mesh` in one
    launch: the y halos mh [.., 2 T, X, msh zh] (None with one y slab) and
    the t halos th [.., 2 tsh, X, M] of `hopping_slab_split` (K3-I reads
    mh, K4 both).  Each halo site is its source row's site, projected by
    W_d^+ and rebuilt as 0.5 W_d h with `halfspinor` (default
    `mesh.halfspinor`), else copied; the slab shift of the reference's
    ppermute is index arithmetic.  Equal element for element to the torch
    exchange `_y_halos` and `_t_halos`, its plain version, which it runs on
    CPU tensors (counted in `halo_pack.plain_calls`).  psi [2,4,3,T,X,M]
    f32, or with an R axis at `r_axis`."""
    halfspinor = mesh.halfspinor if halfspinor is None else halfspinor
    nrhs = _check_halo_field(psi, lat, r_axis)
    mesh.local(lat)  # raises unless T and Y split into even slabs
    if psi.device.type == "cpu":
        halo_pack.plain_calls += 1
        return (_y_halos(psi, lat, mesh, halfspinor, r_axis),
                _t_halos(psi, lat, mesh, halfspinor, r_axis))
    if psi.device.type != "cuda":
        raise ValueError(f"no kernel for device {psi.device}")
    pre = _spinor_prefix(r_axis, nrhs)
    t, x, _, _ = lat.dims
    mh = (torch.empty(pre + (2 * t, x, mesh.y * lat.zh), dtype=psi.dtype, device=psi.device)
          if mesh.y > 1 else None)
    th = torch.empty(pre + (2 * mesh.t, x, lat.m), dtype=psi.dtype, device=psi.device)

    def fld(f):
        return (None, 0, 0, 0) if f is None else (f.data_ptr(),) + _field_strides(f, r_axis)

    lib = kernel_library()
    with torch.cuda.device(psi.device):
        rc = lib.tm_halo_pack(*fld(psi), *fld(mh), *fld(th), t, x, lat.m, lat.zh, mesh.t,
                              mesh.y, int(halfspinor), nrhs or 0,
                              torch.cuda.current_stream(psi.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"halo kernel (KH) launch failed: CUDA error {rc}")
    halo_pack.launches += 1
    return mh, th


halo_pack.launches = 0
halo_pack.plain_calls = 0  # its plain version: the torch exchange on CPU tensors

_SHARD_PLANS: dict = {}


def _shard_plan(ug_p: torch.Tensor, psi_q: torch.Tensor, lat: Lattice, mesh,
                gcomp, r_axis) -> tuple:
    """The checks of one sharded hop, made once per (lattice, mesh, R axis,
    shapes, strides, types, gcomp) and kept: -> (halo shapes, the halos' and
    psi's element strides, R)."""
    key = (lat, mesh.t, mesh.y, r_axis, tuple(psi_q.shape), psi_q.stride(), psi_q.dtype,
           tuple(ug_p.shape), ug_p.stride(), ug_p.dtype, gcomp is not None, psi_q.device)
    plan = _SHARD_PLANS.get(key)
    if plan is None:
        nrhs = _check_halo_field(psi_q, lat, r_axis)
        mesh.local(lat)  # raises unless T and Y split into even slabs
        if gcomp is not None and len(gcomp) != 8:
            raise ValueError("gcomp must hold 8 (re, im) pairs")
        _check_tensors([("ug_p", ug_p, (2, 8, 2 if gcomp is not None else 3, 3)
                         + lat.eo_site_shape)], psi_q.device)
        pre = _spinor_prefix(r_axis, nrhs)
        t, x, _, _ = lat.dims
        mh_shape = pre + (2 * t, x, mesh.y * lat.zh) if mesh.y > 1 else None
        th_shape = pre + (2 * mesh.t, x, lat.m)

        def strides(shape):
            return (0, 0, 0) if shape is None else _field_strides(
                torch.empty(shape, device="meta"), r_axis)

        plan = (mh_shape, th_shape, strides(mh_shape), strides(th_shape),
                _field_strides(psi_q, r_axis), nrhs or 0)
        _SHARD_PLANS[key] = plan
    return plan


def _hopping_shard_cuda(ug_p: torch.Tensor, psi_q: torch.Tensor, p: int, lat: Lattice, mesh,
                        gcomp, r_axis) -> torch.Tensor:
    """The sharded hop with the overlap on the card, one C call: KH, then
    K3-I+K4 (the slab kernel over every row) on the caller's stream."""
    mh_shape, th_shape, mh_st, th_st, psi_st, nrhs = _shard_plan(
        ug_p, psi_q, lat, mesh, gcomp, r_axis)
    if not psi_q.is_contiguous():
        raise ValueError("psi_q must be contiguous")
    dev = psi_q.device
    out = torch.empty_like(psi_q)
    mh = None if mh_shape is None else torch.empty(mh_shape, dtype=psi_q.dtype, device=dev)
    th = torch.empty(th_shape, dtype=psi_q.dtype, device=dev)
    _, corr_ptr = _corr_arg(gcomp)
    t, x, _, _ = lat.dims
    bf16 = ug_p.dtype == torch.bfloat16
    args = (psi_q.data_ptr(), *psi_st, None if mh is None else mh.data_ptr(), *mh_st,
            th.data_ptr(), *th_st, ug_p.data_ptr(), out.data_ptr(), t, x, lat.m, lat.zh, int(p),
            mesh.t, mesh.y, int(mesh.halfspinor), int(gcomp is not None), int(bf16), corr_ptr,
            nrhs)
    lib = kernel_library()
    if dev.index == torch.cuda.current_device():
        rc = lib.tm_shard_hop(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(dev):
            rc = lib.tm_shard_hop(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sharded hop (KH, K3-I+K4) launch failed: CUDA error {rc}")
    halo_pack.launches += 1
    hopping_slab_split.launches["K3-I+K4"] += 1
    hopping_slab_split.bf16_launches += bf16
    hopping_slab_split.rhs_launches += r_axis is not None
    return out


def slab_kernel_info(name: str) -> dict:
    """KH's instance (`name` "KH") or the slab kernel's on a 12-real f32
    gauge with one spinor ("slab": K3, K3-I, K4, K3-I+K4) as the card runs
    it, as `kernel_info`."""
    if name not in ("KH", "slab"):
        raise ValueError(f"slab_kernel_info takes 'KH' or 'slab', got {name!r}")
    return _kernel_info(kernel_library().tm_slab_info, 0 if name == "KH" else 1)


def hopping_shard(ug_p: torch.Tensor, psi_q: torch.Tensor, p: int, lat: Lattice, mesh,
                  gcomp: tuple | None = None, r_axis: int | None = None) -> torch.Tensor:
    """Domain-decomposed H_{p,q} psi on the (t, y) slabs of `mesh`, all on
    one device: the port of `hopping_pallas_shard` (dslash_pallas.py:1345).

    With `mesh.overlap` (the default) one wrapper call per hop: KH packs the
    y and t halos of every slab (`halo_pack`: half-spinors by W^+ of
    (1 -/+ gamma_2) and (1 -/+ gamma_0) with `mesh.halfspinor`, rebuilt as
    0.5 W s), then one slab launch runs the interior and the surface rows
    (K3-I+K4, the reference's K3-I and K4); on the card that is one C call,
    its checks made once per lattice, mesh and layout (`_shard_plan`).
    `overlap=False` runs K3 on psi with its t halos concatenated, the halos
    by the torch exchange (`_y_halos`, `_t_halos`).  With one y slab there
    is no y halo: the kernels wrap the y hops inside the slab (without
    overlap that is K1-T).  The kernel writes the whole output, so there is
    no assembly step.  psi_q [2,4,3,T,X,M], or with an R
    axis at `r_axis` (3: a batch; 1: a flavour doublet); ug_p and gcomp as
    for K1 (f32 or bf16).  The result equals `hopping_split` /
    `hopping_split_rhs` on the whole lattice.  On a distributed mesh `lat`
    is the rank's slab and the hop is `hopping_rank`."""
    if mesh.distributed:
        return hopping_rank(ug_p, psi_q, p, lat, mesh, gcomp, r_axis)
    if not mesh.overlap:
        mh = _y_halos(psi_q, lat, mesh, mesh.halfspinor, r_axis)
        return hopping_slab_split(ug_p, _t_halos(psi_q, lat, mesh, mesh.halfspinor, r_axis,
                                                 ext=True),
                                  p, lat, mesh, "ext", torch.empty_like(psi_q), mh=mh,
                                  gcomp=gcomp, r_axis=r_axis)
    if psi_q.device.type == "cuda":
        return _hopping_shard_cuda(ug_p, psi_q, p, lat, mesh, gcomp, r_axis)
    mh, th = halo_pack(psi_q, lat, mesh, r_axis)
    return hopping_slab_split(ug_p, psi_q, p, lat, mesh, "all", torch.empty_like(psi_q), th=th,
                              mh=mh, gcomp=gcomp, r_axis=r_axis)


def hopping_tshard(ug_p: torch.Tensor, psi_q: torch.Tensor, p: int, lat: Lattice, mesh,
                   gcomp: tuple | None = None) -> torch.Tensor:
    """t-decomposed H_{p,q} psi (K1-T): the port of `hopping_pallas_tshard`
    (dslash_pallas.py:1065).  Each t slab gets its two t halos concatenated
    (half-spinor halos with `mesh.halfspinor`) and the stencil runs on the
    extended slabs with the y hops wrapping inside them: `hopping_shard`
    without overlap on a mesh of one y slab.  psi_q [2,4,3,T,X,M]."""
    if mesh.y != 1:
        raise ValueError(f"hopping_tshard decomposes t only: the mesh has {mesh.y} y slabs")
    return hopping_shard(ug_p, psi_q, p, lat, dataclasses.replace(mesh, overlap=False), gcomp)


# ---------------------------------------------------------------------------
# the hop on one rank of a distributed mesh: KH-P, the exchange, K3-I / K4
# ---------------------------------------------------------------------------


def _one_slab(device):
    """The one-slab mesh the rank's kernels run on: its own slab, halos in
    buffers of their own."""
    from tmlqcd_tpu_torch.parallel import Mesh

    return Mesh(1, 1, device)


def halo_faces(psi: torch.Tensor, lat: Lattice, r_axis: int | None = None,
               halfspinor: bool = True, y_faces: bool = True) -> tuple:
    """KH-P: KH on one rank's slab (`lat`: the slab's own lattice, without a
    mesh), the four faces it sends in one launch: th [.., 2, X, M] (row 0
    the slab's last timeslice projected for the t-1 hop, for the rank above;
    row 1 its first, for the rank below) and, with `y_faces`, mh [.., 2
    T_loc, X, zh] (rows 0 .. T_loc-1 the last y-row for the y neighbour
    above, the rest the first y-row for the one below), else None.  At mesh
    (1, 1) these are KH's own halos: the kernel is KH with one slab and a y
    halo buffer at one y slab (the slab kernel reads such a buffer instead
    of wrapping).  Half-spinor faces (0.5 W h) with `halfspinor`.  Its plain
    version, on CPU tensors, is the torch exchange at one slab."""
    nrhs = _check_halo_field(psi, lat, r_axis)
    one = _one_slab(psi.device)
    one.local(lat)  # raises unless T_loc and Y_loc are even
    if psi.device.type == "cpu":
        return (_y_halos(psi, lat, one, halfspinor, r_axis, faces=y_faces),
                _t_halos(psi, lat, one, halfspinor, r_axis))
    if psi.device.type != "cuda":
        raise ValueError(f"no kernel for device {psi.device}")
    pre = _spinor_prefix(r_axis, nrhs)
    t, x, _, _ = lat.dims
    mh = (torch.empty(pre + (2 * t, x, lat.zh), dtype=psi.dtype, device=psi.device)
          if y_faces else None)
    th = torch.empty(pre + (2, x, lat.m), dtype=psi.dtype, device=psi.device)

    def fld(f):
        return (None, 0, 0, 0) if f is None else (f.data_ptr(),) + _field_strides(f, r_axis)

    lib = kernel_library()
    with torch.cuda.device(psi.device):
        rc = lib.tm_halo_pack(*fld(psi), *fld(mh), *fld(th), t, x, lat.m, lat.zh, 1, 1,
                              int(halfspinor), nrhs or 0,
                              torch.cuda.current_stream(psi.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"face kernel (KH-P) launch failed: CUDA error {rc}")
    halo_faces.launches += 1
    return mh, th


halo_faces.launches = 0


def _rank_slab(ug_p, psi, p, loc, variant, out, th, mh, gcomp, r_axis):
    """One slab launch on the rank's own slab, counted by name in
    `hopping_rank.launches` where it launches a kernel."""
    hopping_slab_split(ug_p, psi, p, loc, _one_slab(psi.device), variant, out, th=th, mh=mh,
                       gcomp=gcomp, r_axis=r_axis)
    if psi.device.type == "cuda":
        name = _SLAB_NAMES.get(variant, "K3" if mh is not None else "K1-T")
        hopping_rank.launches[name] += 1
    return out


def hopping_rank(ug_p: torch.Tensor, psi_q: torch.Tensor, p: int, lat: Lattice, mesh,
                 gcomp: tuple | None = None, r_axis: int | None = None,
                 keep_halos: bool = False):
    """H_{p,q} psi on this rank's slab of the distributed `mesh`: the port
    of `hopping_pallas_shard` (dslash_pallas.py:1345) with its `_exchange`.

    KH-P packs the faces (`halo_faces`); `comm.exchange` posts them, t faces
    to the t neighbours and y faces to the y neighbours (none along an axis
    of one slab: the slab's own faces are then its halos, the y hops wrap);
    with `mesh.overlap` K3-I runs the interior rows (T_loc >= 4) once the y
    faces are in, while the t faces travel, and K4 the surface rows after
    them; below T_loc = 4 there is no interior, and one launch over every
    row (K3-I+K4) runs after the exchange.  Without the overlap K3 (K1-T
    with one y slab) runs on the slab with its received t faces
    concatenated.  psi_q [2,4,3,T_loc,X,m_loc], or with an R axis at
    `r_axis`; ug_p the slab's gauge copy (f32 or bf16, gcomp as for K1).
    Every rank of the mesh calls it together.  Returns the hop, or with
    `keep_halos` (hop, th, mh): the received halos, which K2-S reads."""
    loc = Lattice(lat.dims)
    mh_f, th_f = halo_faces(psi_q, loc, r_axis, mesh.halfspinor, y_faces=mesh.y > 1)
    faces = []
    if mesh.t > 1:
        up, down = mesh.neighbour("t", +1), mesh.neighbour("t", -1)
        faces += [(th_f.select(-3, 0), up, down), (th_f.select(-3, 1), down, up)]
    if mesh.y > 1:
        up, down = mesh.neighbour("y", +1), mesh.neighbour("y", -1)
        t_loc = loc.dims[0]
        faces += [(mh_f.narrow(-3, 0, t_loc), up, down), (mh_f.narrow(-3, t_loc, t_loc), down, up)]
    pend = comm.exchange(faces, mesh) if faces else None
    ky = 2 if mesh.t > 1 else 0

    def t_halos():
        return th_f if mesh.t == 1 else torch.stack([pend.wait(0), pend.wait(1)], dim=-3)

    def y_halos():
        return None if mesh.y == 1 else torch.cat([pend.wait(ky), pend.wait(ky + 1)], dim=-3)

    out = torch.empty_like(psi_q)
    if not mesh.overlap:
        th, mh = t_halos(), y_halos()
        ext = torch.cat([th.narrow(-3, 0, 1), psi_q, th.narrow(-3, 1, 1)], dim=-3)
        _rank_slab(ug_p, ext, p, loc, "ext", out, None, mh, gcomp, r_axis)
    elif loc.dims[0] >= 4:
        mh = y_halos()
        _rank_slab(ug_p, psi_q, p, loc, "int", out, None, mh, gcomp, r_axis)
        th = t_halos()
        _rank_slab(ug_p, psi_q, p, loc, "bnd", out, th, mh, gcomp, r_axis)
    else:
        th, mh = t_halos(), y_halos()
        _rank_slab(ug_p, psi_q, p, loc, "all", out, th, mh, gcomp, r_axis)
    return (out, th, mh) if keep_halos else out


hopping_rank.launches = {"K3": 0, "K3-I": 0, "K4": 0, "K1-T": 0, "K3-I+K4": 0}


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


def _check_slab_halos(psi_q: torch.Tensor, lat: Lattice, th, mh) -> None:
    t, x, _, _ = lat.dims
    need = [("th", th, (2, 4, 3, 2, x, lat.m))]
    if mh is not None:
        need.append(("mh", mh, (2, 4, 3, 2 * t, x, lat.zh)))
    _check_tensors(need, psi_q.device)


def hopping_ug_vjp_slab(g2: torch.Tensor, psi_q: torch.Tensor, p: int, lat: Lattice,
                        th: torch.Tensor, mh: torch.Tensor | None) -> torch.Tensor:
    """K2-S: K2 on one rank's slab (`lat`: the slab's own lattice).  The t
    neighbours of rows 0 and T_loc-1 come from `th` [2,4,3,2,X,M] (row 0
    below, row 1 above) and the y neighbours of the slab's first and last
    y-row from `mh` [2,4,3,2 T_loc,X,zh] (None: one y slab, the y hops wrap):
    the halos the forward hop on the same psi received (`hopping_rank` with
    `keep_halos`), so nothing is exchanged again.  A half-spinor halo 0.5 W h
    gives W^+ back exactly, so the result equals K2 on the whole lattice,
    row for row.  g2, psi_q [2,4,3,T_loc,X,m_loc] f32 -> [2,8,3,3,..]."""
    shape = (2, 4, 3) + lat.eo_site_shape
    _check_tensors([("g2", g2, shape), ("psi_q", psi_q, shape)], psi_q.device)
    _check_slab_halos(psi_q, lat, th, mh)
    if psi_q.device.type == "cpu":
        return hopping_ug_vjp_slab_plain(g2, psi_q, p, lat, th, mh)
    if psi_q.device.type != "cuda":
        raise ValueError(f"no kernel for device {psi_q.device}")
    lib = kernel_library()
    out = torch.empty((2, 8, 3, 3) + lat.eo_site_shape, dtype=torch.float32, device=psi_q.device)
    t, x, _, _ = lat.dims
    with torch.cuda.device(psi_q.device):
        rc = lib.tm_ug_vjp_slab(g2.data_ptr(), psi_q.data_ptr(), th.data_ptr(),
                                None if mh is None else mh.data_ptr(), out.data_ptr(), t, x,
                                lat.m, lat.zh, int(p),
                                torch.cuda.current_stream(psi_q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"slab gauge-cotangent kernel (K2-S) launch failed: CUDA error {rc}")
    hopping_ug_vjp_slab.launches += 1
    return out


hopping_ug_vjp_slab.launches = 0


def hopping_ug_vjp_slab_plain(g2: torch.Tensor, psi_q: torch.Tensor, p: int, lat: Lattice,
                              th: torch.Tensor, mh: torch.Tensor | None) -> torch.Tensor:
    """Plain PyTorch version of K2-S: `hopping_ug_vjp_plain`'s arithmetic on
    the slab, the neighbours across its t and y edges taken from the halos."""
    hopping_ug_vjp_slab_plain.calls += 1
    g = merge_c(g2)
    psi = merge_c(psi_q)
    cth = merge_c(th)
    cmh = None if mh is None else merge_c(mh)
    t, zh, ml = lat.dims[0], lat.zh, lat.m
    out = []
    for d in range(8):
        mu, fb = d // 2, d % 2
        nbr = hop_packed(psi, p, mu, +1 if fb == 0 else -1, lat).clone()
        if mu == 0:
            nbr[..., t - 1 if fb == 0 else 0, :, :] = cth[..., 1 - fb, :, :]
        elif mu == 2 and cmh is not None:
            cols = slice(ml - zh, ml) if fb == 0 else slice(0, zh)
            nbr[..., cols] = cmh[..., t:, :, :] if fb == 0 else cmh[..., :t, :, :]
        pn = torch.conj_physical(spin_apply(hop_projector(mu, fb, psi), nbr))
        out.append(sum(g[s][:, None] * pn[s][None, :] for s in range(4)))
    return split_c(torch.stack(out))


hopping_ug_vjp_slab_plain.calls = 0


def reset_counters() -> None:
    """Zero every launch and call counter of this module, and the calls
    KG's plain version (`gauge_action.gauge_force_plain`) served."""
    from tmlqcd_tpu_torch.ops import gauge_action

    hopping_split.launches = 0
    hopping_split.clover_launches = 0
    hopping_split.bf16_launches = 0
    hopping_split_rhs.launches = 0
    hopping_split_rhs.clover_launches = 0
    hopping_split_rhs.doublet_launches = 0
    hopping_split_rhs.bf16_launches = 0
    hopping_ug_vjp.launches = 0
    hopping_schur.launches = 0
    hopping_schur.hops = 0
    hopping_schur.clover_hops = 0
    hopping_schur.bf16_hops = 0
    hopping_schur_nd.launches = 0
    hopping_schur_nd.hops = 0
    hopping_schur_nd.clover_launches = 0
    halo_pack.launches = 0
    halo_faces.launches = 0
    hopping_ug_vjp_slab.launches = 0
    for name in hopping_rank.launches:
        hopping_rank.launches[name] = 0
    for name in hopping_slab_split.launches:
        hopping_slab_split.launches[name] = 0
    hopping_slab_split.bf16_launches = 0
    hopping_slab_split.rhs_launches = 0
    hopping_split_plain.calls = 0
    hopping_schur_plain.calls = 0
    hopping_split_rhs_plain.calls = 0
    hopping_ug_vjp_plain.calls = 0
    hopping_slab_split_plain.calls = 0
    hopping_schur_nd_plain.calls = 0
    halo_pack.plain_calls = 0
    hopping_ug_vjp_slab_plain.calls = 0
    gauge_force_cuda.launches = 0
    gauge_action.gauge_force_plain.calls = 0


# ---------------------------------------------------------------------------
# the MD gauge force (KG)
# ---------------------------------------------------------------------------


def gauge_force_cuda(u: torch.Tensor, beta: float, c1: float, lat: Lattice) -> torch.Tensor:
    """KG: the MD gauge force of the whole lattice's links u
    [3, 3, 4, T, X, Y*Z] complex64 in one launch (`csrc/gauge_force.cu`),
    F_mu(x) = TA(U_mu(x) [-(beta c0/3) A_mu(x) - (beta c1/3) R_mu(x)]) with
    c0 = 1 - 8 c1, A the plaquette and R the rectangle staples; c1 == 0
    runs no rectangles.  Its plain version is
    `gauge_action.gauge_force_plain`; `gauge_action.gauge_force` routes."""
    if lat.mesh is not None:
        raise ValueError("the gauge-force kernel takes a whole lattice, not a slab of a mesh "
                         "(a slab's shifts cross ranks)")
    if u.dtype != torch.complex64:
        raise TypeError(f"u must be complex64, got {u.dtype}")
    shape = (3, 3, 4) + lat.site_shape
    if tuple(u.shape) != shape:
        raise ValueError(f"u has shape {tuple(u.shape)}, expected {shape}")
    if not u.is_contiguous() or u.is_conj():
        raise ValueError("u must be contiguous, with no lazy conjugation")
    if u.device.type != "cuda":
        raise ValueError(f"no gauge-force kernel for device {u.device}")
    lib = kernel_library()
    out = torch.empty_like(u)
    t, x, y, z = lat.dims
    c0 = 1.0 - 8.0 * c1
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        rc = lib.tm_gauge_force(u.data_ptr(), out.data_ptr(), t, x, y, z, -(beta * c0) / 3.0,
                                -(beta * c1) / 3.0, stream)
    if rc != 0:
        raise RuntimeError(f"gauge-force kernel (KG) launch failed: CUDA error {rc}")
    gauge_force_cuda.launches += 1
    return out


gauge_force_cuda.launches = 0


# ---------------------------------------------------------------------------
# differentiable hopping
# ---------------------------------------------------------------------------


class HoppingDiff(torch.autograd.Function):
    """H_{p,q}(ug_p) psi_q, differentiable in ug_p and psi_q (all split f32).

    forward: K1 (epilogue none, 18-real).  backward: K2 for d ug_p and the
    adjoint identity H^+ = g5 H_{q,p} g5 on K1 for d psi_q; ug_q only
    parameterises the adjoint and receives no gradient (reference:
    `hopping_diff`, dslash_pallas.py:1608-1641).  On a rank's slab (`lat`
    carries a distributed mesh) the forward is `hopping_rank`, whose
    received halos the backward's K2-S reads, and the adjoint another
    `hopping_rank`."""

    @staticmethod
    def forward(ctx, ug_p, ug_q, psi_q, p: int, lat: Lattice):
        ctx.p = p
        ctx.lat = lat
        if lat.mesh is not None:
            out, th, mh = hopping_rank(ug_p, psi_q, p, lat, lat.mesh, keep_halos=True)
            ctx.save_for_backward(ug_q, psi_q, th, mh)
            return out
        ctx.save_for_backward(ug_q, psi_q)
        return hopping_split(ug_p, psi_q, p, lat)

    @staticmethod
    def backward(ctx, g2):
        ug_q, psi_q, *halos = ctx.saved_tensors
        g2 = g2.contiguous()
        p, lat = ctx.p, ctx.lat
        dug = dpsi = None
        if lat.mesh is not None:
            if ctx.needs_input_grad[0]:
                dug = hopping_ug_vjp_slab(g2, psi_q, p, Lattice(lat.dims), *halos)
            if ctx.needs_input_grad[2]:
                dpsi = gamma5_split(hopping_rank(ug_q, gamma5_split(g2), 1 - p, lat, lat.mesh))
            return dug, None, dpsi, None, None
        if ctx.needs_input_grad[0]:
            dug = hopping_ug_vjp(g2, psi_q, p, lat)
        if ctx.needs_input_grad[2]:
            dpsi = gamma5_split(hopping_split(ug_q, gamma5_split(g2), 1 - p, lat))
        return dug, None, dpsi, None, None
