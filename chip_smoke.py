#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (tmlqcd_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero before the
result lines):

1. card: the card's name and power limit (nvidia-smi), and the build of the
   CUDA kernels from tmlqcd_tpu_torch/csrc/ (timed).
2. kernel checks at the main path's shape, 16^3x32: every on-path variant of
   the hopping kernel K1, the gauge-cotangent kernel K2, and HoppingDiff
   forward and backward, each against its plain PyTorch version on the same
   card tensors; the multi-RHS hopping K1-R (R = 12 and 3) against its plain
   version and against R single K1 launches; K1-R on the flavour-doublet
   axis (K1-R-D, R = 2, `r_axis` 1) against its plain version and bit for
   bit against two K1 launches; K1-S (the Schur operator in one cooperative
   launch) bit for bit against the K1 launches it replaces and against its
   plain version, in both epilogue pairs, Mhat(+-) and Qhat_pm, g5 on and
   off, 18/12-real, f32/bf16, at 16^3x32, 32^3x64 (where its grid-stride
   loop wraps) and 10x6x14x6; the doublet force surrogates `q_nd_diff`
   and `q_nd_clover_diff` forward and backward against the plain path; K1
   on the bf16 gauge copy (K1-B) in every epilogue, both copies and both
   parities, and the copy bit-equal to the bf16 cast of the f32 copy.  The
   slab kernels of the domain decomposition (K3, K3-I, K4 on meshes (4,2),
   (2,1), (2,2); K1-T on 4 and 2 t slabs) against their plain version on the
   same halos, R = 0, 12 and the doublet; the halo kernel KH against the
   torch exchange and its plain version element for element; the assembled
   sharded hop (KH, K3-I, K4) against K1 / K1-R / K1-R-D / K1-B / K1-RB on
   the whole lattice in every (halfspinor, overlap) pair, 18- and 12-real,
   f32 and bf16, bit for bit; K1-R on the bf16 copy (K1-RB) against its
   plain version and 12 launches of K1-B.  K1-SD (the doublet's Q_nd and
   Q_nd^2 in one cooperative launch) against the K1-R-D launches and torch
   diagonals it replaces (bit for bit on the twisted-mass doublet, within
   1e-6 of max on the clover doublet) and against its plain version, 12-
   and 18-real, at 16^3x32, 32^3x64 and 10x6x14x6.  The overlap's Q_W on
   K1 (two launches, the mhat epilogue on both parities) against gamma5
   d_full, each parity and the whole field, and one Q_W^2 on K1 against two
   plain Q_W, at 16^3x32 and 10x6x14x6.
3. timings: K1 at 16^3x32 and 32^3x64, K2 at 16^3x32, K1-R (R = 12) at both
   sizes beside 12 launches of K1, K1-R-D at both sizes beside 2 launches
   of K1, K1-B beside f32 K1 (mhat + g5 and clov_mhat + g5), kernel and
   plain version, with GF/s at
   1320 flops/site, the share of the bandwidth of a device-to-device copy
   measured in the same run, and the bound at the card's published rates.
   One sharded hop on the (4,2) mesh in pieces (y exchange, t pack, K3-I,
   K4; K3 without the overlap) beside K1, K1-T on 4 t slabs, and K1-RB at
   R = 12 beside f32 K1-R, at both sizes.  K1, K1-B and K1-C split into
   wrapper-loop, host and device time (torch.profiler; a CUDA graph of the
   launches as a second reading) with each instance's registers and
   occupancy, and one Qhat_pm (Qsw_pm, Qhat_pm on bf16) as one K1-S launch
   beside the four K1 launches it replaces, in turns, at both sizes.  Q_nd,
   Q_nd^2 and the clover Q_nd^2 as one K1-SD launch beside the K1-R-D
   launches and torch diagonals, and one sharded hop on (4,2) with KH (and
   with KH and one slab launch over all rows) beside the torch exchange, in
   turns, each split into wrapper-loop, host and device time, at both sizes;
   the device time of every other K1-R and slab kernel and K2; K1-R-D's and
   K1-SD's instances.
4. end-to-end parity: one Nf=2 twisted-mass Hasenbusch trajectory, one
   twisted-clover Hasenbusch trajectory and one GAUGE + NDRAT trajectory at
   8^4, each on the kernel path
   (CUDA tensors) and on the plain path (CPU tensors) with the same injected
   draws; |ddH| against its bound; then the twisted-mass and the clover
   trajectory again with Solver = mixedcg (the low operator on K1-B); then
   the twisted-mass, clover and NDRAT trajectories again with every solve on
   the slab kernels of a (2,2) mesh, each against its plain half and, on
   the card, against the same point without a mesh within the bound
   10 eps_f32 (|H_old| + |H_new|) / sqrt(32 V) of
   tests/test_torch_shard_hmc.py; and
   hmc4's SFGAUGE action at 8^4 from the classical background (pure gauge:
   the card against the CPU, the frozen links bit-equal on both).  The CPU
   halves run beside the card halves in worker processes.
5. main path 1: `tmlqcd_tpu_torch.cli.hmc.main` on a 16^3x32 input derived
   from sample-input/hmc2-nf2-tm-hasenbusch.input (3 trajectories, the ONLINE
   measurement on the third, an ILDG checkpoint read back), with the kernel
   launch counters read around it.
6. main path 2: `tmlqcd_tpu_torch.cli.invert.main` on phase 5's checkpoint:
   the 12 spin-colour columns of a point source as one batched CG on K1-R,
   the propagator file read back, every column's true residual, two columns
   against single-column solves, the pion correlator; then one profiled
   batched solve for the device's busy share.
7. main path 3: `cli.hmc.main` on a 16^3x32 input derived from
   sample-input/hmc6-nf2-clover-hasenbusch.input (GAUGE + CLOVERTRLOG +
   CLOVERDET + CLOVERDETRATIO, 1 trajectory with the ONLINE measurement, an ILDG
   checkpoint read back), the launch counters read around it; then one
   profiled trajectory at integration steps 1/1/1 for the device's idle
   share.
8. main path 4: `cli.invert.main` with a CLOVER operator on phase 7's
   checkpoint: 12 columns in one batched CG on K1-R with the clover
   epilogues, every column's true residual against the plain unpreconditioned
   clover operator, one column against `invert_clover_eo`.
9. main path 5: `cli.hmc.main` on a 16^3x32 input derived from
   sample-input/hmc3-nf211-clover.input (Nf=2+1+1: GAUGE + CLOVERTRLOG +
   CLOVERDET + NDRAT with its own beta, kappa, CSW, mu, mubar, epsbar,
   DegreeOfRational and interval, and its own GRADIENTFLOW block at
   Frequency 1: 50 flow steps of 0.02, t^2 E read back, E_plaq falling, the
   flow's seconds and t0; 1 trajectory, an ILDG checkpoint read back), with
   the interval check's line and the launch counters read around it (every
   Q_nd and Q_nd^2 one K1-SD launch); then one
   profiled trajectory at steps 1/1/1 for the device's idle share and one
   whole trajectory with synchronising timers around the NDRAT heatbath,
   force and acceptance, the multishift solves and the doublet hops.
10. main path 6: `cli.invert.main` with the DBTMWILSON and DBCLOVER operators
   of sample-input/invert0-doublet.input at 16^3x32 on phase 9's checkpoint:
   12 columns each through `invert_doublet_eo` (one K1-SD launch per CG
   iteration, K1-R-D for the single hops around the solve, the counts
   checked), every column's true residual of the doublet system against
   the plain unpreconditioned operator.
11. main path 7: `cli.invert.main` on phase 5's checkpoint with one TMWILSON
   operator per solver (fastmixed, mixedcg, dflfgmres, dflgcr, increigcg; 12
   columns each), every column's true residual, iterations (outer / inner
   for the mixed solvers), the MG setup time and seconds per propagator
   beside phase 6's batched CG; then a CLOVER operator with mixedcg on phase
   7's checkpoint.
12. main path 8: `cli.hmc.main` on phase 5's point with Solver = mixedcg in
   DET and DETRATIO (2 trajectories, the low operator on K1-B), s/trajectory
   beside phase 5's and outer / inner iterations per solve; then one Qsw_pm
   solve with rgmixedcg against CG on phase 7's gauge (K1-C on bf16).
13. main path 9: `cli.hmc.main` on sample-input/hmc5-multichip.input as
   shipped (4^3x8 on 4 x 2 slabs of one card, 4 trajectories, K4 alone, the
   checkpoint read back), then the same action at 16^3x32 on 4 x 2 slabs (2
   trajectories: KH and K3-I+K4 launched, one each per sharded hop, no K1 or K1-R
   inside the solves)
   beside the same input without a mesh, then batched inversions of 12
   point columns on its checkpoint: under the mesh (KH, multi-RHS K3-I+K4),
   without overlap (K3) and on t slabs alone (K1-T), each column's true
   residual and the unsharded batched CG beside them.  Path 9's launches
   are those of the runs through a mesh; K1-RB has no caller on a main path
   (the reference has none) and is held to its plain version in phase 2.
14. main path 10: `cli.hmc.main` on hmc3's action at 16^3x32 with its NDRAT
   block retyped as NDPOLY (degree 32 on [0.01, 4.7], 1 trajectory, the
   validate lines read back): every Q_nd^2 of the heatbath and the
   acceptance one K1-SD launch (no K1-R-D), the force's Clenshaw through
   `q_nd_diff` (K1, K2), launches counted per piece, heatbath CG
   iterations, peak device memory; then one mu-shift reweighting (2
   samples, mu -> 1.1 mu, Qhat_pm on K1-S) on phase 5's checkpoint.
15. main path 11: `cli.invert.main` on phase 5's checkpoint with stout
   smearing (rho 0.1 x 3) and source smearing (APE 0.5 x 2, Jacobi 0.2 x
   10): 12 smeared point columns in one batched CG on K1-R, each column's
   true residual against the plain unpreconditioned operator on the smeared
   gauge, iterations beside phase 6's.
16. the other entry points: `cli.offline_measurement.main` on phase 9's
   checkpoint (GRADIENTFLOW, POLYAKOV, ORIENTEDPLAQUETTES, FIELDSTRENGTH,
   every file read back, the flow equal to phase 9's), `cli.benchmark.main`
   at 16^3x32 (1000 calls; K1 within 1.5x of K1 timed by phase 3's method
   just before, Qhat_pm on K1-S) and an `api.Session` on phase 5's
   checkpoint (plaquette equal to its
   output.data, one point column inverted with its residual checked, the
   native checksum route in use).
17. main path 12: `cli.invert.main` with an OVERLAP operator (m 0.1, s 0.4,
   degree 128, 8 modes) on phase 5's checkpoint stout-smeared as path 11
   smears it: 2 point columns with SUMR, then 1 with CGNE, every Q_W on K1;
   the setup line (seconds, Lanczos steps, sign_err, ev_resid), iterations
   and seconds per column, each column's true residual with D_ov on the
   plain route, SUMR against CGNE, the Ginsparg-Wilson defect (and a
   planted fault that must exceed its limit), D_ov on K1
   against the plain route within a bound derived from the degree, K1
   launches equal to the count the iterations predict, and the device's
   idle share over the first iterations of one profiled SUMR column.
18. main path 13: `cli.hmc.main` on sample-input/hmc4-sf-coupling.input as
   shipped but 20 trajectories (of 100): 6^4, cold start, SFGAUGE,
   SFCOUPLING every trajectory; finite dH, acceptance > 0, the frozen links bit-equal after
   every trajectory, sf_coupling.data's rows, s/trajectory; no kernel
   launches (pure gauge).

19. main path 14: the distributed HMC, one process per slab.  First the
   kernels of a rank at 16^3x32 on (2,2) and (4,2) and at hmc5's 4^3x8 on
   (4,2) (T_loc 16, 8, 2) on the one card: the
   field cut into slabs, KH-P on each (against the torch exchange, element
   for element), the faces handed to the neighbours by device copies (a
   loopback of this check only), K3-I, K4 and K3-I+K4 per slab against
   their plain version and joined bit for bit against K1, K2-S per slab
   against its plain version and joined bit for bit against K2; loop,
   device and plain time and the bound of each on a slab of (4,2) of
   16^3x32 (16,384 sites) and of 32^3x64 (262,144 sites; the device time
   counts the kernel's own launches only); the
   draws of a trajectory and a hot start by timeslice against one draw.
   Then 8 spawned processes on the card (tests/dist_ranks.py: a file store,
   built kernels, faces through pinned host memory over gloo): in each,
   `hopping_rank` (KH-P, the exchange and the slab kernel it picks) once
   per route at 16^3x32 and 4^3x8 against the same call on host copies
   (its plain route), then `cli.hmc.main(... --distributed --backend gloo)`:
   hmc5-multichip as shipped against phase 13's one-process run (dH within
   a derived bound, plaquettes, acceptance and iterations equal), then its
   action at 16^3x32 on 4 x 2 ranks for 1 trajectory; the launches summed
   over the ranks (KH-P, K3-I+K4 at T_loc 2, K3-I and K4 at T_loc 8, K2-S;
   no K1, K1-S, K1-SD, K2 or KH), s/trajectory and ms per exchange.  With
   two or more cards the same over NCCL, else the line "nccl between cards:
   not run, 1 card".

20. main path 15: the measurements, NDPOLY and the Schrödinger functional
   on the ranks.  8 spawned processes on the card (gloo) run three jobs:
   (a) hmc2 at 16^3x32 on 4 x 2 ranks, 1 trajectory with ONLINE and
   PIONNORM (rank 0 writes the files), against the same input in one
   process (dH, acceptance, iterations within one) and the correlators
   against one process measuring the ranks' checkpoint within a bound
   derived from the solves' stopping test; (b) hmc5's action at 16^3x32
   with GRADIENTFLOW (10 steps of 0.02), POLYAKOV along t and y,
   ORIENTEDPLAQUETTES and FIELDSTRENGTH, every file to 1e-10 relative of
   one process on the ranks' checkpoint; (c) GAUGE + NDPOLY (degree 32) at
   hmc5's 4^3x8, 1 trajectory against one process (dH within a derived
   bound, the interval check equal on every rank, no K1-SD or K1 on the
   ranks, a rank's peak memory).  Then (d) hmc4 as shipped on 3 ranks
   along t (T_loc 2), 4 of its 100 trajectories against one process: the
   frozen links bit-equal after each, dH within n eps_f32 (|H_old| +
   |H_new|), k the closed form.  Each job's s/trajectory, exchanges, ms per
   exchange and launches summed over the ranks.

The second-to-last line is a JSON object describing each kernel; the last
line is the JSON result object.  No JAX is imported.

    python3 chip_smoke.py --k1-split          # phases 1, 2 and phase 3's split
    python3 chip_smoke.py --nd-split          # K1-SD's and KH's checks and splits
    python3 chip_smoke.py --e2e [--root DIR]  # main paths 1, 3, 5-9 alone
    python3 chip_smoke.py --special           # the Q_W checks, the SF parity, paths 12, 13
    python3 chip_smoke.py --distributed       # phases 19 and 20 alone (paths 14, 15), no result lines

`--e2e` prints s/trajectory of paths 1, 3, 5, 8 and 9, path 6's and path
7's seconds per operator and solver as one JSON line; `--root DIR` takes the package from another
checkout (a parent commit's `tmlqcd_tpu_torch/` unpacked under `dist/`), so
two commits can run in turns in one session on one card.  Neither prints
the result lines.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SAMPLE = os.path.join(HERE, "sample-input", "hmc2-nf2-tm-hasenbusch.input")
SAMPLE_CLOVER = os.path.join(HERE, "sample-input", "hmc6-nf2-clover-hasenbusch.input")
SAMPLE_NF211 = os.path.join(HERE, "sample-input", "hmc3-nf211-clover.input")
SAMPLE_DOUBLET = os.path.join(HERE, "sample-input", "invert0-doublet.input")
SAMPLE_MESH = os.path.join(HERE, "sample-input", "hmc5-multichip.input")

# Relative tolerance of a kernel against its plain version on the same card
# inputs: both compute in f32 and differ only in summation order and FMA
# contraction, ~1e-7 of the output scale (4.8e-7 absolute at outputs of ~15
# on the CPU comparison of the plain versions with the reference); an
# indexing or sign error is O(1).  1e-5 leaves a 100x margin to rounding.
KERNEL_RTOL = 1e-5
# f32's unit roundoff, the derived bounds' unit
EPS_F32 = 2.0 ** -24
# |dH(kernel path) - dH(plain path)| at 8^4: the port's plain path and the
# JAX reference differ by 4.1e-5 at 4^4 and 3.0e-4 at 8^4 (CPU runs of this
# trajectory with the same draws: f32 fields, f64 sums, |H| ~ 2.4e5); the
# kernel path differs from the plain one by the same kind of f32 rounding,
# so 3e-3 is 10x that spread while an operator error shifts dH by O(1).
DDH_BOUND = 3e-3
# The same for the clover trajectory at 8^4.  What it adds to H are the trlog
# (an f64 sum of logs of f32 determinants, |S| ~ 1e3) and the block inverses
# inside the operator (f32 closed forms on blocks whose |det| stays above 0.7
# on a random gauge, so they lose no digits); the pseudofermion actions and
# |H| ~ 2.4e5 are of the twisted-mass trajectory's size, and the kernel's
# block matvec differs from the plain one by summation order only.  The
# port's plain path and the JAX reference differ by 1.2e-5 on the 4^4 clover
# trajectory (CPU, same draws) against 4.1e-5 on the twisted-mass one, so the
# same 3e-3 holds; an operator error shifts dH by O(1).
DDH_BOUND_CLOVER = 3e-3
# The same for the GAUGE + NDRAT trajectory at 8^4.  The doublet pseudofermion
# has twice the components (|S| ~ 1e5, |H| ~ 3e5, as large as the twisted-mass
# trajectory's), its action is a sum of 10 f32 multishift solutions in f64,
# and the two paths run the same f32 recurrences on operators that differ by
# summation order only.  The port's plain path and the JAX reference differ
# by less than 1e-3 on the 4^4 NDRAT trajectory (CPU, same draws, the bound of
# tests/test_torch_ndrat_traj.py); 3e-3 is the bound of the other two
# trajectories, and a wrong flavour stride or sign shifts dH by O(1).
DDH_BOUND_NDRAT = 3e-3
FLOPS_SITE = 1320
# the per-site block matvec of a clover epilogue: 2 chiralities x 6 rows x 6
# complex multiply-adds of 8 flops; its blocks are 2 x 72 floats per site
FLOPS_SITE_CLOVER = 2 * 6 * 6 * 8
BLOCK_BYTES = 2 * 72 * 4
# flops per site of K2: per direction two half-spinor projections (48 adds)
# and 9 x 2 complex multiply-adds (144)
FLOPS_SITE_K2 = 8 * (48 + 144)
# published peaks of one H100 SXM, for `bound_ms` (NVIDIA data sheet)
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS_S = 67e12
NRHS = 12
# True relative residual |M x - b| / |b| of a propagator column, checked with
# the unpacked plain operator `d_full`: CG stops at 1e-7 of the
# normal-equation right-hand side; |Qhat^-1| <~ 10 at kappa = 0.13 on a rough
# gauge takes that to ~1e-6 of |b|, and f32 fields add ~1e-7 per operator
# application.  1e-5 leaves 10x; a wrong Schur step leaves O(1).
RESIDUAL_BOUND = 1e-5
# batched vs single-column solution of the same system: the same kernel
# arithmetic, f64 reductions in another order, both stopped at 1e-7: they
# differ by ~1e-6 of max|x| at most.  1e-5 leaves 10x.
BATCH_VS_SINGLE = 1e-5


# The assembled sharded hop (K3-I + K4, K3, K1-T) against K1 (K1-R, K1-R-D,
# K1-B, K1-RB) on the whole lattice: the slab kernels run K1's per-site sum
# (hopping_common.cuh) on the same neighbour values, and the half-spinor
# halos give W^+ psi back exactly, so bit equality is expected; should a
# compiler contract the FMAs of the two kernels differently, they would
# differ by a few ulp.  1e-6 of max|K1| bounds that; a wrong halo is O(1).
SHARD_RTOL = 1e-6
# the (t, y) slab meshes of phase 2: T_loc = 8, 16, 16 at T = 32
SHARD_MESHES = ((4, 2), (2, 1), (2, 2))


class SmokeFailure(RuntimeError):
    pass


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def _say(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------


def phase_card():
    import torch
    from tmlqcd_tpu_torch.ops import dslash_cuda as dc

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    _check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    _say(card)
    _say(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
         f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    dc.kernel_library(verbose=True)
    _say(f"[build] kernels built and loaded in {time.perf_counter() - t0:.2f} s")
    return card


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------


def _rel_err(out, ref) -> tuple[float, float]:
    err = float((out - ref).abs().max())
    scale = max(1.0, float(ref.abs().max()))
    return err, err / scale


def _fields(lat, dev, seed):
    import torch

    from tmlqcd_tpu_torch import rng, su3
    from tmlqcd_tpu_torch.ops import wilson_fast as wf
    from tmlqcd_tpu_torch.ops.wilson import DiracParams

    params = DiracParams(kappa=0.13, mu=0.01)
    u = su3.random_su3(rng.generator(rng.Key(seed), dev), (4,) + lat.site_shape)
    fg18 = wf.make_fast_gauge(u, params, lat, compress=False)
    fg12 = wf.make_fast_gauge(u, params, lat)
    # the bf16 copies, built from the gauge field on their own
    sloppy = {"18-real": wf.make_fast_gauge(u, params, lat, compress=False, sloppy=True),
              "12-real": wf.make_fast_gauge(u, params, lat, sloppy=True)}
    gen = rng.generator(rng.Key(seed, (1,)), dev)
    shape = (2, 4, 3) + lat.eo_site_shape
    psi = torch.randn(shape, generator=gen, device=dev)
    psi_o = torch.randn(shape, generator=gen, device=dev)
    g = torch.randn(shape, generator=gen, device=dev)
    return params, fg18, fg12, psi, psi_o, g, sloppy


def _random_blocks(lat, dev, seed):
    """Generic (not hermitian) clover blocks [2, 72, T, X, M] with entries of
    order one: the kernels read all 72 complex entries whatever they hold."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((2, 72) + lat.eo_site_shape, generator=gen, device=dev)


def _variants(params):
    k2 = params.kappa ** 2
    return [("none", ("none",)),
            ("mee_inv+", ("mee_inv", params.mutld, 1.0)),
            ("mee_inv-", ("mee_inv", params.mutld, -1.0)),
            ("mhat+g5", ("mhat", params.mutld, 1.0, k2, True)),
            ("mhat-g5", ("mhat", params.mutld, -1.0, k2, True)),
            ("mhat+", ("mhat", params.mutld, 1.0, k2, False)),
            ("clov_inv", ("clov_inv",)),
            ("clov_mhat+g5", ("clov_mhat", k2, True)),
            ("clov_mhat", ("clov_mhat", k2, False))]


def _epi_kw(epi, psi_o, blocks) -> dict:
    """The extra fields an epilogue reads."""
    return {"psi_o": psi_o if epi[0] in ("mhat", "clov_mhat") else None,
            "blocks": blocks if epi[0].startswith("clov") else None}


def _sync(dev) -> None:
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def phase_kernels(lat, dev="cuda"):
    import torch

    from tmlqcd_tpu_torch.ops import dslash_cuda as dc
    from tmlqcd_tpu_torch.ops import split_diag as sd
    from tmlqcd_tpu_torch.ops import wilson_fast as wf

    params, fg18, fg12, psi, psi_o, g, sloppy = _fields(lat, dev, 11)
    blocks = _random_blocks(lat, dev, 14)
    worst = {"K1": 0.0, "K2": 0.0, "K1-R": 0.0, "K1-C": 0.0, "K1-RC": 0.0, "K1-R-D": 0.0,
             "K1-B": 0.0}

    def note(key, epi, err):
        if epi[0].startswith("clov"):
            key = {"K1": "K1-C", "K1-R": "K1-RC"}[key]
        worst[key] = max(worst[key], err)

    for gname, fg in (("18-real", fg18), ("12-real", fg12)):
        for p, ug in ((0, fg.ug_even), (1, fg.ug_odd)):
            for vname, epi in _variants(params):
                kw = dict(epi=epi, gcomp=fg.gcomp, **_epi_kw(epi, psi_o, blocks))
                out = dc.hopping_split(ug, psi, p, lat, **kw)
                ref = dc.hopping_split_plain(ug, psi, p, lat, **kw)
                _sync(dev)
                err, rel = _rel_err(out, ref)
                note("K1", epi, err)
                _say(f"[check] K1 {vname:12s} {gname} p={p}: max|d| {err:.3e} (rel {rel:.2e})")
                _check(rel <= KERNEL_RTOL, f"K1 {vname} {gname} p={p} off by {rel:.3e}")
    # K1 on the bf16 gauge copy (K1-B): the copy built from the gauge field
    # is the f32 copy rounded to bf16 bit for bit; the kernel against its
    # plain version (which upcasts the same bits) in every epilogue
    for gname, fg in (("18-real", fg18), ("12-real", fg12)):
        fgb = sloppy[gname]
        for mine, f32 in ((fgb.ug_even, fg.ug_even), (fgb.ug_odd, fg.ug_odd)):
            _check(mine.dtype == torch.bfloat16 and torch.equal(
                mine.view(torch.int16), f32.to(torch.bfloat16).view(torch.int16)),
                f"the {gname} bf16 copy is not the bf16 cast of the f32 copy")
        _say(f"[check] K1-B {gname}: the bf16 copy equals the f32 copy cast to bf16, bit for bit")
        for p, ug in ((0, fgb.ug_even), (1, fgb.ug_odd)):
            for vname, epi in _variants(params):
                kw = dict(epi=epi, gcomp=fgb.gcomp, **_epi_kw(epi, psi_o, blocks))
                n0 = dc.hopping_split.bf16_launches
                out = dc.hopping_split(ug, psi, p, lat, **kw)
                ref = dc.hopping_split_plain(ug, psi, p, lat, **kw)
                _sync(dev)
                _check(dc.hopping_split.bf16_launches == n0 + 1, "K1-B launch not counted")
                err, rel = _rel_err(out, ref)
                worst["K1-B"] = max(worst["K1-B"], err)
                _say(f"[check] K1-B {vname:12s} {gname} p={p}: max|d| {err:.3e} (rel {rel:.2e})")
                _check(rel <= KERNEL_RTOL, f"K1-B {vname} {gname} p={p} off by {rel:.3e}")
    for p, ug in ((0, fg18.ug_even), (1, fg18.ug_odd)):
        out = dc.hopping_ug_vjp(g, psi, p, lat)
        ref = dc.hopping_ug_vjp_plain(g, psi, p, lat)
        _sync(dev)
        err, rel = _rel_err(out, ref)
        worst["K2"] = max(worst["K2"], err)
        _say(f"[check] K2 p={p}: max|d| {err:.3e} (rel {rel:.2e})")
        _check(rel <= KERNEL_RTOL, f"K2 p={p} off by {rel:.3e}")
    # K1-R against its plain version and against R launches of K1
    for nrhs in (NRHS, 3):
        gen = torch.Generator(device=dev).manual_seed(100 + nrhs)
        shape = (2, 4, 3, nrhs) + lat.eo_site_shape
        psis = torch.randn(shape, generator=gen, device=dev)
        psis_o = torch.randn(shape, generator=gen, device=dev)
        for gname, fg in (("18-real", fg18), ("12-real", fg12)):
            for vname, epi in _variants(params):
                clov = epi[0].startswith("clov")
                kw = dict(epi=epi, gcomp=fg.gcomp)
                out = dc.hopping_split_rhs(fg.ug_odd, psis, 1, lat, r_axis=3, **kw,
                                           **_epi_kw(epi, psis_o, blocks))
                ref = dc.hopping_split_rhs_plain(fg.ug_odd, psis, 1, lat, **kw,
                                                 **_epi_kw(epi, psis_o, blocks))
                _sync(dev)
                err, rel = _rel_err(out, ref)
                note("K1-R", epi, err)
                vs_k1 = 0.0
                for r in range(nrhs):
                    one = dc.hopping_split(
                        fg.ug_odd, psis[:, :, :, r].contiguous(), 1, lat, **kw,
                        **_epi_kw(epi, psis_o[:, :, :, r].contiguous(), blocks))
                    vs_k1 = max(vs_k1, float((out[:, :, :, r] - one).abs().max()))
                _say(f"[check] K1-R R={nrhs:2d} {vname:12s} {gname}: max|d| {err:.3e} "
                     f"(rel {rel:.2e}), vs {nrhs} x K1 {vs_k1:.3e}")
                _check(rel <= KERNEL_RTOL, f"K1-R R={nrhs} {vname} {gname} off by {rel:.3e}")
                # the clover epilogue of K1-R runs K1's arithmetic on blocks
                # staged in shared memory: the same bits
                _check(vs_k1 <= (0.0 if clov else KERNEL_RTOL * max(1.0, float(ref.abs().max()))),
                       f"K1-R R={nrhs} {vname} {gname} differs from K1 by {vs_k1:.3e}")
        del psis, psis_o, out, ref
    # K1-R on the flavour-doublet axis (R = 2, r_axis 1, epilogue none):
    # against its plain version, and each flavour bit for bit against K1 on
    # that flavour alone (a wrong component or flavour stride still runs and
    # is wrong in one flavour only; the two flavours hold different fields)
    gen = torch.Generator(device=dev).manual_seed(102)
    chi = torch.randn((2, 2, 4, 3) + lat.eo_site_shape, generator=gen, device=dev)
    for gname, fg in (("18-real", fg18), ("12-real", fg12)):
        for p, ug in ((0, fg.ug_even), (1, fg.ug_odd)):
            out = dc.hopping_split_rhs(ug, chi, p, lat, gcomp=fg.gcomp, r_axis=1)
            ref = dc.hopping_split_rhs_plain(ug, chi, p, lat, gcomp=fg.gcomp, r_axis=1)
            _sync(dev)
            _check(out.shape == chi.shape and ref.shape == chi.shape, "K1-R-D output shape")
            for f in range(2):
                err, rel = _rel_err(out[:, f], ref[:, f])
                worst["K1-R-D"] = max(worst["K1-R-D"], err)
                one = dc.hopping_split(ug, chi[:, f].contiguous(), p, lat, gcomp=fg.gcomp)
                vs_k1 = float((out[:, f] - one).abs().max())
                _say(f"[check] K1-R-D {gname} p={p} flavour {f}: max|d| {err:.3e} "
                     f"(rel {rel:.2e}), vs K1 {vs_k1:.3e}")
                _check(rel <= KERNEL_RTOL, f"K1-R-D {gname} p={p} flavour {f} off by {rel:.3e}")
                _check(vs_k1 == 0.0, f"K1-R-D {gname} p={p} flavour {f} differs from K1 by "
                                     f"{vs_k1:.3e}")
    # HoppingDiff (K1 forward, K2 + adjoint K1 backward) against autograd of
    # the plain version
    for p in (0, 1):
        ug_p, ug_q = (fg18.ug_even, fg18.ug_odd) if p == 0 else (fg18.ug_odd, fg18.ug_even)
        a = ug_p.clone().requires_grad_(True)
        b = psi.clone().requires_grad_(True)
        out = dc.HoppingDiff.apply(a, ug_q, b, p, lat)
        da, db = torch.autograd.grad(out, (a, b), g)
        a2 = ug_p.clone().requires_grad_(True)
        b2 = psi.clone().requires_grad_(True)
        ref = dc.hopping_split_plain(a2, b2, p, lat)
        ra, rb = torch.autograd.grad(ref, (a2, b2), g)
        _sync(dev)
        for name, x, y in (("fwd", out.detach(), ref.detach()), ("d ug", da, ra), ("d psi", db, rb)):
            err, rel = _rel_err(x, y)
            _say(f"[check] HoppingDiff p={p} {name}: max|d| {err:.3e} (rel {rel:.2e})")
            _check(rel <= KERNEL_RTOL, f"HoppingDiff p={p} {name} off by {rel:.3e}")
    # q_hat_clover_diff (two HoppingDiff hops, the block matvecs between
    # them in plain tensor arithmetic) forward and backward against autograd
    # of the same operator built from the plain hop
    blk2 = [dc.blk_unflatten(_random_blocks(lat, dev, s)) for s in (15, 16)]
    k2 = params.kappa ** 2

    def plain_q(ug_e, ug_o, moo, mee_inv, x):
        tmp = dc.hopping_split_plain(ug_e, x, 0, lat)
        tmp = dc.hopping_split_plain(ug_o, sd.blocks_apply_split(mee_inv, tmp), 1, lat)
        return wf.gamma5_split(sd.blocks_apply_split(moo, x) - k2 * tmp)

    grads = []
    for fn in (lambda *a: wf.q_hat_clover_diff(*a, params, lat), plain_q):
        ins = [t.clone().requires_grad_(True) for t in (fg18.ug_even, fg18.ug_odd, *blk2, psi)]
        out = fn(*ins)
        grads.append((out.detach(),) + torch.autograd.grad(out, ins, g))
    _sync(dev)
    for name, x, y in zip(("fwd", "d ug_e", "d ug_o", "d moo", "d mee_inv", "d psi"), *grads):
        err, rel = _rel_err(x, y)
        _say(f"[check] q_hat_clover_diff {name}: max|d| {err:.3e} (rel {rel:.2e})")
        _check(rel <= KERNEL_RTOL, f"q_hat_clover_diff {name} off by {rel:.3e}")
    # the doublet force surrogates q_nd_diff and q_nd_clover_diff (HoppingDiff
    # flavour by flavour, the flavour-mixing diagonals between the hops in
    # plain tensor arithmetic) forward and backward against autograd of the
    # same operators built from the plain doublet hop
    from tmlqcd_tpu_torch.ops.ndoublet import NDParams

    ndp = NDParams(kappa=0.13, mubar=0.12, epsbar=0.15)
    gd = torch.randn(chi.shape, generator=gen, device=dev)

    def plain_hop(ug, c2, p):
        return dc.hopping_split_rhs_plain(ug, c2, p, lat, r_axis=1)

    def plain_qnd(ug_e, ug_o, c2):
        tmp = sd.mee_inv_nd_split(plain_hop(ug_e, c2, 0), ndp.mubar_t, ndp.epsbar_t, +1.0)
        m = sd.mee_nd_split(c2, ndp.mubar_t, ndp.epsbar_t, +1.0) - k2 * plain_hop(ug_o, tmp, 1)
        return sd.gamma5_nd(sd.tau1_split(m))

    def plain_qnd_clover(ug_e, ug_o, moo_u, moo_d, ma, mb, me, c2):
        tmp = sd.mee_inv_nd_apply_split(ma, mb, me, ndp.epsbar_t, plain_hop(ug_e, c2, 0))
        m = sd.mee_nd_apply_split(moo_u, moo_d, ndp.epsbar_t, c2) - k2 * plain_hop(ug_o, tmp, 1)
        return sd.gamma5_nd(sd.tau1_split(m))

    blk5 = [dc.blk_unflatten(_random_blocks(lat, dev, s)) for s in (18, 19, 20, 21, 22)]
    cases = (("q_nd_diff", (), lambda *a: wf.q_nd_diff(*a, ndp, lat), plain_qnd,
              ("fwd", "d ug_e", "d ug_o", "d chi")),
             ("q_nd_clover_diff", blk5, lambda *a: wf.q_nd_clover_diff(*a, ndp, lat),
              plain_qnd_clover, ("fwd", "d ug_e", "d ug_o", "d moo_u", "d moo_d", "d minv_a",
                                 "d minv_b", "d minv_e", "d chi")))
    for what, blks, kern_fn, plain_fn, names in cases:
        grads = []
        for fn in (kern_fn, plain_fn):
            ins = [t.clone().requires_grad_(True) for t in (fg18.ug_even, fg18.ug_odd, *blks, chi)]
            out = fn(*ins)
            grads.append((out.detach(),) + torch.autograd.grad(out, ins, gd))
        _sync(dev)
        for name, x, y in zip(names, *grads):
            err, rel = _rel_err(x, y)
            _say(f"[check] {what} {name}: max|d| {err:.3e} (rel {rel:.2e})")
            _check(rel <= KERNEL_RTOL, f"{what} {name} off by {rel:.3e}")
    return worst


def _schur_stages(params, kind: str, signs: tuple, g5: bool, blocks=None) -> tuple:
    """K1-S stages of `dslash_cuda.hopping_schur`: one per sign (Mhat(+-):
    one; Qhat_pm: (+1, -1)); `kind` "tm" or "clover" (then blocks[2 j],
    blocks[2 j + 1] are stage j's even and odd blocks)."""
    k2 = params.kappa ** 2
    if kind == "tm":
        return tuple((("mee_inv", params.mutld, sign), ("mhat", params.mutld, sign, k2, g5),
                      None, None) for sign in signs)
    return tuple((("clov_inv",), ("clov_mhat", k2, g5), blocks[2 * j], blocks[2 * j + 1])
                 for j in range(len(signs)))


def _schur_by_k1(dc, fg, x, lat, stages):
    """The K1 launches K1-S replaces: per stage the even hop, then the odd
    hop reading the stage's input as psi_o."""
    for epi_e, epi_o, blk_e, blk_o in stages:
        tmp = dc.hopping_split(fg.ug_even, x, 0, lat, epi=epi_e, gcomp=fg.gcomp, blocks=blk_e)
        x = dc.hopping_split(fg.ug_odd, tmp, 1, lat, epi=epi_o, psi_o=x, gcomp=fg.gcomp,
                             blocks=blk_o)
    return x


def phase_schur_kernels(lats, dev="cuda"):
    """K1-S against the K1 launches it replaces, bit for bit, and against its
    plain version: both epilogue pairs (mee_inv -> mhat, clov_inv ->
    clov_mhat), Mhat(+), Mhat(-) and Qhat_pm, with and without gamma5, 18-
    and 12-real links in f32 and bf16, on each lattice of `lats`."""
    import torch

    from tmlqcd_tpu_torch.ops import dslash_cuda as dc

    worst, n_exact, n_cases = 0.0, 0, 0
    for lat in lats:
        tag = "x".join(map(str, lat.dims[::-1][:3])) + f"x{lat.dims[0]}"
        params, fg18, fg12, psi, _, _, sloppy = _fields(lat, dev, 41)
        blocks = [_random_blocks(lat, dev, 50 + i) for i in range(4)]
        for gname, fg in (("18-real f32", fg18), ("12-real f32", fg12),
                          ("18-real bf16", sloppy["18-real"]), ("12-real bf16", sloppy["12-real"])):
            exact, cases, rel_max = 0, 0, 0.0
            for kind in ("tm", "clover"):
                for g5 in (True, False):
                    for signs in ((1.0,), (-1.0,), (1.0, -1.0)):
                        stages = _schur_stages(params, kind, signs, g5, blocks)
                        n0 = dc.hopping_schur.launches
                        out = dc.hopping_schur(fg.ug_even, fg.ug_odd, psi, lat, stages, fg.gcomp)
                        seq = _schur_by_k1(dc, fg, psi, lat, stages)
                        ref = dc.hopping_schur_plain(fg.ug_even, fg.ug_odd, psi, lat, stages,
                                                     fg.gcomp)
                        _sync(dev)
                        _check(dc.hopping_schur.launches == n0 + 1, "K1-S launch not counted")
                        same = bool(torch.equal(out, seq))
                        err, rel = _rel_err(out, ref)
                        worst = max(worst, err)
                        rel_max = max(rel_max, rel)
                        exact += same
                        cases += 1
                        what = f"K1-S {tag} {gname} {kind} signs {signs} g5 {g5}"
                        _check(same, f"{what} differs from the K1 launches by "
                                     f"{float((out - seq).abs().max()):.3e}")
                        _check(rel <= KERNEL_RTOL, f"{what} off its plain version by {rel:.3e}")
            n_exact += exact
            n_cases += cases
            _say(f"[check] K1-S {tag} {gname}: {exact} of {cases} cases (tm and clover, Mhat(+), "
                 f"Mhat(-), Qhat_pm, g5 on and off) bit-equal to the K1 launches; against plain "
                 f"max rel {rel_max:.2e}")
        del params, fg18, fg12, psi, sloppy, blocks, out, seq, ref
        torch.cuda.empty_cache()
    _say(f"[check] K1-S: {n_exact} of {n_cases} bit-equal to the K1 launches they replace")
    return worst


# K1-SD on the clover doublet against the K1-R-D launches and torch block
# matvecs it replaces: torch sums a block row with `.sum(dim=(2, 4))`, K1-SD
# in K1's `store_clover` order, so the two differ by f32 summation order
# (~1e-7 of the scale); a wrong block, flavour or sign is O(1).
ND_CLOVER_RTOL = 1e-6


def phase_nd_schur_kernels(lats, dev="cuda"):
    """K1-SD (`dslash_cuda.hopping_schur_nd`: every Q_nd and Q_nd^2 on a
    CUDA tensor in one cooperative launch) against the route it replaced
    (two K1-R-D launches per Q_nd and the torch flavour diagonals,
    `_nd_by_k1rd`), on the same card tensors: bit for bit on the
    twisted-mass doublet, within ND_CLOVER_RTOL of max|composed| on the
    clover doublet; and against its plain version (KERNEL_RTOL).  Q_nd and
    Q_nd^2, twisted mass and clover, 12- and 18-real links, each lattice of
    `lats`."""
    import torch

    from tmlqcd_tpu_torch.ops import dslash_cuda as dc
    from tmlqcd_tpu_torch.ops import wilson_fast as wf

    worst, n_exact, n_tm, n_cases, clover_rel = 0.0, 0, 0, 0, 0.0
    for lat in lats:
        tag = "x".join(map(str, lat.dims[::-1][:3])) + f"x{lat.dims[0]}"
        for compress in (True, False):
            ndp, ndc, fg, fc, chi = _nd_fixture(lat, dev, 80, compress)
            gname = "12-real" if compress else "18-real"
            for clover in (False, True):
                op, params = (fc, ndc) if clover else (fg, ndp)
                for square in (False, True):
                    fn = {(False, False): wf.q_nd_fast, (False, True): wf.q_nd_sq_fast,
                          (True, False): wf.q_nd_clover_fast,
                          (True, True): wf.q_nd_sq_clover_fast}[(clover, square)]
                    n0 = dc.hopping_schur_nd.launches
                    out = fn(op, chi, params, lat)
                    _check(dc.hopping_schur_nd.launches == n0 + 1, "K1-SD launch not counted")
                    comp = _nd_by_k1rd(dc, wf, op, chi, params, lat, clover, square)
                    stage = wf._nd_stage(params, fc if clover else None)
                    ref = dc.hopping_schur_nd_plain(fg.ug_even, fg.ug_odd, chi, lat, stage,
                                                    fg.gcomp, square)
                    _sync(dev)
                    what = (f"K1-SD {tag} {gname} {'clover' if clover else 'tm'} "
                            f"{'Q_nd^2' if square else 'Q_nd'}")
                    _check(bool(torch.isfinite(out).all()) and float(out.abs().max()) > 0.0,
                           f"{what}: output not finite or empty")
                    d_comp = float((out - comp).abs().max())
                    scale = float(comp.abs().max())
                    err, rel = _rel_err(out, ref)
                    worst = max(worst, err)
                    n_cases += 1
                    if clover:
                        clover_rel = max(clover_rel, d_comp / scale)
                        _check(d_comp <= ND_CLOVER_RTOL * scale,
                               f"{what} differs from the composed path by {d_comp:.3e} "
                               f"(max {scale:.3e})")
                    else:
                        n_tm += 1
                        n_exact += d_comp == 0.0
                        _check(d_comp == 0.0, f"{what} differs from the composed path by "
                                              f"{d_comp:.3e}")
                    _check(rel <= KERNEL_RTOL, f"{what} off its plain version by {rel:.3e}")
            del ndp, ndc, fg, fc, chi, out, comp, ref
            torch.cuda.empty_cache()
    _say(f"[check] K1-SD: {n_exact} of {n_tm} twisted-mass cases bit-equal to the K1-R-D "
         f"launches and torch diagonals they replace; clover doublet within "
         f"{clover_rel:.2e} of max|composed| (bound {ND_CLOVER_RTOL:.0e}); {n_cases} cases "
         f"against plain max|d| {worst:.3e} (bound rel {KERNEL_RTOL:.0e})")
    return worst


def _whole_hop(dc, fg, x, p, lat, r_axis):
    """K1 / K1-R / K1-R-D (on a bf16 gauge K1-B / K1-RB) on the whole lattice."""
    ug = fg.ug_even if p == 0 else fg.ug_odd
    if r_axis is None:
        return dc.hopping_split(ug, x, p, lat, gcomp=fg.gcomp)
    return dc.hopping_split_rhs(ug, x, p, lat, gcomp=fg.gcomp, r_axis=r_axis)


def phase_shard_kernels(lat, dev="cuda"):
    """The slab kernels K3, K3-I, K4 and K1-T against their plain version on
    the same card tensors, variant by variant; the assembled sharded hop
    against K1 (K1-R, K1-R-D, K1-B, K1-RB) on the whole lattice, on meshes
    (4,2), (2,1), (2,2), every (halfspinor, overlap) pair, R = 0, 12 and the
    doublet, 18- and 12-real links in f32 and bf16; K1-RB against its plain
    version and against R launches of K1-B."""
    import itertools

    import torch

    from tmlqcd_tpu_torch import parallel
    from tmlqcd_tpu_torch.ops import dslash_cuda as dc

    params, fg18, fg12, psi, psi_o, _, sloppy = _fields(lat, dev, 31)
    gauges = {"18-real": fg18, "12-real": fg12, "18-real bf16": sloppy["18-real"],
              "12-real bf16": sloppy["12-real"]}
    gen = torch.Generator(device=dev).manual_seed(32)
    inputs = {None: psi,
              3: torch.randn((2, 4, 3, NRHS) + lat.eo_site_shape, generator=gen, device=dev),
              1: torch.randn((2, 2, 4, 3) + lat.eo_site_shape, generator=gen, device=dev)}
    worst = {"K3": 0.0, "K3-I": 0.0, "K4": 0.0, "K1-T": 0.0, "K1-RB": 0.0, "KH": 0.0,
             "K3-I+K4": 0.0}
    n_hops = n_exact = n_kh = 0
    shard_err = 0.0
    for shape in SHARD_MESHES:
        mesh = parallel.Mesh(*shape, device=dev)
        # each variant against its plain version, on the halos of the exchange
        for (gname, fg), (r_axis, x) in itertools.product(
                (("12-real", fg12), ("18-real bf16", sloppy["18-real"])), inputs.items()):
            mh = dc._y_halos(x, lat, mesh, True, r_axis)
            th = dc._t_halos(x, lat, mesh, True, r_axis)
            cases = (("K3", "ext", dc._t_halos(x, lat, mesh, True, r_axis, ext=True), {}),
                     ("K3-I", "int", x, {}), ("K4", "bnd", x, {"th": th}),
                     ("K3-I+K4", "all", x, {"th": th}))
            for name, variant, src, extra in cases:
                if variant == "int" and mesh.local(lat).dims[0] < 4:
                    continue
                if mh is None and variant == "ext":  # one y slab: the y hops wrap
                    name = "K1-T"
                outs = []
                for fn in (dc.hopping_slab_split, dc.hopping_slab_split_plain):
                    out = torch.zeros_like(x)
                    fn(fg.ug_odd, src, 1, lat, mesh, variant, out, mh=mh, gcomp=fg.gcomp,
                       r_axis=r_axis, **extra)
                    outs.append(out)
                _sync(dev)
                err, rel = _rel_err(*outs)
                worst[name] = max(worst[name], err)
                _check(rel <= KERNEL_RTOL, f"{name} mesh {shape} {gname} R axis {r_axis} off its "
                                           f"plain version by {rel:.3e}")
                _check(float(outs[0].abs().max()) > 0.0, f"{name} wrote nothing")
        _say(f"[check] slab kernels on mesh {shape}: max|d| vs plain K3 {worst['K3']:.3e}, "
             f"K3-I {worst['K3-I']:.3e}, K4 {worst['K4']:.3e}, K3-I+K4 {worst['K3-I+K4']:.3e}, "
             f"K1-T {worst['K1-T']:.3e}")
        # KH (halo_pack) against its plain version, the torch exchange,
        # element for element: every product in a halo is exact
        for (r_axis, x), hs in itertools.product(inputs.items(), (True, False)):
            n0 = dc.halo_pack.launches
            mh, th = dc.halo_pack(x, lat, mesh, r_axis, hs)
            _check(dc.halo_pack.launches == n0 + 1, "KH launch not counted")
            ref_mh = dc._y_halos(x, lat, mesh, hs, r_axis)
            ref_th = dc._t_halos(x, lat, mesh, hs, r_axis)
            _sync(dev)
            _check((mh is None) == (ref_mh is None) and th.shape == ref_th.shape
                   and (mh is None or mh.shape == ref_mh.shape),
                   f"KH mesh {shape} R axis {r_axis}: halo shapes differ from the torch exchange")
            worst["KH"] = max(worst["KH"], float((th - ref_th).abs().max()),
                              0.0 if mh is None else float((mh - ref_mh).abs().max()))
            _check((mh is None or torch.equal(mh, ref_mh)) and torch.equal(th, ref_th),
                   f"KH mesh {shape} halfspinor {hs} R axis {r_axis} differs from the "
                   f"torch exchange")
            n_kh += 1
        _say(f"[check] KH on mesh {shape}: the y and t halos equal the torch exchange "
             f"element for element (R axis None, 1, 3; half-spinor on and off; max|d| "
             f"{worst['KH']:.3e})")
        # the assembled sharded hop against K1 on the whole lattice
        for (hs, ov), (gname, fg), (r_axis, x), p in itertools.product(
                itertools.product((True, False), (True, False)), gauges.items(),
                inputs.items(), (0, 1)):
            ug = fg.ug_even if p == 0 else fg.ug_odd
            out = dc.hopping_shard(ug, x, p, lat, dataclasses.replace(
                mesh, halfspinor=hs, overlap=ov), fg.gcomp, r_axis)
            whole = _whole_hop(dc, fg, x, p, lat, r_axis)
            _sync(dev)
            err = float((out - whole).abs().max())
            scale = float(whole.abs().max())
            shard_err = max(shard_err, err / scale)
            n_hops += 1
            n_exact += err == 0.0
            _check(err <= SHARD_RTOL * scale, f"sharded hop mesh {shape} hs={hs} ov={ov} {gname} "
                                              f"R axis {r_axis} p={p} differs from K1 by {err:.3e}")
    _say(f"[check] sharded hop (KH + K3-I+K4, or K3) vs K1 / K1-R / K1-R-D / K1-B / K1-RB on "
         f"the whole lattice: {n_hops} hops on meshes {SHARD_MESHES}, {n_exact} bit for bit, "
         f"max rel {shard_err:.3e} (bound {SHARD_RTOL:.0e}); KH {n_kh} cases")
    _check(n_exact == n_hops, f"{n_hops - n_exact} sharded hops differ from K1 in their bits")
    # K1-T: t slabs with concatenated halos, the y hops wrapping in the slab
    for t_shards, (gname, fg), hs in itertools.product((4, 2), gauges.items(), (True, False)):
        mesh = parallel.Mesh(t_shards, 1, device=dev, halfspinor=hs)
        for p, ug in ((0, fg.ug_even), (1, fg.ug_odd)):
            out = dc.hopping_tshard(ug, psi, p, lat, mesh, fg.gcomp)
            whole = _whole_hop(dc, fg, psi, p, lat, None)
            ref = dc.hopping_slab_split_plain(ug, dc._t_halos(psi, lat, mesh, hs, ext=True), p,
                                              lat, mesh, "ext", torch.zeros_like(psi),
                                              gcomp=fg.gcomp)
            _sync(dev)
            err, rel = _rel_err(out, ref)
            worst["K1-T"] = max(worst["K1-T"], err)
            _check(rel <= KERNEL_RTOL, f"K1-T {t_shards} slabs {gname} p={p} off by {rel:.3e}")
            d = float((out - whole).abs().max())
            _check(d <= SHARD_RTOL * float(whole.abs().max()),
                   f"K1-T {t_shards} slabs {gname} p={p} differs from K1 by {d:.3e}")
    _say(f"[check] K1-T (t slabs 4 and 2, every gauge, both halo forms) vs plain max|d| "
         f"{worst['K1-T']:.3e}, vs K1 within {SHARD_RTOL:.0e}")
    # K1-RB: K1-R on the bf16 copies, against its plain version and R
    # launches of K1-B (bit for bit with the epilogue none)
    k2 = params.kappa ** 2
    psis, psis_o = inputs[3], torch.randn_like(inputs[3])
    for gname in ("18-real", "12-real"):
        fgb = sloppy[gname]
        for vname, epi in (("none", ("none",)), ("mhat+g5", ("mhat", params.mutld, 1.0, k2, True))):
            kw = dict(epi=epi, gcomp=fgb.gcomp, **_epi_kw(epi, psis_o, None))
            n0 = dc.hopping_split_rhs.bf16_launches
            out = dc.hopping_split_rhs(fgb.ug_odd, psis, 1, lat, **kw)
            _check(dc.hopping_split_rhs.bf16_launches == n0 + 1, "K1-RB launch not counted")
            ref = dc.hopping_split_rhs_plain(fgb.ug_odd, psis, 1, lat, **kw)
            _sync(dev)
            err, rel = _rel_err(out, ref)
            worst["K1-RB"] = max(worst["K1-RB"], err)
            vs_k1b = 0.0
            for r in range(NRHS):
                one = dc.hopping_split(fgb.ug_odd, psis[:, :, :, r].contiguous(), 1, lat, epi=epi,
                                       gcomp=fgb.gcomp,
                                       **_epi_kw(epi, psis_o[:, :, :, r].contiguous(), None))
                vs_k1b = max(vs_k1b, float((out[:, :, :, r] - one).abs().max()))
            _say(f"[check] K1-RB R={NRHS} {vname:8s} {gname}: max|d| {err:.3e} (rel {rel:.2e}), "
                 f"vs {NRHS} x K1-B {vs_k1b:.3e}")
            _check(rel <= KERNEL_RTOL, f"K1-RB {vname} {gname} off by {rel:.3e}")
            _check(vs_k1b <= (0.0 if epi[0] == "none" else KERNEL_RTOL * float(ref.abs().max())),
                   f"K1-RB {vname} {gname} differs from K1-B by {vs_k1b:.3e}")
    return worst, n_exact, n_hops


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------


def _time_ms(fn, n: int) -> float:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / n


def _sm_count() -> int:
    import torch

    return torch.cuda.get_device_properties(0).multi_processor_count


def _host_ms(fn, n: int) -> float:
    """Host time per call: the loop of n calls on the host's clock, stopped
    before the synchronisation (the enqueue alone, no device wait)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host = (time.perf_counter() - t0) / n * 1e3
    torch.cuda.synchronize()
    return host


def _is_kernel(name: str, kernel: str) -> bool:
    """Whether a device event's name is the kernel function `kernel`, in its
    mangled form (`<len><name>` after `_Z`, as `_Z11slab_kernelIfEv..`) or
    demangled (`void slab_kernel<float>(..)`): `slab_kernel` is not
    `ug_vjp_slab_kernel`."""
    return (f"{len(kernel)}{kernel}" in name
            or re.search(rf"(?<![A-Za-z0-9_]){re.escape(kernel)}(?![A-Za-z0-9_])", name)
            is not None)


# torch.profiler may report fewer of a kernel's launches than were made
# (late in a long process 5 of 50; a session of one call none): a kernel's
# device time is the mean over the launches it did report, published only
# from at least MIN_SEEN of them, gathered over at most PROFILE_SESSIONS
# sessions
MIN_SEEN = 10
PROFILE_SESSIONS = 8


def _device_events(fn, n: int, match) -> list:
    """The durations (us) of the device intervals whose name `match`es in
    one torch.profiler session of n calls."""
    import torch

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return [float(ev.time_range.end - ev.time_range.start) for ev in prof.events()
            if ev.device_type == torch.autograd.DeviceType.CUDA and match(ev.name)]


def _device_ms(fn, n: int, sub: str, per_call: int | None = 1) -> tuple[float, int, int]:
    """Device time per call of the intervals `sub` names: a kernel
    function's name (ending in `_kernel`) that function alone
    (`_is_kernel`: `slab_kernel` is not `ug_vjp_slab_kernel`), any other
    `sub` by substring ("" every interval, copies included).  With
    `per_call` launches a call: the mean over the launches torch.profiler
    reported, times per_call, from sessions of n calls until it reported
    MIN_SEEN; a session reporting more than were made fails, and so do
    PROFILE_SESSIONS with fewer than MIN_SEEN.  With per_call None (a torch
    composite whose count a call is not known): the sum per call of a
    session whose count equals the previous session's (a session that
    dropped some differs), at least one a call.  -> (ms, intervals seen,
    intervals made or, per_call None, seen)."""
    import torch

    def match(name):
        return _is_kernel(name, sub) if sub.endswith("_kernel") else sub in name

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    seen, made, last = [], 0, None
    for _ in range(PROFILE_SESSIONS):
        got = _device_events(fn, n, match)
        if per_call is None:
            if last is not None and len(got) == last >= n:
                return sum(got) / n / 1e3, len(got), len(got)
            last = len(got)
            continue
        _check(len(got) <= n * per_call, f"device time of {sub!r}: the profiler reported "
                                          f"{len(got)} intervals for {n * per_call} made")
        seen += got
        made += n * per_call
        if len(seen) >= MIN_SEEN:
            return sum(seen) / len(seen) * per_call / 1e3, len(seen), made
    _check(per_call is not None, f"device time of {sub!r}: no two of {PROFILE_SESSIONS} "
                                 f"sessions of {n} calls reported the same intervals")
    _check(False, f"device time of {sub!r}: the profiler reported {len(seen)} of {made} "
                  f"launches, fewer than {MIN_SEEN}")


def _graph_ms(fn, n: int) -> float:
    """Time per call of n calls captured in one CUDA graph and replayed
    (CUDA events around 3 replays): launches without the host between them."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    stop.record()
    stop.synchronize()
    ms = start.elapsed_time(stop) / (3 * n)
    del graph
    torch.cuda.empty_cache()
    return ms


def _copy_bandwidth() -> float:
    """Bytes/s of a 1 GiB device-to-device copy (read + write counted)."""
    import torch

    src = torch.empty(2**28, dtype=torch.float32, device="cuda")
    dst = torch.empty_like(src)
    ms = _time_ms(lambda: dst.copy_(src), 20)
    bw = 2 * src.numel() * 4 / (ms * 1e-3)
    del src, dst
    torch.cuda.empty_cache()
    return bw


def _model(epi, gbytes: int, nrhs: int = 1) -> tuple[int, int]:
    """(bytes, flops) per site of one hopping call by the traffic model:
    the gauge and the clover blocks once, each spinor read or written once
    per right-hand side."""
    clov = epi[0].startswith("clov")
    spinors = 3 if epi[0] in ("mhat", "clov_mhat") else 2
    nbytes = gbytes + (BLOCK_BYTES if clov else 0) + nrhs * spinors * 96
    return nbytes, nrhs * (FLOPS_SITE + (FLOPS_SITE_CLOVER if clov else 0))


def _bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    """Least time at the published peaks: the larger of bytes over the memory
    rate and flops over the f32 rate, and which of the two it is."""
    tb, tf = nbytes / PEAK_BYTES_S * 1e3, flops / PEAK_F32_FLOPS_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def phase_timings(lat16, lat32):
    import torch

    from tmlqcd_tpu_torch.ops import dslash_cuda as dc

    bw = _copy_bandwidth()
    _say(f"[time] device copy bandwidth {bw / 1e9:.1f} GB/s")
    rows = {}
    for lat in (lat16, lat32):
        tag = "x".join(map(str, lat.dims[::-1][:3])) + f"x{lat.dims[0]}"
        params, fg18, fg12, psi, psi_o, g, sloppy = _fields(lat, "cuda", 12)
        blocks = _random_blocks(lat, "cuda", 17)
        sites = lat.volume // 2
        k2 = params.kappa ** 2
        for gname, fg, gbytes in (("18-real", fg18, 576), ("12-real", fg12, 384)):
            for vname, epi in (("none", ("none",)),
                               ("mhat+g5", ("mhat", params.mutld, 1.0, k2, True)),
                               ("clov_inv", ("clov_inv",)),
                               ("clov_mhat+g5", ("clov_mhat", k2, True))):
                kw = dict(epi=epi, gcomp=fg.gcomp, **_epi_kw(epi, psi_o, blocks))
                n = 200 if lat is lat16 else 50
                ms = _time_ms(lambda: dc.hopping_split(fg.ug_odd, psi, 1, lat, **kw), n)
                pms = _time_ms(lambda: dc.hopping_split_plain(fg.ug_odd, psi, 1, lat, **kw),
                               max(n // 10, 5))
                site_bytes, site_flops = _model(epi, gbytes)
                nbytes = site_bytes * sites
                gfs = site_flops * sites / (ms * 1e-3) / 1e9
                share = nbytes / (ms * 1e-3) / bw
                bound = _bound_ms(nbytes, site_flops * sites)
                rows[(tag, gname, vname)] = (ms, pms, *bound)
                _say(f"[time] K1 {tag} {gname} {vname:12s}: kernel {ms * 1e3:9.1f} us "
                     f"({gfs:7.1f} GF/s, {share:6.1%} of copy bandwidth at "
                     f"{nbytes / sites:.0f} B/site, bound {bound[0] * 1e3:.1f} us by {bound[1]}, "
                     f"{nbytes / bw * 1e6:.1f} us at copy bandwidth)  "
                     f"plain {pms * 1e3:10.1f} us ({pms / ms:5.1f}x)")
        # K1-B: the same kernel on the bf16 copies (half the gauge bytes)
        # beside the f32 K1 of the same epilogue, timed in turns
        for gname, gbytes in (("18-real", 288), ("12-real", 192)):
            fgb = sloppy[gname]
            for vname, epi in (("mhat+g5", ("mhat", params.mutld, 1.0, k2, True)),
                               ("clov_mhat+g5", ("clov_mhat", k2, True))):
                kw = dict(epi=epi, gcomp=fgb.gcomp, **_epi_kw(epi, psi_o, blocks))
                n = 200 if lat is lat16 else 50
                ms = _time_ms(lambda: dc.hopping_split(fgb.ug_odd, psi, 1, lat, **kw), n)
                pms = _time_ms(lambda: dc.hopping_split_plain(fgb.ug_odd, psi, 1, lat, **kw),
                               max(n // 10, 5))
                site_bytes, site_flops = _model(epi, gbytes)
                nbytes = site_bytes * sites
                bound = _bound_ms(nbytes, site_flops * sites)
                f32_ms = rows[(tag, gname, vname)][0]
                rows[(tag, "K1-B", gname, vname)] = (ms, pms, *bound, f32_ms)
                _say(f"[time] K1-B {tag} {gname} {vname:12s}: kernel {ms * 1e3:9.1f} us "
                     f"({site_flops * sites / (ms * 1e-3) / 1e9:7.1f} GF/s, "
                     f"{nbytes / (ms * 1e-3) / bw:6.1%} of copy bandwidth at "
                     f"{nbytes / sites:.0f} B/site, bound {bound[0] * 1e3:.1f} us by {bound[1]}, "
                     f"{nbytes / bw * 1e6:.1f} us at copy bandwidth)  f32 K1 {f32_ms * 1e3:9.1f} "
                     f"us ({f32_ms / ms:4.2f}x)  plain {pms * 1e3:10.1f} us")
        if lat is lat16:
            ms = _time_ms(lambda: dc.hopping_ug_vjp(g, psi, 0, lat), 200)
            pms = _time_ms(lambda: dc.hopping_ug_vjp_plain(g, psi, 0, lat), 20)
            nbytes = (2 * 96 + 576) * sites
            bound = _bound_ms(nbytes, FLOPS_SITE_K2 * sites)
            _say(f"[time] K2 {tag}: kernel {ms * 1e3:9.1f} us ({nbytes / (ms * 1e-3) / bw:6.1%} "
                 f"of copy bandwidth at {nbytes / sites:.0f} B/site, bound {bound[0] * 1e3:.1f} us "
                 f"by {bound[1]}, {nbytes / bw * 1e6:.1f} us at copy bandwidth)  "
                 f"plain {pms * 1e3:10.1f} us ({pms / ms:5.1f}x)")
            rows[(tag, "K2")] = (ms, pms, *bound)
        # K1-R at R = 12 beside 12 launches of K1 on the same fields
        gen = torch.Generator(device="cuda").manual_seed(13)
        shape = (2, 4, 3, NRHS) + lat.eo_site_shape
        psis = torch.randn(shape, generator=gen, device="cuda")
        psis_o = torch.randn(shape, generator=gen, device="cuda")
        cols = [(psis[:, :, :, r].contiguous(), psis_o[:, :, :, r].contiguous())
                for r in range(NRHS)]
        for gname, fg, gbytes, vname, epi in (
                ("12-real", fg12, 384, "mhat+g5", ("mhat", params.mutld, 1.0, k2, True)),
                ("18-real", fg18, 576, "none", ("none",)),
                ("12-real", fg12, 384, "clov_inv", ("clov_inv",)),
                ("12-real", fg12, 384, "clov_mhat+g5", ("clov_mhat", k2, True))):
            kw = dict(epi=epi, gcomp=fg.gcomp)
            n = 100 if lat is lat16 else 20

            def k1_loop():
                for c, co in cols:
                    dc.hopping_split(fg.ug_odd, c, 1, lat, **kw, **_epi_kw(epi, co, blocks))

            def k1r():
                return dc.hopping_split_rhs(fg.ug_odd, psis, 1, lat, r_axis=3, **kw,
                                            **_epi_kw(epi, psis_o, blocks))

            # at 32^3x64 K1-R walks the sites t-blocked: hold that order
            # against K1 too (phase 2 ran the memory order)
            out = k1r()
            for r in (0, NRHS - 1):
                one = dc.hopping_split(fg.ug_odd, cols[r][0], 1, lat, **kw,
                                       **_epi_kw(epi, cols[r][1], blocks))
                err, rel = _rel_err(out[:, :, :, r], one)
                _check(rel <= KERNEL_RTOL, f"K1-R {tag} {gname} {vname} column {r} differs from "
                                           f"K1 by {err:.3e}")
            del out, one
            ms = _time_ms(k1r, n)
            ms1 = _time_ms(k1_loop, max(n // 4, 5))
            pms = float("nan")
            if lat is lat16:
                pms = _time_ms(lambda: dc.hopping_split_rhs_plain(
                    fg.ug_odd, psis, 1, lat, **kw, **_epi_kw(epi, psis_o, blocks)), 5)
            site_bytes, site_flops = _model(epi, gbytes, NRHS)
            nbytes = site_bytes * sites
            bound = _bound_ms(nbytes, site_flops * sites)
            gfs = site_flops * sites / (ms * 1e-3) / 1e9
            rows[(tag, "K1-R", gname, vname)] = (ms, pms, *bound, ms1)
            _say(f"[time] K1-R {tag} R={NRHS} {gname} {vname:12s}: kernel {ms * 1e3:9.1f} us "
                 f"({gfs:7.1f} GF/s, {nbytes / (ms * 1e-3) / bw:6.1%} of copy bandwidth at "
                 f"{nbytes / sites:.0f} B/site, bound {bound[0] * 1e3:.1f} us by {bound[1]}, "
                 f"{nbytes / bw * 1e6:.1f} us at copy bandwidth)  "
                 f"{NRHS} x K1 {ms1 * 1e3:9.1f} us ({ms1 / ms:4.2f}x)  plain {pms * 1e3:10.1f} us")
        # K1-R-D (flavour doublet, epilogue none) beside 2 launches of K1
        chi = torch.randn((2, 2, 4, 3) + lat.eo_site_shape, generator=gen, device="cuda")
        fl = [chi[:, f].contiguous() for f in range(2)]
        for gname, fg, gbytes in (("18-real", fg18, 576), ("12-real", fg12, 384)):
            n = 200 if lat is lat16 else 50

            def k1rd():
                return dc.hopping_split_rhs(fg.ug_odd, chi, 1, lat, gcomp=fg.gcomp, r_axis=1)

            def k1_pair():
                for c in fl:
                    dc.hopping_split(fg.ug_odd, c, 1, lat, gcomp=fg.gcomp)

            out = k1rd()
            for f in range(2):
                one = dc.hopping_split(fg.ug_odd, fl[f], 1, lat, gcomp=fg.gcomp)
                _check(bool(torch.equal(out[:, f], one)),
                       f"K1-R-D {tag} {gname} flavour {f} differs from K1")
            del out, one
            ms = _time_ms(k1rd, n)
            ms1 = _time_ms(k1_pair, n)
            pms = float("nan")
            if lat is lat16:
                pms = _time_ms(lambda: dc.hopping_split_rhs_plain(
                    fg.ug_odd, chi, 1, lat, gcomp=fg.gcomp, r_axis=1), 20)
            site_bytes, site_flops = _model(("none",), gbytes, 2)
            nbytes = site_bytes * sites
            bound = _bound_ms(nbytes, site_flops * sites)
            gfs = site_flops * sites / (ms * 1e-3) / 1e9
            rows[(tag, "K1-R-D", gname)] = (ms, pms, *bound, ms1)
            _say(f"[time] K1-R-D {tag} R=2 {gname} none        : kernel {ms * 1e3:9.1f} us "
                 f"({gfs:7.1f} GF/s, {nbytes / (ms * 1e-3) / bw:6.1%} of copy bandwidth at "
                 f"{nbytes / sites:.0f} B/site, bound {bound[0] * 1e3:.1f} us by {bound[1]}, "
                 f"{nbytes / bw * 1e6:.1f} us at copy bandwidth)  "
                 f"2 x K1 {ms1 * 1e3:9.1f} us ({ms1 / ms:4.2f}x)  plain {pms * 1e3:10.1f} us")
        del params, fg18, fg12, psi, psi_o, g, psis, psis_o, cols, blocks, chi, fl, sloppy
        torch.cuda.empty_cache()
    return rows, bw


def phase_k1_split(lat16, lat32, bw: float):
    """K1's device time apart from its host time: K1 (12-real f32, mhat+g5),
    K1-B (the same on the bf16 copy) and K1-C (clov_mhat+g5) at 16^3x32 and
    32^3x64, each timed as phase 3 times it (CUDA events around a loop of
    wrapper calls), on the host's clock (the enqueue alone), on the device
    (torch.profiler's kernel intervals) and as a CUDA graph of the launches;
    each instance's registers and resident blocks per SM; then one Qhat_pm
    (Qsw_pm, and Qhat_pm on the bf16 copy) as one K1-S launch beside the four
    K1 launches it replaces, in turns, and K1-S's instances."""
    from tmlqcd_tpu_torch.ops import dslash_cuda as dc

    rows = {}
    for lat in (lat16, lat32):
        tag = "x".join(map(str, lat.dims[::-1][:3])) + f"x{lat.dims[0]}"
        params, _, fg12, psi, psi_o, _, sloppy = _fields(lat, "cuda", 12)
        blocks = _random_blocks(lat, "cuda", 17)
        sites = lat.volume // 2
        k2 = params.kappa ** 2
        n = 200 if lat is lat16 else 50
        mhat = ("mhat", params.mutld, 1.0, k2, True)
        for name, fg, gbytes, epi in (("K1", fg12, 384, mhat),
                                      ("K1-B", sloppy["12-real"], 192, mhat),
                                      ("K1-C", fg12, 384, ("clov_mhat", k2, True))):
            kw = dict(epi=epi, gcomp=fg.gcomp, **_epi_kw(epi, psi_o, blocks))

            def fn(fg=fg, kw=kw, lat=lat):
                return dc.hopping_split(fg.ug_odd, psi, 1, lat, **kw)

            loop = _time_ms(fn, n)
            host = _host_ms(fn, n)
            dev, seen, _ = _device_ms(fn, n, "hopping_kernel")
            graph = _graph_ms(fn, n)
            info = dc.kernel_info(epi, True, name == "K1-B")
            site_bytes, site_flops = _model(epi, gbytes)
            bound = _bound_ms(site_bytes * sites, site_flops * sites)
            share = site_bytes * sites / (dev * 1e-3) / bw
            rows[(tag, name)] = dict(loop=loop, host=host, device=dev, graph=graph,
                                     bound=bound[0], share=share, **info)
            _say(f"[split] {name:4s} {tag} 12-real {epi[0]}+g5: wrapper loop {loop * 1e3:7.1f} us, "
                 f"host {host * 1e3:6.1f} us/call, device {dev * 1e3:7.1f} us ({seen} kernels "
                 f"profiled), graph {graph * 1e3:7.1f} us, bound {bound[0] * 1e3:.1f} us by "
                 f"{bound[1]} ({site_bytes} B/site; device time {share:.1%} of copy "
                 f"bandwidth); {info['registers']} registers, {info['local_bytes']} B of local "
                 f"memory, "
                 f"{info['blocks_per_sm']} blocks of {info['threads']} per SM "
                 f"({info['blocks_per_sm'] * info['threads'] // 32} warps of 64), "
                 f"{-(-sites // info['threads'])} blocks in the grid")
        # one Qhat_pm (Qsw_pm): K1-S beside the four K1 launches it replaces,
        # in turns (K1 x 4, K1-S, K1-S, K1 x 4); the bound is the four hops'
        # byte models summed
        blks = [_random_blocks(lat, "cuda", 60 + i) for i in range(4)]
        for name, fg, gbytes, kind in (("Qhat_pm", fg12, 384, "tm"),
                                       ("Qhat_pm bf16", sloppy["12-real"], 192, "tm"),
                                       ("Qsw_pm", fg12, 384, "clover")):
            stages = _schur_stages(params, kind, (1.0, -1.0), True, blks)

            def by_k1(fg=fg, stages=stages, lat=lat):
                return _schur_by_k1(dc, fg, psi, lat, stages)

            def by_k1s(fg=fg, stages=stages, lat=lat):
                return dc.hopping_schur(fg.ug_even, fg.ug_odd, psi, lat, stages, fg.gcomp)

            times = {"K1 x 4": [], "K1-S": []}
            for label, fn in (("K1 x 4", by_k1), ("K1-S", by_k1s), ("K1-S", by_k1s),
                              ("K1 x 4", by_k1)):
                per_call = 2 * len(stages) if label == "K1 x 4" else 1
                times[label].append((_time_ms(fn, n), _host_ms(fn, n),
                                     _device_ms(fn, n, "hopping_", per_call)[0]))
            nbytes = sum(_model(epi, gbytes)[0] for st in stages for epi in st[:2]) * sites
            flops = sum(_model(epi, gbytes)[1] for st in stages for epi in st[:2]) * sites
            bound = _bound_ms(nbytes, flops)
            pms = (_time_ms(lambda fg=fg, stages=stages, lat=lat: dc.hopping_schur_plain(
                fg.ug_even, fg.ug_odd, psi, lat, stages, fg.gcomp), max(n // 20, 3))
                   if lat is lat16 else float("nan"))
            best = {k: tuple(min(r[i] for r in v) for i in range(3)) for k, v in times.items()}
            rows[(tag, name)] = dict(
                loop=best["K1-S"][0], host=best["K1-S"][1], device=best["K1-S"][2],
                k1_loop=best["K1 x 4"][0], k1_host=best["K1 x 4"][1],
                k1_device=best["K1 x 4"][2], bound=bound[0], bound_by=bound[1], plain=pms,
                share=nbytes / (best["K1-S"][2] * 1e-3) / bw)
            fmt = lambda v: ", ".join(f"{x * 1e3:.1f}" for x in v)  # noqa: E731
            _say(f"[split] {name:12s} {tag} 12-real: K1-S wrapper loop "
                 f"{fmt(r[0] for r in times['K1-S'])} us, host {fmt(r[1] for r in times['K1-S'])}"
                 f" us, device {fmt(r[2] for r in times['K1-S'])} us; four K1 launches wrapper "
                 f"loop {fmt(r[0] for r in times['K1 x 4'])} us, host "
                 f"{fmt(r[1] for r in times['K1 x 4'])} us, device "
                 f"{fmt(r[2] for r in times['K1 x 4'])} us; bound {bound[0] * 1e3:.1f} us by "
                 f"{bound[1]} ({nbytes // sites} B/site, K1-S device time "
                 f"{rows[(tag, name)]['share']:.1%} of copy bandwidth); plain {pms * 1e3:.1f} us")
        for clover in (False, True):
            for bf16 in (False, True):
                info = dc.schur_kernel_info(clover, True, True, bf16)
                _say(f"[split] K1-S instance {'clover' if clover else 'tm'} g5 12-real "
                     f"{'bf16' if bf16 else 'f32'}: {info['registers']} "
                     f"registers, {info['local_bytes']} B of local memory, {info['blocks_per_sm']} "
                     f"blocks of {info['threads']} per SM, a resident grid of "
                     f"{info['blocks_per_sm'] * _sm_count()} blocks")
        del params, fg12, psi, psi_o, sloppy, blocks, blks
        import torch

        torch.cuda.empty_cache()
    return rows


def _slab_model(lat, mesh, variant: str, gbytes: int, nrhs: int = 1,
                yhalo: bool = True) -> tuple[int, int]:
    """(bytes, flops) of one slab-kernel launch over all slabs: each input
    read once (the psi rows the variant's stencil reaches, its halo buffers,
    the links of its sites) and each output written once; 96 B per spinor
    site and column, 1320 flops per site and column.  K1-T (`yhalo` False)
    reads no y halo."""
    tl, xx, _, _ = mesh.local(lat).dims
    tsh, msh, zh = mesh.t, mesh.y, lat.zh
    row = xx * lat.m  # sites of one timeslice of the whole lattice
    yrow = xx * msh * zh  # y-halo sites of one timeslice (both sides: x 2)
    if variant == "int":
        sites, psi_rows, halo = tsh * (tl - 2) * row, tsh * tl, 2 * tsh * (tl - 2) * yrow
    elif variant == "all":
        sites, psi_rows, halo = tsh * tl * row, tsh * tl, 2 * tsh * row + 2 * tsh * tl * yrow
    elif variant == "bnd":
        sites, psi_rows, halo = 2 * tsh * row, tsh * min(4, tl), 2 * tsh * row + 4 * tsh * yrow
    else:  # "ext": K3 and K1-T
        sites, psi_rows, halo = tsh * tl * row, tsh * (tl + 2), 2 * tsh * tl * yrow * yhalo
    nbytes = sites * gbytes + nrhs * 96 * (psi_rows * row + halo + sites)
    return nbytes, nrhs * FLOPS_SITE * sites


def phase_shard_timings(lat16, lat32, bw: float):
    """One sharded hop on the (4, 2) mesh in pieces (the y exchange, the t
    pack, K3-I, K4, the whole hop with the overlap, K3 without it) beside K1
    on the whole lattice, at 16^3x32 and 32^3x64, 12-real links; K1-T on 4 t
    slabs; K1-RB at R = 12 beside f32 K1-R."""
    import torch

    from tmlqcd_tpu_torch import parallel
    from tmlqcd_tpu_torch.ops import dslash_cuda as dc

    rows = {}
    mesh = parallel.Mesh(4, 2, device="cuda")
    for lat in (lat16, lat32):
        tag = "x".join(map(str, lat.dims[::-1][:3])) + f"x{lat.dims[0]}"
        params, fg18, fg12, psi, psi_o, _, sloppy = _fields(lat, "cuda", 33)
        n = 200 if lat is lat16 else 50
        ug, gc = fg12.ug_odd, fg12.gcomp
        mh = dc._y_halos(psi, lat, mesh)
        th, ext = dc._t_halos(psi, lat, mesh), dc._t_halos(psi, lat, mesh, ext=True)
        out = torch.empty_like(psi)
        k1 = _time_ms(lambda: dc.hopping_split(ug, psi, 1, lat, gcomp=gc), n)
        y_ms = _time_ms(lambda: dc._y_halos(psi, lat, mesh), n)
        t_ms = _time_ms(lambda: dc._t_halos(psi, lat, mesh), n)
        timed = {
            "K3-I": ("int", lambda: dc.hopping_slab_split(ug, psi, 1, lat, mesh, "int", out, mh=mh,
                                                          gcomp=gc)),
            "K4": ("bnd", lambda: dc.hopping_slab_split(ug, psi, 1, lat, mesh, "bnd", out, th=th,
                                                        mh=mh, gcomp=gc)),
            "K3": ("ext", lambda: dc.hopping_slab_split(ug, ext, 1, lat, mesh, "ext", out, mh=mh,
                                                        gcomp=gc)),
            "K3-I+K4": ("all", lambda: dc.hopping_slab_split(ug, psi, 1, lat, mesh, "all", out,
                                                             th=th, mh=mh, gcomp=gc)),
        }
        parts = {}
        for name, (variant, fn) in timed.items():
            ms = _time_ms(fn, n)
            plain = dc.hopping_slab_split_plain
            pms = _time_ms(lambda: plain(ug, ext if variant == "ext" else psi, 1, lat, mesh,
                                         variant, out, th=th if variant in ("bnd", "all") else None,
                                         mh=mh, gcomp=gc), max(n // 10, 5))
            nbytes, flops = _slab_model(lat, mesh, variant, 384)
            bound = _bound_ms(nbytes, flops)
            parts[name] = ms
            rows[(tag, name)] = (ms, pms, *bound)
            _say(f"[time] {name:4s} {tag} mesh (4,2) 12-real: kernel {ms * 1e3:8.1f} us "
                 f"({nbytes / (ms * 1e-3) / bw:6.1%} of copy bandwidth at {nbytes / 1e6:.2f} MB, "
                 f"bound {bound[0] * 1e3:.1f} us by {bound[1]}, {nbytes / bw * 1e6:.1f} us at copy "
                 f"bandwidth)  plain {pms * 1e3:9.1f} us")
        whole = _time_ms(lambda: dc.hopping_shard(ug, psi, 1, lat, mesh, gcomp=gc), n)
        flat_mesh = dataclasses.replace(mesh, overlap=False)
        flat = _time_ms(lambda: dc.hopping_shard(ug, psi, 1, lat, flat_mesh, gcomp=gc), n)
        rows[(tag, "hop")] = (whole, flat, k1)
        _say(f"[time] sharded hop {tag} mesh (4,2): y exchange {y_ms * 1e3:.1f} us, t pack "
             f"{t_ms * 1e3:.1f} us, K3-I {parts['K3-I'] * 1e3:.1f} us, K4 {parts['K4'] * 1e3:.1f} "
             f"us, assembly 0 (both write the whole output); whole hop {whole * 1e3:.1f} us "
             f"(overlap), {flat * 1e3:.1f} us (K3, no overlap); K1 on the whole lattice "
             f"{k1 * 1e3:.1f} us ({whole / k1:.2f}x)")
        # K1-T on 4 t slabs
        tmesh = parallel.Mesh(4, 1, device="cuda")
        text = dc._t_halos(psi, lat, tmesh, ext=True)
        ms = _time_ms(lambda: dc.hopping_slab_split(ug, text, 1, lat, tmesh, "ext", out,
                                                    gcomp=gc), n)
        pms = _time_ms(lambda: dc.hopping_slab_split_plain(ug, text, 1, lat, tmesh, "ext", out,
                                                           gcomp=gc), max(n // 10, 5))
        nbytes, flops = _slab_model(lat, tmesh, "ext", 384, yhalo=False)
        bound = _bound_ms(nbytes, flops)
        rows[(tag, "K1-T")] = (ms, pms, *bound)
        _say(f"[time] K1-T {tag} 4 t slabs 12-real: kernel {ms * 1e3:8.1f} us "
             f"({nbytes / (ms * 1e-3) / bw:6.1%} of copy bandwidth, bound {bound[0] * 1e3:.1f} us "
             f"by {bound[1]})  plain {pms * 1e3:9.1f} us  K1 {k1 * 1e3:.1f} us")
        # K1-RB at R = 12 beside f32 K1-R, in turns
        gen = torch.Generator(device="cuda").manual_seed(34)
        psis = torch.randn((2, 4, 3, NRHS) + lat.eo_site_shape, generator=gen, device="cuda")
        psis_o = torch.randn_like(psis)
        k2 = params.kappa ** 2
        epi = ("mhat", params.mutld, 1.0, k2, True)
        fgb = sloppy["12-real"]
        kw = dict(epi=epi, psi_o=psis_o)
        f32_1 = _time_ms(lambda: dc.hopping_split_rhs(fg12.ug_odd, psis, 1, lat, gcomp=gc, **kw),
                         max(n // 2, 10))
        ms = _time_ms(lambda: dc.hopping_split_rhs(fgb.ug_odd, psis, 1, lat, gcomp=gc, **kw),
                      max(n // 2, 10))
        ms2 = _time_ms(lambda: dc.hopping_split_rhs(fgb.ug_odd, psis, 1, lat, gcomp=gc, **kw),
                       max(n // 2, 10))
        f32_2 = _time_ms(lambda: dc.hopping_split_rhs(fg12.ug_odd, psis, 1, lat, gcomp=gc, **kw),
                         max(n // 2, 10))
        pms = float("nan")
        if lat is lat16:
            pms = _time_ms(lambda: dc.hopping_split_rhs_plain(fgb.ug_odd, psis, 1, lat, gcomp=gc,
                                                              **kw), 5)
        site_bytes, site_flops = _model(epi, 192, NRHS)
        sites = lat.volume // 2
        bound = _bound_ms(site_bytes * sites, site_flops * sites)
        rows[(tag, "K1-RB")] = (min(ms, ms2), pms, *bound, min(f32_1, f32_2))
        _say(f"[time] K1-RB {tag} R={NRHS} 12-real mhat+g5: kernel {ms * 1e3:.1f}, "
             f"{ms2 * 1e3:.1f} us ({site_bytes * sites / (min(ms, ms2) * 1e-3) / bw:6.1%} of copy "
             f"bandwidth at {site_bytes} B/site, bound {bound[0] * 1e3:.1f} us by {bound[1]})  "
             f"f32 K1-R {f32_1 * 1e3:.1f}, {f32_2 * 1e3:.1f} us  plain {pms * 1e3:.1f} us")
        del params, fg18, fg12, psi, psi_o, sloppy, mh, th, ext, out, psis, psis_o, text
        torch.cuda.empty_cache()
    return rows


# bytes per site of one parity of the doublet Schur operator on the 12-real
# f32 copy: a hop of both flavours is 384 B of gauge + 2 x (96 read + 96
# written); the odd phase reads chi_o of both flavours (192 B) more; the
# clover doublet adds 3 (even) + 2 (odd) block fields of 576 B
ND_HOP_BYTES = 384 + 2 * (96 + 96)
ND_QND_BYTES = 2 * ND_HOP_BYTES + 2 * 96
ND_CLOVER_BYTES = 5 * BLOCK_BYTES


def _nd_fixture(lat, dev, seed, compress: bool = True):
    """The doublet operator's inputs at hmc3's NDRAT point (2Kappamubar =
    0.1315052, 2Kappaepsbar = 0.1351419, kappa = 0.1400645): a random gauge,
    its FastGauge (12- or 18-real), the FastCloverND of CSW 1.74 on it, and
    a doublet."""
    import torch

    from tmlqcd_tpu_torch import rng, su3
    from tmlqcd_tpu_torch.ops import clover as cl
    from tmlqcd_tpu_torch.ops import ndoublet as nd
    from tmlqcd_tpu_torch.ops import wilson_fast as wf

    two_k = 2 * 0.1400645
    ndp = nd.NDParams(kappa=0.1400645, mubar=0.1315052 / two_k, epsbar=0.1351419 / two_k)
    ndc = nd.NDParams(kappa=0.1400645, mubar=0.1315052 / two_k, epsbar=0.1351419 / two_k,
                      c_sw=1.74)
    u = su3.random_su3(rng.generator(rng.Key(seed), dev), (4,) + lat.site_shape)
    fg = wf.make_fast_gauge(u, ndp.wilson, lat, compress=compress)
    with torch.no_grad():
        sw_e, sw_o = cl.sw_blocks_eo(u, ndc.kappa, ndc.c_sw, lat)
    fc = wf.fast_clover_nd_from(fg, sw_e, sw_o, ndc)
    gen = torch.Generator(device=dev).manual_seed(seed)
    chi = torch.randn((2, 2, 4, 3) + lat.eo_site_shape, generator=gen, device=dev)
    return ndp, ndc, fg, fc, chi


def _nd_by_k1rd(dc, wf, op, chi, params, lat, clover: bool, square: bool):
    """Q_nd (Q_nd^2; clover forms) as composed before K1-SD: each hop one
    K1-R-D launch, the flavour diagonals in torch (`dslash_cuda._q_nd_by`
    on `hopping_split_rhs`, the composition K1-SD's plain version runs on
    its plain hop)."""
    fg = op.fg if clover else op
    stage = wf._nd_stage(params, op if clover else None)
    for _ in range(2 if square else 1):
        chi = dc._q_nd_by(dc.hopping_split_rhs, fg.ug_even, fg.ug_odd, chi, lat, stage, fg.gcomp)
    return chi


def _split3(fn, n: int, sub: str = "", per_call: int | None = None) -> tuple:
    """(wrapper loop, host, device) ms per call: CUDA events around a loop
    of calls, the host's clock around the enqueue alone, and the device
    time of `sub`'s intervals (`_device_ms`; by default every interval,
    kernels and copies, of a torch composite)."""
    return _time_ms(fn, n), _host_ms(fn, n), _device_ms(fn, n, sub, per_call)[0]


def _fmt_us(v) -> str:
    return ", ".join(f"{x * 1e3:.1f}" for x in v)


def phase_nd_shard_split(lat16, lat32, bw: float):
    """The doublet Schur operator and the sharded hop split into wrapper
    loop, host and device time (`_split3`), at 16^3x32 and 32^3x64, 12-real
    f32; K1-SD and KH (`dslash_cuda.hopping_schur_nd`, `halo_pack`) each
    beside the route it replaced, in turns (old, new, new, old).  Q_nd,
    Q_nd^2 and Q_nd^2 with clover; one sharded hop on the (4,2) mesh and its
    pieces (the y exchange, the t pack, K3-I, K4, KH).  Then the device time
    of every other slab and K1-R kernel and K2 by itself, and the instances
    (registers, blocks per SM) of K1-R-D, K1-SD, KH and the slab kernel."""
    import torch

    from tmlqcd_tpu_torch import parallel
    from tmlqcd_tpu_torch.ops import dslash_cuda as dc
    from tmlqcd_tpu_torch.ops import wilson_fast as wf

    rows = {}
    mesh = parallel.Mesh(4, 2, device="cuda")
    for lat in (lat16, lat32):
        tag = "x".join(map(str, lat.dims[::-1][:3])) + f"x{lat.dims[0]}"
        sites = lat.volume // 2
        n = 100 if lat is lat16 else 20
        ndp, ndc, fg, fc, chi = _nd_fixture(lat, "cuda", 70)
        for name, clover, square, site_bytes in (
                ("Q_nd", False, False, ND_QND_BYTES),
                ("Q_nd^2", False, True, 2 * ND_QND_BYTES),
                ("Q_nd^2 clover", True, True, 2 * (ND_QND_BYTES + ND_CLOVER_BYTES))):
            op, params = (fc, ndc) if clover else (fg, ndp)

            def composed(op=op, params=params, clover=clover, square=square, lat=lat):
                return _nd_by_k1rd(dc, wf, op, chi, params, lat, clover, square)

            fn = {(False, False): wf.q_nd_fast, (False, True): wf.q_nd_sq_fast,
                  (True, True): wf.q_nd_sq_clover_fast}[(clover, square)]

            def new(fn=fn, op=op, params=params, lat=lat):
                return fn(op, chi, params, lat)

            times = {}
            turns = [("composed", composed), ("K1-SD", new), ("K1-SD", new),
                     ("composed", composed)]
            for label, f in turns:  # K1-SD: one launch a call
                named = ("hopping_schur_nd", 1) if label == "K1-SD" else ()
                times.setdefault(label, []).append(_split3(f, n, *named))
            bound = _bound_ms(site_bytes * sites, 0.0)
            best = {k: tuple(min(r[i] for r in v) for i in range(3)) for k, v in times.items()}
            rows[(tag, name)] = dict(bound=bound[0], bound_by=bound[1],
                                     **{f"{k} {w}": best[k][i] for k in best
                                        for i, w in enumerate(("loop", "host", "device"))})
            if lat is lat16 and name == "Q_nd^2":
                stage = wf._nd_stage(params)
                rows[(tag, name)]["plain"] = _time_ms(
                    lambda: dc.hopping_schur_nd_plain(fg.ug_even, fg.ug_odd, chi, lat, stage,
                                                      fg.gcomp, square=True), 3)
            _say(f"[nd-split] {name:13s} {tag} 12-real: " + "; ".join(
                f"{k} loop {_fmt_us(r[0] for r in v)} us, host {_fmt_us(r[1] for r in v)} us, "
                f"device {_fmt_us(r[2] for r in v)} us" for k, v in times.items())
                 + f"; bound {bound[0] * 1e3:.1f} us ({site_bytes} B/site)")
        del fg, fc, chi
        # one sharded hop on the (4,2) mesh and its pieces
        params, _, fg12, psi, _, _, _ = _fields(lat, "cuda", 33)
        ug, gc = fg12.ug_odd, fg12.gcomp
        out = torch.empty_like(psi)
        mh = dc._y_halos(psi, lat, mesh)
        th = dc._t_halos(psi, lat, mesh)
        pieces = {
            "y exchange": lambda: dc._y_halos(psi, lat, mesh),
            "t pack": lambda: dc._t_halos(psi, lat, mesh),
            "K3-I": lambda: dc.hopping_slab_split(ug, psi, 1, lat, mesh, "int", out, mh=mh,
                                                  gcomp=gc),
            "K4": lambda: dc.hopping_slab_split(ug, psi, 1, lat, mesh, "bnd", out, th=th, mh=mh,
                                                gcomp=gc),
            "KH": lambda: dc.halo_pack(psi, lat, mesh),
        }
        named = {"K3-I": ("slab_kernel", 1), "K4": ("slab_kernel", 1), "KH": ("halo_kernel", 1)}
        for name, fn in pieces.items():
            rows[(tag, "shard " + name)] = _split3(fn, n, *named.get(name, ()))

        def glue_hop():
            return _shard_by_glue(dc, ug, psi, 1, lat, mesh, gc, None)

        def hop():
            return dc.hopping_shard(ug, psi, 1, lat, mesh, gc)

        times = {}
        turns = [("glue", glue_hop), ("KH", hop), ("KH", hop), ("glue", glue_hop)]
        for label, f in turns:
            times.setdefault(label, []).append(_split3(f, n))
        rows[(tag, "shard hop")] = {k: tuple(min(r[i] for r in v) for i in range(3))
                                    for k, v in times.items()}
        _say(f"[shard-split] {tag} mesh (4,2) 12-real: " + "; ".join(
            f"{k} loop / host / device {_fmt_us(v)} us" for k, v in
            ((k, rows[(tag, "shard " + k)]) for k in pieces)))
        _say(f"[shard-split] {tag} sharded hop: " + "; ".join(
            f"{k} loop {_fmt_us(r[0] for r in v)} us, host {_fmt_us(r[1] for r in v)} us, "
            f"device {_fmt_us(r[2] for r in v)} us" for k, v in times.items()))
        # KH's bound: each halo site and column read once (96 B) and written
        # once (96 B)
        halo_sites = 2 * lat.dims[0] * lat.dims[1] * mesh.y * lat.zh + 2 * mesh.t * (
            lat.dims[1] * lat.m)
        kh_bound = _bound_ms(192 * halo_sites, 0.0)
        kh_plain = _time_ms(lambda: (dc._y_halos(psi, lat, mesh), dc._t_halos(psi, lat, mesh)), n)
        rows[(tag, "KH")] = rows[(tag, "shard KH")] + (kh_bound[0], kh_bound[1], kh_plain)
        _say(f"[shard-split] KH {tag} mesh (4,2): {halo_sites} halo sites, bound "
             f"{kh_bound[0] * 1e3:.2f} us ({192 * halo_sites / 1e6:.2f} MB); plain "
             f"{kh_plain * 1e3:.1f} us")
        # the device time of the other kernels, each by itself
        k2 = params.kappa ** 2
        gen = torch.Generator(device="cuda").manual_seed(71)
        psis = torch.randn((2, 4, 3, NRHS) + lat.eo_site_shape, generator=gen, device="cuda")
        psis_o = torch.randn_like(psis)
        blocks = _random_blocks(lat, "cuda", 72)
        mhat = ("mhat", params.mutld, 1.0, k2, True)
        cmhat = ("clov_mhat", k2, True)
        chi = torch.randn((2, 2, 4, 3) + lat.eo_site_shape, generator=gen, device="cuda")
        tmesh = parallel.Mesh(4, 1, device="cuda")
        text = dc._t_halos(psi, lat, tmesh, ext=True)
        ext = dc._t_halos(psi, lat, mesh, ext=True)
        g = torch.randn_like(psi)
        sloppy = wf.sloppy_gauge(fg12)
        solo = {
            "1R K1-R R=12 mhat+g5": (lambda: dc.hopping_split_rhs(
                ug, psis, 1, lat, epi=mhat, psi_o=psis_o, gcomp=gc), "hopping_rhs_kernel"),
            "1RC K1-RC R=12 clov_mhat+g5": (lambda: dc.hopping_split_rhs(
                ug, psis, 1, lat, epi=cmhat, psi_o=psis_o, gcomp=gc, blocks=blocks),
                "hopping_rhs_kernel"),
            "1D K1-R-D": (lambda: dc.hopping_split_rhs(ug, chi, 1, lat, gcomp=gc, r_axis=1),
                          "hopping_rhs_kernel"),
            "1R-B K1-RB R=12 mhat+g5": (lambda: dc.hopping_split_rhs(
                sloppy.ug_odd, psis, 1, lat, epi=mhat, psi_o=psis_o, gcomp=gc),
                "hopping_rhs_kernel"),
            "3 K1-T 4 t slabs": (lambda: dc.hopping_slab_split(ug, text, 1, lat, tmesh, "ext", out,
                                                               gcomp=gc), "slab_kernel"),
            "4 K3 (4,2)": (lambda: dc.hopping_slab_split(ug, ext, 1, lat, mesh, "ext", out, mh=mh,
                                                         gcomp=gc), "slab_kernel"),
            "5 K3-I (4,2)": (pieces["K3-I"], "slab_kernel"),
            "6 K4 (4,2)": (pieces["K4"], "slab_kernel"),
            "6B K3-I+K4 (4,2)": (lambda: dc.hopping_slab_split(ug, psi, 1, lat, mesh, "all", out,
                                                               th=th, mh=mh, gcomp=gc),
                                 "slab_kernel"),
            "7 K2": (lambda: dc.hopping_ug_vjp(g, psi, 0, lat), "ug_vjp_kernel"),
        }
        for name, (fn, sub) in solo.items():
            dev, seen, _ = _device_ms(fn, n, sub)
            rows[(tag, "device " + name)] = dev
            _say(f"[device] {name} {tag}: {dev * 1e3:.1f} us device ({seen} kernels profiled)")
        del params, fg12, psi, out, mh, th, psis, psis_o, blocks, chi, text, ext, g, sloppy
        torch.cuda.empty_cache()
    info = dc.rhs_kernel_info(("none",), True, False, 2)
    rows["K1-R-D info"] = info
    _say(f"[split] K1-R-D instance (hopping_rhs_kernel, epilogue none, 12-real f32, R = 2): "
         f"{info['registers']} registers, {info['local_bytes']} B of local memory, "
         f"{info['blocks_per_sm']} blocks of {info['threads']} per SM")
    for clover in (False, True):
        info = dc.schur_nd_kernel_info(clover, True)
        rows[f"K1-SD info {'clover' if clover else 'tm'}"] = info
        _say(f"[split] K1-SD instance {'clover' if clover else 'tm'} 12-real f32: "
             f"{info['registers']} registers, {info['local_bytes']} B of local memory, "
             f"{info['blocks_per_sm']} blocks of {info['threads']} per SM, a resident grid "
             f"of {info['blocks_per_sm'] * _sm_count()} blocks")
    for name, what in (("KH", "KH (halo_kernel)"),
                       ("slab", "K4 and K3-I+K4 (slab_kernel, 12-real f32, one spinor)")):
        info = dc.slab_kernel_info(name)
        rows[f"{name} info"] = info
        _say(f"[split] {what} instance: {info['registers']} registers, "
             f"{info['local_bytes']} B of local memory, {info['blocks_per_sm']} blocks of "
             f"{info['threads']} per SM")
    return rows


def _shard_by_glue(dc, ug, psi, p, lat, mesh, gcomp, r_axis):
    """The sharded hop as routed before KH: the y halos by the torch
    exchange (`_y_halos`), K3-I on a side stream while the t halos are
    packed (`_t_halos`), then K4."""
    import torch

    out = torch.empty_like(psi)
    mh = dc._y_halos(psi, lat, mesh, mesh.halfspinor, r_axis)
    if not hasattr(_shard_by_glue, "side"):
        _shard_by_glue.side = torch.cuda.Stream()
    side = _shard_by_glue.side
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        dc.hopping_slab_split(ug, psi, p, lat, mesh, "int", out, mh=mh, gcomp=gcomp,
                              r_axis=r_axis)
    th = dc._t_halos(psi, lat, mesh, mesh.halfspinor, r_axis)
    dc.hopping_slab_split(ug, psi, p, lat, mesh, "bnd", out, th=th, mh=mh, gcomp=gcomp,
                          r_axis=r_axis)
    torch.cuda.current_stream().wait_stream(side)
    return out


# ---------------------------------------------------------------------------
# phase 4
# ---------------------------------------------------------------------------


NDRAT_PARITY_INPUT = """L = 8
T = 8
beta = 5.3
tau = 1.0
NumberOfTimescales = 2
BeginMonomial GAUGE
  Timescale = 0
  IntegrationSteps = 2
EndMonomial
BeginMonomial NDRAT
  Timescale = 1
  kappa = 0.13
  2Kappamubar = 0.1
  2Kappaepsbar = 0.12
  DegreeOfRational = 10
  StildeMin = 0.01
  StildeMax = 4.7
  AcceptancePrecision = 1e-20
  ForcePrecision = 1e-20
  MaxSolverIterations = 1000
  IntegrationSteps = 2
EndMonomial
"""


# hmc4's action at 8^4 (SFGAUGE, beta 8, 10 steps of 2MN), from the
# classical background at eta = 0 (a hot start at beta 8 is far from it)
SF_PARITY_INPUT = """L = 8
T = 8
beta = 8.0
tau = 1.0
BeginMonomial SFGAUGE
  Eta = 0.0
  Nu = 0.0
  Ct = 1.0
  Timescale = 0
  IntegrationSteps = 10
EndMonomial
"""


# The stopping tolerance of the parity trajectories with a mixed solver:
# |r| <= 1e-7 |b| (precision 1e-14) for twisted mass and 3e-7 for clover,
# just above where the true residual of f32 fields floors; below it the
# defect correction runs to its 50 outer steps on every solve (measured on an
# H100 at 8^4: the clover trajectory at 1e-7 took 600 inner iterations per
# acceptance solve, and its plain path on the CPU six minutes).
MIXED_TOL = 1e-7
MIXED_TOL_CLOVER = 3e-7


def _with_solver(cfg, solver: str):
    """`cfg` with `Solver = solver` on every monomial that solves."""
    import dataclasses

    return dataclasses.replace(cfg, monomials=tuple(
        dataclasses.replace(m, solver=solver) if hasattr(m, "solver") else m
        for m in cfg.monomials))


def _with_mesh(cfg, mesh):
    """`cfg` with every solving monomial (and the config) on `mesh`."""
    import dataclasses

    return dataclasses.replace(cfg, mesh=mesh, monomials=tuple(
        dataclasses.replace(m, mesh=mesh) if hasattr(m, "mesh") else m for m in cfg.monomials))


# Phase 4's points (keyword arguments of `phase_parity`) in the order they
# run on the card.  Their CPU halves take ~190 s one after another, each
# mostly on one core at 8^4, so they run beside the card halves in
# PARITY_WORKERS processes of PARITY_THREADS threads each, the slowest first
PARITY_POINTS = ({}, {"clover": True}, {"ndrat": True}, {"solver": "mixedcg"},
                 {"clover": True, "solver": "mixedcg"}, {"mesh_shape": (2, 2)},
                 {"clover": True, "mesh_shape": (2, 2)}, {"ndrat": True, "mesh_shape": (2, 2)},
                 {"sf": True})
PARITY_ORDER = (6, 1, 4, 7, 2, 5, 3, 0, 8)  # the CPU halves by their time, longest first
PARITY_WORKERS = 4
PARITY_THREADS = 2


def _parity_setup(dims=(8, 8, 8, 8), devs=("cuda", "cpu"), clover=False, ndrat=False,
                  solver=None, mesh_shape=None, sf=False):
    """The configuration, the runs and the draws of one parity point, made
    on the host from fixed keys (the same in every process)."""
    import types

    from tmlqcd_tpu_torch import parallel, rng, su3
    from tmlqcd_tpu_torch.lattice import Lattice
    from tmlqcd_tpu_torch.models.suites import nf2_twisted_mass_hasenbusch

    lat = Lattice(dims)
    if clover:
        from tmlqcd_tpu_torch.config import build_hmc
        from tmlqcd_tpu_torch.config_tmlqcd import parse_input

        prec = "1e-20" if solver is None else f"{MIXED_TOL_CLOVER ** 2:.0e}"
        with open(SAMPLE_CLOVER) as f:
            cfg = build_hmc(parse_input(clover_smoke_input(
                f.read(), dims=dims, steps={"GAUGE": "1", "CLOVERDET": "1", "CLOVERDETRATIO": "2"},
                precisions=(prec, prec))))
        bound, tag = DDH_BOUND_CLOVER, "clover "
    elif ndrat or sf:
        from tmlqcd_tpu_torch.config import build_hmc
        from tmlqcd_tpu_torch.config_tmlqcd import parse_input

        cfg = build_hmc(parse_input(SF_PARITY_INPUT if sf else NDRAT_PARITY_INPUT))
        bound, tag = (DDH_BOUND, "sf ") if sf else (DDH_BOUND_NDRAT, "ndrat ")
    else:
        tol = 1e-10 if solver is None else MIXED_TOL
        cfg = nf2_twisted_mass_hasenbusch(lat, beta=5.3, kappa=0.13, mu=0.01, mu_hasenbusch=0.1,
                                          steps=(1, 1, 2), acc_tol=tol, force_tol=tol,
                                          maxiter=1000)
        bound, tag = DDH_BOUND, ""
    _check(cfg.lat.dims == lat.dims, "parity input was not derived as intended")
    if mesh_shape is not None:
        cfg = _with_mesh(cfg, parallel.Mesh(*mesh_shape, device=devs[0]))
        tag += f"mesh {mesh_shape} "
    runs = [(dev, cfg) for dev in devs]
    if solver is not None:
        tag += f"{solver} "
        runs = [(dev, _with_solver(cfg, solver)) for dev in devs] + [("cg", cfg)]
    key = rng.Key(2024)
    if sf:
        from tmlqcd_tpu_torch.ops.sf import sf_classical_background

        _check(cfg.momenta_mask is not None, "SFGAUGE lowered without the momenta mask")
        u = sf_classical_background(lat, 0.0)
    else:
        u = su3.random_su3(rng.generator(key.fold(0), "cpu"), (4,) + lat.site_shape)
    p = rng.random_momenta(key.fold(1), u.shape[2:], "cpu")

    def eta_shape(m):
        if hasattr(m, "_eta_shape"):  # the rational monomials (a doublet for ND)
            return m._eta_shape()
        return (4, 3) + lat.eo_site_shape if hasattr(m, "chrono_init_state") else None

    etas = [None if eta_shape(m) is None else rng.normal_spinor(key.fold(2, i), eta_shape(m), "cpu")
            for i, m in enumerate(cfg.monomials)]
    uni = rng.uniform(key.fold(3), "cpu")
    return types.SimpleNamespace(lat=lat, runs=runs, tag=tag, bound=bound, key=key, u=u, p=p,
                                 etas=etas, uni=uni, sf=sf, devs=devs)


def _parity_traj(s, c, dev):
    """One trajectory of a parity point on `dev` -> (stats, frozen links
    unchanged (True unless SF), seconds)."""
    import torch

    from tmlqcd_tpu_torch.hmc import Draws, hmc_trajectory

    d = Draws(s.p.to(dev), [e if e is None else e.to(dev) for e in s.etas], s.uni)
    t0 = time.perf_counter()
    with torch.no_grad():
        u_out, st = hmc_trajectory(c, s.u.to(dev), s.key, draws=d)
    frozen = not s.sf or bool(torch.equal(u_out[:, :, 1:4, 0].cpu(), s.u[:, :, 1:4, 0]))
    return st, frozen, time.perf_counter() - t0


def _plain_half(kw: dict):
    """A worker process's job: the CPU half of the parity point `kw`."""
    import torch

    torch.set_num_threads(PARITY_THREADS)
    s = _parity_setup(**kw)
    st, frozen, sec = _parity_traj(s, dict(s.runs)["cpu"], "cpu")
    return tuple(st), frozen, sec


@contextlib.contextmanager
def _plain_halves():
    """The CPU halves of PARITY_POINTS submitted to worker processes (spawned:
    the card is never touched there), longest first; yields their futures
    in PARITY_POINTS order.  The workers are stopped on the way out, also
    when a check fails."""
    import concurrent.futures
    import multiprocessing

    pool = concurrent.futures.ProcessPoolExecutor(
        PARITY_WORKERS, mp_context=multiprocessing.get_context("spawn"))
    try:
        futs = {i: pool.submit(_plain_half, PARITY_POINTS[i]) for i in PARITY_ORDER}
        yield [futs[i] for i in range(len(PARITY_POINTS))]
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


def phase_parity(dims=(8, 8, 8, 8), devs=("cuda", "cpu"), clover=False, ndrat=False,
                 solver=None, mesh_shape=None, dh_whole=None, sf=False, cpu_half=None):
    """One trajectory on the kernel path and on the plain path with the same
    draws; returns (|ddH|, dH of the kernel path).  `sf`: hmc4's SFGAUGE
    action (pure gauge, no kernel: the card against the CPU) from the
    classical background, the frozen links checked bit-equal on both.  `solver` (mixedcg): the
    fermion monomials solve with it, at MIXED_TOL (MIXED_TOL_CLOVER), and the
    kernel path runs the trajectory with CG at the same tolerance as well,
    for |dH(solver) - dH(cg)|.  `mesh_shape`: every solve on the slab
    kernels of that (t, y) mesh; `dh_whole`, the kernel path's dH without a
    mesh, is held to the kernel path's dH on the mesh within `_mesh_bound`.
    `cpu_half`: a future of `_plain_half` for this point, whose result
    stands for the run on devs[1]."""
    from tmlqcd_tpu_torch.hmc import TrajectoryStats

    s = _parity_setup(dims, devs, clover, ndrat, solver, mesh_shape, sf)
    tag, lat = s.tag, s.lat
    res = {}
    for name, c in s.runs:
        dev = devs[0] if name == "cg" else name
        if cpu_half is not None and name == devs[-1]:
            st, frozen, sec = cpu_half.result()
            st, where = TrajectoryStats(*st), " in a worker process"
        else:
            (st, frozen, sec), where = _parity_traj(s, c, dev), ""
        res[name] = st
        _check(frozen, f"sf parity on {dev}: the frozen links moved")
        _say(f"[parity] {tag if name != 'cg' else ''}{lat.dims} trajectory on {dev}"
             f"{' with CG' if name == 'cg' else ''}: dH {st.delta_h:+.9e} plaq "
             f"{st.plaquette:.12f} acc_iters {st.acc_iterations} force_iters "
             f"{st.force_iterations} ({sec:.1f} s{where})")
    kern = res[devs[0]]
    _check(math.isfinite(kern.delta_h), "kernel-path dH is not finite")
    plain = res[devs[1]]
    ddh = abs(kern.delta_h - plain.delta_h)
    dplaq = abs(kern.plaquette - plain.plaquette)
    _say(f"[parity] {tag}|ddH| kernel vs plain {ddh:.3e} (bound {s.bound:.0e}), "
         f"|dplaq| {dplaq:.3e}")
    _check(ddh <= s.bound, f"{tag}kernel vs plain |ddH| {ddh:.3e} > {s.bound:.0e}")
    if solver is not None:
        tol = MIXED_TOL_CLOVER if clover else MIXED_TOL
        _say(f"[parity] {tag}|dH({solver}) - dH(cg)| on the kernel path at tol {tol:.0e}: "
             f"{abs(kern.delta_h - res['cg'].delta_h):.3e}")
    if ndrat:
        _check(kern.acc_iterations == plain.acc_iterations and 0 < kern.acc_iterations[1] < 1000,
               f"ndrat multishift iterations kernel {kern.acc_iterations} plain "
               f"{plain.acc_iterations}")
    if dh_whole is not None:
        dmesh, mbound = abs(kern.delta_h - dh_whole), _mesh_bound(kern, lat)
        _say(f"[parity] {tag}|dH(mesh) - dH(no mesh)| on the kernel path: {dmesh:.3e} (bound "
             f"{mbound:.3e})")
        _check(dmesh <= mbound, f"{tag}mesh vs no mesh |ddH| {dmesh:.3e} > {mbound:.3e}")
    return ddh, kern.delta_h


def _mesh_bound(st, lat) -> float:
    """|dH(mesh) - dH(no mesh)| of one f32 trajectory, derived in
    tests/test_torch_shard_hmc.py: the two runs round other f32 values, so
    H, an f64 sum of N = 8 x 4 x V terms, moves by ~eps |H| / sqrt(N); the
    bound is 10x that (a wrong halo moves dH by O(1))."""
    return 10 * 2.0 ** -24 * (abs(st.h_old) + abs(st.h_new)) / math.sqrt(8 * 4 * lat.volume)


# ---------------------------------------------------------------------------
# phase 5
# ---------------------------------------------------------------------------

MAXITER = 1000


def smoke_input(text: str) -> str:
    """hmc2-nf2-tm-hasenbusch with 3 trajectories, NSave = 3, the ONLINE
    measurement every 3rd trajectory and the physics point of
    bench/bench_traj.py for the monomials and the measurement (kappa = 0.13,
    2KappaMu = 0.0026, 2KappaMu2 = 0.026, steps 2/2/5, precisions 1e-16 /
    1e-14, MaxSolverIterations 1000): hmc2's own kappa = 0.163 from a hot
    start runs its solves to maxiter."""
    out, block = [], None
    for line in text.splitlines():
        s = line.split("#", 1)[0].strip()
        m = re.match(r"(?i)^BeginMonomial\s+(\S+)", s)
        if m:
            block = m.group(1).upper()
        elif re.match(r"(?i)^EndMonomial\b", s):
            block = None
        kv = re.match(r"^([A-Za-z0-9_]+)\s*=", s)
        key = kv.group(1).lower() if kv else None
        sub = {"measurements": "3", "nsave": "3", "kappa": "0.13", "frequency": "3",
               "acceptanceprecision": "1e-16", "forceprecision": "1e-14",
               "maxsolveriterations": str(MAXITER), "2kappamu2": "0.026"}
        if key == "2kappamu":
            sub["2kappamu"] = "0.026" if block == "DET" else "0.0026"
        if key == "integrationsteps":
            sub["integrationsteps"] = {"GAUGE": "2", "DET": "2", "DETRATIO": "5"}[block]
        if key in sub:
            line = line[:len(line) - len(line.lstrip())] + f"{kv.group(1)} = {sub[key]}"
        out.append(line)
    return "\n".join(out) + "\n"


def clover_smoke_input(text: str, dims=(32, 16, 16, 16), steps=None,
                       precisions=("1e-16", "1e-14"), ntraj: int = 3) -> str:
    """hmc6-nf2-clover-hasenbusch cut to `dims` (T, LX, LY, LZ) with `ntraj`
    trajectories, NSave = `ntraj`, the ONLINE measurement on the last of them,
    steps 2/2/5, precisions 1e-16 / 1e-14 and MaxSolverIterations 1000 as
    `smoke_input` sets them.  The physics point stays hmc6's own (beta =
    1.726, kappa = 0.1400645, CSW = 1.74, 2KappaMu = 0.0009 / 0.05): unlike
    hmc2's kappa it converges from a hot start and 1 + T stays invertible
    there.  Phase 7 checks the first (every solve below MaxSolverIterations)
    and prints the acceptance iterations; phase 8 prints and checks the
    smallest |det| of a chirality block on the checkpoint."""
    steps = steps or {"GAUGE": "2", "CLOVERDET": "2", "CLOVERDETRATIO": "5"}
    sub = {"t": str(dims[0]), "lx": str(dims[1]), "ly": str(dims[2]), "lz": str(dims[3]),
           "measurements": str(ntraj), "nsave": str(ntraj), "frequency": str(ntraj),
           "acceptanceprecision": precisions[0], "forceprecision": precisions[1],
           "maxsolveriterations": str(MAXITER)}
    out, block = [], None
    for line in text.splitlines():
        s = line.split("#", 1)[0].strip()
        m = re.match(r"(?i)^BeginMonomial\s+(\S+)", s)
        if m:
            block = m.group(1).upper()
        elif re.match(r"(?i)^EndMonomial\b", s):
            block = None
        kv = re.match(r"^([A-Za-z0-9_]+)\s*=", s)
        key = kv.group(1).lower() if kv else None
        value = steps.get(block) if key == "integrationsteps" else sub.get(key)
        if value is not None:
            line = line[:len(line) - len(line.lstrip())] + f"{kv.group(1)} = {value}"
        out.append(line)
    return "\n".join(out) + "\n"


def nf211_smoke_input(text: str, online_from: str | None = None) -> str:
    """hmc3-nf211-clover cut to 16^3x32 with 1 trajectory and NSave = 1.
    Its action stays its own: GAUGE + CLOVERTRLOG + CLOVERDET + NDRAT at
    beta = 1.726, kappa = 0.1400645, CSW = 1.74, 2KappaMu = 0.0009 / 0.05,
    2Kappamubar = 0.1315052, 2Kappaepsbar = 0.1351419, DegreeOfRational = 10
    on [0.01, 4.7], and so does its GRADIENTFLOW block (StepSize 0.02,
    Steps 50), its Frequency cut to 1 for the one trajectory.  Cut: the
    lattice (24^3x48), the number of trajectories, the integration steps
    (2/3/6 -> 2/2/3), the precisions and MaxSolverIterations (the other
    smoke points' 1e-16 / 1e-14 and 1000).  With `online_from` (hmc6's
    text) its ONLINE block stands in for GRADIENTFLOW: a package from before
    the flow's port (run with --root) cannot lower it."""
    if online_from is not None:
        online = re.search(r"(?ims)^BeginMeasurement\s+ONLINE.*?^EndMeasurement[^\n]*\n",
                           online_from)
        _check(online is not None, "no ONLINE block to take")
        text, n = re.subn(r"(?ims)^BeginMeasurement\s+GRADIENTFLOW.*?^EndMeasurement[^\n]*\n",
                          lambda _: online.group(0), text)
        _check(n == 1, "hmc3 holds no GRADIENTFLOW block to replace")
    return clover_smoke_input(text, steps={"GAUGE": "2", "CLOVERDET": "2", "NDRAT": "3"}, ntraj=1)


def _read_counts(dc) -> dict:
    slab = dc.hopping_slab_split.launches
    # K1-S and its hops (0 in a tree from before K1-S, run with --root)
    schur = getattr(dc, "hopping_schur", None)
    schur_plain = getattr(dc, "hopping_schur_plain", None)
    # K1-SD and KH (absent from a tree before them, run with --root)
    nd = getattr(dc, "hopping_schur_nd", None)
    nd_plain = getattr(dc, "hopping_schur_nd_plain", None)
    kh = getattr(dc, "halo_pack", None)
    # the kernels of a rank (absent from a tree before them, run with --root);
    # a rank's slab launches also count in hopping_slab_split's names
    rank = getattr(dc, "hopping_rank", None)
    rank = rank.launches if rank else {}
    faces = getattr(dc, "halo_faces", None)
    k2s = getattr(dc, "hopping_ug_vjp_slab", None)
    k2s_plain = getattr(dc, "hopping_ug_vjp_slab_plain", None)
    return {"K1": dc.hopping_split.launches, "K1-R": dc.hopping_split_rhs.launches,
            "K1-S": schur.launches if schur else 0, "K1-S hops": schur.hops if schur else 0,
            "K1-S clover hops": schur.clover_hops if schur else 0,
            "K1-S bf16 hops": schur.bf16_hops if schur else 0,
            "K1-S plain": schur_plain.calls if schur_plain else 0,
            "K1-C": dc.hopping_split.clover_launches,
            "K1-RC": dc.hopping_split_rhs.clover_launches,
            "K1-R-D": dc.hopping_split_rhs.doublet_launches,
            "K1-B": dc.hopping_split.bf16_launches,
            "K1-RB": dc.hopping_split_rhs.bf16_launches,
            "K3": slab["K3"] - rank.get("K3", 0), "K3-I": slab["K3-I"] - rank.get("K3-I", 0),
            "K4": slab["K4"] - rank.get("K4", 0), "K1-T": slab["K1-T"] - rank.get("K1-T", 0),
            "K3-I+K4": slab.get("K3-I+K4", 0) - rank.get("K3-I+K4", 0),
            "KH-P": faces.launches if faces else 0, "K3-I rank": rank.get("K3-I", 0),
            "K4 rank": rank.get("K4", 0), "K3-I+K4 rank": rank.get("K3-I+K4", 0),
            "K2-S": k2s.launches if k2s else 0,
            "K2-S plain": k2s_plain.calls if k2s_plain else 0,
            "K1-SD": nd.launches if nd else 0, "K1-SD hops": nd.hops if nd else 0,
            "K1-SD clover": nd.clover_launches if nd else 0,
            "KH": kh.launches if kh else 0,
            "K1-SD plain": nd_plain.calls if nd_plain else 0,
            "KH plain": getattr(kh, "plain_calls", 0),
            "slab R>0": dc.hopping_slab_split.rhs_launches,
            "K2": dc.hopping_ug_vjp.launches, "K1 plain": dc.hopping_split_plain.calls,
            "K1-R plain": dc.hopping_split_rhs_plain.calls,
            "K2 plain": dc.hopping_ug_vjp_plain.calls,
            "slab plain": dc.hopping_slab_split_plain.calls}


def _schur_ran(dc, counts: dict) -> bool:
    """K1-S ran on a path, where the tree has it (not in one from before
    K1-S, run with --root)."""
    return counts["K1-S"] > 0 or not hasattr(dc, "hopping_schur")


def _check_no_plain(counts: dict) -> None:
    plain = {k: v for k, v in counts.items() if k.endswith("plain")}
    _check(not any(plain.values()), f"a plain version served the main path: {counts}")


def _check_online(meas: str, tag: str) -> None:
    """The ONLINE measurement's file: 32 timeslices `1 1 t C_PP C_PA`, C_PP
    positive and finite."""
    _check(os.path.exists(meas), f"{os.path.basename(meas)} was not written")
    with open(meas) as f:
        rows = [ln.split() for ln in f if ln.strip()]
    cpp = [float(r[3]) for r in rows]
    _check(len(rows) == 32 and all(r[:3] == ["1", "1", str(t)] for t, r in enumerate(rows)),
           f"{os.path.basename(meas)} has {len(rows)} lines or a wrong column layout")
    _check(all(math.isfinite(c) and c > 0.0 for c in cpp)
           and all(math.isfinite(float(r[4])) for r in rows),
           f"{os.path.basename(meas)}: C_PP must be positive and finite on every timeslice")
    _say(f"[{tag}] {os.path.basename(meas)}: 32 timeslices, C_PP(0) {cpp[0]:.6e}, "
         f"min C_PP {min(cpp):.6e}")


def _read_gradflow(path: str):
    """(t, t^2 E_plaq, t^2 E_clover) columns of a gradflow.NNNNNN file."""
    _check(os.path.exists(path), f"{os.path.basename(path)} was not written")
    with open(path) as f:
        head = f.readline()
        rows = [[float(v) for v in ln.split()] for ln in f if ln.strip()]
    _check(head == "# t t2E_plaq t2E_clover\n" and rows and all(len(r) == 3 for r in rows),
           f"{os.path.basename(path)} has a wrong layout")
    return [list(c) for c in zip(*rows)]


def _check_gradflow(path: str, tag: str, flow_s: list) -> None:
    """hmc3's GRADIENTFLOW file: 50 steps of 0.02, t^2 E finite and
    positive, E_plaq = t^2 E / t^2 falling at every step (the Wilson flow is
    the gradient flow of the Wilson action, which E_plaq is up to a
    constant; E_clover of a rough field may rise at first, as the clover
    leaves line up); t0 where t^2 E_plaq reaches 0.3, if it does."""
    from tmlqcd_tpu_torch.meas.gradient_flow import t0_scale

    times, t2p, t2c = _read_gradflow(path)
    _check(len(times) == 50 and abs(times[-1] - 1.0) < 1e-9,
           f"{os.path.basename(path)}: {len(times)} flow steps to t = {times[-1]}")
    _check(all(math.isfinite(v) and v > 0 for v in t2p + t2c),
           f"{os.path.basename(path)}: t^2 E must be finite and positive")
    e = [v / t**2 for t, v in zip(times, t2p)]
    _check(all(b < a for a, b in zip(e, e[1:])), f"E_plaq does not fall monotonically: {e}")
    t0 = t0_scale(times, t2p, 0.3)
    _say(f"[{tag}] {os.path.basename(path)}: {len(times)} steps of 0.02 in "
         f"{sum(flow_s):.3f} s ({len(flow_s)} flow); t^2 E_plaq {t2p[0]:.6e} at t = "
         f"{times[0]:.2f}, {t2p[-1]:.6e} at t = {times[-1]:.2f}; t^2 E_clover {t2c[0]:.6e}, "
         f"{t2c[-1]:.6e}; " + (f"t0 = {t0:.6f} (t^2 E_plaq = 0.3)" if math.isfinite(t0)
                               else "t^2 E_plaq does not reach 0.3 by t = 1"))


def phase_main_path(workdir: str, clover: bool = False, nf211: bool = False):
    import numpy as np

    from tmlqcd_tpu_torch.cli import hmc as cli
    from tmlqcd_tpu_torch.config_tmlqcd import read_input
    from tmlqcd_tpu_torch.io.checkpoint import load_checkpoint
    from tmlqcd_tpu_torch.io.lime import read_lime
    from tmlqcd_tpu_torch.ops import dslash_cuda as dc

    from tmlqcd_tpu_torch.meas import runner

    tag = "main-nf211" if nf211 else "main-clover" if clover else "main"
    with open(SAMPLE_NF211 if nf211 else SAMPLE_CLOVER if clover else SAMPLE) as f:
        text = f.read()
    # hmc3's own GRADIENTFLOW block, where the package carries the flow
    flow = nf211 and "GRADIENTFLOW" in runner.PORTED
    if nf211:
        with open(SAMPLE_CLOVER) as f:
            text = nf211_smoke_input(text, None if flow else f.read())
    else:
        text = clover_smoke_input(text, ntraj=1) if clover else smoke_input(text)
    path = os.path.join(workdir, f"{tag}.input")
    with open(path, "w") as f:
        f.write(text)
    cfg = read_input(path)
    ntraj = 1 if clover or nf211 else 3
    online = (("GRADIENTFLOW", 1, 0.0, 0.0) if flow
              else ("ONLINE", ntraj, 0.1400645, 0.0009) if clover or nf211
              else ("ONLINE", 3, 0.13, 0.0026))
    types = (["GAUGE", "CLOVERTRLOG", "CLOVERDET", "NDRAT"] if nf211
             else ["GAUGE", "CLOVERTRLOG", "CLOVERDET", "CLOVERDETRATIO"] if clover
             else ["GAUGE", "DET", "DETRATIO"])
    csw = [m.csw for m in cfg.monomials[1:]]
    _check(cfg.lat.dims == (32, 16, 16, 16) and cfg.measurements == ntraj
           and [(m.type, m.frequency, m.kappa, m.two_kappa_mu) for m in cfg.meas] == [online]
           and [m.type for m in cfg.monomials] == types
           and csw == ([1.74, 1.74, 0.0] if nf211 else [1.74 if clover else 0.0] * len(csw)),
           "smoke input was not derived as intended")
    _check(not flow or (cfg.meas[0].flow_eps, cfg.meas[0].flow_steps) == (0.02, 50),
           "the GRADIENTFLOW block of the smoke input is not hmc3's")
    if nf211:
        ndrat = cfg.monomials[3]
        _check((ndrat.two_kappa_mubar, ndrat.two_kappa_epsbar, ndrat.rat_order, ndrat.stilde_min,
                ndrat.stilde_max, cfg.beta, ndrat.kappa)
               == (0.1315052, 0.1351419, 10, 0.01, 4.7, 1.726, 0.1400645),
               "the NDRAT block of the smoke input is not hmc3's")
    run_dir = os.path.join(workdir, f"run-{tag}")
    # the flow's seconds: a synchronising timer around the measurement's flow
    flow_s, wilson_flow = [], runner.wilson_flow

    def timed_flow(*a, **k):
        import torch

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = wilson_flow(*a, **k)
        torch.cuda.synchronize()
        flow_s.append(time.perf_counter() - t0)
        return res

    dc.reset_counters()
    log = io.StringIO()
    t0 = time.perf_counter()
    try:
        if flow:
            runner.wilson_flow = timed_flow
        with contextlib.redirect_stdout(log):
            rc = cli.main(["-f", path, "-o", run_dir, "--checkpoint-format", "ildg"])
    finally:
        if flow:
            runner.wilson_flow = wilson_flow
    wall = time.perf_counter() - t0
    counts = _read_counts(dc)
    sys.stdout.write(log.getvalue())
    _say(f"[{tag}] cli.hmc exit {rc}, {wall:.1f} s wall; launches {counts}")
    _check(rc == 0, f"cli.hmc returned {rc}")
    if nf211:
        # the interval check ran before the first trajectory and said what it found
        m = re.search(r"\[validate\].*ndrat: spec\(Q\^2\) ~ \[(\S+), (\S+)\]", log.getvalue())
        _check(m is not None, "cli.hmc did not print the interval check of the NDRAT monomial")
        lmin, lmax = float(m.group(1)), float(m.group(2))
        _say(f"[{tag}] interval check: spec(Q_nd^2) ~ [{lmin:.3e}, {lmax:.3e}] on the hot start "
             f"against [0.01, 4.7]: {'inside' if 0.01 <= lmin and lmax <= 4.7 else 'OUTSIDE'}")
        _check(0.0 < lmin < lmax and math.isfinite(lmax), "the spectral estimates are not ordered")
    with open(os.path.join(run_dir, "output.data")) as f:
        lines = [ln.split() for ln in f if ln.strip() and not ln.startswith("#")]
    _check(len(lines) == ntraj, f"output.data has {len(lines)} lines, expected {ntraj}")
    secs, acc = [], []
    for cols in lines:
        plaq, dh, acc_iters = float(cols[1]), float(cols[3]), [int(c) for c in cols[7:]]
        _check(math.isfinite(dh), f"non-finite dH in {cols}")
        _check(0.0 < plaq < 1.0, f"plaquette {plaq} outside (0, 1)")
        _check(all(i < MAXITER for i in acc_iters), f"a solve reached maxiter: {cols}")
        secs.append(float(cols[6]))
        acc.append(acc_iters)
    _say(f"[{tag}] acceptance-solve iterations per monomial and trajectory {acc}")
    _check(counts["K1"] > 0 and counts["K2"] > 0 and _schur_ran(dc, counts),
           f"a kernel was not launched: {counts}")
    # only the ONLINE solve (twisted mass, no clover term) runs the Schur
    # operator without a clover epilogue on the clover path, beside the hops
    # of the force; every Mhat and Qhat_pm runs on K1-S
    _check((counts["K1-C"] + counts["K1-S clover hops"] > 0) == (clover or nf211),
           f"clover epilogue launches: {counts}")
    if hasattr(dc, "hopping_schur_nd"):
        # every multishift iteration of NDRAT is one K1-SD launch (Q_nd^2),
        # every heatbath Q and y_j one (Q_nd); no doublet hop runs alone
        _check((counts["K1-SD"] > 0) == nf211 and counts["K1-R"] == 0,
               f"doublet launches: {counts}")
    else:
        # before K1-SD: 2 or 4 launches of K1-R on the doublet axis each
        _check((counts["K1-R-D"] > 0) == nf211 and counts["K1-R"] == counts["K1-R-D"],
               f"doublet launches: {counts}")
    _check_no_plain(counts)
    if flow:
        _check_gradflow(os.path.join(run_dir, f"gradflow.{ntraj - 1:06d}"), tag, flow_s)
    else:
        _check_online(os.path.join(run_dir, f"onlinemeas.{ntraj - 1:06d}"), tag)
    # the ILDG checkpoint, read back with its checksum verified
    conf = os.path.join(run_dir, f"conf.{ntraj:06d}.lime")
    _check(os.path.exists(conf), f"{os.path.basename(conf)} was not written")
    _check("scidac-checksum" in [r.type for r in read_lime(conf)],
           f"{os.path.basename(conf)} carries no checksum record")
    arr, traj, _ = load_checkpoint(conf, cfg.lat)  # raises on a checksum mismatch
    _check(traj == ntraj and arr.shape == (3, 3, 4) + cfg.lat.site_shape
           and bool(np.isfinite(arr).all()), f"{os.path.basename(conf)} does not read back")
    dev = np.abs(np.einsum("ij...,kj...->ik...", arr, arr.conj()) - np.eye(3).reshape(3, 3, 1, 1, 1, 1))
    _check(float(dev.max()) < 1e-5, f"links read back are not unitary ({dev.max():.2e})")
    _say(f"[{tag}] s/trajectory {secs}; {os.path.basename(conf)} read back, checksum verified")
    return counts, secs, conf


# ---------------------------------------------------------------------------
# phase 6
# ---------------------------------------------------------------------------

INVERT_INPUT = """L = 16
T = 32
BeginOperator TMWILSON
  kappa = 0.13
  2KappaMu = 0.0026
  Solver = cg
  SolverPrecision = 1e-14
  MaxSolverIterations = 1000
  PropagatorPrecision = 32
EndOperator
"""


def _say_profile(what: str, wall: float, prof, kernels: dict) -> None:
    """Device ops only, as intervals on the device's clock: their union is
    the busy time (a sum over `key_averages()` counts overlapping entries
    twice).  `kernels` maps a label to a substring of the kernel's name."""
    import torch

    spans, per = [], {k: 0.0 for k in kernels}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, end = float(ev.time_range.start), float(ev.time_range.end)
        if end <= start:
            continue
        spans.append((start, end))
        for label, sub in kernels.items():
            if sub in ev.name:
                per[label] += end - start
    if not spans:
        _say(f"[profile] {what} {wall:.4f} s unprofiled; the profiler reported no device "
             f"time, idle share not measured")
        return
    spans.sort()
    busy, (lo, hi) = 0.0, spans[0]
    for start, end in spans[1:]:
        if start > hi:
            busy += hi - lo
            lo, hi = start, end
        else:
            hi = max(hi, end)
    busy += hi - lo
    window = max(e for _, e in spans) - spans[0][0]
    shares = "; ".join(f"{k} {v / 1e6:.4f} s ({v / busy:.1%} of device time)"
                       for k, v in per.items())
    _say(f"[profile] {what} {wall:.4f} s unprofiled; profiled window {window / 1e6:.4f} s from "
         f"the first to the last of {len(spans)} device ops, device busy {busy / 1e6:.4f} s: "
         f"idle share {1.0 - busy / window:.1%}; {shares}")


def phase_invert(workdir: str, conf: str):
    import numpy as np
    import torch

    from tmlqcd_tpu_torch.cli import invert as cli
    from tmlqcd_tpu_torch.config_tmlqcd import read_input
    from tmlqcd_tpu_torch.inverter import invert_eo, invert_eo_rhs
    from tmlqcd_tpu_torch.io.checkpoint import load_checkpoint
    from tmlqcd_tpu_torch.io.propagator import read_propagator
    from tmlqcd_tpu_torch.meas.correlators import pion_correlator
    from tmlqcd_tpu_torch.meas.sources import point_source
    from tmlqcd_tpu_torch.ops import dslash_cuda as dc
    from tmlqcd_tpu_torch.ops.wilson import DiracParams, d_full

    path = os.path.join(workdir, "invert.input")
    with open(path, "w") as f:
        f.write(INVERT_INPUT)
    cfg = read_input(path)
    op = cfg.operators[0]
    lat = cfg.lat
    out_dir = os.path.join(workdir, "prop")
    dc.reset_counters()
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        rc = cli.main(["-f", path, "-c", conf, "--format", "lime", "-o", out_dir])
    wall = time.perf_counter() - t0
    counts = _read_counts(dc)
    sys.stdout.write(log.getvalue())
    _check(rc == 0, f"cli.invert returned {rc}")
    m = re.search(r"12 sources batched: (\d+) iters, max\|r\|\^2=(\S+), (\S+)s", log.getvalue())
    _check(m is not None, "cli.invert did not report a batched solve of 12 sources")
    iters, solve_s = int(m.group(1)), float(m.group(3))
    _say(f"[invert] cli.invert exit {rc}, {wall:.1f} s wall")
    _say(f"[invert] batched solve seconds {solve_s}")
    _say(f"[invert] iterations {iters}")
    _say(f"[invert] launches K1 {counts['K1']} K1-R {counts['K1-R']} (4 per iteration + 8)")
    _check(0 < iters < op.max_solver_iterations, f"the batched solve ran {iters} iterations")
    _check(counts["K1-R"] == 4 * iters + 8, f"K1-R launches {counts['K1-R']} != 4 * {iters} + 8")
    _check_no_plain(counts)

    # the propagator file: 12 columns, every checksum verified on reading
    prop = os.path.join(out_dir, "propagator.00.000003.lime")
    _check(os.path.exists(prop), "propagator.00.000003.lime was not written")
    cols, prec = read_propagator(prop, lat)  # raises on a checksum mismatch
    _check(len(cols) == NRHS and prec == 32, f"{len(cols)} columns at precision {prec}")
    arr, _, _ = load_checkpoint(conf, lat)
    u = torch.as_tensor(arr, device="cuda").to(torch.complex64)
    params = DiracParams(kappa=op.kappa, mu=op.two_kappa_mu / (2 * op.kappa))
    x = [torch.as_tensor(c, device="cuda").to(torch.complex64) for c in cols]
    worst, cpp = 0.0, 0.0
    for i, (s, c) in enumerate((s, c) for s in range(4) for c in range(3)):
        b = point_source(lat, s, c, (0, 0, 0, 0), device="cuda")
        res = float(torch.linalg.vector_norm(d_full(u, x[i], params, lat) - b))  # |b| = 1
        worst = max(worst, res)
        _check(res <= RESIDUAL_BOUND, f"column {i}: |M x - b| / |b| = {res:.3e}")
        cpp = cpp + pion_correlator(x[i], lat, 0)
    _say(f"[invert] true residual |M x - b| / |b| over the 12 columns: max {worst:.3e} "
         f"(bound {RESIDUAL_BOUND:.0e})")
    _check(bool((cpp > 0).all()) and bool(torch.isfinite(cpp).all()),
           "the pion correlator of the point propagator must be positive on every timeslice")
    _say(f"[invert] pion correlator C_PP(0) {float(cpp[0]):.6e}, C_PP(T/2) "
         f"{float(cpp[lat.dims[0] // 2]):.6e}, min {float(cpp.min()):.6e}")
    tol = float(op.precision) ** 0.5
    for i in (0, 7):
        b = point_source(lat, i // 3, i % 3, (0, 0, 0, 0), device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one = invert_eo(u, b, params, lat, tol=tol, maxiter=op.max_solver_iterations)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        diff = float((one.x - x[i]).abs().max())
        scale = float(one.x.abs().max())
        _say(f"[invert] column {i}: single-column solve {one.iterations} iters in {dt:.3f} s, "
             f"max|x_batch - x_single| {diff:.3e} (max|x| {scale:.3e})")
        _check(diff <= BATCH_VS_SINGLE * scale, f"column {i}: batch and single differ by {diff:.3e}")

    # where the batched solve's time goes: one profiled solve
    bs = torch.stack([point_source(lat, s, c, (0, 0, 0, 0), device="cuda")
                      for s in range(4) for c in range(3)])
    invert_eo_rhs(u, bs, params, lat, tol=tol, maxiter=op.max_solver_iterations)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    invert_eo_rhs(u, bs, params, lat, tol=tol, maxiter=op.max_solver_iterations)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    # device activity only: the idle share reads device intervals, and the
    # host ops of a trajectory would add ~10^6 events to sort through
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        invert_eo_rhs(u, bs, params, lat, tol=tol, maxiter=op.max_solver_iterations)
        torch.cuda.synchronize()
    _say_profile("batched solve", plain_wall, prof, {"K1-R": "hopping_rhs_kernel"})
    return counts, iters, solve_s


# ---------------------------------------------------------------------------
# phases 7 and 9 (after a run of phase_main_path): where the time goes
# ---------------------------------------------------------------------------


def phase_profile(workdir: str, conf: str, input_name: str, what: str, kernels: dict,
                  patches=None):
    """More trajectories from a main path's checkpoint, outside the CLI.  Two
    short ones (the same action at integration steps 1/1/1, since a profile
    of a whole trajectory holds over a million device ops and takes minutes
    to read): one timed, one under torch.profiler for the device's idle share
    and the device time of `kernels` (label -> substring of the kernel's
    name).  With `patches` ((object, attribute, label) triples) then one
    whole trajectory with synchronising host timers around those functions."""
    import dataclasses

    import torch

    from tmlqcd_tpu_torch import rng
    from tmlqcd_tpu_torch.config import build_hmc
    from tmlqcd_tpu_torch.config_tmlqcd import read_input
    from tmlqcd_tpu_torch.hmc import chrono_states, hmc_trajectory
    from tmlqcd_tpu_torch.io.checkpoint import load_checkpoint

    rcfg = read_input(os.path.join(workdir, input_name))
    cfg = build_hmc(rcfg)
    arr, _, _ = load_checkpoint(conf, cfg.lat)
    u = torch.as_tensor(arr, device="cuda").to(torch.complex64)
    chrono = chrono_states(cfg, u.device)

    short = dataclasses.replace(cfg, integrator=dataclasses.replace(
        cfg.integrator, levels=tuple(dataclasses.replace(lv, steps=1)
                                     for lv in cfg.integrator.levels)))

    def traj(c, i, u, chrono):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            u, st, chrono = hmc_trajectory(c, u, rng.Key(900 + i), chrono=chrono)
        torch.cuda.synchronize()
        return u, chrono, st, time.perf_counter() - t0

    _, _, st, wall = traj(short, 0, u, chrono)
    _check(math.isfinite(st.delta_h), "profile trajectory: dH is not finite")
    # device activity only: the idle share reads device intervals, and the
    # host ops of a trajectory would add ~10^6 events to sort through
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        traj(short, 0, u, chrono)
    _say_profile(f"{what} trajectory at steps 1/1/1", wall, prof, kernels)
    del prof
    if not patches:
        return wall

    # host timers, each synchronised on entry and exit (so this trajectory is
    # slower than the plain one); inclusive times of the named functions
    spent, calls = {}, {}

    def timed(name, fn):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.synchronize()
                spent[name] = spent.get(name, 0.0) + time.perf_counter() - t0
                calls[name] = calls.get(name, 0) + 1
        return wrapper

    saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in patches]
    try:
        for obj, attr, name in patches:
            setattr(obj, attr, timed(name, getattr(obj, attr)))
        u, chrono, st, wall_t = traj(cfg, 2, u, chrono)
    finally:
        for obj, attr, fn in saved:
            setattr(obj, attr, fn)
    _say(f"[profile] {what} trajectory with synchronising timers {wall_t:.4f} s "
         f"(dH {st.delta_h:+.4e}, force iterations {st.force_iterations}):")
    for name, sec in sorted(spent.items(), key=lambda kv: -kv[1]):
        _say(f"[profile]   {name}: {sec:.4f} s in {calls[name]} calls ({sec / wall_t:.1%})")
    return wall


def _conf_traj(conf: str) -> int:
    """The trajectory counter in a checkpoint's file name conf.NNNNNN.lime."""
    return int(os.path.basename(conf).split(".")[1])


# ---------------------------------------------------------------------------
# phase 8
# ---------------------------------------------------------------------------

INVERT_CLOVER_INPUT = """L = 16
T = 32
BeginOperator CLOVER
  kappa = 0.1400645
  2KappaMu = 0.0009
  CSW = 1.74
  Solver = cg
  SolverPrecision = 1e-14
  MaxSolverIterations = 1000
  PropagatorPrecision = 32
EndOperator
"""
# True relative residual of a clover propagator column against the plain
# unpreconditioned operator (1 + T + i mutld g5) x - kappa H x.  As for
# RESIDUAL_BOUND: CG stops at 1e-7 of the normal-equation right-hand side;
# on the rough smoke gauge |Qsw^-1| stays below ~10 (50 iterations reach 1e-8
# on a random gauge), the block inverse is conditioned like 1 / 0.7, and f32
# fields add ~1e-7 per operator application.  1e-5 leaves 10x.
RESIDUAL_BOUND_CLOVER = 1e-5


def phase_invert_clover(workdir: str, conf: str):
    import torch

    from tmlqcd_tpu_torch.cli import invert as cli
    from tmlqcd_tpu_torch.config_tmlqcd import read_input
    from tmlqcd_tpu_torch.inverter import invert_clover_eo, invert_eo_rhs
    from tmlqcd_tpu_torch.io.checkpoint import load_checkpoint
    from tmlqcd_tpu_torch.io.propagator import read_propagator
    from tmlqcd_tpu_torch.meas.sources import point_source
    from tmlqcd_tpu_torch.ops import clover as cl
    from tmlqcd_tpu_torch.ops import dslash_cuda as dc
    from tmlqcd_tpu_torch.ops.wilson import DiracParams, boundary_phases, dslash_full

    path = os.path.join(workdir, "invert-clover.input")
    with open(path, "w") as f:
        f.write(INVERT_CLOVER_INPUT)
    cfg = read_input(path)
    op, lat = cfg.operators[0], cfg.lat
    out_dir = os.path.join(workdir, "prop-clover")
    dc.reset_counters()
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        rc = cli.main(["-f", path, "-c", conf, "--format", "lime", "-o", out_dir])
    wall = time.perf_counter() - t0
    counts = _read_counts(dc)
    sys.stdout.write(log.getvalue())
    _check(rc == 0, f"cli.invert (CLOVER) returned {rc}")
    m = re.search(r"\(CLOVER\) 12 sources batched: (\d+) iters, max\|r\|\^2=(\S+), (\S+)s",
                  log.getvalue())
    _check(m is not None, "cli.invert did not report a batched CLOVER solve of 12 sources")
    iters, solve_s = int(m.group(1)), float(m.group(3))
    _say(f"[invert-clover] cli.invert exit {rc}, {wall:.1f} s wall, batched solve {solve_s} s, "
         f"{iters} iterations; launches {counts}")
    _check(0 < iters < op.max_solver_iterations, f"the batched solve ran {iters} iterations")
    # 4 per iteration + 8 around them, all but the first hop of the Schur
    # prologue with a clover epilogue
    _check(counts["K1-R"] == 4 * iters + 8 and counts["K1-RC"] == 4 * iters + 7,
           f"K1-R launches {counts['K1-R']} / clover {counts['K1-RC']} for {iters} iterations")
    _check_no_plain(counts)

    prop = os.path.join(out_dir, f"propagator.00.{_conf_traj(conf):06d}.lime")
    cols, prec = read_propagator(prop, lat)  # raises on a checksum mismatch
    _check(len(cols) == NRHS and prec == 32, f"{len(cols)} columns at precision {prec}")
    arr, _, _ = load_checkpoint(conf, lat)
    u = torch.as_tensor(arr, device="cuda").to(torch.complex64)
    params = DiracParams(kappa=op.kappa, mu=op.two_kappa_mu / (2 * op.kappa), c_sw=op.csw)
    with torch.no_grad():
        sw = cl.sw_blocks(u, params.kappa, params.c_sw, lat)
        ph = boundary_phases(params, lat)
        # how far 1 + T + i mu g5 is from singular on this gauge: the 6 x 6
        # determinant of every chirality block of every site
        m66 = cl.mee_blocks(sw, params.mutld, +1.0).permute(5, 6, 7, 0, 1, 3, 2, 4)
        dets = torch.linalg.det(m66.reshape(m66.shape[:4] + (6, 6))).abs()
        _say(f"[invert-clover] |det(1 + T + i mu g5)| of a chirality block over "
             f"{dets.numel()} blocks: min {float(dets.min()):.4f} max {float(dets.max()):.4f}")
        _check(float(dets.min()) > 0.05, "a clover block of the smoke gauge is close to singular")
        worst = 0.0
        x = [torch.as_tensor(c, device="cuda").to(torch.complex64) for c in cols]
        for i, (s, c) in enumerate((s, c) for s in range(4) for c in range(3)):
            b = point_source(lat, s, c, (0, 0, 0, 0), device="cuda")
            mx = cl.sw_apply(sw, x[i], params.mutld, +1.0) - params.kappa * dslash_full(
                u, x[i], ph, lat)
            res = float(torch.linalg.vector_norm(mx - b))  # |b| = 1
            worst = max(worst, res)
            _check(res <= RESIDUAL_BOUND_CLOVER, f"clover column {i}: |M x - b| / |b| = {res:.3e}")
    _say(f"[invert-clover] true residual |M x - b| / |b| against the unpreconditioned clover "
         f"operator over the 12 columns: max {worst:.3e} (bound {RESIDUAL_BOUND_CLOVER:.0e})")
    tol = float(op.precision) ** 0.5
    b = point_source(lat, 7 // 3, 7 % 3, (0, 0, 0, 0), device="cuda")
    n0 = _read_counts(dc)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one = invert_clover_eo(u, b, params, lat, tol=tol, maxiter=op.max_solver_iterations)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n1 = _read_counts(dc)
    # hops with a clover epilogue: single K1 launches and those K1-S ran
    hops = sum(n1[k] - n0[k] for k in ("K1-C", "K1-S clover hops"))
    diff, scale = float((one.x - x[7]).abs().max()), float(one.x.abs().max())
    _say(f"[invert-clover] column 7: invert_clover_eo {one.iterations} iters in {dt:.3f} s "
         f"({hops} hops with the clover epilogues, {n1['K1-S'] - n0['K1-S']} K1-S launches), "
         f"max|x_batch - x_single| {diff:.3e} (max|x| {scale:.3e})")
    _check(diff <= BATCH_VS_SINGLE * scale, f"clover column 7: batch and single differ by {diff:.3e}")
    _check(hops == 4 * one.iterations + 7,
           "invert_clover_eo did not run the hops with the clover epilogues as counted")
    _check_no_plain(_read_counts(dc))
    bs = torch.stack([point_source(lat, s, c, (0, 0, 0, 0), device="cuda")
                      for s in range(4) for c in range(3)])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    invert_eo_rhs(u, bs, params, lat, tol=tol, maxiter=op.max_solver_iterations)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    _say(f"[invert-clover] warm batched solve {warm:.4f} s")
    return counts, iters, solve_s


# ---------------------------------------------------------------------------
# phase 10
# ---------------------------------------------------------------------------

# True relative residual of a doublet propagator column (the source in the
# upper flavour, the solution a flavour pair) against the plain
# unpreconditioned doublet operator (1 [+ T] + i mubar g5 tau3 + epsbar tau1) x
# - kappa H x.  As for RESIDUAL_BOUND: CG stops at 1e-7 of the normal-equation
# right-hand side, |Q_nd^-1| on the smoke gauge stays of order 10 (the
# interval check of phase 9 prints the smallest eigenvalue of Q_nd^2 for the
# heavier doublet of hmc3), f32 fields add ~1e-7 per application.  1e-5
# leaves 10x; a wrong Schur step or flavour order leaves O(1).
RESIDUAL_BOUND_DOUBLET = 1e-5


def doublet_smoke_input(text: str) -> str:
    """invert0-doublet's two operators (DBTMWILSON, DBCLOVER; kappa, CSW,
    2Kappamubar, 2Kappaepsbar as shipped) at 16^3x32 with the other inverter
    points' SolverPrecision = 1e-14 and MaxSolverIterations = 1000, and
    single-precision propagator files."""
    sub = {"l": "16", "t": "32", "solverprecision": "1e-14",
           "maxsolveriterations": f"{MAXITER}\n  PropagatorPrecision = 32"}
    out = []
    for line in text.splitlines():
        kv = re.match(r"^([A-Za-z0-9_]+)\s*=", line.split("#", 1)[0].strip())
        if kv and kv.group(1).lower() in sub:
            line = (line[:len(line) - len(line.lstrip())]
                    + f"{kv.group(1)} = {sub[kv.group(1).lower()]}")
        out.append(line)
    return "\n".join(out) + "\n"


def phase_invert_doublet(workdir: str, conf: str):
    import torch

    from tmlqcd_tpu_torch.cli import invert as cli
    from tmlqcd_tpu_torch.config_tmlqcd import read_input
    from tmlqcd_tpu_torch.io.checkpoint import load_checkpoint
    from tmlqcd_tpu_torch.io.propagator import read_propagator
    from tmlqcd_tpu_torch.meas.sources import point_source
    from tmlqcd_tpu_torch.ops import clover as cl
    from tmlqcd_tpu_torch.ops import dslash_cuda as dc
    from tmlqcd_tpu_torch.ops import ndoublet as nd
    from tmlqcd_tpu_torch.ops.wilson import boundary_phases, dslash_full

    path = os.path.join(workdir, "invert-doublet.input")
    with open(SAMPLE_DOUBLET) as f:
        text = doublet_smoke_input(f.read())
    with open(path, "w") as f:
        f.write(text)
    cfg = read_input(path)
    lat = cfg.lat
    _check(lat.dims == (32, 16, 16, 16)
           and [(o.type, o.kappa, o.csw, o.two_kappa_mubar, o.two_kappa_epsbar, o.precision,
                 o.max_solver_iterations, o.propagator_precision) for o in cfg.operators]
           == [("DBTMWILSON", 0.1400645, 0.0, 0.039, 0.0333, 1e-14, MAXITER, 32),
               ("DBCLOVER", 0.1400645, 1.74, 0.039, 0.0333, 1e-14, MAXITER, 32)],
           "doublet inverter input was not derived as intended")
    out_dir = os.path.join(workdir, "prop-doublet")
    dc.reset_counters()
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        rc = cli.main(["-f", path, "-c", conf, "--format", "lime", "-o", out_dir])
    wall = time.perf_counter() - t0
    counts = _read_counts(dc)
    sys.stdout.write(log.getvalue())
    _check(rc == 0, f"cli.invert (doublet) returned {rc}")
    solves = [(m.group(1), int(m.group(2)), float(m.group(3))) for m in re.finditer(
        r"\((DBTMWILSON|DBCLOVER)\) source \(s=\d,c=\d\): (\d+) iters, \|r\|\^2=\S+, (\S+)s",
        log.getvalue())]
    _check(len(solves) == 2 * NRHS, f"cli.invert reported {len(solves)} doublet solves, not 24")
    iters = {}
    for ty in ("DBTMWILSON", "DBCLOVER"):
        its = [n for t, n, _ in solves if t == ty]
        secs = [s for t, _, s in solves if t == ty]
        iters[ty] = its
        _say(f"[invert-doublet] {ty}: iterations per column {its}, seconds per column "
             f"{secs} (sum {sum(secs):.3f} s)")
        _check(all(0 < n < MAXITER for n in its), f"a {ty} solve ran {its} iterations")
    if hasattr(dc, "hopping_schur_nd"):
        # per solve of n CG iterations: K1-SD once per CG operator
        # application (n + 1, the first for r0 = b - A x0) and once for the
        # right-hand side's Q_nd; K1-R-D for the prologue's and the
        # epilogue's single hops
        expect = {"K1-SD": sum(n + 2 for _, n, _ in solves), "K1-R-D": 2 * len(solves)}
        got = {"K1-SD": counts["K1-SD"], "K1-R-D": counts["K1-R-D"]}
        ok = got == expect and counts["K1-R"] == counts["K1-R-D"]
    else:
        # before K1-SD every hop of a solve was one K1-R-D launch: 4 per
        # iteration, 4 for CG's first residual, 3 in the Schur prologue, 1 after
        expect = {"K1-R-D": sum(4 * n + 8 for _, n, _ in solves)}
        got = {"K1-R-D": counts["K1-R-D"]}
        ok = got == expect and counts["K1-R"] == counts["K1-R-D"]
    _say(f"[invert-doublet] cli.invert exit {rc}, {wall:.1f} s wall; launches {counts} "
         f"(expected {expect})")
    _check(ok, f"doublet launches {got} != {expect}")
    _check_no_plain(counts)

    arr, _, _ = load_checkpoint(conf, lat)
    u = torch.as_tensor(arr, device="cuda").to(torch.complex64)
    traj = _conf_traj(conf)
    worst = {}
    with torch.no_grad():
        for iop, op in enumerate(cfg.operators):
            two_k = 2.0 * op.kappa
            p = nd.NDParams(kappa=op.kappa, mubar=op.two_kappa_mubar / two_k,
                            epsbar=op.two_kappa_epsbar / two_k, c_sw=op.csw)
            ph = boundary_phases(p.wilson, lat)
            sw = cl.sw_blocks(u, p.kappa, p.c_sw, lat) if p.c_sw != 0.0 else None
            fl = []
            for f in range(2):
                cols, prec = read_propagator(  # raises on a checksum mismatch
                    os.path.join(out_dir, f"propagator.{iop:02d}.fl{f}.{traj:06d}.lime"), lat)
                _check(len(cols) == NRHS and prec == 32, f"{len(cols)} columns at precision {prec}")
                fl.append(cols)
            worst[op.type] = 0.0
            for i, (s, c) in enumerate((s, c) for s in range(4) for c in range(3)):
                x = torch.stack([torch.as_tensor(fl[f][i], device="cuda").to(torch.complex64)
                                 for f in range(2)])
                b = point_source(lat, s, c, (0, 0, 0, 0), device="cuda")
                diag = (cl.mee_nd_clover(sw, x, p.mubar_t, p.epsbar_t) if sw is not None
                        else nd.mee_nd(x, p.mubar_t, p.epsbar_t))
                mx = diag - p.kappa * torch.stack([dslash_full(u, x[f], ph, lat)
                                                   for f in range(2)])
                mx[0] -= b  # the source sits in the upper flavour; |b| = 1
                res = float(torch.linalg.vector_norm(mx))
                worst[op.type] = max(worst[op.type], res)
                _check(res <= RESIDUAL_BOUND_DOUBLET,
                       f"{op.type} column {i}: |M_nd x - b| / |b| = {res:.3e}")
                _check(float(x[1].abs().max()) > 0.0, f"{op.type} column {i}: empty lower flavour")
    _say(f"[invert-doublet] true residual |M_nd x - b| / |b| against the unpreconditioned "
         f"doublet operator over 12 columns: {worst} (bound {RESIDUAL_BOUND_DOUBLET:.0e})")
    return counts, iters, solves


# ---------------------------------------------------------------------------
# phase 11: main path 7, the inverter's other solvers
# ---------------------------------------------------------------------------

SOLVER_OPS = ("fastmixed", "mixedcg", "dflfgmres", "dflgcr", "increigcg")
INVERT_SOLVERS_INPUT = "L = 16\nT = 32\n" + "".join(f"""BeginOperator TMWILSON
  kappa = 0.13
  2KappaMu = 0.0026
  Solver = {solver}
  SolverPrecision = 1e-14
  MaxSolverIterations = 1000
  PropagatorPrecision = 32
EndOperator
""" for solver in SOLVER_OPS)
INVERT_CLOVER_MIXED_INPUT = INVERT_CLOVER_INPUT.replace("Solver = cg", "Solver = mixedcg")


class _MixedRecorder:
    """Wraps a mixed_cg function and keeps (outer, inner) of each call."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, *a, **k):
        res = self.fn(*a, **k)
        self.calls.append((int(res.outer_iterations), int(res.inner_iterations)))
        return res


def _run_cli(module, argv, patches=()):
    """module.main(argv) with its stdout captured and the counters zeroed
    just before; (rc, log, counts, wall).  `patches`: (object, attribute,
    value) set for the run and restored after."""
    from tmlqcd_tpu_torch.ops import dslash_cuda as dc

    saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in patches]
    for obj, attr, value in patches:
        setattr(obj, attr, value)
    log = io.StringIO()
    try:
        dc.reset_counters()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            rc = module.main(argv)
        wall = time.perf_counter() - t0
        counts = _read_counts(dc)
    finally:
        for obj, attr, value in saved:
            setattr(obj, attr, value)
    sys.stdout.write(log.getvalue())
    return rc, log.getvalue(), counts, wall


def phase_invert_solvers(workdir: str, conf: str, cconf: str, batched_s: float):
    """`cli.invert` on phase 5's checkpoint with one TMWILSON operator per
    solver (12 point-source columns each), then a CLOVER operator with
    mixedcg on phase 7's checkpoint; every column's true residual."""
    import torch

    from tmlqcd_tpu_torch import inverter
    from tmlqcd_tpu_torch.cli import invert as cli
    from tmlqcd_tpu_torch.config_tmlqcd import read_input
    from tmlqcd_tpu_torch.io.checkpoint import load_checkpoint
    from tmlqcd_tpu_torch.io.propagator import read_propagator
    from tmlqcd_tpu_torch.meas.sources import point_source
    from tmlqcd_tpu_torch.ops import clover as cl
    from tmlqcd_tpu_torch.ops import dslash_cuda as dc
    from tmlqcd_tpu_torch.ops.wilson import DiracParams, boundary_phases, d_full, dslash_full

    path = os.path.join(workdir, "invert-solvers.input")
    with open(path, "w") as f:
        f.write(INVERT_SOLVERS_INPUT)
    cfg = read_input(path)
    lat = cfg.lat
    out_dir = os.path.join(workdir, "prop-solvers")
    rec = _MixedRecorder(inverter.mixed_cg)
    rc, log, counts, wall = _run_cli(cli, ["-f", path, "-c", conf, "--format", "lime", "-o",
                                          out_dir], [(inverter, "mixed_cg", rec)])
    _check(rc == 0, f"cli.invert (solvers) returned {rc}")
    _say(f"[invert-solvers] cli.invert exit {rc}, {wall:.1f} s wall; launches {counts}")
    _check(counts["K1-B"] + counts["K1-S bf16 hops"] > 0 and counts["K1"] > 0
           and counts["K1-R"] > 0 and _schur_ran(dc, counts),
           f"a kernel of the solvers' path was not launched: {counts}")
    _check_no_plain(counts)
    setups = {int(m.group(1)): float(m.group(2)) for m in re.finditer(
        r"op (\d+): MG setup built in (\S+)s", log)}
    cols = {}
    for m in re.finditer(r"op (\d+) \(TMWILSON\) source \(s=\d,c=\d\): (\d+) iters, "
                         r"\|r\|\^2=\S+, (\S+)s", log):
        cols.setdefault(int(m.group(1)), []).append((int(m.group(2)), float(m.group(3))))
    m = re.search(r"op (\d+) \(TMWILSON\) 12 sources incr-eigcg: iters \[([^\]]*)\], "
                  r"max\|r\|\^2=\S+, (\S+)s", log)
    _check(m is not None, "cli.invert did not report the incremental eigCG solve")
    eig_iters = [int(n) for n in m.group(2).split(",")]
    summary = {}
    arr, _, _ = load_checkpoint(conf, lat)
    u = torch.as_tensor(arr, device="cuda").to(torch.complex64)
    traj = _conf_traj(conf)
    with torch.no_grad():
        for iop, (op, solver) in enumerate(zip(cfg.operators, SOLVER_OPS)):
            if solver == "increigcg":
                iters, secs = eig_iters, float(m.group(3))
            else:
                _check(len(cols.get(iop, [])) == NRHS, f"{solver}: {len(cols.get(iop, []))} "
                                                       f"columns reported, not {NRHS}")
                iters, secs = [n for n, _ in cols[iop]], sum(t for _, t in cols[iop])
            _check(all(0 < n for n in iters), f"{solver}: iterations {iters}")
            props, prec = read_propagator(
                os.path.join(out_dir, f"propagator.{iop:02d}.{traj:06d}.lime"), lat)
            _check(len(props) == NRHS and prec == 32, f"{solver}: {len(props)} columns")
            params = DiracParams(kappa=op.kappa, mu=op.two_kappa_mu / (2 * op.kappa))
            worst = 0.0
            for i, (sp, c) in enumerate((sp, c) for sp in range(4) for c in range(3)):
                x = torch.as_tensor(props[i], device="cuda").to(torch.complex64)
                b = point_source(lat, sp, c, (0, 0, 0, 0), device="cuda")
                res = float(torch.linalg.vector_norm(d_full(u, x, params, lat) - b))  # |b| = 1
                worst = max(worst, res)
                _check(res <= RESIDUAL_BOUND, f"{solver} column {i}: |M x - b| / |b| = {res:.3e}")
            summary[solver] = (iters, secs + setups.get(iop, 0.0), worst)
            _say(f"[invert-solvers] {solver}: iterations per column {iters}"
                 f"{' (FGMRES/GCR cycles of 5)' if solver.startswith('dfl') else ''}, "
                 f"{secs:.3f} s for 12 columns"
                 f"{f' + MG setup {setups[iop]:.3f} s' if iop in setups else ''} "
                 f"(batched CG, phase 6: {batched_s} s); true residual max {worst:.3e}")
    per = [f"outer {o} inner {n}" for o, n in rec.calls]
    _say(f"[invert-solvers] mixed CG solves (fastmixed, then mixedcg), per column: {per}")
    _check(len(rec.calls) == 2 * NRHS, f"{len(rec.calls)} mixed CG solves recorded")

    # the CLOVER operator with mixedcg on phase 7's clover checkpoint
    cpath = os.path.join(workdir, "invert-clover-mixed.input")
    with open(cpath, "w") as f:
        f.write(INVERT_CLOVER_MIXED_INPUT)
    ccfg = read_input(cpath)
    op = ccfg.operators[0]
    cdir = os.path.join(workdir, "prop-clover-mixed")
    rec = _MixedRecorder(inverter.mixed_cg)
    rc, log, ccounts, cwall = _run_cli(cli, ["-f", cpath, "-c", cconf, "--format", "lime", "-o",
                                             cdir], [(inverter, "mixed_cg", rec)])
    _check(rc == 0, f"cli.invert (CLOVER mixedcg) returned {rc}")
    _check(ccounts["K1-C"] + ccounts["K1-S clover hops"] > 0, f"no clover epilogue launch: "
                                                               f"{ccounts}")
    _check_no_plain(ccounts)
    csecs = [float(t) for t in re.findall(r"\(CLOVER\) source \(s=\d,c=\d\): \d+ iters, "
                                          r"\|r\|\^2=\S+, (\S+)s", log)]
    _check(len(csecs) == NRHS, f"CLOVER mixedcg: {len(csecs)} columns reported")
    arr, _, _ = load_checkpoint(cconf, lat)
    uc = torch.as_tensor(arr, device="cuda").to(torch.complex64)
    props, _ = read_propagator(os.path.join(cdir, f"propagator.00.{_conf_traj(cconf):06d}.lime"),
                               lat)
    params = DiracParams(kappa=op.kappa, mu=op.two_kappa_mu / (2 * op.kappa), c_sw=op.csw)
    worst = 0.0
    with torch.no_grad():
        sw = cl.sw_blocks(uc, params.kappa, params.c_sw, lat)
        ph = boundary_phases(params, lat)
        for i, (sp, c) in enumerate((sp, c) for sp in range(4) for c in range(3)):
            x = torch.as_tensor(props[i], device="cuda").to(torch.complex64)
            b = point_source(lat, sp, c, (0, 0, 0, 0), device="cuda")
            mx = cl.sw_apply(sw, x, params.mutld, +1.0) - params.kappa * dslash_full(uc, x, ph, lat)
            res = float(torch.linalg.vector_norm(mx - b))
            worst = max(worst, res)
            _check(res <= RESIDUAL_BOUND_CLOVER, f"CLOVER mixedcg column {i}: residual {res:.3e}")
    _say(f"[invert-solvers] CLOVER mixedcg: {sum(csecs):.3f} s for 12 columns, outer/inner per "
         f"column {rec.calls}, true residual max {worst:.3e}; launches {ccounts}")
    summary["clover mixedcg"] = ([n for _, n in rec.calls], sum(csecs), worst)
    total = {k: counts[k] + ccounts[k] for k in counts}
    return total, summary


# ---------------------------------------------------------------------------
# phase 12: main path 8, HMC with a mixed solver
# ---------------------------------------------------------------------------


# The tolerance of the timed Qsw_pm solves: above the f32 floor of the true
# residual (~1e-7 relative), under which the reliable updates of rgmixedcg
# replace the residual until maxiter.
RG_TOL = 1e-6


def mixed_smoke_input(text: str, solver: str = "mixedcg", ntraj: int = 2) -> str:
    """Phase 5's input (`smoke_input` of hmc2) with `Solver = solver` in the
    DET and DETRATIO blocks, `ntraj` trajectories and NSave = `ntraj`; the
    ONLINE block stays every 3rd trajectory, so it does not run."""
    out, block = [], None
    for line in smoke_input(text).splitlines():
        s = line.split("#", 1)[0].strip()
        m = re.match(r"(?i)^BeginMonomial\s+(\S+)", s)
        if m:
            block = m.group(1).upper()
        kv = re.match(r"^([A-Za-z0-9_]+)\s*=", s)
        key = kv.group(1).lower() if kv else None
        if key in ("measurements", "nsave"):
            line = f"{kv.group(1)} = {ntraj}"
        out.append(line)
        if key == "maxsolveriterations" and block in ("DET", "DETRATIO"):
            out.append(f"  Solver = {solver}")
    return "\n".join(out) + "\n"


def phase_mixed_hmc(workdir: str, secs_cg: list, cconf: str):
    """`cli.hmc` on phase 5's point with Solver = mixedcg in DET and
    DETRATIO (2 trajectories); then one timed Qsw_pm solve with rgmixedcg
    against CG on phase 7's clover gauge."""
    import torch

    from tmlqcd_tpu_torch import rng
    from tmlqcd_tpu_torch.cli import hmc as cli
    from tmlqcd_tpu_torch.config_tmlqcd import read_input
    from tmlqcd_tpu_torch.hmc import monomials
    from tmlqcd_tpu_torch.io.checkpoint import load_checkpoint
    from tmlqcd_tpu_torch.ops import dslash_cuda as dc
    from tmlqcd_tpu_torch.ops import wilson_fast as wf
    from tmlqcd_tpu_torch.ops.wilson import DiracParams
    from tmlqcd_tpu_torch.solvers import mixed_cg as mixed_mod

    with open(SAMPLE) as f:
        text = mixed_smoke_input(f.read())
    path = os.path.join(workdir, "main-mixed.input")
    with open(path, "w") as f:
        f.write(text)
    cfg = read_input(path)
    _check(cfg.measurements == 2 and [(m.type, m.solver) for m in cfg.monomials]
           == [("GAUGE", "auto"), ("DET", "mixedcg"), ("DETRATIO", "mixedcg")]
           and [(m.acceptance_precision, m.force_precision) for m in cfg.monomials[1:]]
           == [(1e-16, 1e-14)] * 2, "mixed smoke input was not derived as intended")
    run_dir = os.path.join(workdir, "run-main-mixed")
    rec = _MixedRecorder(mixed_mod.mixed_cg)
    rc, log, counts, wall = _run_cli(cli, ["-f", path, "-o", run_dir],
                                     [(mixed_mod, "mixed_cg", rec)])
    _say(f"[main-mixed] cli.hmc exit {rc}, {wall:.1f} s wall; launches {counts}")
    _check(rc == 0, f"cli.hmc (mixedcg) returned {rc}")
    with open(os.path.join(run_dir, "output.data")) as f:
        lines = [ln.split() for ln in f if ln.strip() and not ln.startswith("#")]
    _check(len(lines) == 2, f"output.data has {len(lines)} lines, expected 2")
    secs = []
    for cols in lines:
        plaq, dh = float(cols[1]), float(cols[3])
        _check(math.isfinite(dh), f"non-finite dH in {cols}")
        _check(0.0 < plaq < 1.0, f"plaquette {plaq} outside (0, 1)")
        secs.append(float(cols[6]))
    # the low operator on the bf16 copy (K1-B or K1-S on it), f32 hops beside it
    bf16 = counts["K1-B"] + counts["K1-S bf16 hops"]
    _check(bf16 > 0 and counts["K1"] + counts["K1-S hops"] > bf16 and counts["K2"] > 0
           and _schur_ran(dc, counts), f"a kernel of the mixed HMC path was not launched: "
                                       f"{counts}")
    _check_no_plain(counts)
    outer = [o for o, _ in rec.calls]
    _say(f"[main-mixed] s/trajectory {secs} (CG, phase 5: {secs_cg}); {len(rec.calls)} mixed "
         f"CG solves, outer/inner per solve {rec.calls}; at max_outer (50): "
         f"{sum(o >= 50 for o in outer)}")

    # one Qsw_pm solve with rgmixedcg on phase 7's clover gauge: K1 with the
    # clover epilogues on the bf16 copy at 16^3x32
    ccfg = read_input(os.path.join(workdir, "main-clover.input"))
    lat = ccfg.lat
    m = ccfg.monomials[3]  # CLOVERDETRATIO: the light operator
    params = DiracParams(kappa=m.kappa, mu=m.two_kappa_mu / (2 * m.kappa), c_sw=m.csw)
    arr, _, _ = load_checkpoint(cconf, lat)
    u = torch.as_tensor(arr, device="cuda").to(torch.complex64)
    gen = rng.generator(rng.Key(77), "cuda")
    b2 = torch.randn((2, 4, 3) + lat.eo_site_shape, generator=gen, device="cuda")
    tol = RG_TOL
    fc = wf.make_fast_clover(u, params, lat)
    res = {}
    for solver in ("cg", "rgmixedcg", "rgmixedcg", "cg"):
        n0 = _read_counts(dc)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = monomials._solve_qsw(fc, b2, params, lat, tol, MAXITER, solver)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n1 = _read_counts(dc)
        # hops on the bf16 copy and with a clover epilogue, K1's and K1-S's
        nb = sum(n1[k] - n0[k] for k in ("K1-B", "K1-S bf16 hops"))
        nc = sum(n1[k] - n0[k] for k in ("K1-C", "K1-S clover hops"))
        r = wf.q_hat_pm_clover_fast(fc, out.x, params, lat) - b2
        rel = float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b2))
        res.setdefault(solver, []).append((dt, out.iterations, rel, nb, nc))
        _say(f"[main-mixed] Qsw_pm solve {solver} on the clover gauge: {out.iterations} "
             f"iterations, {dt:.4f} s, |Q x - b| / |b| {rel:.3e} (tol {tol:.0e}); "
             f"hops bf16 {nb}, clover {nc}")
        _check(rel <= 10 * tol and out.iterations < MAXITER, f"{solver} solve off: {rel:.3e}")
    _check(all(nb > 0 and nc >= nb for _, _, _, nb, nc in res["rgmixedcg"]),
           "the rgmixedcg solve did not run the clover epilogues on the bf16 copy")
    _check_no_plain(_read_counts(dc))
    return counts, secs, rec.calls, res


# ---------------------------------------------------------------------------
# phase 13: main path 9, the domain-decomposed HMC on a slab mesh
# ---------------------------------------------------------------------------


def mesh_smoke_input(text: str, **keys) -> str:
    """sample-input/hmc5-multichip.input with the global keys given (L, T,
    Measurements, NSave, NrTProcs, NrYProcs) replaced; the action stays."""
    out = []
    for line in text.splitlines():
        kv = re.match(r"^([A-Za-z0-9_]+)\s*=", line.split("#", 1)[0].strip())
        if kv and kv.group(1) in keys:
            line = f"{kv.group(1)} = {keys[kv.group(1)]}"
        out.append(line)
    return "\n".join(out) + "\n"


class _SolveRecorder:
    """Wraps dispatch.solve_degenerate: the whole-lattice hopping launches
    (K1, K1-R, K1-S) made inside the solves, summed."""

    def __init__(self, fn, dc):
        self.fn, self.dc, self.k1, self.k1r, self.k1s, self.calls = fn, dc, 0, 0, 0, 0

    def __call__(self, *a, **k):
        n0 = _read_counts(self.dc)
        res = self.fn(*a, **k)
        n1 = _read_counts(self.dc)
        self.k1 += n1["K1"] - n0["K1"]
        self.k1r += n1["K1-R"] - n0["K1-R"]
        self.k1s += n1["K1-S"] - n0["K1-S"]
        self.calls += 1
        return res


def _hop_kernels(dc) -> tuple:
    """The slab kernels of a sharded hop with the overlap: KH and K3-I+K4
    (K3-I and K4 in a tree from before KH, run with --root)."""
    return ("KH", "K3-I+K4") if hasattr(dc, "halo_pack") else ("K3-I", "K4")


def _check_kh(dc, counts: dict, what: str) -> None:
    """Every sharded hop with the overlap ran KH and then K3-I+K4, and
    nothing else of the slab kernels (a tree from before KH, run with
    --root, has neither)."""
    if hasattr(dc, "halo_pack"):
        _check(counts["KH"] > 0 and counts["KH"] == counts["K3-I+K4"]
               and counts["K3-I"] == counts["K4"] == 0,
               f"{what}: a sharded hop did not run KH and K3-I+K4: {counts}")


def _output_rows(run_dir: str) -> list:
    with open(os.path.join(run_dir, "output.data")) as f:
        return [ln.split() for ln in f if ln.strip() and not ln.startswith("#")]


def phase_mesh_hmc(workdir: str):
    """`cli.hmc` on hmc5-multichip as shipped (4^3x8 on 4 x 2 slabs, K4
    alone), then at 16^3x32 on 4 x 2 slabs (KH, K3-I+K4) for 2 trajectories
    beside the same input without a mesh, then one batched inversion of 12
    point columns on its checkpoint under the mesh against the unsharded one."""
    import numpy as np
    import torch

    from tmlqcd_tpu_torch import parallel
    from tmlqcd_tpu_torch.cli import hmc as cli
    from tmlqcd_tpu_torch.config_tmlqcd import read_input
    from tmlqcd_tpu_torch.inverter import invert_eo_rhs
    from tmlqcd_tpu_torch.io.checkpoint import load_checkpoint
    from tmlqcd_tpu_torch.meas.sources import point_source
    from tmlqcd_tpu_torch.ops import dslash_cuda as dc
    from tmlqcd_tpu_torch.ops.wilson import DiracParams, d_full
    from tmlqcd_tpu_torch.solvers import dispatch

    # 1. hmc5 as shipped
    run_dir = os.path.join(workdir, "run-mesh-hmc5")
    rc, log, counts, wall = _run_cli(cli, ["-f", SAMPLE_MESH, "-o", run_dir])
    _say(f"[main-mesh] cli.hmc hmc5-multichip as shipped exit {rc}, {wall:.1f} s wall; "
         f"launches {counts}")
    _check(rc == 0, f"cli.hmc (hmc5) returned {rc}")
    _check("[hmc] device mesh {'t': 4, 'm': 2} over 1 devices (t x y slabs: 2 x 2, 8 slabs per "
           "device)" in log, "cli.hmc did not print the mesh line of hmc5")
    rows = _output_rows(run_dir)
    _check(len(rows) == 4, f"output.data has {len(rows)} lines, expected 4")
    for cols in rows:
        _check(0.0 < float(cols[1]) < 1.0 and math.isfinite(float(cols[3])),
               f"hmc5 trajectory off: {cols}")
    arr, traj, _ = load_checkpoint(os.path.join(run_dir, "conf.000004.npz"))
    _check(traj == 4 and bool(np.isfinite(arr).all()), "conf.000004.npz does not read back")
    _check(counts[_hop_kernels(dc)[-1]] > 0 and counts["K3-I"] == 0,
           f"hmc5 slab launches: {counts}")
    _check_kh(dc, counts, "hmc5")
    _check_no_plain(counts)
    total = dict(counts)  # every run of path 9, summed
    _say(f"[main-mesh] hmc5: plaquettes {[float(c[1]) for c in rows]}, s/trajectory "
         f"{[float(c[6]) for c in rows]}; conf.000004.npz read back")

    # 2. the same action at 16^3x32: on 4 x 2 slabs, then without a mesh
    with open(SAMPLE_MESH) as f:
        text = f.read()
    secs, res_counts = {}, {}
    for procs in ((4, 2), (1, 1)):
        tag = f"{procs[0]}x{procs[1]}"
        path = os.path.join(workdir, f"mesh-{tag}.input")
        with open(path, "w") as f:
            f.write(mesh_smoke_input(text, L=16, T=32, Measurements=2, NSave=2,
                                     NrTProcs=procs[0], NrYProcs=procs[1]))
        cfg = read_input(path)
        _check(cfg.lat.dims == (32, 16, 16, 16) and cfg.measurements == 2
               and cfg.nr_procs[0] == procs[0] and cfg.nr_procs[2] == procs[1]
               and [m.type for m in cfg.monomials] == ["GAUGE", "DET"],
               "the 16^3x32 mesh input was not derived as intended")
        rec = _SolveRecorder(dispatch.solve_degenerate, dc)
        run = os.path.join(workdir, f"run-mesh-{tag}")
        rc, log, counts, wall = _run_cli(cli, ["-f", path, "-o", run],
                                         [(dispatch, "solve_degenerate", rec)])
        _check(rc == 0, f"cli.hmc (16^3x32, {tag}) returned {rc}")
        rows = _output_rows(run)
        _check(len(rows) == 2 and all(0.0 < float(c[1]) < 1.0 and math.isfinite(float(c[3]))
                                      and int(c[8]) < 500 for c in rows),
               f"16^3x32 {tag} trajectories off: {rows}")
        secs[tag] = [float(c[6]) for c in rows]
        res_counts[tag] = counts
        _say(f"[main-mesh] 16^3x32 mesh {tag}: {wall:.1f} s wall, s/trajectory {secs[tag]}, "
             f"acceptance iterations {[int(c[8]) for c in rows]}; {rec.calls} solves, inside "
             f"them K1 {rec.k1}, K1-R {rec.k1r}, K1-S {rec.k1s}; launches {counts}")
        _check_no_plain(counts)
        if procs == (4, 2):
            _check(all(counts[k] > 0 for k in _hop_kernels(dc)) and rec.k1 == 0
                   and rec.k1r == 0 and rec.k1s == 0,
                   f"the solves on the mesh did not run on the slab kernels alone: {counts}, "
                   f"inside the solves K1 {rec.k1} K1-R {rec.k1r} K1-S {rec.k1s}")
            _check_kh(dc, counts, "16^3x32 (4,2)")
            conf = os.path.join(run, "conf.000002.npz")
    _say(f"[main-mesh] s/trajectory at 16^3x32: 4 x 2 slabs {secs['4x2']}, no mesh "
         f"{secs['1x1']} ({min(secs['4x2']) / min(secs['1x1']):.2f}x)")

    # 3. 12 point columns under the mesh (the multi-RHS slab kernels): the
    # default mesh (KH, K3-I+K4), without overlap (K3), and on t slabs alone
    # without overlap (K1-T), each beside the batched CG on the whole lattice
    cfg = read_input(os.path.join(workdir, "mesh-4x2.input"))
    lat, det = cfg.lat, cfg.monomials[1]
    params = DiracParams(kappa=det.kappa, mu=det.two_kappa_mu / (2 * det.kappa))
    arr, _, _ = load_checkpoint(conf, lat)
    u = torch.as_tensor(arr, device="cuda").to(torch.complex64)
    bs = torch.stack([point_source(lat, sp, c, (0, 0, 0, 0), device="cuda")
                      for sp in range(4) for c in range(3)])
    runs = (("whole", None, ()),
            ("mesh (4,2)", parallel.Mesh(4, 2, device="cuda"), _hop_kernels(dc)),
            ("mesh (4,2) no overlap", parallel.Mesh(4, 2, device="cuda", overlap=False),
             ("K3",)),
            ("t slabs (4,1) no overlap", parallel.Mesh(4, 1, device="cuda", overlap=False),
             ("K1-T",)))
    # path 9's launches: the runs through a mesh, not their baselines
    for key, value in res_counts["4x2"].items():
        total[key] += value
    ref = None
    for name, mesh, kernels in runs + runs[1:2]:
        dc.reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = invert_eo_rhs(u, bs, params, lat, tol=1e-7, maxiter=MAXITER, mesh=mesh)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        cm = _read_counts(dc)
        if mesh is not None:
            for key, value in cm.items():
                total[key] += value
        _check_no_plain(cm)
        worst = max(float(torch.linalg.vector_norm(d_full(u, res.x[i], params, lat) - bs[i]))
                    for i in range(NRHS))  # |b| = 1
        _check(worst <= RESIDUAL_BOUND, f"{name}: a column's |M x - b| / |b| is {worst:.3e}")
        if ref is None:
            ref = res
        diff = float((res.x - ref.x).abs().max())
        scale = float(ref.x.abs().max())
        _check(diff <= BATCH_VS_SINGLE * scale, f"{name}: the solution differs by {diff:.3e}")
        _check(res.iterations == ref.iterations < MAXITER,
               f"{name}: {res.iterations} iterations, whole lattice {ref.iterations}")
        _check(all(cm[k] > 0 for k in kernels) and (mesh is None or cm["K1-R"] == 4),
               f"{name}: launches {cm}")
        if mesh is not None and mesh.overlap:
            _check_kh(dc, cm, name)
        _say(f"[main-mesh] invert_eo_rhs 12 columns, {name}: {res.iterations} "
             f"iterations, {dt:.3f} s, true residual max {worst:.3e}, max|x - x_whole| "
             f"{diff:.3e} (max|x| {scale:.3e}); launches " +
             ", ".join(f"{k} {v}" for k, v in cm.items() if v))
    return total, secs


# ---------------------------------------------------------------------------
# phase 14
# ---------------------------------------------------------------------------


def ndpoly_smoke_input(text: str) -> str:
    """hmc3 cut as `nf211_smoke_input` cuts it, its NDRAT block retyped as
    NDPOLY: the same kappa, 2Kappamubar, 2Kappaepsbar and interval [0.01,
    4.7], degree max(DegreeOfRational, 32) = 32, 3 integration steps on its
    timescale, heatbath precision 1e-16 (|r| <= 1e-8 |b|).  Its GRADIENTFLOW
    block is taken out: path 5 runs it."""
    text, n = re.subn(r"(?im)^(BeginMonomial\s+)NDRAT\b", r"\1NDPOLY", text)
    _check(n == 1, "hmc3 holds no NDRAT block to retype")
    text = re.sub(r"(?ims)^BeginMeasurement\s+GRADIENTFLOW.*?^EndMeasurement[^\n]*\n", "", text)
    return clover_smoke_input(text, steps={"GAUGE": "2", "CLOVERDET": "2", "NDPOLY": "3"},
                              ntraj=1)


def phase_ndpoly(workdir: str, conf1: str):
    """Main path 10: `cli.hmc.main` on hmc3's action with NDPOLY in place of
    NDRAT at 16^3x32 (1 trajectory, the validate lines read back), the
    launches of the NDPOLY heatbath, force and acceptance counted apart,
    peak device memory; then one mu-shift reweighting (2 samples,
    mu -> 1.1 mu) on path 1's checkpoint."""
    import torch

    from tmlqcd_tpu_torch import rng
    from tmlqcd_tpu_torch.cli import hmc as cli
    from tmlqcd_tpu_torch.config_tmlqcd import read_input
    from tmlqcd_tpu_torch.hmc.poly_monomials import NDPolyMonomial
    from tmlqcd_tpu_torch.hmc.reweight import mu_shift_reweighting
    from tmlqcd_tpu_torch.io.checkpoint import load_checkpoint
    from tmlqcd_tpu_torch.ops import dslash_cuda as dc
    from tmlqcd_tpu_torch.ops.wilson import DiracParams

    with open(SAMPLE_NF211) as f:
        text = ndpoly_smoke_input(f.read())
    path = os.path.join(workdir, "main-ndpoly.input")
    with open(path, "w") as f:
        f.write(text)
    cfg = read_input(path)
    poly = cfg.monomials[3]
    _check(cfg.lat.dims == (32, 16, 16, 16) and not cfg.meas
           and [m.type for m in cfg.monomials] == ["GAUGE", "CLOVERTRLOG", "CLOVERDET", "NDPOLY"]
           and (poly.kappa, poly.two_kappa_mubar, poly.two_kappa_epsbar, poly.stilde_min,
                poly.stilde_max, poly.csw) == (0.1400645, 0.1315052, 0.1351419, 0.01, 4.7, 0.0),
           "the NDPOLY smoke input was not derived as intended")
    # each piece of the NDPOLY monomial with the counters read around it
    pieces = {"heatbath": {}, "force": {}, "action": {}}
    hb_iters, calls = [], {k: 0 for k in pieces}

    def counted(name, fn):
        def wrapper(*a, **k):
            before = _read_counts(dc)
            out = fn(*a, **k)
            after = _read_counts(dc)
            for key, value in after.items():
                pieces[name][key] = pieces[name].get(key, 0) + value - before[key]
            calls[name] += 1
            if name == "heatbath":
                hb_iters.append(out[2])
            return out
        return wrapper

    patches = [(NDPolyMonomial, "heatbath_info", counted("heatbath", NDPolyMonomial.heatbath_info)),
               (NDPolyMonomial, "force", counted("force", NDPolyMonomial.force)),
               (NDPolyMonomial, "action_info", counted("action", NDPolyMonomial.action_info))]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run_dir = os.path.join(workdir, "run-ndpoly")
    rc, log, counts, wall = _run_cli(cli, ["-f", path, "-o", run_dir, "--checkpoint-format",
                                           "ildg"], patches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    _check(rc == 0, f"cli.hmc returned {rc}")
    m = re.search(r"\[validate\] ndpoly: polynomial degree (\d+), max relative error (\S+)", log)
    v = re.search(r"\[validate\].*ndpoly: spec\(Q\^2\) ~ \[(\S+), (\S+)\]", log)
    _check(m is not None and v is not None and int(m.group(1)) == 32,
           "cli.hmc did not print the NDPOLY validate lines")
    lmin, lmax = float(v.group(1)), float(v.group(2))
    _say(f"[ndpoly] cli.hmc exit {rc}, {wall:.1f} s wall; degree 32, max relative error "
         f"{float(m.group(2)):.3e} of P(x) x^(1/4) on [0.01, 4.7]; spec(Q_nd^2) ~ "
         f"[{lmin:.3e}, {lmax:.3e}]: {'inside' if 0.01 <= lmin and lmax <= 4.7 else 'OUTSIDE'}")
    lines = _output_rows(run_dir)
    _check(len(lines) == 1, f"output.data has {len(lines)} lines")
    plaq, dh, secs = float(lines[0][1]), float(lines[0][3]), float(lines[0][6])
    _check(math.isfinite(dh) and 0.0 < plaq < 1.0, f"dH {dh}, plaquette {plaq}")
    _check(counts["K1-SD"] > 0 and counts["K1-R-D"] == 0 and counts["K1-R"] == 0,
           f"doublet launches: {counts}")
    for name in ("heatbath", "action"):
        c = pieces[name]
        _check(calls[name] == 1 and c["K1-SD"] > 0
               and all(c[k] == 0 for k in ("K1-R-D", "K1", "K2", "K1-S")),
               f"NDPOLY {name}: Q_nd^2 must be K1-SD alone: {c}")
    f = pieces["force"]
    _check(f["K1"] > 0 and f["K2"] > 0 and f["K1-SD"] > 0 and f["K1-R-D"] == 0,
           f"NDPOLY force launches: {f}")
    _check_no_plain(counts)
    _say(f"[ndpoly] s/trajectory {secs}, dH {dh:+.6e}, plaquette {plaq:.6f}; heatbath CG "
         f"iterations {hb_iters}; peak device memory {peak:.2f} GiB")
    for name in ("heatbath", "force", "action"):
        c = pieces[name]
        _say(f"[ndpoly] {name}: {calls[name]} calls, launches K1-SD {c['K1-SD']}, K1 {c['K1']}, "
             f"K2 {c['K2']}, K1-R-D {c['K1-R-D']}")
    _say(f"[ndpoly] launches of the whole run: " + ", ".join(f"{k} {v}" for k, v in counts.items()
                                                             if v))

    # mu-shift reweighting on path 1's checkpoint: w = det Qhat_pm(1.1 mu) /
    # det Qhat_pm(mu), kappa = 0.13, mu = 0.01
    lat = cfg.lat
    arr, _, _ = load_checkpoint(conf1, lat)
    u = torch.as_tensor(arr, device="cuda").to(torch.complex64)
    p_old = DiracParams(kappa=0.13, mu=0.0026 / 0.26)
    p_new = DiracParams(kappa=0.13, mu=1.1 * p_old.mu)
    dc.reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    samples = mu_shift_reweighting(u, p_old, p_new, lat, rng.Key(5), n_samples=2, tol=1e-7,
                                   maxiter=MAXITER)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    rcounts = _read_counts(dc)
    vals = [float(x) for x in samples]
    _check(len(vals) == 2 and all(math.isfinite(x) for x in vals), f"samples {vals}")
    _check(rcounts["K1-S"] > 0 and rcounts["K1"] == 0, f"reweighting launches: {rcounts}")
    _check_no_plain(rcounts)
    _say(f"[ndpoly] mu-shift reweighting on {os.path.basename(conf1)}, mu {p_old.mu} -> "
         f"{p_new.mu}: samples {vals} (mean exp {sum(math.exp(x) for x in vals) / 2:.6f}), "
         f"{dt:.3f} s, K1-S launches {rcounts['K1-S']}")
    for key, value in rcounts.items():
        counts[key] += value
    return counts, secs


# ---------------------------------------------------------------------------
# phase 15
# ---------------------------------------------------------------------------

SMEARED_INPUT = INVERT_INPUT + """UseStoutSmearing = yes
StoutRho = 0.1
StoutNoIterations = 3
UseSourceSmearing = yes
APEAlpha = 0.5
APEIterations = 2
JacobiKappa = 0.2
JacobiIterations = 10
"""


def phase_invert_smeared(workdir: str, conf: str, iters6: int):
    """Main path 11: `cli.invert.main` on phase 5's checkpoint with stout
    smearing (rho 0.1, 3 iterations) and source smearing (APE 0.5 x 2,
    Jacobi 0.2 x 10): 12 smeared point columns in one batched CG on K1-R,
    each column's true residual against the plain unpreconditioned operator
    on the stout-smeared gauge."""
    import torch

    from tmlqcd_tpu_torch.cli import invert as cli
    from tmlqcd_tpu_torch.config_tmlqcd import read_input
    from tmlqcd_tpu_torch.io.checkpoint import load_checkpoint
    from tmlqcd_tpu_torch.io.propagator import read_propagator
    from tmlqcd_tpu_torch.meas.smearing import ape_smear_spatial, jacobi_smear, stout_smear
    from tmlqcd_tpu_torch.meas.sources import point_source
    from tmlqcd_tpu_torch.ops.wilson import DiracParams, d_full

    path = os.path.join(workdir, "invert-smeared.input")
    with open(path, "w") as f:
        f.write(SMEARED_INPUT)
    cfg = read_input(path)
    op, lat = cfg.operators[0], cfg.lat
    _check(cfg.use_stout_smearing and cfg.use_source_smearing
           and (cfg.stout_rho, cfg.stout_iterations, cfg.ape_alpha, cfg.ape_iterations,
                cfg.jacobi_kappa, cfg.jacobi_iterations) == (0.1, 3, 0.5, 2, 0.2, 10),
           "the smeared inversion input was not read as intended")
    out_dir = os.path.join(workdir, "prop-smeared")
    rc, log, counts, wall = _run_cli(cli, ["-f", path, "-c", conf, "--format", "lime",
                                           "-o", out_dir])
    _check(rc == 0, f"cli.invert returned {rc}")
    m = re.search(r"12 sources batched: (\d+) iters, max\|r\|\^2=(\S+), (\S+)s", log)
    _check(m is not None and "[invert] stout smearing: rho=0.1 iters=3" in log,
           "cli.invert did not report the stout smearing and a batched solve of 12 sources")
    iters, solve_s = int(m.group(1)), float(m.group(3))
    _check(0 < iters < op.max_solver_iterations and counts["K1-R"] == 4 * iters + 8,
           f"{iters} iterations, launches {counts}")
    _check_no_plain(counts)
    cols, _ = read_propagator(os.path.join(out_dir, "propagator.00.000003.lime"), lat)
    _check(len(cols) == NRHS, f"{len(cols)} columns")
    arr, _, _ = load_checkpoint(conf, lat)
    u = stout_smear(torch.as_tensor(arr, device="cuda").to(torch.complex64), lat, 0.1, 3)
    u_ape = ape_smear_spatial(u, lat, 0.5, 2)
    params = DiracParams(kappa=op.kappa, mu=op.two_kappa_mu / (2 * op.kappa))
    worst = 0.0
    for i, (s, c) in enumerate((s, c) for s in range(4) for c in range(3)):
        b = jacobi_smear(point_source(lat, s, c, (0, 0, 0, 0), device="cuda"), u_ape, lat,
                         0.2, 10)
        x = torch.as_tensor(cols[i], device="cuda").to(torch.complex64)
        res = float(torch.linalg.vector_norm(d_full(u, x, params, lat) - b)
                    / torch.linalg.vector_norm(b))
        worst = max(worst, res)
        _check(res <= RESIDUAL_BOUND, f"smeared column {i}: |M x - b| / |b| = {res:.3e}")
    _say(f"[smeared] cli.invert exit {rc}, {wall:.1f} s wall; batched solve {solve_s} s "
         f"({solve_s / NRHS:.4f} s per column), {iters} iterations (phase 6, unsmeared: "
         f"{iters6}); true residual max {worst:.3e} (bound {RESIDUAL_BOUND:.0e}); launches "
         f"K1-R {counts['K1-R']}")
    return counts, solve_s


# ---------------------------------------------------------------------------
# phase 16
# ---------------------------------------------------------------------------

OFFLINE_INPUT = """L = 16
T = 32
BeginMeasurement GRADIENTFLOW
  Frequency = 10
  StepSize = 0.02
  Steps = 50
EndMeasurement
BeginMeasurement POLYAKOV
  Direction = 0
EndMeasurement
BeginMeasurement ORIENTEDPLAQUETTES
EndMeasurement
BeginMeasurement FIELDSTRENGTH
EndMeasurement
"""


# calls the benchmark CLI times (its default is 100) and the K1 it is held to
BENCH_APPS = 1000


def phase_offline_benchmark_api(workdir: str, nconf: str, conf1: str, k1_ms: float):
    """`cli.offline_measurement.main` on phase 9's checkpoint (every file
    read back, the flow against phase 9's own), `cli.benchmark.main` at
    16^3x32 (K1 within 1.5x of K1 timed by phase 3's method just before, each
    the least of `benchmark.LOOPS` loops), and
    an `api.Session` round trip
    on phase 5's checkpoint (plaquette, one inverted point column, the
    native checksum route)."""
    import torch

    from tmlqcd_tpu_torch import api, native
    from tmlqcd_tpu_torch.cli import benchmark, offline_measurement
    from tmlqcd_tpu_torch.lattice import Lattice
    from tmlqcd_tpu_torch.meas.sources import point_source
    from tmlqcd_tpu_torch.ops import dslash_cuda as dc
    from tmlqcd_tpu_torch.ops.wilson import DiracParams, d_full

    total = {}

    def add(c):
        for key, value in c.items():
            total[key] = total.get(key, 0) + value

    # offline measurement: trajectory 1's checkpoint is measured as trajectory 0
    path = os.path.join(workdir, "offline.input")
    with open(path, "w") as f:
        f.write(OFFLINE_INPUT)
    out_dir = os.path.join(workdir, "offline")
    rc, log, counts, wall = _run_cli(offline_measurement, ["-f", path, "-c", nconf, "-o",
                                                           out_dir])
    add(counts)
    _check(rc == 0, f"cli.offline_measurement returned {rc}")
    names = sorted(os.listdir(out_dir))
    _check(names == ["field_strength.data", "gradflow.000000", "oriented_plaquettes.data",
                     "polyakov.data"], f"offline files {names}")
    times, t2p, t2c = _read_gradflow(os.path.join(out_dir, "gradflow.000000"))
    _, p9, c9 = _read_gradflow(os.path.join(workdir, "run-main-nf211", "gradflow.000000"))
    dev = max(abs(a - b) / b for a, b in zip(t2p + t2c, p9 + c9))
    _check(len(times) == 50 and dev <= 1e-6,
           f"the offline flow differs from phase 9's by {dev:.3e} relative")
    rows = {}
    for name in names[:1] + names[2:]:
        with open(os.path.join(out_dir, name)) as f:
            lines = [ln.split() for ln in f if ln.strip()]
        _check(len(lines) == 1 and lines[0][0] == "00000000"
               and all(math.isfinite(float(v)) for v in lines[0][1:]),
               f"{name}: {lines}")
        rows[name] = lines[0][1:]
    op = [float(v) for v in rows["oriented_plaquettes.data"]]
    _check(all(0.0 < v < 1.0 for v in op), f"oriented plaquettes {op}")
    _say(f"[offline] cli.offline_measurement exit {rc}, {wall:.1f} s wall; gradflow.000000 "
         f"equals phase 9's within {dev:.1e}; polyakov {rows['polyakov.data']}; oriented "
         f"plaquettes {op}; field strength (E_plaq, E_clover, Q) {rows['field_strength.data']}")

    # the benchmark CLI at 16^3x32: K1 and one Qhat_pm (K1-S).  K1's loop is
    # host-bound (~25 us of wrapper a call), and the card's host is shared:
    # the time of 100 calls swings by 2x within seconds and drifts over
    # minutes, and one loop of 1000 read 1.53x another seconds apart.  So the
    # CLI reports the least of `benchmark.LOOPS` loops of BENCH_APPS calls,
    # and its K1 is held to the least of as many loops of phase 3's method on
    # phase 3's fields just before it, not to phase 3's reading of minutes
    # ago (printed beside)
    lat16 = Lattice((32, 16, 16, 16))
    params, _, fg12, psi, psi_o, _, _ = _fields(lat16, "cuda", 12)
    epi = ("mhat", params.mutld, 1.0, params.kappa ** 2, True)
    k1_now = min(_time_ms(lambda: dc.hopping_split(fg12.ug_odd, psi, 1, lat16, epi=epi,
                                                   gcomp=fg12.gcomp,
                                                   **_epi_kw(epi, psi_o, None)), BENCH_APPS)
                 for _ in range(benchmark.LOOPS))
    del fg12, psi, psi_o
    rc, log, counts, wall = _run_cli(benchmark, ["--dims", "16", "16", "16", "32",
                                                 "--apps", str(BENCH_APPS)])
    add(counts)
    _check(rc == 0, f"cli.benchmark returned {rc}")
    res = json.loads(log.strip().splitlines()[-1])
    k1, qpm = res["K1"], res["Qhat_pm"]
    _check(res["route"] == "cuda" and res["card"] != "not read" and counts["K1"] > 0
           and counts["K1-S"] > 0 and res["apps"] == BENCH_APPS,
           f"benchmark {res}, launches {counts}")
    _check(k1_now / 1.5 <= k1["ms"] <= 1.5 * k1_now,
           f"benchmark K1 {k1['ms']:.4f} ms against phase 3's method just before, "
           f"{k1_now:.4f} ms (phase 3: {k1_ms:.4f} ms)")
    _check_no_plain(counts)
    _say(f"[benchmark] {res['card']}: K1 {k1['ms'] * 1e3:.1f} us ({k1['gflops']:.1f} GF/s, "
         f"{k1['bound_share']:.1%} of its bound {k1['bound_ms'] * 1e3:.1f} us; phase 3's method "
         f"just before {k1_now * 1e3:.1f} us, phase 3 {k1_ms * 1e3:.1f} us; the least of "
         f"{benchmark.LOOPS} loops of {BENCH_APPS} calls each); Qhat_pm (K1-S) {qpm['ms'] * 1e3:.1f} us ({qpm['gflops']:.1f} "
         f"GF/s, {qpm['bound_share']:.1%} of its bound {qpm['bound_ms'] * 1e3:.1f} us)")

    # the embedding API
    inp = os.path.join(workdir, "invert.input")
    dc.reset_counters()
    t0 = time.perf_counter()
    s = api.init(inp)
    s.read_gauge(conf1)
    plaq = s.plaquette()
    b = point_source(s.lat, 0, 0, (0, 0, 0, 0), device="cuda")
    x = s.invert(b)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _read_counts(dc)
    add(counts)
    ref_plaq = float(_output_rows(os.path.dirname(conf1))[-1][1])
    op = s.cfg.operators[0]
    params = DiracParams(kappa=op.kappa, mu=op.two_kappa_mu / (2 * op.kappa))
    res = float(torch.linalg.vector_norm(d_full(s.gauge, x, params, s.lat) - b))
    route = native.checksum_route()
    _check(s.gauge.device.type == "cuda" and s.trajectory == _conf_traj(conf1),
           f"session gauge on {s.gauge.device}, trajectory {s.trajectory}")
    _check(abs(plaq - ref_plaq) <= 1e-11, f"session plaquette {plaq} != output.data {ref_plaq}")
    _check(res <= RESIDUAL_BOUND, f"session inversion: |M x - b| / |b| = {res:.3e}")
    _check(route == "native", f"the checksum route is {route}")
    _check(counts["K1-S"] > 0, f"session launches {counts}")
    _check_no_plain(counts)
    s.finalize()
    _say(f"[api] Session on {os.path.basename(conf1)}: plaquette {plaq:.12f} (output.data "
         f"{ref_plaq:.12f}); one point column |M x - b| / |b| {res:.3e}; {wall:.2f} s; "
         f"checksum route {route}; launches K1-S {counts['K1-S']}, K1 {counts['K1']}")
    return total


# ---------------------------------------------------------------------------
# phase 2: the overlap's Q_W on K1
# ---------------------------------------------------------------------------

# The overlap operator of path 12: rho = 1 + s = 1.4, kappa = 1/(8 - 2 rho)
OVERLAP_RHO = 1.4


def phase_qw_kernels(lats, dev="cuda"):
    """The overlap's Q_W = gamma5 D_W(-rho) on K1 (`ops/overlap.qw_split`:
    one launch per parity with the mhat epilogue at mutld 0, k2 = kappa and
    gamma5, psi_o the same-parity half) against the plain route gamma5
    `d_full`: each parity half and the whole field, then one Q_W^2 on K1
    against two plain Q_W.  Returns (largest max|d|, largest relative
    deviation of one Q_W)."""
    from tmlqcd_tpu_torch import rng, su3
    from tmlqcd_tpu_torch.ops import dslash_cuda as dc
    from tmlqcd_tpu_torch.ops import overlap as ov
    from tmlqcd_tpu_torch.ops import wilson_fast as wf

    worst, worst_rel = 0.0, 0.0
    params = ov.OverlapParams(rho=OVERLAP_RHO, m=0.1)
    kappa = params.kernel.kappa
    for lat in lats:
        u = su3.random_su3(rng.generator(rng.Key(31), dev), (4,) + lat.site_shape)
        fg = wf.make_fast_gauge(u, params.kernel, lat)
        psi = rng.normal_spinor(rng.Key(32), (4, 3) + lat.site_shape, dev)
        x = ov.to_pair(psi, lat)
        n0 = dc.hopping_split.launches
        y = ov.qw_split(fg, x, kappa, lat)
        _sync(dev)
        _check(dc.hopping_split.launches == n0 + 2, "Q_W on K1 is not two K1 launches")
        ref = ov.qw_plain(u, psi, params, lat)
        ref_pair = ov.to_pair(ref, lat)
        tag = "x".join(map(str, lat.dims))
        for p in (0, 1):
            err, rel = _rel_err(y[p], ref_pair[p])
            worst, worst_rel = max(worst, err), max(worst_rel, rel)
            _say(f"[check] Q_W on K1 {tag} parity {p}: max|d| {err:.3e} (rel {rel:.2e})")
            _check(rel <= KERNEL_RTOL, f"Q_W on K1 {tag} parity {p} off by {rel:.3e}")
        err, rel = _rel_err(ov.from_pair(y, lat), ref)
        _check(rel <= KERNEL_RTOL, f"Q_W on K1 {tag} (whole field) off by {rel:.3e}")
        y2 = ov.qw_split(fg, y, kappa, lat)
        ref2 = ov.qw_plain(u, ref, params, lat)
        _sync(dev)
        err, rel = _rel_err(ov.from_pair(y2, lat), ref2)
        worst = max(worst, err)
        _say(f"[check] Q_W^2 on K1 (4 launches) {tag} against two plain Q_W: max|d| {err:.3e} "
             f"(rel {rel:.2e})")
        _check(rel <= KERNEL_RTOL, f"Q_W^2 on K1 {tag} off by {rel:.3e}")
    return worst, worst_rel


# ---------------------------------------------------------------------------
# phase 17: main path 12, overlap propagators
# ---------------------------------------------------------------------------

# Path 2's operator point cut to the overlap: m = 0.1, s = 0.4 (rho = 1.4),
# a degree-128 sign with 8 deflated modes on path 2's checkpoint, stout-
# smeared as path 11 smears it.  OVERLAP_PREC is SolverPrecision (|r|^2, the
# solvers stop at |r| <= sqrt(prec) |b|).
OVERLAP_PREC = "1e-10"
# The Ginsparg-Wilson defect |{g5, D} psi - D g5 D psi / rho| / |psi| at
# m = 0.  The reference's bound 10 (sign_err + ev_resid) + 1e-6 assumes
# converged modes: at 16^3x32 its 64 Lanczos steps leave ev_resid ~0.44, so
# that bound (~4.4) lies above any reading.  The limit is set from readings
# instead: the sound operator reads ~7e-2 here on an H100; a sign scaled by
# GW_FAULT gives rho (1 - GW_FAULT^2) = 0.27 for an exact sign (its defect
# is that multiple of g5), and every run reads that planted fault too
GW_LIMIT = 0.2
GW_FAULT = 0.9
OVERLAP_MAXITER = 1000
OVERLAP_PROFILED = 20
OVERLAP_INPUT = """L = 16
T = 32
UseStoutSmearing = yes
StoutRho = 0.1
StoutNoIterations = 3
BeginOperator OVERLAP
  m = 0.1
  s = 0.4
  DegreeOfSignFunction = 128
  NoEigenvalues = 8
  Solver = {solver}
  SolverPrecision = {prec}
  MaxSolverIterations = {maxiter}
EndOperator
"""


def phase_overlap(workdir: str, conf: str, eps_q: float):
    """Main path 12: `cli.invert` with an OVERLAP operator on phase 5's
    checkpoint, stout-smeared (rho 0.1 x 3): 2 point columns with SUMR, then
    1 with CGNE, every Q_W on K1.  Checks each column's true residual with
    D_ov on the plain route (gamma5 d_full; CGNE's bound times the
    condition number 2 rho / m), SUMR against CGNE, the Ginsparg-Wilson
    defect beside a planted fault, D_ov on K1 against the plain route within a bound derived from
    the degree, and the K1 launches against the count the iterations
    predict; the first OVERLAP_PROFILED iterations of one SUMR column
    profiled for the device's idle share.  Returns (launch counts of the
    two runs, seconds per SUMR column)."""
    import numpy as np
    import torch

    from tmlqcd_tpu_torch import rng
    from tmlqcd_tpu_torch.cli import invert as cli
    from tmlqcd_tpu_torch.config_tmlqcd import read_input
    from tmlqcd_tpu_torch.meas.sources import point_source
    from tmlqcd_tpu_torch.ops import overlap as ov

    setups = {}
    real_make = ov.make_overlap

    counts, cols, secs, iters = {}, {}, {}, {}
    prec = float(OVERLAP_PREC)
    tol = prec ** 0.5
    for solver, ncol in (("sumr", 2), ("cgne", 1)):
        path = os.path.join(workdir, f"overlap-{solver}.input")
        with open(path, "w") as f:
            f.write(OVERLAP_INPUT.format(solver=solver, prec=OVERLAP_PREC,
                                         maxiter=OVERLAP_MAXITER))
        op = read_input(path).operators[0]
        _check((op.type, op.overlap_m, op.overlap_s, op.sign_degree, op.sign_n_ev, op.solver)
               == ("OVERLAP", 0.1, 0.4, 128, 8, solver),
               "the overlap input was not read as intended")
        out_dir = os.path.join(workdir, f"prop-overlap-{solver}")
        def keep(*a, solver=solver, **k):
            setups[solver] = real_make(*a, **k)
            return setups[solver]

        rc, log, c, wall = _run_cli(cli, ["-f", path, "-c", conf, "--format", "npz",
                                          "--columns", str(ncol), "-o", out_dir],
                                    patches=[(ov, "make_overlap", keep)])
        _check(rc == 0, f"cli.invert (OVERLAP, {solver}) returned {rc}")
        m = re.search(r"overlap setup \(8 modes, degree 128, sign err (\S+), ev resid (\S+), "
                      r"(\d+) Lanczos steps\) built in (\S+)s", log)
        _check(m is not None, "cli.invert did not print the overlap setup line")
        runs = re.findall(rf"\(OVERLAP, {solver}\) source \(s=\d,c=\d\): (\d+) iters, "
                          r"\|r\|\^2=(\S+), (\S+)s", log)
        _check(len(runs) == ncol, f"{len(runs)} {solver} columns reported, expected {ncol}")
        iters[solver] = [int(r[0]) for r in runs]
        secs[solver] = [float(r[2]) for r in runs]
        _check(all(0 < i < OVERLAP_MAXITER for i in iters[solver]),
               f"{solver} did not converge within {OVERLAP_MAXITER} iterations: {iters[solver]}")
        counts[solver] = c
        _check_no_plain(c)
        setup = setups[solver]
        # K1 launches: the Lanczos steps (Q_W^2, 4 each) and the Ritz signs
        # (Q_W, 2 each), then per sign application 4 (degree + 1) + 2; SUMR
        # takes one sign per iteration, CGNE 2 per iteration and 3 more (D^+ b
        # and the start residual b - D^+ D x0)
        per_sign = ov.k1_launches_per_sign(setup.params.degree)
        n_signs = (sum(iters[solver]) if solver == "sumr"
                   else sum(2 * i + 3 for i in iters[solver]))
        predicted = 4 * setup.lanczos_steps + 2 * setup.params.n_ev + per_sign * n_signs
        _say(f"[overlap] {solver}: setup {float(m.group(4)):.3f} s, {setup.lanczos_steps} "
             f"Lanczos steps, sign_err {setup.sign_err:.3e}, ev_resid {setup.ev_resid:.3e}, "
             f"[lo^2, hi^2] = [{setup.lo2:.4e}, {setup.hi2:.4e}]; iterations {iters[solver]}, "
             f"seconds per column {secs[solver]}; K1 launches {c['K1']} (predicted "
             f"4 x {setup.lanczos_steps} + 2 x {setup.params.n_ev} + {per_sign} x {n_signs} = "
             f"{predicted}); cli.invert {wall:.1f} s wall")
        _check(c["K1"] == predicted, f"K1 launches {c['K1']} != predicted {predicted}")
        with np.load(os.path.join(out_dir, "propagator.00.000003.npz")) as z:
            cols[solver] = torch.as_tensor(z["propagator"], device="cuda")
    setup = setups["sumr"]
    lat = setup.lat
    p = setup.params
    _say(f"[overlap] the two runs' setups: lo^2 {setup.lo2:.6e} / {setups['cgne'].lo2:.6e}, "
         f"the same coefficients: {setup.coeffs == setups['cgne'].coeffs}")
    # true residuals with D_ov on the plain route (gamma5 d_full), each on
    # the setup its run built.  SUMR minimises |b - D x| itself: bound tol.
    # CGNE stops at |D^+ r| <= tol |D^+ b|, so |r| / |b| <= kappa tol with
    # kappa = sigma_max / sigma_min of D_ov; for a unitary gamma5 sign the
    # eigenvalues of the normal D_ov lie on the circle of centre rho + m/2
    # and radius rho - m/2, so kappa <= 2 rho / m
    kappa = 2.0 * p.rho / p.m
    bounds = {"sumr": tol, "cgne": kappa * tol}
    resid = {}
    for solver, x in cols.items():
        for i in range(x.shape[0]):
            b = point_source(lat, 0, i, (0, 0, 0, 0), device="cuda")
            r = float(torch.linalg.vector_norm(ov.dov_psi(setups[solver], x[i], plain=True) - b))
            resid[(solver, i)] = r
            _say(f"[overlap] {solver} column {i}: |D_ov x - b| / |b| = {r:.3e} (plain route; "
                 f"bound {bounds[solver]:.3e}, tolerance {tol:.0e}"
                 f"{', times kappa <= 2 rho / m = %.0f' % kappa if solver == 'cgne' else ''})")
            _check(r <= bounds[solver], f"{solver} column {i}: true residual {r:.3e} > "
                   f"{bounds[solver]:.3e}")
    # the two solutions of column 0, each from its own run's setup: for one
    # operator x_s - x_c = D^-1 (r_c - r_s), so |x_s - x_c| / |x| <= kappa
    # (|r_s| + |r_c|) / |b| with the true residuals just read; two setups
    # that differ break it
    diff = float(torch.linalg.vector_norm(cols["sumr"][0] - cols["cgne"][0])
                 / torch.linalg.vector_norm(cols["cgne"][0]))
    agree = kappa * (resid[("sumr", 0)] + resid[("cgne", 0)])
    _say(f"[overlap] SUMR against CGNE, column 0: {diff:.3e} relative = {diff / tol:.2f} tol "
         f"(bound kappa (|r_sumr| + |r_cgne|) / |b| = {agree:.3e} = {agree / tol:.1f} tol)")
    _check(diff <= agree, f"SUMR and CGNE differ by {diff:.3e} > {agree:.3e}")
    # Ginsparg-Wilson defect against GW_LIMIT, and the same with a planted
    # fault (the sign scaled by GW_FAULT), which must exceed it
    psi = rng.normal_spinor(rng.Key(77), (4, 3) + lat.site_shape, "cuda")
    gw = ov.gw_defect(setup, psi)
    real_sign = ov.sign_q
    ov.sign_q = lambda *a, **k: GW_FAULT * real_sign(*a, **k)
    try:
        gw_fault = ov.gw_defect(setup, psi)
    finally:
        ov.sign_q = real_sign
    ref_bound = 10.0 * (setup.sign_err + setup.ev_resid) + 1e-6
    _say(f"[overlap] Ginsparg-Wilson defect {gw:.3e} (limit {GW_LIMIT}); with the sign scaled "
         f"by {GW_FAULT}: {gw_fault:.3e} (rho (1 - {GW_FAULT}^2) = "
         f"{p.rho * (1.0 - GW_FAULT ** 2):.3f} for an exact sign); the reference's 10 (sign_err "
         f"+ ev_resid) + 1e-6 = {ref_bound:.3e} at ev_resid {setup.ev_resid:.3e}")
    _check(gw <= GW_LIMIT, f"GW defect {gw:.3e} > {GW_LIMIT}")
    _check(gw_fault > GW_LIMIT, f"the GW check does not catch a sign scaled by {GW_FAULT}: "
           f"{gw_fault:.3e} <= {GW_LIMIT}")
    # D_ov on K1 against the plain route: per Q_W the routes differ by at
    # most eps_q relative (phase 2's Q_W check, floored at 2^-23); to first
    # order the Clenshaw sum propagates an error made at step k by at most
    # (k + 1) (the Chebyshev polynomials of the second kind on [-1, 1]), so
    # |sign_K1 - sign_plain| <= 2 eps_q sum_k (k + 1) |c_k| sqrt(hi^2) |psi|
    # (two Q_W per step, the final Q_W bounded by sqrt(hi^2)), scaled by
    # (rho - m/2) for D_ov
    eps_q = max(eps_q, 2.0 ** -23)
    ck = np.abs(np.asarray(setup.coeffs))
    amp = float(np.sum((np.arange(len(ck)) + 1) * ck)) * setup.hi2 ** 0.5
    bound = 2.0 * eps_q * amp * (p.rho - 0.5 * p.m)
    d_k1 = ov.dov_psi(setup, psi)
    d_plain = ov.dov_psi(setup, psi, plain=True)
    dev_rel = float(torch.linalg.vector_norm(d_k1 - d_plain) / torch.linalg.vector_norm(psi))
    _say(f"[overlap] D_ov on K1 against the plain route: |d| / |psi| = {dev_rel:.3e}; bound "
         f"2 eps_q sum_k (k+1)|c_k| sqrt(hi^2) (rho - m/2) = 2 x {eps_q:.2e} x "
         f"{amp:.4e} x {p.rho - 0.5 * p.m:.2f} = {bound:.3e} (degree {p.degree})")
    _check(dev_rel <= bound, f"D_ov on K1 off the plain route by {dev_rel:.3e} > {bound:.3e}")
    # one SUMR column profiled (device activity only), its first
    # OVERLAP_PROFILED iterations: every iteration is the same sign function
    # and ~1200 device ops, and a whole column would give the profiler
    # several hundred thousand to sort
    b = point_source(lat, 0, 0, (0, 0, 0, 0), device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ov.invert_overlap(setup, b, tol=tol, maxiter=OVERLAP_PROFILED, solver="sumr")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        ov.invert_overlap(setup, b, tol=tol, maxiter=OVERLAP_PROFILED, solver="sumr")
        torch.cuda.synchronize()
    _say_profile(f"overlap SUMR column, its first {OVERLAP_PROFILED} iterations", wall, prof,
                 {"K1": "hopping_kernel"})
    del prof
    return counts, secs["sumr"]


# ---------------------------------------------------------------------------
# phase 18: main path 13, the Schrödinger functional (hmc4)
# ---------------------------------------------------------------------------

SAMPLE_SF = os.path.join(HERE, "sample-input", "hmc4-sf-coupling.input")
# hmc4's Measurements cut from 100 to 20: from the cold start dH is ~2.6 and
# the configuration stays cold until a trajectory is accepted (~7 % each),
# which the input's seed gives at trajectory 8; 5 of the first 20 accept
SF_SHIPPED, SF_TRAJECTORIES = 100, 20


def phase_hmc_sf(workdir: str):
    """Main path 13: `cli.hmc` on sample-input/hmc4-sf-coupling.input as
    shipped (6^4, cold start, beta 8, SFGAUGE, SFCOUPLING every trajectory)
    but for Measurements, cut to SF_TRAJECTORIES.  Checks: finite dH,
    acceptance > 0, the frozen t = 0 spatial links bit-equal to the start
    after every trajectory, sf_coupling.data with one row per trajectory,
    finite dS/deta and k equal to sf_coupling_normalization.  Pure gauge: no
    kernel runs (the reference runs no Pallas here either).  Returns
    (launch counts, s/trajectory)."""
    import torch

    from tmlqcd_tpu_torch import hmc as hmc_pkg
    from tmlqcd_tpu_torch.cli import hmc as cli
    from tmlqcd_tpu_torch.config_tmlqcd import read_input
    from tmlqcd_tpu_torch.ops.sf import sf_coupling_normalization

    cfg = read_input(SAMPLE_SF)
    _check(cfg.lat.dims == (6, 6, 6, 6) and cfg.start_condition == "cold"
           and cfg.measurements == SF_SHIPPED
           and [m.type for m in cfg.monomials] == ["SFGAUGE"]
           and [m.type for m in cfg.meas] == ["SFCOUPLING"], "hmc4 was not read as shipped")
    with open(SAMPLE_SF) as f:
        text = re.sub(r"(?m)^Measurements = \d+$", f"Measurements = {SF_TRAJECTORIES}", f.read())
    path = os.path.join(workdir, "hmc4-sf-coupling.input")
    with open(path, "w") as f:
        f.write(text)
    cfg = read_input(path)
    _check(cfg.measurements == SF_TRAJECTORIES, "hmc4's Measurements were not cut")
    frozen = []
    real = hmc_pkg.hmc_trajectory

    def watched(c, u, key, *a, **k):
        if not frozen:
            frozen.append(u[:, :, 1:4, 0].clone())
        out = real(c, u, key, *a, **k)
        frozen.append(bool(torch.equal(out[0][:, :, 1:4, 0], frozen[0])))
        return out

    run_dir = os.path.join(workdir, "run-sf")
    rc, log, counts, wall = _run_cli(cli, ["-f", path, "-o", run_dir],
                                     patches=[(hmc_pkg, "hmc_trajectory", watched)])
    _check(rc == 0, f"cli.hmc (hmc4) returned {rc}")
    _check(len(frozen) == SF_TRAJECTORIES + 1 and all(frozen[1:]),
           f"the frozen t = 0 spatial links moved: {frozen[1:]}")
    rows = _output_rows(run_dir)
    _check(len(rows) == SF_TRAJECTORIES, f"{len(rows)} rows in output.data")
    dh = [float(r[3]) for r in rows]
    acc = [int(r[5]) for r in rows]
    s_traj = [float(r[6]) for r in rows]
    _check(all(math.isfinite(v) for v in dh) and sum(acc) > 0,
           f"hmc4: dH {dh}, accepted {acc}")
    with open(os.path.join(run_dir, "sf_coupling.data")) as f:
        sfrows = [ln.split() for ln in f if ln.strip()]
    k = sf_coupling_normalization(cfg.lat, cfg.meas[0].ct)
    _check(len(sfrows) == SF_TRAJECTORIES, f"{len(sfrows)} rows in sf_coupling.data")
    ds = [float(r[1]) for r in sfrows]
    _check(all(math.isfinite(v) for v in ds)
           and all(abs(float(r[2]) - k) <= 1e-9 * k for r in sfrows),
           f"sf_coupling.data: dS/deta {ds}, k {[r[2] for r in sfrows]} against {k}")
    _check(not any(v for key, v in counts.items() if key.startswith("K")),
           f"a kernel launched on the pure-gauge SF path: {counts}")
    mean = sum(s_traj) / len(s_traj)
    late = ds[len(ds) // 2:]
    _say(f"[sf] cli.hmc hmc4 as shipped but {SF_TRAJECTORIES} trajectories exit {rc}, "
         f"{wall:.1f} s wall; s/trajectory mean {mean:.4f}, first {s_traj[:3]}, min "
         f"{min(s_traj):.3f}, max {max(s_traj):.3f}; dH first {dh[:3]}, last {dh[-3:]}; "
         f"acceptance {sum(acc)}/{len(acc)}, the first at trajectory {acc.index(1)}; frozen "
         f"links bit-equal after every trajectory; <dS/deta> over the last half "
         f"{sum(late) / len(late):.6e}; k {k:.10e}")
    return counts, s_traj


# ---------------------------------------------------------------------------
# phase 19: main path 14, the distributed HMC (one process per slab)
# ---------------------------------------------------------------------------

# the rank kernels' checks: (lattice, (t, y) mesh): 16^3x32 at T_loc 16 and
# 8, and hmc5's 4^3x8 on (4, 2) at T_loc 2, the shape path 14's hmc5 run
# gives them
DIST_CASES = (((32, 16, 16, 16), (2, 2)), ((32, 16, 16, 16), (4, 2)), ((8, 4, 4, 4), (4, 2)))
# the ranks' run: its processes and their join
DIST_TIMEOUT = 600.0


def _dist_ranks():
    """tests/dist_ranks.py (the spawned ranks, the faces' loopback), shared
    with the port's tests; its directory joins sys.path, which the spawned
    ranks inherit."""
    tests = os.path.join(HERE, "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import dist_ranks

    return dist_ranks


def phase_draws(dims=(32, 16, 16, 16)) -> dict:
    """The draws of a trajectory and of a hot start at 16^3x32 on the card:
    by timeslice (`lat=`, the decomposition-independent draws every HMC
    path takes) against one draw of the whole field (the route without
    `lat`, which every path took before the draws were keyed by timeslice)
    -> {draw: (ms by timeslice, ms in one draw)}."""
    from tmlqcd_tpu_torch import rng, su3
    from tmlqcd_tpu_torch.lattice import Lattice

    lat, key = Lattice(dims), rng.Key(5)
    spinor = (4, 3) + lat.eo_site_shape
    cases = {
        "momenta": (lambda: rng.random_momenta(key, (4,) + lat.site_shape, "cuda", lat=lat),
                    lambda: rng.random_momenta(key, (4,) + lat.site_shape, "cuda")),
        "pseudofermion": (lambda: rng.normal_spinor(key, spinor, "cuda", lat=lat),
                          lambda: rng.normal_spinor(key, spinor, "cuda")),
        "hot start": (lambda: rng.random_su3_field(key, lat, "cuda"),
                      lambda: su3.random_su3(rng.generator(key, "cuda"), (4,) + lat.site_shape)),
    }
    rows = {name: (_time_ms(rows_fn, 10), _time_ms(one_fn, 10))
            for name, (rows_fn, one_fn) in cases.items()}
    _say(f"[time] draws at {lat.dims}, by timeslice ({lat.dims[0]} generators) against one draw: "
         + "; ".join(f"{k} {a:.3f} ms against {b:.3f} ms" for k, (a, b) in rows.items()))
    return rows


def _k2s_model(loc, yhalo: bool) -> tuple[int, int]:
    """(bytes, flops) of one K2-S launch on a slab: g and psi read once (96 B
    a site each), 576 B written a site, the t and y halos read once."""
    t, x, _, _ = loc.dims
    sites = t * x * loc.m
    halo = 2 * x * loc.m + (2 * t * x * loc.zh if yhalo else 0)
    return sites * (96 + 96 + 576) + 96 * halo, FLOPS_SITE_K2 * sites


def phase_rank_kernels():
    """The kernels of a rank on the one card, for each of DIST_CASES and for
    the one-flavour spinor and the flavour doublet (r_axis 1: KH-P and the
    slab kernel's R>0 route, K1-R-D on the whole lattice): the
    field cut into slabs, KH-P on each against its plain version (the
    torch exchange at one slab, element for element), the faces handed to
    the neighbours by device copies, then K3-I and K4 per slab against their
    plain version (1e-5 of max(1, max|plain|)) and joined bit for bit
    against K1 on the whole lattice; K3-I+K4 (T_loc < 4 on a rank runs it)
    the same (at T_loc 2 there is no interior: K4 covers every row); K2-S
    per slab on the received faces against its plain version and joined bit
    for bit against K2 on the whole lattice.  Then, on slab 0 of (4,2) at
    16^3x32 (16,384 sites) and on one slab of (4,2) at 32^3x64 (262,144
    sites, where a launch is no longer at the launch floor), each kernel's
    loop and device time, its plain version's and its bound
    (`_rank_kernel_times`) -> (worst errors, the 16^3x32 rows, the 32^3x64
    rows)."""
    import torch

    from tmlqcd_tpu_torch import parallel
    from tmlqcd_tpu_torch.lattice import Lattice
    from tmlqcd_tpu_torch.ops import dslash_cuda as dc

    loopback = _dist_ranks().loopback
    worst = {k: 0.0 for k in ("KH-P", "K3-I rank", "K4 rank", "K3-I+K4 rank", "K2-S")}
    n_hops = n_exact = 0
    timed = {}
    for dims, shape in DIST_CASES:
        lat = Lattice(dims)
        params, fg18, fg12, psi, psi_o, g, _ = _fields(lat, "cuda", 35)
        mesh = parallel.Mesh(*shape, device="cuda")
        loc = Lattice(mesh.local(lat).dims)
        one = parallel.Mesh(1, 1, device="cuda")

        def cut(f, mesh=mesh):
            return [s.contiguous() for s in parallel.split_slabs(f, lat, mesh)]

        # the one-flavour spinor, then the flavour doublet (R = 2 at r_axis 1,
        # the slab kernel's R>0 route NDPOLY's operators take on the ranks)
        for x_in, r_axis in ((psi, None), (torch.stack([psi, psi_o], dim=1), 1)):
            for hs in (True, False):
                xs, faces = cut(x_in), []
                for x in xs:
                    n0 = dc.halo_faces.launches
                    mh_f, th_f = dc.halo_faces(x, loc, r_axis, hs)
                    _check(dc.halo_faces.launches == n0 + 1, "KH-P launch not counted")
                    ref_mh = dc._y_halos(x, loc, one, hs, r_axis, faces=True)
                    ref_th = dc._t_halos(x, loc, one, hs, r_axis)
                    _sync("cuda")
                    worst["KH-P"] = max(worst["KH-P"], float((th_f - ref_th).abs().max()),
                                        float((mh_f - ref_mh).abs().max()))
                    _check(torch.equal(mh_f, ref_mh) and torch.equal(th_f, ref_th),
                           f"KH-P mesh {shape} R axis {r_axis} halfspinor {hs} differs from the "
                           f"torch exchange")
                    faces.append((mh_f, th_f))
                halos = loopback(faces, shape)
                variants = ((("K3-I rank", "int", {}),) if loc.dims[0] >= 4 else ())
                for (gname, fg), p in ((("12-real", fg12), 0), (("12-real", fg12), 1),
                                       (("18-real", fg18), 1)):
                    ug = fg.ug_even if p == 0 else fg.ug_odd
                    ugs = cut(ug)
                    split_out, all_out = [], []
                    for r, x in enumerate(xs):
                        th, mh = halos[r]
                        res = {"K3-I rank": torch.zeros_like(x)}
                        bnd = (("K4 rank", "bnd", {"th": th}), ("K3-I+K4 rank", "all", {"th": th}))
                        for name, variant, extra in variants + bnd:
                            outs = []
                            for fn in (dc.hopping_slab_split, dc.hopping_slab_split_plain):
                                out = torch.zeros_like(x)
                                fn(ugs[r], x, p, loc, one, variant, out, mh=mh, gcomp=fg.gcomp,
                                   r_axis=r_axis, **extra)
                                outs.append(out)
                            _sync("cuda")
                            err, rel = _rel_err(*outs)
                            worst[name] = max(worst[name], err)
                            _check(rel <= KERNEL_RTOL,
                                   f"{name} mesh {shape} R axis {r_axis} slab {r} {gname} p={p} "
                                   f"off its plain version by {rel:.3e}")
                            res[name] = outs[0]
                        t_loc = loc.dims[0]
                        joined = res["K3-I rank"].clone()
                        for row in (0, t_loc - 1):
                            joined[..., row, :, :] = res["K4 rank"][..., row, :, :]
                        split_out.append(joined)
                        all_out.append(res["K3-I+K4 rank"])
                    whole = _whole_hop(dc, fg, x_in, p, lat, r_axis)
                    _sync("cuda")
                    for outs in (split_out, all_out):
                        got = parallel.join_slabs(outs, None, mesh)
                        n_hops += 1
                        n_exact += bool(torch.equal(got, whole))
                if r_axis is not None:  # K2-S has no R axis
                    continue
                # K2-S on the received faces, against its plain version and K2
                gs = cut(g)
                for p in (0, 1):
                    got = []
                    for r, x in enumerate(xs):
                        th, mh = halos[r]
                        n0 = dc.hopping_ug_vjp_slab.launches
                        out = dc.hopping_ug_vjp_slab(gs[r], x, p, loc, th, mh)
                        _check(dc.hopping_ug_vjp_slab.launches == n0 + 1,
                               "K2-S launch not counted")
                        ref = dc.hopping_ug_vjp_slab_plain(gs[r], x, p, loc, th, mh)
                        _sync("cuda")
                        err, rel = _rel_err(out, ref)
                        worst["K2-S"] = max(worst["K2-S"], err)
                        _check(rel <= KERNEL_RTOL, f"K2-S mesh {shape} slab {r} p={p} off its "
                                                   f"plain version by {rel:.3e}")
                        got.append(out)
                    whole = dc.hopping_ug_vjp(g, psi, p, lat)
                    _sync("cuda")
                    n_hops += 1
                    n_exact += bool(torch.equal(parallel.join_slabs(got, None, mesh), whole))
                if (dims, shape) == DIST_CASES[1]:
                    timed = dict(loc=loc, one=one, x=xs[0], halos=halos[0],
                                 ug=cut(fg12.ug_odd)[0], gc=fg12.gcomp, g=gs[0])
        _say(f"[check] rank kernels, {lat.dims} on mesh {shape} (T_loc {loc.dims[0]}), one "
             f"flavour and the doublet (r_axis 1): KH-P equal to the torch exchange; max|d| "
             f"vs plain K3-I {worst['K3-I rank']:.3e}, K4 {worst['K4 rank']:.3e}, K3-I+K4 "
             f"{worst['K3-I+K4 rank']:.3e}, K2-S {worst['K2-S']:.3e}")
    _say(f"[check] joined rank kernels vs K1 / K1-R-D / K2 on the whole lattice: {n_exact} of "
         f"{n_hops} bit for bit")
    _check(n_exact == n_hops, f"{n_hops - n_exact} joined rank hops differ from K1 / K1-R-D / K2 "
                              f"in their bits")
    # loop, device and plain time of each kernel on slab 0 of (4,2) at
    # 16^3x32, then on one slab of (4,2) at 32^3x64
    rows = _rank_kernel_times(timed["x"], timed["halos"], timed["ug"], timed["gc"], timed["g"],
                              timed["loc"], timed["one"], "16^3x32")
    big = _rank_kernel_times(*_big_slab(), "32^3x64")
    return worst, rows, big


# one rank's slab of 32^3x64 on (4, 2): 16 x 32 x 16 x 32 = 262,144 sites
BIG_SLAB = (16, 32, 16, 32)


def _big_slab():
    """The inputs of the rank kernels on BIG_SLAB: a random gauge copy,
    spinor and cotangent on the slab, and the halos its own faces give when
    handed round as if every neighbour were the slab itself (the values do
    not matter for a time) -> (x, (th, mh), ug, gcomp, g, loc, one)."""
    from tmlqcd_tpu_torch import parallel
    from tmlqcd_tpu_torch.lattice import Lattice
    from tmlqcd_tpu_torch.ops import dslash_cuda as dc

    loc = Lattice(BIG_SLAB)
    _, _, fg12, x, _, g, _ = _fields(loc, "cuda", 37)
    faces = dc.halo_faces(x, loc, None, True)
    halos = _dist_ranks().loopback([faces, faces], (1, 2))[0]
    return (x, halos, fg12.ug_odd, fg12.gcomp, g, loc,
            parallel.Mesh(1, 1, device="cuda"))


def _rank_kernel_times(x, halos, ug, gc, g, loc, one, tag: str) -> dict:
    """Each rank kernel on one slab `loc` (odd parity, half-spinor faces):
    loop time (CUDA events, 200 calls), device time (torch.profiler, 50
    calls, the kernel's own launches only), its plain version's and its
    bound by the byte model -> {name: (loop, plain, bound, bound by,
    device)} in ms."""
    import torch

    from tmlqcd_tpu_torch.ops import dslash_cuda as dc

    th, mh = halos
    out = torch.empty_like(x)
    slab = {"int": "K3-I rank", "bnd": "K4 rank", "all": "K3-I+K4 rank"}
    cases = {"KH-P": (lambda: dc.halo_faces(x, loc), lambda: (dc._y_halos(
                 x, loc, one, True, None, faces=True), dc._t_halos(x, loc, one, True, None)),
                 "halo_kernel", (192 * (2 * loc.dims[1] * loc.m
                                        + 2 * loc.dims[0] * loc.dims[1] * loc.zh), 0)),
             "K2-S": (lambda: dc.hopping_ug_vjp_slab(g, x, 1, loc, th, mh),
                      lambda: dc.hopping_ug_vjp_slab_plain(g, x, 1, loc, th, mh),
                      "ug_vjp_slab_kernel", _k2s_model(loc, True))}
    for variant, name in slab.items():
        kw = {"th": th} if variant != "int" else {}
        cases[name] = (lambda v=variant, kw=kw: dc.hopping_slab_split(ug, x, 1, loc, one, v, out,
                                                                      mh=mh, gcomp=gc, **kw),
                       lambda v=variant, kw=kw: dc.hopping_slab_split_plain(
                           ug, x, 1, loc, one, v, out, mh=mh, gcomp=gc, **kw),
                       "slab_kernel", _slab_model(loc, one, variant, 384))
    rows = {}
    for name, (fn, plain, sub, (nbytes, flops)) in cases.items():
        ms = _time_ms(fn, 200)
        dev_ms, seen, made = _device_ms(fn, 50, sub)
        pms = _time_ms(plain, 10)
        bound = _bound_ms(nbytes, flops)
        rows[name] = (ms, pms, *bound, dev_ms)
        _say(f"[time] {name:13s} {tag} slab of (4,2) [{loc.dims}, {loc.volume} sites]: loop "
             f"{ms * 1e3:8.1f} us, device {dev_ms * 1e3:8.1f} us (mean of the {seen} of its {made} "
             f"launches the profiler saw), "
             f"bound {bound[0] * 1e3:.2f} us by {bound[1]} ({nbytes / 1e6:.3f} MB, "
             f"{bound[0] / dev_ms:.0%} of it by device time), plain {pms * 1e3:9.1f} us")
    return rows


# hopping_rank's routes, (halfspinor, overlap): K3-I then K4 (K3-I+K4 below
# T_loc 4) beside the exchange, the same with full-spinor faces, and K3 on
# the extended slab
RANK_ROUTES = ((True, True), (False, True), (True, False))


def _rank_hop_check(mesh) -> dict:
    """On this rank of `mesh` (4 x 2 ranks): `dslash_cuda.hopping_rank`, the
    composite of KH-P, `comm.exchange` and the slab kernel the mesh picks,
    once per route of RANK_ROUTES at 16^3x32 (T_loc 8) and at hmc5's 4^3x8
    (T_loc 2), on the one-flavour spinor and on the flavour doublet (r_axis
    1, the slab kernel's R>0 route), on card tensors against the same call
    on host copies (the plain route: the torch faces, the exchange,
    hopping_slab_split_plain), and against this rank's slab of K1 / K1-R-D
    on the whole lattice, bit for bit -> {"rel": {case: relative max|d|},
    "unequal": [cases whose slab differs from K1 / K1-R-D]}."""
    import torch

    from tmlqcd_tpu_torch import parallel
    from tmlqcd_tpu_torch.lattice import Lattice
    from tmlqcd_tpu_torch.ops import dslash_cuda as dc

    errs, unequal = {}, []
    for dims in ((32, 16, 16, 16), (8, 4, 4, 4)):
        lat = Lattice(dims)
        _, _, fg12, psi, psi_o, _, _ = _fields(lat, "cuda", 36)
        loc = mesh.local(lat)
        r = mesh.rank
        for x_in, r_axis in ((psi, None), (torch.stack([psi, psi_o], dim=1), 1)):
            x = parallel.split_slabs(x_in, lat, mesh)[r].contiguous()
            for hs, ov in RANK_ROUTES:
                m = dataclasses.replace(mesh, halfspinor=hs, overlap=ov)
                key = (f"{dims[3]}^3x{dims[0]} T_loc {loc.dims[0]} R axis {r_axis} halfspinor {hs} "
                       f"overlap {ov}")
                for p in (0, 1):
                    ugw = fg12.ug_even if p == 0 else fg12.ug_odd
                    ug = parallel.split_slabs(ugw, lat, mesh)[r].contiguous()
                    got = dc.hopping_rank(ug, x, p, loc, m, fg12.gcomp, r_axis=r_axis)
                    ref = dc.hopping_rank(ug.cpu(), x.cpu(), p, loc, m, fg12.gcomp, r_axis=r_axis)
                    rel = float((got.cpu() - ref).abs().max()) / max(1.0, float(ref.abs().max()))
                    errs[key] = max(errs.get(key, 0.0), rel)
                    whole = _whole_hop(dc, fg12, x_in, p, lat, r_axis)
                    if not torch.equal(got, parallel.split_slabs(whole, lat, mesh)[r]):
                        unequal.append(f"{key} p={p}")
    return {"rel": errs, "unequal": unequal}


def _dist_job(rank: int, jobs, backend: str, hop_check: bool) -> dict:
    """One rank of phase 19's and 20's runs (its group joined by
    tests/dist_ranks.py, rank r on card r mod the cards): with `hop_check`,
    `_rank_hop_check`; then `cli.hmc.main(argv + --distributed)` for each
    job, the launch counters zeroed just before and read just after; its
    counts, the exchange statistics, the wall time, the interval check's
    results on this rank, whether the SF's frozen links stayed bit-equal
    after each trajectory (on the rank holding t = 0), each trajectory's
    (H_old, H_new) and its peak device memory."""
    from tmlqcd_tpu_torch import comm, parallel
    from tmlqcd_tpu_torch.cli import hmc as cli
    from tmlqcd_tpu_torch.ops import dslash_cuda as dc

    import torch

    from tmlqcd_tpu_torch import hmc as hmc_pkg
    from tmlqcd_tpu_torch.hmc import validate

    dc.kernel_library()  # built before the ranks started: loaded
    result = {"rank": rank, "runs": [],
              "hop_check": _rank_hop_check(parallel.make_mesh((4, 2))) if hop_check else None}
    checked = []
    real_check = validate.check_rational_intervals

    def check(*a, **k):  # the interval check's results on this rank
        out = real_check(*a, **k)
        checked.append([tuple(c) for c in out])
        return out

    # with a momenta mask (the SF): whether the frozen t = 0 spatial links are
    # bit-equal to the start after each trajectory, on the rank holding t = 0
    frozen, energies = [], []
    real_traj = hmc_pkg.hmc_trajectory

    def watched(c, u, key, *a, **k):
        out = real_traj(c, u, key, *a, **k)
        energies.append((out[1].h_old, out[1].h_new))
        if c.momenta_mask is not None and c.lat.offset[0] == 0:
            if not frozen:
                frozen.append(u[:, :, 1:4, 0].clone())
            frozen.append(bool(torch.equal(out[0][:, :, 1:4, 0], frozen[0])))
        return out

    validate.check_rational_intervals = check
    hmc_pkg.hmc_trajectory = watched
    try:
        for argv in jobs:
            checked.clear()
            frozen.clear()
            energies.clear()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            dc.reset_counters()
            comm.reset_stats()
            t0 = time.perf_counter()
            rc = cli.main(list(argv) + ["--distributed", "--backend", backend])
            wall = time.perf_counter() - t0
            result["runs"].append({"rc": rc, "wall": wall, "counts": _read_counts(dc),
                                   "comm": comm.stats(), "validate": list(checked),
                                   "frozen": frozen[1:], "energies": list(energies),
                                   "peak_gib": torch.cuda.max_memory_allocated() / 2**30})
    finally:
        validate.check_rational_intervals = real_check
        hmc_pkg.hmc_trajectory = real_traj
    return result


def _run_ranks(world: int, backend: str, jobs, out_dir: str, hop_check: bool = False) -> list:
    """`world` spawned ranks of `_dist_job` on the card(s) -> their results."""
    dist_ranks = _dist_ranks()
    os.makedirs(out_dir, exist_ok=True)
    try:
        results = dist_ranks.run_ranks(_dist_job, world, out_dir, jobs, backend, hop_check,
                                       timeout=DIST_TIMEOUT, cpu=False, backend=backend)
    except RuntimeError as exc:
        raise SmokeFailure(f"the ranks failed: {exc}") from None
    for r, res in enumerate(results):
        _check(all(run["rc"] == 0 for run in res["runs"]), f"rank {r}: cli.hmc returned "
                                                            f"{[run['rc'] for run in res['runs']]}")
    return results


def _sum_counts(results, run: int) -> dict:
    total = {}
    for res in results:
        for k, v in res["runs"][run]["counts"].items():
            total[k] = total.get(k, 0) + v
    return total


def phase_distributed(workdir: str, one_dir: str | None = None):
    """Main path 14: `cli.hmc --distributed` in 8 spawned processes on the
    one card with backend gloo (the ranks run the card's kernels; the faces
    travel through pinned host memory), after `_rank_hop_check` in each:
    hmc5-multichip as shipped (4 x 2 slabs of 4^3x8, T_loc 2: KH-P and
    K3-I+K4 on a rank) against the one-process mesh run of the same input
    (`one_dir`, phase 13's, else run here), then its action at 16^3x32 on
    4 x 2 ranks for 1 trajectory (T_loc 8: KH-P, K3-I, K4), K2-S in every
    force; no K1, K1-S, K1-SD, K2 or KH launch in the ranks.  Then NCCL
    between cards where there are two or more, else the line that says it
    was not run."""
    import torch

    from tmlqcd_tpu_torch.cli import hmc as cli

    if one_dir is None:
        one_dir = os.path.join(workdir, "run-one-hmc5")
        rc, _, _, _ = _run_cli(cli, ["-f", SAMPLE_MESH, "-o", one_dir])
        _check(rc == 0, f"cli.hmc (hmc5, one process) returned {rc}")
    with open(SAMPLE_MESH) as f:
        text = f.read()
    big = os.path.join(workdir, "dist-16x32.input")
    with open(big, "w") as f:
        f.write(mesh_smoke_input(text, L=16, T=32, Measurements=1, NSave=1, NrTProcs=4,
                                 NrYProcs=2))
    dist_dir, big_dir = os.path.join(workdir, "run-dist-hmc5"), os.path.join(workdir,
                                                                               "run-dist-16x32")
    jobs = [["-f", SAMPLE_MESH, "-o", dist_dir], ["-f", big, "-o", big_dir]]
    t0 = time.perf_counter()
    results = _run_ranks(8, "gloo", jobs, os.path.join(workdir, "ranks-gloo"), hop_check=True)
    wall = time.perf_counter() - t0
    hop = {k: max(res["hop_check"]["rel"][k] for res in results)
           for k in results[0]["hop_check"]["rel"]}
    unequal = [f"rank {r}: {c}" for r, res in enumerate(results)
               for c in res["hop_check"]["unequal"]]
    _say("[check] hopping_rank on 8 ranks (gloo) against its plain route on host copies, "
         "relative max|d| over the ranks and both parities: "
         + "; ".join(f"{k} {v:.3e}" for k, v in hop.items())
         + f"; each rank's slab against K1 / K1-R-D on the whole lattice: "
           f"{len(hop) * 2 * len(results) - len(unequal)} of {len(hop) * 2 * len(results)} "
           f"bit for bit")
    _check(all(v <= KERNEL_RTOL for v in hop.values()),
           f"hopping_rank off its plain route: {hop}")
    _check(not unequal, f"hopping_rank differs from K1 / K1-R-D in its bits: {unequal}")
    counts5, counts16 = _sum_counts(results, 0), _sum_counts(results, 1)
    total = {k: counts5[k] + counts16[k] for k in counts5}
    _say(f"[main-dist] 8 ranks (gloo) on {torch.cuda.device_count()} card(s): {wall:.1f} s wall "
         f"for the hopping_rank check and both runs (the ranks' start included); launches "
         f"summed over the ranks: hmc5 "
         + ", ".join(f"{k} {v}" for k, v in counts5.items() if v) + "; 16^3x32 "
         + ", ".join(f"{k} {v}" for k, v in counts16.items() if v))
    _check_no_plain(total)
    for what, c in (("hmc5", counts5), ("16^3x32", counts16)):
        _check(all(c[k] == 0 for k in ("K1", "K1-R", "K1-S", "K1-SD", "K2", "KH", "K1-R-D")),
               f"{what} on ranks: a whole-lattice kernel launched: {c}")
        _check(c["KH-P"] > 0 and c["K2-S"] > 0, f"{what} on ranks: KH-P / K2-S did not run: {c}")
    _check(counts5["K3-I+K4 rank"] > 0, f"hmc5 on ranks (T_loc 2): K3-I+K4 did not run {counts5}")
    _check(counts16["K3-I rank"] > 0 and counts16["K4 rank"] > 0
           and counts16["K3-I rank"] == counts16["K4 rank"],
           f"16^3x32 on ranks (T_loc 8): K3-I / K4 did not run in pairs: {counts16}")
    rows, one = _output_rows(dist_dir), _output_rows(one_dir)
    _check(len(rows) == len(one) == 4, f"output.data rows: {len(rows)} on ranks, {len(one)} one")
    vol = 8 * 4 ** 3
    h = 16 * vol + 6 * 5.3 * vol + 6 * vol  # |H| from above, as tests/test_torch_dist.py
    bound = 10 * 2.0 ** -24 * 2 * h / math.sqrt(8 * 4 * vol)
    ddh = [abs(float(d[3]) - float(o[3])) for d, o in zip(rows, one)]
    # the acceptance solves' iterations (columns 8 on): the ranks' heatbath
    # and force surrogates run the sharded operators (the diagonals in
    # torch) where one process runs K1 and K1-S (the diagonals in the
    # kernel), so the two runs solve right-hand sides equal to f32 rounding;
    # CG's residual falls by a factor ~0.3-0.8 an iteration, so a
    # perturbation that small moves the iteration where it crosses the
    # stopping threshold by at most one (a wrong operator moves it by many)
    for d, o in zip(rows, one):
        _check(math.isfinite(float(d[3])) and d[0] == o[0] and d[5] == o[5]
               and len(d) == len(o) and all(abs(int(a) - int(b)) <= 1
                                            for a, b in zip(d[7:], o[7:])),
               f"hmc5 on ranks against one process: {d} vs {o}")
        _check(abs(float(d[1]) - float(o[1])) <= 1e-5, f"plaquette {d[1]} vs {o[1]}")
    _check(max(ddh) <= bound, f"|ddH| {max(ddh):.3e} above its bound {bound:.3e}")
    n_equal = sum(d[7:] == o[7:] for d, o in zip(rows, one))
    big_rows = _output_rows(big_dir)
    _check(len(big_rows) == 1 and math.isfinite(float(big_rows[0][3]))
           and 0.0 < float(big_rows[0][1]) < 1.0, f"16^3x32 on ranks: {big_rows}")
    st5, st16 = results[0]["runs"][0]["comm"], results[0]["runs"][1]["comm"]
    _say(f"[main-dist] hmc5 on 8 ranks: s/trajectory {[float(c[6]) for c in rows]} (one process "
         f"{[float(c[6]) for c in one]}), |ddH| {[f'{v:.2e}' for v in ddh]} (bound "
         f"{bound:.2e}), plaquettes equal to 1e-5, acceptance iterations equal in {n_equal} of "
         f"{len(rows)} rows (within one in all); rank 0: {st5['exchanges']} "
         f"exchanges, {st5['seconds'] / max(st5['exchanges'], 1) * 1e3:.3f} ms each (gloo through "
         f"host memory, not NCCL), {st5['bytes'] / 1e6:.2f} MB sent")
    _say(f"[main-dist] 16^3x32 on 8 ranks: s/trajectory {float(big_rows[0][6])}, dH "
         f"{float(big_rows[0][3]):+.4e}, acceptance iterations {big_rows[0][8]}; rank 0: "
         f"{st16['exchanges']} exchanges, {st16['seconds'] / max(st16['exchanges'], 1) * 1e3:.3f} "
         f"ms each (gloo through host memory, not NCCL), {st16['bytes'] / 1e6:.2f} MB sent")
    cards = torch.cuda.device_count()
    if cards >= 2:
        world = 4 if cards >= 4 else 2
        small = os.path.join(workdir, "dist-nccl.input")
        with open(small, "w") as f:
            f.write(mesh_smoke_input(text, NrTProcs=world // 2 if world == 4 else 2,
                                     NrYProcs=2 if world == 4 else 1))
        t0 = time.perf_counter()
        nres = _run_ranks(world, "nccl", [["-f", small, "-o", os.path.join(workdir, "run-nccl")]],
                          os.path.join(workdir, "ranks-nccl"))
        nrows = _output_rows(os.path.join(workdir, "run-nccl"))
        stn = nres[0]["runs"][0]["comm"]
        _check(len(nrows) == 4 and all(math.isfinite(float(c[3])) for c in nrows),
               f"nccl run: {nrows}")
        _say(f"[main-dist] nccl between cards: {world} ranks on {world} cards, "
             f"{time.perf_counter() - t0:.1f} s wall, s/trajectory {[float(c[6]) for c in nrows]}, "
             f"{stn['seconds'] / max(stn['exchanges'], 1) * 1e3:.3f} ms per exchange")
    else:
        _say("nccl between cards: not run, 1 card")
    return total, [float(c[6]) for c in rows]


# ---------------------------------------------------------------------------
# phase 20: main path 15, measurements, NDPOLY and the SF on the ranks
# ---------------------------------------------------------------------------

# the ranks' jobs: (a) hmc2 with ONLINE and PIONNORM at 16^3x32, (b) hmc5's
# action at 16^3x32 with the gauge measurements, (c) GAUGE + NDPOLY at
# hmc5's 4^3x8, all on 4 x 2 ranks; (d) hmc4 on 3 ranks along t
MEAS_FLOW_STEPS = 10  # hmc3's GRADIENTFLOW, Steps cut from 50
NDPOLY_TRAJECTORIES = 1  # cut from 2 for the time limit (~8000 exchanges a trajectory)
SF_RANK_TRAJECTORIES = 4  # of hmc4's 100
SF_RANKS = 3  # T_loc 2: the mesh refuses T = 6 on 2 ranks (T_loc 3 is odd)
# the f32 true-residual floor of a CG solve, |b - A x| / |b|: 1.3e-7 at
# most in the port's records (ROADMAP queue 3), with a margin of ~8
R_FLOOR = 1e-6


def _pionnorm_block(online: str) -> str:
    """A PIONNORM block with the ONLINE block's operator and frequency."""
    return re.sub(r"(?i)BeginMeasurement\s+ONLINE", "BeginMeasurement PIONNORM", online)


def meas_smoke_inputs(workdir: str) -> dict:
    """The four inputs of phase 20, written into `workdir` -> {job: path}."""
    with open(SAMPLE) as f:
        hmc2 = smoke_input(f.read())
    hmc2 = re.sub(r"(?m)^(\s*)(Measurements|NSave|Frequency) = 3$", r"\1\2 = 1", hmc2)
    online = re.search(r"(?ims)^BeginMeasurement\s+ONLINE.*?^EndMeasurement[^\n]*\n", hmc2)
    _check(online is not None, "hmc2 holds no ONLINE block")
    hmc2 += "NrTProcs = 4\nNrYProcs = 2\n" + _pionnorm_block(online.group(0))
    with open(SAMPLE_MESH) as f:
        hmc5 = f.read()
    gauge = mesh_smoke_input(hmc5, L=16, T=32, Measurements=1, NSave=1)
    gauge += (f"BeginMeasurement GRADIENTFLOW\n  Frequency = 1\n  StepSize = 0.02\n"
              f"  Steps = {MEAS_FLOW_STEPS}\nEndMeasurement\n"
              + "".join(f"BeginMeasurement POLYAKOV\n  Frequency = 1\n  Direction = {d}\n"
                        "EndMeasurement\n" for d in (0, 2))
              + "BeginMeasurement ORIENTEDPLAQUETTES\n  Frequency = 1\nEndMeasurement\n"
              "BeginMeasurement FIELDSTRENGTH\n  Frequency = 1\nEndMeasurement\n")
    # hmc3's doublet (path 10's NDPOLY: its kappa, 2Kappamubar, 2Kappaepsbar,
    # interval and degree 32) in place of hmc5's DET, on DET's timescale with
    # its integration steps and precision (the heatbath to |r| <= 1e-8 |b|,
    # as path 10)
    poly, n = re.subn(r"(?ims)^BeginMonomial\s+DET\b.*?^EndMonomial[^\n]*\n",
                      "BeginMonomial NDPOLY\n  Timescale = 1\n  kappa = 0.1400645\n"
                      "  2Kappamubar = 0.1315052\n  2Kappaepsbar = 0.1351419\n"
                      "  StildeMin = 0.01\n  StildeMax = 4.7\n  AcceptancePrecision = 1e-16\n"
                      "  MaxSolverIterations = 1000\n  IntegrationSteps = 2\nEndMonomial\n",
                      mesh_smoke_input(hmc5, Measurements=NDPOLY_TRAJECTORIES,
                                       NSave=NDPOLY_TRAJECTORIES))
    _check(n == 1, "hmc5 holds no DET block to replace")
    with open(SAMPLE_SF) as f:
        sf = re.sub(r"(?m)^Measurements = \d+$", f"Measurements = {SF_RANK_TRAJECTORIES}",
                    f.read())
    sf = re.sub(r"(?m)^NSave = \d+$", "NSave = 1", sf) + f"NrTProcs = {SF_RANKS}\n"
    paths = {}
    for name, text in (("hmc2", hmc2), ("gauge", gauge), ("ndpoly", poly), ("sf", sf)):
        paths[name] = os.path.join(workdir, f"meas-{name}.input")
        with open(paths[name], "w") as f:
            f.write(text)
    return paths


def _meas_rows(path: str) -> list:
    with open(path) as f:
        return [[float(v) for v in ln.split()] for ln in f if ln.strip() and ln[0] != "#"]


def _qhat_bounds(conf: str, lat, params) -> tuple[float, float]:
    """(lambda_min / 2, lambda_max * 2) of Qhat_pm on a checkpoint: the
    port's inverse and power iterations in one process, padded by 2 for a
    bound."""
    import torch

    from tmlqcd_tpu_torch import rng
    from tmlqcd_tpu_torch.io.checkpoint import load_checkpoint
    from tmlqcd_tpu_torch.ops import wilson_fast as wf
    from tmlqcd_tpu_torch.solvers.eigen import lambda_max, lambda_min

    arr, _, _ = load_checkpoint(conf, lat)
    u = torch.as_tensor(arr, device="cuda").to(torch.complex64)
    fg = wf.make_fast_gauge(u, params, lat)
    mv = lambda x2: wf.q_hat_pm_fast(fg, x2, params, lat)  # noqa: E731
    shape = (4, 3) + lat.eo_site_shape
    with torch.no_grad():
        lo = lambda_min(mv, shape, rng.Key(31), device="cuda", split=True)
        hi = lambda_max(mv, shape, rng.Key(32), device="cuda", split=True)
    return lo / 2.0, hi * 2.0


def _correlator_bound(cpp, kappa: float, tol: float, b_sq: float, vs: int,
                      lam: tuple[float, float]) -> float:
    """|C(t) - C'(t)| of two solves of one system M psi = b that each met
    CG's stopping test (the normal equations' residual at most r = max(tol,
    R_FLOOR) of its right-hand side), C = sum over a timeslice of a bilinear
    of psi with a unitary spin matrix, normalised by the spatial volume vs:
    |dx_o| <= 2 r |rhs| / lambda_min(Qhat_pm), |rhs| <= sqrt(lambda_max)
    (1 + 16 kappa) |b| (|H| <= 16), |dx_e| <= 16 kappa |dx_o|, and |dC| <=
    (2 |psi| + |dpsi|) |dpsi| / vs, |psi|^2 = vs sum_t C_PP(t)."""
    r = max(tol, R_FLOOR)
    rhs = math.sqrt(lam[1]) * (1 + 16 * kappa) * math.sqrt(b_sq)
    dpsi = (1 + 16 * kappa) * 2 * r * rhs / lam[0]
    psi = math.sqrt(vs * sum(cpp))
    return (2 * psi + dpsi) * dpsi / vs


def _check_rank_kernels(c: dict, what: str, t_loc: int) -> None:
    """A path on ranks ran the rank kernels (K3-I and K4 in pairs at T_loc
    >= 4, K3-I+K4 below) and no whole-lattice kernel."""
    _check(all(c[k] == 0 for k in ("K1", "K1-R", "K1-S", "K1-SD", "K2", "KH", "K1-R-D")),
           f"{what} on ranks: a whole-lattice kernel launched: {c}")
    _check(c["KH-P"] > 0 and c["K2-S"] > 0, f"{what} on ranks: KH-P / K2-S did not run: {c}")
    if t_loc >= 4:
        _check(c["K3-I rank"] > 0 and c["K3-I rank"] == c["K4 rank"],
               f"{what} on ranks (T_loc {t_loc}): K3-I / K4 did not run in pairs: {c}")
    else:
        _check(c["K3-I+K4 rank"] > 0, f"{what} on ranks (T_loc {t_loc}): K3-I+K4 did not run")


def _say_ranks(tag: str, rows: list, st: dict, counts: dict) -> None:
    _say(f"[main-dist-meas] {tag}: s/trajectory {[r[6] for r in rows]}; rank 0: "
         f"{st['exchanges']} exchanges, {st['seconds'] / max(st['exchanges'], 1) * 1e3:.3f} ms "
         f"each (gloo through host memory), {st['bytes'] / 1e6:.2f} MB sent; launches summed "
         f"over the ranks: " + ", ".join(f"{k} {v}" for k, v in counts.items() if v))


def _ds_deta_bound(cfg, n_traj: int) -> float:
    """|d(dS/deta)| of two runs of the SF input `cfg` whose links differ by
    f32 rounding alone: each of the 2 n link updates of a 2MN trajectory
    (n steps) rounds every entry (|U_ij| <= 1) at eps_f32 in each run, so
    after n_traj trajectories the links differ by d <= 4 n n_traj eps_f32
    an entry, a product of three links by 3 sqrt(3) d <= 6 d.  dS/deta =
    -(beta c_t / 3) sum over k = 1..3 and the vs sites of the two boundary
    timeslices of Re tr(P dW^+/deta), with P such a product and dW/deta
    diagonal, |dW_jj/deta| = |dphi_j/deta| / L; so |d(dS/deta)| <= beta c_t
    vs 6 d (sum_j |dphi_j/deta| + |dphi'_j/deta|) / L."""
    m = cfg.meas[0]
    t_ext, el = cfg.lat.dims[0], cfg.lat.dims[1]
    vs = cfg.lat.volume // t_ext
    d = 4 * cfg.integrator.steps[0] * n_traj * EPS_F32
    dphi = 2 * (1 + abs(m.nu - 0.5) + abs(m.nu + 0.5))
    return cfg.beta * m.ct * vs * 6 * d * dphi / el


def _meas_abc(workdir: str, inputs: dict, cfgs: dict, runs: dict, res8: list, counts: dict,
              stats: dict, secs: dict) -> None:
    """Phase 20's checks of (a)-(c) against one process (see
    `phase_distributed_meas`); fills secs[job] with s/trajectory."""
    import numpy as np

    from tmlqcd_tpu_torch.cli import hmc as cli
    from tmlqcd_tpu_torch.cli import offline_measurement as offline
    from tmlqcd_tpu_torch.ops.wilson import DiracParams

    # (a) hmc2 with ONLINE and PIONNORM
    one = os.path.join(workdir, "run-one-hmc2")
    rc, _, one_counts, _ = _run_cli(cli, ["-f", inputs["hmc2"], "-o", one])
    _check(rc == 0, f"cli.hmc (hmc2, one process) returned {rc}")
    rows, orows = _output_rows(runs["hmc2"]), _output_rows(one)
    _check(len(rows) == len(orows) == 1, f"hmc2 output.data: {rows} vs {orows}")
    d, o = rows[0], orows[0]
    lat2 = cfgs["hmc2"].lat
    vol, t_ext = lat2.volume, lat2.dims[0]
    h = 16 * vol + 6 * 5.3 * vol + 2 * 6 * vol  # |H| from above: momenta, gauge, 2 pseudofermions
    bound = 10 * 2.0 ** -24 * 2 * h / math.sqrt(8 * 4 * vol)
    _check(math.isfinite(float(d[3])) and abs(float(d[3]) - float(o[3])) <= bound
           and d[5] == o[5] and abs(float(d[1]) - float(o[1])) <= 1e-5
           and all(abs(int(a) - int(b)) <= 1 for a, b in zip(d[7:], o[7:])),
           f"hmc2 on ranks against one process: {d} vs {o} (dH bound {bound:.2e})")
    _check_rank_kernels(counts["hmc2"], "hmc2", 8)
    offl = os.path.join(workdir, "offline-hmc2")
    rc, _, _, _ = _run_cli(offline, ["-f", inputs["hmc2"], "-c",
                                     os.path.join(runs["hmc2"], "conf.000001.npz"), "-o", offl])
    _check(rc == 0, f"cli.offline_measurement (hmc2) returned {rc}")
    m = cfgs["hmc2"].meas[0]
    params = DiracParams(kappa=m.kappa, mu=m.two_kappa_mu / (2 * m.kappa))
    lam = _qhat_bounds(os.path.join(runs["hmc2"], "conf.000001.npz"), cfgs["hmc2"].lat, params)
    vs = vol // t_ext
    # (file, its C columns, its width, |b|^2: a Z2 wall or a Z2 volume)
    for name, cols, width, b_sq in (("onlinemeas.000000", (3, 4), 5, 12 * vs),
                                    ("pionnorm.000000", (1,), 2, 12 * vol)):
        got, want = (np.array(_meas_rows(os.path.join(x, name))) for x in (runs["hmc2"], offl))
        _check(got.shape == want.shape == (t_ext, width), f"{name}: {got.shape}")
        cb = _correlator_bound(list(want[:, cols[0]]), m.kappa, float(m.precision) ** 0.5,
                               b_sq, vs, lam)
        diff = float(np.max(np.abs(got[:, list(cols)] - want[:, list(cols)])))
        rel = float(np.max(np.abs(got[:, cols[0]] - want[:, cols[0]]) / np.abs(want[:, cols[0]])))
        _check(diff <= cb and bool(np.all(got[:, cols[0]] > 0)),
               f"{name} on ranks against one process: max|dC| {diff:.3e} above its bound "
               f"{cb:.3e}, or C_PP <= 0")
        _say(f"[main-dist-meas] (a) {name}: {t_ext} timeslices from rank 0, C_PP(0) "
             f"{got[0, cols[0]]:.6e}; against one process on the ranks' checkpoint max|dC| "
             f"{diff:.3e} (bound {cb:.3e} from the stopping test, spec(Qhat_pm) within "
             f"[{lam[0]:.3e}, {lam[1]:.3e}]), C_PP relative {rel:.3e}")
    secs["hmc2"] = float(d[6])
    _say_ranks("(a) hmc2 16^3x32 on 4 x 2 ranks", [[float(v) for v in d]], stats["hmc2"],
               counts["hmc2"])
    _say(f"[main-dist-meas] (a) one process: s/trajectory {float(o[6])}, dH {float(o[3]):+.4e} "
         f"against {float(d[3]):+.4e} on the ranks (bound {bound:.2e}), acceptance iterations "
         f"{o[7:]} against {d[7:]}")

    # (b) the gauge measurements
    rows = _output_rows(runs["gauge"])
    _check(len(rows) == 1 and math.isfinite(float(rows[0][3])), f"(b) output.data {rows}")
    _check_rank_kernels(counts["gauge"], "hmc5 at 16^3x32", 8)
    offl = os.path.join(workdir, "offline-gauge")
    rc, _, _, _ = _run_cli(offline, ["-f", inputs["gauge"], "-c",
                                     os.path.join(runs["gauge"], "conf.000001.npz"), "-o", offl])
    _check(rc == 0, f"cli.offline_measurement (gauge) returned {rc}")
    names = ["field_strength.data", "gradflow.000000", "oriented_plaquettes.data",
             "polyakov.data"]
    _check(sorted(f for f in os.listdir(runs["gauge"]) if not f.startswith(("conf", "nstore",
                                                                           "output")))
           == names, f"(b) files on rank 0: {os.listdir(runs['gauge'])}")
    worst = 0.0
    for name in names[:3]:
        got, want = (np.array(_meas_rows(os.path.join(x, name))) for x in (runs["gauge"], offl))
        _check(got.shape == want.shape, f"{name}: {got.shape} vs {want.shape}")
        rel = float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-300)))
        worst = max(worst, rel)
        _check(rel <= 1e-10, f"{name} on ranks against one process: relative {rel:.3e}")
    # the Polyakov lines: the ranks multiply their slabs' partial products,
    # one process the slices in a row, so the two associate the N factors
    # otherwise; each f32 3x3 product of unitary factors errs by <= 24
    # eps_f32 in the spectral norm, which the unitary factors carry on
    # unchanged, so each order is within 24 N eps_f32 of the exact line and
    # |(1/3) tr| of the difference, and of its volume mean, within 48 N eps_f32
    got, want = (np.array(_meas_rows(os.path.join(x, "polyakov.data")))
                 for x in (runs["gauge"], offl))
    _check(got.shape == want.shape == (2, 4) and list(got[:, 1]) == [0, 2],
           f"polyakov.data: {got} vs {want}")
    poly_d, poly_b = [], []
    for g, w in zip(got, want):
        poly_d.append(float(np.max(np.abs(g[2:] - w[2:]))))
        poly_b.append(48 * cfgs["gauge"].lat.dims[int(g[1])] * EPS_F32)
    _check(all(d <= b for d, b in zip(poly_d, poly_b)),
           f"polyakov.data on ranks against one process: |d| {poly_d} above {poly_b}")
    times, t2p, t2c = _read_gradflow(os.path.join(runs["gauge"], "gradflow.000000"))
    e = [v / t ** 2 for t, v in zip(times, t2p)]
    _check(len(times) == MEAS_FLOW_STEPS and all(b < a for a, b in zip(e, e[1:])),
           f"(b) E_plaq along the flow: {e}")
    secs["gauge"] = float(rows[0][6])
    _say_ranks("(b) hmc5's action 16^3x32 with the gauge measurements on 4 x 2 ranks",
               [[float(v) for v in rows[0]]], stats["gauge"], counts["gauge"])
    _say(f"[main-dist-meas] (b) {', '.join(names)} from rank 0 against one process on the "
         f"ranks' checkpoint: relative {worst:.3e} at most (the Polyakov lines |d| t "
         f"{poly_d[0]:.3e}, y {poly_d[1]:.3e}, bounds 48 N eps_f32 {poly_b[0]:.3e}, "
         f"{poly_b[1]:.3e}; values {[[float(v) for v in r[2:]] for r in got]}); {MEAS_FLOW_STEPS} flow "
         f"steps, t^2 E_plaq {t2p[0]:.6e} -> {t2p[-1]:.6e}, E_plaq falling")

    # (c) NDPOLY
    one = os.path.join(workdir, "run-one-ndpoly")
    rc, olog, one_nd, _ = _run_cli(cli, ["-f", inputs["ndpoly"], "-o", one])
    _check(rc == 0, f"cli.hmc (ndpoly, one process) returned {rc}")
    _check(one_nd["K1-SD"] > 0, f"NDPOLY in one process did not run K1-SD: {one_nd}")
    rows, orows = _output_rows(runs["ndpoly"]), _output_rows(one)
    _check(len(rows) == len(orows) == NDPOLY_TRAJECTORIES, f"(c) output.data {rows}")
    vol = cfgs["ndpoly"].lat.volume
    h = 16 * vol + 6 * 5.3 * vol + 12 * vol  # momenta, gauge, the doublet pseudofermion
    bound = 10 * 2.0 ** -24 * 2 * h / math.sqrt(8 * 4 * vol)
    ddh = [abs(float(a[3]) - float(b[3])) for a, b in zip(rows, orows)]
    _check(all(math.isfinite(float(a[3])) for a in rows) and max(ddh) <= bound
           and all(a[5] == b[5] for a, b in zip(rows, orows)),
           f"(c) NDPOLY on ranks against one process: {rows} vs {orows} (bound {bound:.2e})")
    checks = [res["runs"][2]["validate"] for res in res8]
    _check(checks[0] and all(c == checks[0] for c in checks[1:]),
           f"(c) the interval check differs between the ranks: {checks}")
    c = counts["ndpoly"]
    _check(c["K1-SD"] == 0 and c["K1"] == 0, f"(c) K1-SD / K1 launched on the ranks: {c}")
    _check_rank_kernels(c, "NDPOLY", 2)
    peak = max(res["runs"][2]["peak_gib"] for res in res8)
    secs["ndpoly"] = [float(r[6]) for r in rows]
    _say_ranks("(c) GAUGE + NDPOLY (degree 32) 4^3x8 on 4 x 2 ranks",
               [[float(v) for v in r] for r in rows], stats["ndpoly"], c)
    _say(f"[main-dist-meas] (c) |ddH| against one process {[f'{v:.2e}' for v in ddh]} (bound "
         f"{bound:.2e}), acceptance equal; the interval check on all 8 ranks {checks[0]}; peak "
         f"device memory of a rank {peak:.3f} GiB; one process {[float(r[6]) for r in orows]} "
         f"s/trajectory on K1-SD ({one_nd['K1-SD']} launches)")


def phase_distributed_meas(workdir: str):
    """Main path 15: `cli.hmc --distributed` with the measurements, NDPOLY
    and the Schrödinger functional on the ranks, 8 processes on the one card
    (gloo), every job against one process:
    (a) hmc2 at 16^3x32 on 4 x 2 ranks (T_loc 8), 1 trajectory with ONLINE
        and PIONNORM: output.data against the same input in one process
        (dH within phase 19's derived bound, acceptance equal, iterations
        within one, plaquette to 1e-5), the correlators against one process
        measuring the ranks' checkpoint (`cli.offline_measurement`, the same
        key: the same source) within `_correlator_bound`, C_PP(t) > 0; KH-P,
        K3-I, K4 and K2-S launched, no whole-lattice kernel;
    (b) hmc5's action at 16^3x32 on 4 x 2 ranks with GRADIENTFLOW
        (MEAS_FLOW_STEPS of 0.02), POLYAKOV along t and y,
        ORIENTEDPLAQUETTES and FIELDSTRENGTH: every file against one
        process measuring the ranks' checkpoint, 1e-10 relative (the
        Polyakov lines, associated otherwise, within 48 N eps_f32), E_plaq
        falling along the flow;
    (c) GAUGE + NDPOLY (degree 32) at hmc5's 4^3x8 on 4 x 2 ranks
        (T_loc 2), NDPOLY_TRAJECTORIES trajectories against the same input
        in one process: dH within the derived bound, the interval check the
        same on every rank, no K1-SD and no K1 in the ranks (one process
        runs K1-SD), the peak device memory of a rank;
    (d) hmc4 as shipped on SF_RANKS ranks along t (T_loc 2) in a spawn of
        its own, run beside the one-process runs of (a)-(c),
        SF_RANK_TRAJECTORIES of its 100 trajectories against one process:
        the frozen links bit-equal after each trajectory (a checkpoint
        each), dH within n eps_f32 (|H_old| + |H_new|) of the ranks'
        trajectory, sf_coupling.data's dS/deta within `_ds_deta_bound` and
        its k the closed form.
    Returns (launches summed over the jobs and the ranks, {job: s/trajectory})."""
    import numpy as np
    import torch

    from tmlqcd_tpu_torch.cli import hmc as cli
    from tmlqcd_tpu_torch.cli import offline_measurement as offline
    from tmlqcd_tpu_torch.config_tmlqcd import read_input
    from tmlqcd_tpu_torch.ops.sf import sf_coupling_normalization
    from tmlqcd_tpu_torch.ops.wilson import DiracParams

    inputs = meas_smoke_inputs(workdir)
    cfgs = {k: read_input(v) for k, v in inputs.items()}
    _check(cfgs["hmc2"].lat.dims == (32, 16, 16, 16) and cfgs["hmc2"].nr_procs[0] == 4
           and [m.type for m in cfgs["hmc2"].meas] == ["ONLINE", "PIONNORM"]
           and [m.type for m in cfgs["ndpoly"].monomials] == ["GAUGE", "NDPOLY"]
           and cfgs["ndpoly"].lat.dims == (8, 4, 4, 4) and cfgs["sf"].lat.dims == (6, 6, 6, 6)
           and cfgs["gauge"].lat.dims == (32, 16, 16, 16), "phase 20's inputs were not derived")
    runs = {k: os.path.join(workdir, f"run-dist-{k}") for k in inputs}
    jobs = [["-f", inputs[k], "-o", runs[k]] for k in ("hmc2", "gauge", "ndpoly")]
    t0 = time.perf_counter()
    res8 = _run_ranks(8, "gloo", jobs, os.path.join(workdir, "ranks-meas"))
    wall8 = time.perf_counter() - t0
    _say(f"[main-dist-meas] 8 ranks (gloo) on the one card: {wall8:.1f} s wall for (a)-(c), "
         f"the ranks' start included")
    counts = {name: _sum_counts(res8, k) for k, name in enumerate(("hmc2", "gauge", "ndpoly"))}
    stats = {name: res8[0]["runs"][k]["comm"]
             for k, name in enumerate(("hmc2", "gauge", "ndpoly"))}
    secs = {}
    # (d)'s ranks run beside this process's one-process runs and checks of
    # (a)-(c), so their start costs no wall time of its own
    pool = concurrent.futures.ThreadPoolExecutor(1)
    t0 = time.perf_counter()
    sf_ranks = pool.submit(lambda: (_run_ranks(SF_RANKS, "gloo", [["-f", inputs["sf"], "-o",
                                                                   runs["sf"]]],
                                               os.path.join(workdir, "ranks-sf")),
                                    time.perf_counter() - t0))
    try:
        _meas_abc(workdir, inputs, cfgs, runs, res8, counts, stats, secs)
        res3, wall3 = sf_ranks.result()
    finally:
        pool.shutdown(wait=True)
    counts["sf"] = _sum_counts(res3, 0)
    stats["sf"] = res3[0]["runs"][0]["comm"]
    _say(f"[main-dist-meas] {SF_RANKS} ranks (gloo) on the one card: {wall3:.1f} s wall for (d), "
         f"the ranks' start included, beside the one-process runs of (a)-(c)")

    # (d) the Schrödinger functional on ranks along t
    one = os.path.join(workdir, "run-one-sf")
    rc, _, _, _ = _run_cli(cli, ["-f", inputs["sf"], "-o", one])
    _check(rc == 0, f"cli.hmc (hmc4, one process) returned {rc}")
    rows, orows = _output_rows(runs["sf"]), _output_rows(one)
    _check(len(rows) == len(orows) == SF_RANK_TRAJECTORIES, f"(d) output.data {rows}")
    # dH: the bound of tests/test_torch_sf.py, n eps_f32 (|H_old| + |H_new|)
    # of the ranks' own trajectories (each of the n MD steps rounds every
    # term of H at eps_f32 relative, the two runs in another order)
    n_steps = cfgs["sf"].integrator.steps[0]
    energies = res3[0]["runs"][0]["energies"]
    _check(len(energies) == SF_RANK_TRAJECTORIES, f"(d) energies of {len(energies)} trajectories")
    bounds = [n_steps * EPS_F32 * (abs(h0) + abs(h1)) for h0, h1 in energies]
    ddh = [abs(float(a[3]) - float(b[3])) for a, b in zip(rows, orows)]
    _check(all(d <= b for d, b in zip(ddh, bounds)) and all(a[5] == b[5] for a, b in zip(rows, orows)),
           f"(d) hmc4 on ranks against one process: {rows} vs {orows} (bounds {bounds})")
    frozen = res3[0]["runs"][0]["frozen"]
    _check(len(frozen) == SF_RANK_TRAJECTORIES and all(frozen),
           f"(d) the frozen t = 0 spatial links moved on the rank holding them: {frozen}")
    k_closed = sf_coupling_normalization(cfgs["sf"].lat, cfgs["sf"].meas[0].ct)
    sfrows = _meas_rows(os.path.join(runs["sf"], "sf_coupling.data"))
    osfrows = _meas_rows(os.path.join(one, "sf_coupling.data"))
    _check(len(sfrows) == len(osfrows) == SF_RANK_TRAJECTORIES
           and all(abs(r[2] - k_closed) <= 1e-9 * k_closed for r in sfrows),
           f"(d) sf_coupling.data: {sfrows} (k {k_closed})")
    ds_bound = _ds_deta_bound(cfgs["sf"], SF_RANK_TRAJECTORIES)
    dds = [abs(r[1] - o[1]) for r, o in zip(sfrows, osfrows)]
    _check(max(dds) <= ds_bound, f"(d) dS/deta on ranks {[r[1] for r in sfrows]} against one "
                                 f"process {[o[1] for o in osfrows]}: above {ds_bound:.3e}")
    secs["sf"] = [float(r[6]) for r in rows]
    _say_ranks(f"(d) hmc4 6^4 on {SF_RANKS} ranks along t", [[float(v) for v in r] for r in rows],
               stats["sf"], counts["sf"])
    _say(f"[main-dist-meas] (d) |ddH| against one process {[f'{v:.2e}' for v in ddh]} (bounds "
         f"{[f'{v:.2e}' for v in bounds]}: {n_steps} steps of eps_f32 (|H_old| + |H_new|) of "
         f"each trajectory), acceptance equal, the frozen links bit-equal after each of "
         f"{SF_RANK_TRAJECTORIES} trajectories; dS/deta {[r[1] for r in sfrows]} against one "
         f"process {[r[1] for r in osfrows]}, |d| {max(dds):.3e} (bound {ds_bound:.3e}); k "
         f"{k_closed:.10e}")
    total = {}
    for cnt in counts.values():
        for key, value in cnt.items():
            total[key] = total.get(key, 0) + value
    _check_no_plain(total)
    return total, secs


def _e2e(label: str) -> None:
    """Main paths 1, 3, 5, 6, 7, 8 and 9 alone (`--e2e`): s/trajectory of
    paths 1, 3, 5 and 8, path 6's seconds per operator (12 columns each),
    path 7's seconds per solver and path 9's s/trajectory on the (4,2) mesh
    and without it, printed as one JSON line."""
    with tempfile.TemporaryDirectory() as workdir:
        _, secs1, conf = phase_main_path(workdir)
        _, secs3, cconf = phase_main_path(workdir, clover=True)
        _, secs5, nconf = phase_main_path(workdir, nf211=True)
        _, _, solves6 = phase_invert_doublet(workdir, nconf)
        _, solvers = phase_invert_solvers(workdir, conf, cconf, float("nan"))
        _, secs8, _, _ = phase_mixed_hmc(workdir, secs1, cconf)
        _, secs9 = phase_mesh_hmc(workdir)
    path6 = {}
    for ty, _, sec in solves6:
        path6[ty] = path6.get(ty, 0.0) + sec
    print(json.dumps({"e2e": label, "path1_s_traj": secs1, "path3_s_traj": secs3,
                      "path5_s_traj": secs5, "path6_s": path6, "path8_s_traj": secs8,
                      "path9_s_traj": secs9,
                      "path7_s": {k: v[1] for k, v in solvers.items()}}), flush=True)


def main() -> int:
    args = sys.argv[1:]
    # --root DIR: the package and its kernel sources from another checkout
    # (the parent commit beside the change, for --e2e)
    root = os.path.abspath(args[args.index("--root") + 1]) if "--root" in args else HERE
    if not (os.path.isdir(os.path.join(root, "tmlqcd_tpu_torch"))
            and all(os.path.exists(f) for f in (SAMPLE, SAMPLE_CLOVER, SAMPLE_NF211,
                                                SAMPLE_DOUBLET))):
        print("chip_smoke: run from a checkout of the repository "
              "(tmlqcd_tpu_torch/ and sample-input/ are missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from tmlqcd_tpu_torch.lattice import Lattice

    if "--nd-split" in args:
        # K1-SD's and KH's checks (phase 2), and the doublet operator and the
        # sharded hop split into loop, host and device time beside the
        # routes they replaced, with the other kernels' device times (phase
        # 3), alone
        try:
            phase_card()
            lat16, lat32 = Lattice((32, 16, 16, 16)), Lattice((64, 32, 32, 32))
            phase_nd_schur_kernels((lat16, lat32, Lattice((10, 6, 14, 6))))
            phase_shard_kernels(lat16)
            phase_nd_shard_split(lat16, lat32, _copy_bandwidth())
        except SmokeFailure as exc:
            print(f"chip_smoke: FAIL: {exc}", file=sys.stderr)
            return 1
        return 0
    if "--special" in args:
        # the special operators alone: the Q_W checks (phase 2), the SF
        # parity trajectory (phase 4), path 1 for its checkpoint, then paths
        # 12 and 13; no result lines
        try:
            phase_card()
            _, qw_rel = phase_qw_kernels((Lattice((32, 16, 16, 16)), Lattice((10, 6, 14, 6))))
            phase_parity(sf=True)
            with tempfile.TemporaryDirectory() as workdir:
                _, _, conf = phase_main_path(workdir)
                phase_overlap(workdir, conf, qw_rel)
                phase_hmc_sf(workdir)
        except SmokeFailure as exc:
            print(f"chip_smoke: FAIL: {exc}", file=sys.stderr)
            return 1
        return 0
    if "--distributed" in args:
        # phases 19 and 20 alone: the rank kernels and main paths 14 and 15
        try:
            phase_card()
            phase_rank_kernels()
            phase_draws()
            with tempfile.TemporaryDirectory() as workdir:
                phase_distributed(workdir)
                phase_distributed_meas(workdir)
        except SmokeFailure as exc:
            print(f"chip_smoke: FAIL: {exc}", file=sys.stderr)
            return 1
        return 0
    if "--k1-split" in args or "--e2e" in args:
        # the kernel checks and K1's device / host split alone (phases 1, 2
        # and phase 3's split), or main paths 1, 3, 7 and 8 alone; neither
        # prints the result lines
        try:
            phase_card()
            if "--k1-split" in args:
                lat16, lat32 = Lattice((32, 16, 16, 16)), Lattice((64, 32, 32, 32))
                phase_schur_kernels((lat16, lat32, Lattice((10, 6, 14, 6))))
                phase_kernels(lat16)
                phase_shard_kernels(lat16)
                phase_k1_split(lat16, lat32, _copy_bandwidth())
            else:
                _e2e(root)
        except SmokeFailure as exc:
            print(f"chip_smoke: FAIL: {exc}", file=sys.stderr)
            return 1
        return 0
    t_start = time.perf_counter()

    def done(phase):
        _say(f"[phase] {phase} done at {time.perf_counter() - t_start:.0f} s")

    try:
        phase_card()
        done("1 card and build")
        lat16 = Lattice((32, 16, 16, 16))
        worst = phase_kernels(lat16)
        slab_worst, _, _ = phase_shard_kernels(lat16)
        worst.update(slab_worst)
        lat32 = Lattice((64, 32, 32, 32))
        # 32^3x64: the grid-stride loop wraps; 10x6x14x6: V = 2520, no whole block
        worst["K1-S"] = phase_schur_kernels((lat16, lat32, Lattice((10, 6, 14, 6))))
        worst["K1-SD"] = phase_nd_schur_kernels((lat16, lat32, Lattice((10, 6, 14, 6))))
        # the overlap's Q_W on K1 (mhat on both parities) against gamma5 d_full
        qw_worst, qw_rel = phase_qw_kernels((lat16, Lattice((10, 6, 14, 6))))
        worst["K1"] = max(worst["K1"], qw_worst)
        done("2 kernel checks")
        rows, bw = phase_timings(lat16, lat32)
        rows.update(phase_shard_timings(lat16, lat32, bw))
        split = phase_k1_split(lat16, lat32, bw)
        nd_rows = phase_nd_shard_split(lat16, lat32, bw)
        done("3 timings")
        with _plain_halves() as halves:
            dh = []
            for kw, half in zip(PARITY_POINTS, halves):
                # a mesh point is held to the same point's dH without one
                whole = dh[PARITY_POINTS.index({k: v for k, v in kw.items() if k != "mesh_shape"})
                           ] if "mesh_shape" in kw else None
                dh.append(phase_parity(**kw, dh_whole=whole, cpu_half=half)[1])
        done("4 parity trajectories")
        with tempfile.TemporaryDirectory() as workdir:
            hmc_counts, hmc_secs, conf = phase_main_path(workdir)
            done("5 main path 1")
            inv_counts, inv_iters, inv_solve_s = phase_invert(workdir, conf)
            done("6 main path 2")
            chmc_counts, _, cconf = phase_main_path(workdir, clover=True)
            done("7 main path 3")
            phase_profile(workdir, cconf, "main-clover.input", "clover",
                          {"K1-S": "hopping_schur_kernel", "K1": "hopping_kernel",
                           "K2": "ug_vjp_kernel"})
            done("7 clover profile")
            cinv_counts, _, _ = phase_invert_clover(workdir, cconf)
            done("8 main path 4")
            nhmc_counts, _, nconf = phase_main_path(workdir, nf211=True)
            done("9 main path 5")
            from tmlqcd_tpu_torch.hmc import monomials, rational_monomials
            from tmlqcd_tpu_torch.ops import wilson_fast as wf

            base = rational_monomials._RationalBase
            phase_profile(
                workdir, nconf, "main-nf211.input", "Nf=2+1+1",
                {"K1-S": "hopping_schur_kernel", "K1": "hopping_kernel",
                 "K1-SD": "hopping_schur_nd", "K1-R-D": "hopping_rhs_kernel",
                 "K2": "ug_vjp_kernel"},
                patches=[(base, "heatbath", "NDRAT heatbath"),
                         (base, "force_info", "NDRAT force (solve, y_j, surrogate, autograd)"),
                         (base, "action_info", "NDRAT acceptance"),
                         (rational_monomials, "cg_multishift", "multishift solves (in the three above)"),
                         (wf, "q_nd_fast", "Q_nd (K1-SD, heatbath and y_j), each synchronised"),
                         (wf, "q_nd_sq_fast", "Q_nd^2 (K1-SD, multishift), each synchronised"),
                         (rational_monomials._NDOps, "force", "NDRAT autograd.grad + TA"),
                         (monomials._CloverState, "force", "CLOVERDET autograd.grad + TA"),
                         (monomials, "_surrogate_force", "CLOVERTRLOG force (its sw_blocks forward included)"),
                         (monomials, "_solve_qsw", "CLOVERDET CG solves (chrono guess included)")])
            done("9 Nf=2+1+1 profile")
            dinv_counts, _, _ = phase_invert_doublet(workdir, nconf)
            done("10 main path 6")
            sinv_counts, _ = phase_invert_solvers(workdir, conf, cconf, inv_solve_s)
            done("11 main path 7")
            mhmc_counts, _, _, _ = phase_mixed_hmc(workdir, hmc_secs, cconf)
            done("12 main path 8")
            mesh_counts, _ = phase_mesh_hmc(workdir)
            done("13 main path 9")
            poly_counts, _ = phase_ndpoly(workdir, conf)
            done("14 main path 10")
            smear_counts, _ = phase_invert_smeared(workdir, conf, inv_iters)
            done("15 main path 11")
            tag16 = "16x16x16x32"
            off_counts = phase_offline_benchmark_api(
                workdir, nconf, conf, rows[(tag16, "12-real", "mhat+g5")][0])
            done("16 offline measurement, benchmark, api")
            ov_counts, _ = phase_overlap(workdir, conf, qw_rel)
            done("17 main path 12")
            sf_counts, _ = phase_hmc_sf(workdir)
            done("18 main path 13")
            rank_worst, rank_rows, rank_big = phase_rank_kernels()
            worst.update(rank_worst)
            phase_draws()
            done("19 rank kernels")
            dist_counts, _ = phase_distributed(workdir, os.path.join(workdir, "run-mesh-hmc5"))
            done("19 main path 14")
            dmeas_counts, _ = phase_distributed_meas(workdir)
            done("20 main path 15")
    except SmokeFailure as exc:
        print(f"chip_smoke: FAIL: {exc}", file=sys.stderr)
        return 1
    src = "tmlqcd_tpu_torch/csrc/hopping.cu"
    slab_src = "tmlqcd_tpu_torch/csrc/hopping_slab.cu"

    paths = {"launches_hmc": hmc_counts, "launches_invert": inv_counts,
             "launches_hmc_clover": chmc_counts, "launches_invert_clover": cinv_counts,
             "launches_hmc_nf211": nhmc_counts, "launches_invert_doublet": dinv_counts,
             "launches_invert_solvers": sinv_counts, "launches_hmc_mixed": mhmc_counts,
             "launches_hmc_mesh": mesh_counts, "launches_hmc_ndpoly": poly_counts,
             "launches_invert_smeared": smear_counts,
             "launches_offline_benchmark_api": off_counts,
             "launches_invert_overlap": {k: ov_counts["sumr"][k] + ov_counts["cgne"][k]
                                         for k in ov_counts["sumr"]},
             "launches_hmc_sf": sf_counts, "launches_hmc_distributed": dist_counts,
             "launches_hmc_distributed_meas": dmeas_counts}

    def entry(name, replaces, key, row, source=src, device_ms=None):
        ms, plain_ms, bound_ms, bound_by = row[:4]
        per_path = {k: c[key] for k, c in paths.items()}
        extra = {} if device_ms is None else {"device_ms": device_ms}
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": sum(per_path.values()), **per_path,
                "max_abs_err": worst[key], "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": None, **extra}

    tag16 = "16x16x16x32"
    qpm = split[(tag16, "Qhat_pm")]
    k1s = entry("hopping_schur (K1-S)",
                "tmlqcd_tpu/ops/dslash_pallas.py:520 x4 via tmlqcd_tpu/ops/wilson_fast.py:166",
                "K1-S", (qpm["loop"], qpm["plain"], qpm["bound"], qpm["bound_by"]),
                device_ms=qpm["device"])
    k1s["hops"] = sum(c["K1-S hops"] for c in paths.values())

    qsq = nd_rows[(tag16, "Q_nd^2")]
    k1sd = entry("hopping_schur_nd (K1-SD)",
                 "tmlqcd_tpu/ops/dslash_pallas.py:491 x4 via tmlqcd_tpu/ops/wilson_fast.py:376",
                 "K1-SD", (qsq["K1-SD loop"], qsq["plain"], qsq["bound"], qsq["bound_by"]),
                 device_ms=qsq["K1-SD device"])
    k1sd["hops"] = sum(c["K1-SD hops"] for c in paths.values())
    # KH at 16^3x32 on (4,2): (loop, plain, bound, bound by, device)
    kh = nd_rows[(tag16, "KH")]
    kh_row = (kh[0], kh[5], kh[3], kh[4], kh[2])

    def moved(key):
        """The hops of an epilogue or link type that ran inside K1-S on the
        main paths (where K1-C and K1-B launched before K1-S)."""
        return {"hops_in_k1s": sum(c[key] for c in paths.values())}

    kernels = [
        entry("hopping_split (K1)", "tmlqcd_tpu/ops/dslash_pallas.py:520", "K1",
              rows[("16x16x16x32", "12-real", "mhat+g5")],
              device_ms=split[(tag16, "K1")]["device"]),
        k1s,
        entry("hopping_ug_vjp (K2)", "tmlqcd_tpu/ops/dslash_pallas.py:1489", "K2",
              rows[("16x16x16x32", "K2")]),
        entry("hopping_split_rhs (K1-R)", "tmlqcd_tpu/ops/dslash_pallas.py:491", "K1-R",
              rows[("16x16x16x32", "K1-R", "12-real", "mhat+g5")]),
        entry("hopping_split clov (K1-C)", "tmlqcd_tpu/ops/dslash_pallas.py:409", "K1-C",
              rows[("16x16x16x32", "12-real", "clov_mhat+g5")],
              device_ms=split[(tag16, "K1-C")]["device"]) | moved("K1-S clover hops"),
        entry("hopping_split_rhs clov (K1-RC)", "tmlqcd_tpu/ops/dslash_pallas.py:409", "K1-RC",
              rows[("16x16x16x32", "K1-R", "12-real", "clov_mhat+g5")]),
        entry("hopping_split_rhs doublet (K1-R-D)", "tmlqcd_tpu/ops/dslash_pallas.py:491",
              "K1-R-D", rows[("16x16x16x32", "K1-R-D", "12-real")]),
        entry("hopping_split bf16 gauge (K1-B)", "tmlqcd_tpu/ops/dslash_pallas.py:186", "K1-B",
              rows[("16x16x16x32", "K1-B", "12-real", "mhat+g5")],
              device_ms=split[(tag16, "K1-B")]["device"]) | moved("K1-S bf16 hops"),
        entry("hopping_split_rhs bf16 gauge (K1-RB)", "tmlqcd_tpu/ops/dslash_pallas.py:491",
              "K1-RB", rows[("16x16x16x32", "K1-RB")]),
        entry("hopping_slab_split ext (K3)", "tmlqcd_tpu/ops/dslash_pallas.py:1228", "K3",
              rows[("16x16x16x32", "K3")], slab_src),
        entry("hopping_slab_split int (K3-I)", "tmlqcd_tpu/ops/dslash_pallas.py:1267", "K3-I",
              rows[("16x16x16x32", "K3-I")], slab_src),
        entry("hopping_slab_split bnd (K4)", "tmlqcd_tpu/ops/dslash_pallas.py:1307", "K4",
              rows[("16x16x16x32", "K4")], slab_src),
        entry("hopping_tshard (K1-T)", "tmlqcd_tpu/ops/dslash_pallas.py:997", "K1-T",
              rows[("16x16x16x32", "K1-T")], slab_src),
        k1sd,
        entry("hopping_slab_split all rows (K3-I+K4)",
              "tmlqcd_tpu/ops/dslash_pallas.py:1267 and :1307 in one launch", "K3-I+K4",
              rows[("16x16x16x32", "K3-I+K4")], slab_src,
              device_ms=nd_rows[(tag16, "device 6B K3-I+K4 (4,2)")]),
        entry("halo_pack (KH)", "tmlqcd_tpu/ops/dslash_pallas.py:1413 (the halo exchange of "
              "hopping_pallas_shard :1345)", "KH", kh_row[:4], slab_src, device_ms=kh_row[4]),
    ]
    # the kernels of a rank: times on a slab of (4,2) at 16^3x32
    for name, key, replaces in (
            ("halo_faces (KH-P)", "KH-P", "tmlqcd_tpu/ops/dslash_pallas.py:1413 (the send side "
             "of `_exchange`, hopping_pallas_shard :1345, on a rank)"),
            ("hopping_rank int (K3-I on a rank)", "K3-I rank",
             "tmlqcd_tpu/ops/dslash_pallas.py:1267 (on a rank)"),
            ("hopping_rank bnd (K4 on a rank)", "K4 rank",
             "tmlqcd_tpu/ops/dslash_pallas.py:1307 (on a rank)"),
            ("hopping_rank all rows (K3-I+K4 on a rank)", "K3-I+K4 rank",
             "tmlqcd_tpu/ops/dslash_pallas.py:1267 and :1307 in one launch (on a rank)"),
            ("hopping_ug_vjp_slab (K2-S)", "K2-S",
             "tmlqcd_tpu/ops/dslash_pallas.py:1489 (K2 on a rank's slab)")):
        row, big = rank_rows[key], rank_big[key]
        kernels.append(entry(name, replaces, key, row[:4], slab_src, device_ms=row[4])
                       | {"ms_32x64_slab": big[0], "device_ms_32x64_slab": big[4],
                          "plain_ms_32x64_slab": big[1], "bound_ms_32x64_slab": big[2]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
