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
   card tensors.
3. timings: K1 at 16^3x32 and 32^3x64, K2 at 16^3x32, kernel and plain
   version, with GF/s at 1320 flops/site and the share of the bandwidth of a
   device-to-device copy measured in the same run.
4. end-to-end parity: one Nf=2 Hasenbusch trajectory at 8^4 on the kernel
   path (CUDA tensors) and on the plain path (CPU tensors) with the same
   injected draws; |ddH| against its bound.
5. main path: `tmlqcd_tpu_torch.cli.hmc.main` on a 16^3x32 input derived from
   sample-input/hmc2-nf2-tm-hasenbusch.input (3 trajectories), with the
   kernel launch counters read around it.

The second-to-last line is a JSON object describing each kernel; the last
line is the JSON result object.  No JAX is imported.
"""

from __future__ import annotations

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

# Relative tolerance of a kernel against its plain version on the same card
# inputs: both compute in f32 and differ only in summation order and FMA
# contraction, ~1e-7 of the output scale (4.8e-7 absolute at outputs of ~15
# on the CPU comparison of the plain versions with the reference); an
# indexing or sign error is O(1).  1e-5 leaves a 100x margin to rounding.
KERNEL_RTOL = 1e-5
# |dH(kernel path) - dH(plain path)| at 8^4: the port's plain path and the
# JAX reference differ by 4.1e-5 at 4^4 and 3.0e-4 at 8^4 (CPU runs of this
# trajectory with the same draws: f32 fields, f64 sums, |H| ~ 2.4e5); the
# kernel path differs from the plain one by the same kind of f32 rounding,
# so 3e-3 is 10x that spread while an operator error shifts dH by O(1).
DDH_BOUND = 3e-3
FLOPS_SITE = 1320


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
    gen = rng.generator(rng.Key(seed, (1,)), dev)
    shape = (2, 4, 3) + lat.eo_site_shape
    psi = torch.randn(shape, generator=gen, device=dev)
    psi_o = torch.randn(shape, generator=gen, device=dev)
    g = torch.randn(shape, generator=gen, device=dev)
    return params, fg18, fg12, psi, psi_o, g


def _variants(params):
    k2 = params.kappa ** 2
    return [("none", ("none",)),
            ("mee_inv+", ("mee_inv", params.mutld, 1.0)),
            ("mee_inv-", ("mee_inv", params.mutld, -1.0)),
            ("mhat+g5", ("mhat", params.mutld, 1.0, k2, True)),
            ("mhat-g5", ("mhat", params.mutld, -1.0, k2, True)),
            ("mhat+", ("mhat", params.mutld, 1.0, k2, False))]


def _sync(dev) -> None:
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def phase_kernels(lat, dev="cuda"):
    import torch

    from tmlqcd_tpu_torch.ops import dslash_cuda as dc

    params, fg18, fg12, psi, psi_o, g = _fields(lat, dev, 11)
    worst = {"K1": 0.0, "K2": 0.0}
    for gname, fg in (("18-real", fg18), ("12-real", fg12)):
        for p, ug in ((0, fg.ug_even), (1, fg.ug_odd)):
            for vname, epi in _variants(params):
                kw = dict(epi=epi, psi_o=psi_o if epi[0] == "mhat" else None, gcomp=fg.gcomp)
                out = dc.hopping_split(ug, psi, p, lat, **kw)
                ref = dc.hopping_split_plain(ug, psi, p, lat, **kw)
                _sync(dev)
                err, rel = _rel_err(out, ref)
                worst["K1"] = max(worst["K1"], err)
                _say(f"[check] K1 {vname:9s} {gname} p={p}: max|d| {err:.3e} (rel {rel:.2e})")
                _check(rel <= KERNEL_RTOL, f"K1 {vname} {gname} p={p} off by {rel:.3e}")
    for p, ug in ((0, fg18.ug_even), (1, fg18.ug_odd)):
        out = dc.hopping_ug_vjp(g, psi, p, lat)
        ref = dc.hopping_ug_vjp_plain(g, psi, p, lat)
        _sync(dev)
        err, rel = _rel_err(out, ref)
        worst["K2"] = max(worst["K2"], err)
        _say(f"[check] K2 p={p}: max|d| {err:.3e} (rel {rel:.2e})")
        _check(rel <= KERNEL_RTOL, f"K2 p={p} off by {rel:.3e}")
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
    return worst


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


def phase_timings(lat16, lat32):
    from tmlqcd_tpu_torch.ops import dslash_cuda as dc

    bw = _copy_bandwidth()
    _say(f"[time] device copy bandwidth {bw / 1e9:.1f} GB/s")
    rows = {}
    for lat in (lat16, lat32):
        tag = "x".join(map(str, lat.dims[::-1][:3])) + f"x{lat.dims[0]}"
        params, fg18, fg12, psi, psi_o, g = _fields(lat, "cuda", 12)
        sites = lat.volume // 2
        for gname, fg, gbytes in (("18-real", fg18, 576), ("12-real", fg12, 384)):
            for vname, epi in (("none", ("none",)),
                               ("mhat+g5", ("mhat", params.mutld, 1.0, params.kappa ** 2, True))):
                po = psi_o if epi[0] == "mhat" else None
                kw = dict(epi=epi, psi_o=po, gcomp=fg.gcomp)
                n = 200 if lat is lat16 else 50
                ms = _time_ms(lambda: dc.hopping_split(fg.ug_odd, psi, 1, lat, **kw), n)
                pms = _time_ms(lambda: dc.hopping_split_plain(fg.ug_odd, psi, 1, lat, **kw),
                               max(n // 10, 5))
                nbytes = (gbytes + 2 * 96 + (96 if po is not None else 0)) * sites
                gfs = FLOPS_SITE * sites / (ms * 1e-3) / 1e9
                share = nbytes / (ms * 1e-3) / bw
                rows[(tag, gname, vname)] = (ms, pms)
                _say(f"[time] K1 {tag} {gname} {vname:8s}: kernel {ms * 1e3:9.1f} us "
                     f"({gfs:7.1f} GF/s, {share:6.1%} of copy bandwidth at "
                     f"{nbytes / sites:.0f} B/site)  plain {pms * 1e3:10.1f} us "
                     f"({pms / ms:5.1f}x)")
        if lat is lat16:
            ms = _time_ms(lambda: dc.hopping_ug_vjp(g, psi, 0, lat), 200)
            pms = _time_ms(lambda: dc.hopping_ug_vjp_plain(g, psi, 0, lat), 20)
            nbytes = (2 * 96 + 576) * sites
            _say(f"[time] K2 {tag}: kernel {ms * 1e3:9.1f} us ({nbytes / (ms * 1e-3) / bw:6.1%} "
                 f"of copy bandwidth at {nbytes / sites:.0f} B/site)  plain {pms * 1e3:10.1f} us "
                 f"({pms / ms:5.1f}x)")
            rows[(tag, "K2")] = (ms, pms)
        del params, fg18, fg12, psi, psi_o, g
    return rows, bw


# ---------------------------------------------------------------------------
# phase 4
# ---------------------------------------------------------------------------


def phase_parity(dims=(8, 8, 8, 8), devs=("cuda", "cpu")):
    import torch

    from tmlqcd_tpu_torch import rng, su3
    from tmlqcd_tpu_torch.hmc import Draws, hmc_trajectory
    from tmlqcd_tpu_torch.lattice import Lattice
    from tmlqcd_tpu_torch.models.suites import nf2_twisted_mass_hasenbusch

    lat = Lattice(dims)
    cfg = nf2_twisted_mass_hasenbusch(lat, beta=5.3, kappa=0.13, mu=0.01, mu_hasenbusch=0.1,
                                      steps=(1, 1, 2), acc_tol=1e-10, force_tol=1e-10,
                                      maxiter=1000)
    key = rng.Key(2024)
    u = su3.random_su3(rng.generator(key.fold(0), "cpu"), (4,) + lat.site_shape)
    p = rng.random_momenta(key.fold(1), u.shape[2:], "cpu")
    etas = [None] + [rng.normal_spinor(key.fold(2, i), (4, 3) + lat.eo_site_shape, "cpu")
                     for i in (1, 2)]
    uni = rng.uniform(key.fold(3), "cpu")
    res = {}
    for dev in devs:
        d = Draws(p.to(dev), [e if e is None else e.to(dev) for e in etas], uni)
        t0 = time.perf_counter()
        with torch.no_grad():
            _, st = hmc_trajectory(cfg, u.to(dev), key, draws=d)
        res[dev] = st
        _say(f"[parity] {lat.dims} trajectory on {dev}: dH {st.delta_h:+.9e} plaq {st.plaquette:.12f} "
             f"acc_iters {st.acc_iterations} force_iters {st.force_iterations} "
             f"({time.perf_counter() - t0:.1f} s)")
    kern, plain = res[devs[0]], res[devs[1]]
    ddh = abs(kern.delta_h - plain.delta_h)
    dplaq = abs(kern.plaquette - plain.plaquette)
    _say(f"[parity] |ddH| kernel vs plain {ddh:.3e} (bound {DDH_BOUND:.0e}), |dplaq| {dplaq:.3e}")
    _check(math.isfinite(kern.delta_h), "kernel-path dH is not finite")
    _check(ddh <= DDH_BOUND, f"kernel vs plain |ddH| {ddh:.3e} > {DDH_BOUND:.0e}")
    return ddh


# ---------------------------------------------------------------------------
# phase 5
# ---------------------------------------------------------------------------

MAXITER = 1000


def smoke_input(text: str) -> str:
    """hmc2-nf2-tm-hasenbusch with the ONLINE block dropped, 3 trajectories,
    NSave = 3 and the physics point of bench/bench_traj.py (kappa = 0.13,
    2KappaMu = 0.0026, 2KappaMu2 = 0.026, steps 2/2/5, precisions 1e-16 /
    1e-14, MaxSolverIterations 1000): hmc2's own kappa = 0.163 from a hot
    start runs its solves to maxiter."""
    out, block, skip = [], None, False
    for line in text.splitlines():
        s = line.split("#", 1)[0].strip()
        if re.match(r"(?i)^BeginMeasurement\b", s):
            skip = True
        if skip:
            if re.match(r"(?i)^EndMeasurement\b", s):
                skip = False
            continue
        m = re.match(r"(?i)^BeginMonomial\s+(\S+)", s)
        if m:
            block = m.group(1).upper()
        elif re.match(r"(?i)^EndMonomial\b", s):
            block = None
        kv = re.match(r"^([A-Za-z0-9_]+)\s*=", s)
        key = kv.group(1).lower() if kv else None
        sub = {"measurements": "3", "nsave": "3", "kappa": "0.13",
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


def phase_main_path(workdir: str):
    import numpy as np

    from tmlqcd_tpu_torch.cli import hmc as cli
    from tmlqcd_tpu_torch.config_tmlqcd import read_input
    from tmlqcd_tpu_torch.io.checkpoint import load_checkpoint
    from tmlqcd_tpu_torch.ops import dslash_cuda as dc

    with open(SAMPLE) as f:
        text = smoke_input(f.read())
    path = os.path.join(workdir, "smoke.input")
    with open(path, "w") as f:
        f.write(text)
    cfg = read_input(path)
    _check(cfg.lat.dims == (32, 16, 16, 16) and cfg.measurements == 3 and not cfg.meas,
           "smoke input was not derived as intended")
    run_dir = os.path.join(workdir, "run")
    dc.reset_counters()
    t0 = time.perf_counter()
    rc = cli.main(["-f", path, "-o", run_dir])
    wall = time.perf_counter() - t0
    counts = {"K1": dc.hopping_split.launches, "K2": dc.hopping_ug_vjp.launches,
              "K1 plain": dc.hopping_split_plain.calls, "K2 plain": dc.hopping_ug_vjp_plain.calls}
    _say(f"[main] cli.hmc exit {rc}, {wall:.1f} s wall; launches {counts}")
    _check(rc == 0, f"cli.hmc returned {rc}")
    with open(os.path.join(run_dir, "output.data")) as f:
        lines = [ln.split() for ln in f if ln.strip() and not ln.startswith("#")]
    _check(len(lines) == 3, f"output.data has {len(lines)} lines, expected 3")
    secs = []
    for cols in lines:
        plaq, dh, acc_iters = float(cols[1]), float(cols[3]), [int(c) for c in cols[7:]]
        _check(math.isfinite(dh), f"non-finite dH in {cols}")
        _check(0.0 < plaq < 1.0, f"plaquette {plaq} outside (0, 1)")
        _check(all(i < MAXITER for i in acc_iters), f"a solve reached maxiter: {cols}")
        secs.append(float(cols[6]))
    _check(counts["K1"] > 0 and counts["K2"] > 0, f"a kernel was not launched: {counts}")
    _check(counts["K1 plain"] == 0 and counts["K2 plain"] == 0,
           f"a plain version served the main path: {counts}")
    conf = os.path.join(run_dir, "conf.000003.npz")
    _check(os.path.exists(conf), "conf.000003.npz was not written")
    arr, traj, _ = load_checkpoint(conf, cfg.lat)
    _check(traj == 3 and arr.shape == (3, 3, 4) + cfg.lat.site_shape
           and bool(np.isfinite(arr).all()), "conf.000003.npz does not read back")
    _say(f"[main] s/trajectory {secs} (mean of the last two {sum(secs[1:]) / 2:.3f} s); "
         f"conf.000003.npz read back")
    return counts, secs


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "tmlqcd_tpu_torch")) or not os.path.exists(SAMPLE):
        print("chip_smoke: run from a checkout of the repository "
              "(tmlqcd_tpu_torch/ and sample-input/ are missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from tmlqcd_tpu_torch.lattice import Lattice

    try:
        phase_card()
        lat16 = Lattice((32, 16, 16, 16))
        worst = phase_kernels(lat16)
        rows, _ = phase_timings(lat16, Lattice((64, 32, 32, 32)))
        phase_parity()
        with tempfile.TemporaryDirectory() as workdir:
            counts, _ = phase_main_path(workdir)
    except SmokeFailure as exc:
        print(f"chip_smoke: FAIL: {exc}", file=sys.stderr)
        return 1
    k1 = rows[("16x16x16x32", "12-real", "mhat+g5")]
    k2 = rows[("16x16x16x32", "K2")]
    kernels = [
        {"name": "hopping_split (K1)", "route": "cuda",
         "source": "tmlqcd_tpu_torch/csrc/hopping.cu",
         "replaces": "tmlqcd_tpu/ops/dslash_pallas.py:520", "launches": counts["K1"],
         "max_abs_err": worst["K1"], "ms": k1[0], "plain_ms": k1[1]},
        {"name": "hopping_ug_vjp (K2)", "route": "cuda",
         "source": "tmlqcd_tpu_torch/csrc/hopping.cu",
         "replaces": "tmlqcd_tpu/ops/dslash_pallas.py:1489", "launches": counts["K2"],
         "max_abs_err": worst["K2"], "ms": k2[0], "plain_ms": k2[1]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
