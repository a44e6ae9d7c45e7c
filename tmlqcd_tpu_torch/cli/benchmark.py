"""Dslash benchmark driver (reference: benchmark.c): times the hopping
kernel K1 and one Qhat_pm and prints one JSON object.

Port of `tmlqcd_tpu/cli/benchmark.py`.  On the card, K1 is one hop on the
odd sites with the fused twisted-mass epilogue (12-real f32 gauge copy,
`mhat` + g5: the last hop of every Mhat) and Qhat_pm is one K1-S launch
(its four hops), each timed with CUDA events around a loop of wrapper calls
after 3 warm-up calls.  With --cpu the same calls run their plain PyTorch
versions, timed on the host's clock.  The object holds, for each: the time
per call, GF/s at 1320 flops per site and hop, the bytes per site of the
traffic model (the gauge copy once, every spinor read or written once) and,
on the card, the least time at the H100 SXM's published rates (3.35 TB/s,
67 TF/s f32), the share of it reached, and the card's name and power limit
as nvidia-smi gives them.

Usage: python -m tmlqcd_tpu_torch.cli.benchmark [--dims LX LY LZ T] [--apps N] [--cpu]
(default 32 32 32 64 on the card, 8 8 8 16 with --cpu).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

FLOPS_SITE = 1320
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS_S = 67e12
# bytes per output site of one hop on the 12-real copy: 384 B of gauge, the
# input spinor (96 B) and the output (96 B), and psi_o (96 B) with `mhat`
K1_BYTES = 384 + 3 * 96
# Qhat_pm: per sign a `mee_inv` hop (no psi_o) and a `mhat` hop
QPM_BYTES = 2 * ((384 + 2 * 96) + K1_BYTES)


def _card() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def _time_ms(fn, n: int, cuda: bool) -> float:
    for _ in range(3):
        fn()
    if not cuda:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) / n * 1e3
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / n


def _row(ms: float, sites: int, hops: int, site_bytes: int, cuda: bool) -> dict:
    flops = hops * FLOPS_SITE * sites
    row = {"ms": ms, "gflops": flops / (ms * 1e-3) / 1e9, "bytes_per_site": site_bytes}
    if cuda:
        bound = max(site_bytes * sites / PEAK_BYTES_S, flops / PEAK_F32_FLOPS_S) * 1e3
        row.update(bound_ms=bound, bound_share=bound / ms)
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description="dslash benchmark (PyTorch / CUDA)")
    ap.add_argument("--dims", type=int, nargs=4, default=None, metavar=("LX", "LY", "LZ", "T"))
    ap.add_argument("--apps", type=int, default=None, help="timed calls of each")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU with the kernels' plain PyTorch versions")
    args = ap.parse_args(argv)

    if args.cpu:
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: run on a GPU, or pass --cpu for the plain path")
        device = torch.device("cuda", torch.cuda.current_device())
    cuda = device.type == "cuda"

    from tmlqcd_tpu_torch import rng, su3
    from tmlqcd_tpu_torch.lattice import Lattice
    from tmlqcd_tpu_torch.ops import dslash_cuda as dc
    from tmlqcd_tpu_torch.ops import wilson_fast as wf
    from tmlqcd_tpu_torch.ops.wilson import DiracParams

    lx, ly, lz, t = args.dims or ((32, 32, 32, 64) if cuda else (8, 8, 8, 16))
    lat = Lattice((t, lx, ly, lz))
    n = args.apps or (100 if cuda else 3)
    params = DiracParams(kappa=0.13, mu=0.01)
    with torch.no_grad():
        u = su3.random_su3(rng.generator(rng.Key(0), device), (4,) + lat.site_shape)
        fg = wf.make_fast_gauge(u, params, lat)
        del u
        gen = rng.generator(rng.Key(1), device)
        shape = (2, 4, 3) + lat.eo_site_shape
        psi = torch.randn(shape, generator=gen, device=device)
        psi_o = torch.randn(shape, generator=gen, device=device)
        epi = ("mhat", params.mutld, 1.0, params.kappa ** 2, True)
        k1_ms = _time_ms(lambda: dc.hopping_split(fg.ug_odd, psi, 1, lat, epi=epi, psi_o=psi_o,
                                                  gcomp=fg.gcomp), n, cuda)
        qpm_ms = _time_ms(lambda: wf.q_hat_pm_fast(fg, psi, params, lat), n, cuda)
    sites = lat.volume // 2
    result = {"dims": {"LX": lx, "LY": ly, "LZ": lz, "T": t}, "device": str(device),
              "route": "cuda" if cuda else "plain", "apps": n,
              "K1": _row(k1_ms, sites, 1, K1_BYTES, cuda),
              "Qhat_pm": _row(qpm_ms, sites, 4, QPM_BYTES, cuda)}
    if cuda:
        result["card"] = _card()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
