"""Offline measurement driver: run the configured measurement list over
stored gauge configurations.

Port of `tmlqcd_tpu/cli/offline_measurement.py` (reference:
offline_measurement.c).  Every measurement's Frequency is forced to 1 and
each configuration of trajectory n is measured as trajectory n - 1, so the
files carry the numbers `cli.hmc` gives the measurement after that
trajectory.

Usage:
    python -m tmlqcd_tpu_torch.cli.offline_measurement -f sample.input \\
        -c conf.000010.npz [conf.000020.lime ...] [-o outdir] [--cpu]

Without --cpu the run needs a CUDA device and raises if there is none; with
--cpu it runs the plain PyTorch versions of the kernels on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import torch


def main(argv=None):
    ap = argparse.ArgumentParser(description="offline measurements (PyTorch / CUDA)")
    ap.add_argument("-f", "--input", required=True)
    ap.add_argument("-c", "--configs", nargs="+", required=True,
                    help="gauge checkpoints (.npz or ILDG)")
    ap.add_argument("-o", "--output-dir", default=".")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU with the kernels' plain PyTorch versions")
    args = ap.parse_args(argv)

    if args.cpu:
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: run on a GPU, or pass --cpu for the plain path")
        device = torch.device("cuda", torch.cuda.current_device())

    from tmlqcd_tpu_torch import rng
    from tmlqcd_tpu_torch.config import check_ported
    from tmlqcd_tpu_torch.config_tmlqcd import read_input
    from tmlqcd_tpu_torch.io.checkpoint import load_checkpoint
    from tmlqcd_tpu_torch.meas.runner import run_measurements
    from tmlqcd_tpu_torch.ops.gauge_action import plaquette

    cfg = read_input(args.input)
    check_ported(cfg)
    lat = cfg.lat
    os.makedirs(args.output_dir, exist_ok=True)
    # the frequency gate is (traj + 1) % frequency == 0: offline, every one runs
    cfg = dataclasses.replace(cfg, meas=tuple(dataclasses.replace(m, frequency=1)
                                              for m in cfg.meas))
    key = rng.Key(cfg.seed)
    for path in args.configs:
        arr, traj, _ = load_checkpoint(path, lat)
        u = torch.as_tensor(arr, device=device).to(torch.complex64)
        with torch.no_grad():
            print(f"[meas] {path}: trajectory {traj}, plaquette {float(plaquette(u, lat)):.8f}",
                  flush=True)
            run_measurements(cfg, u, lat, traj - 1, args.output_dir, key)
    return 0


if __name__ == "__main__":
    sys.exit(main())
