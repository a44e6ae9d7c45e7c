"""HMC driver: the `hmc_tm -f input` equivalent of the port.

Port of `tmlqcd_tpu/cli/hmc.py`: read input -> start configuration
(hot/cold/continue) -> trajectory loop writing output.data and printing one
line per trajectory -> native checkpoints every NSave and at the end.

Usage:
    python -m tmlqcd_tpu_torch.cli.hmc -f sample.input [-o rundir] [--cpu]

Without --cpu the run needs a CUDA device and raises if there is none; with
--cpu it runs the plain PyTorch versions of the kernels on the CPU.

output.data, one line per trajectory:
    traj plaquette rectangle dH exp(-dH) accept seconds <acceptance-solve iterations>
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import time

import torch


class _GracefulStop:
    """Signal -> finish the current trajectory, checkpoint, exit cleanly."""

    def __init__(self):
        self.stop = False
        for sig in (signal.SIGTERM, signal.SIGINT, signal.SIGUSR1):
            try:
                signal.signal(sig, self._handler)
            except ValueError:  # not the main thread
                pass

    def _handler(self, signum, frame):
        print(f"[hmc] caught signal {signum}: will checkpoint and stop "
              f"after the current trajectory", flush=True)
        self.stop = True


def main(argv=None):
    ap = argparse.ArgumentParser(description="twisted-mass HMC (PyTorch / CUDA)")
    ap.add_argument("-f", "--input", required=True, help="tmLQCD-style input file")
    ap.add_argument("-o", "--output-dir", default=None, help="run directory")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU with the kernels' plain PyTorch versions")
    args = ap.parse_args(argv)

    if args.cpu:
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: run on a GPU, or pass --cpu for the plain path")
        device = torch.device("cuda", torch.cuda.current_device())

    from tmlqcd_tpu_torch import rng, su3
    from tmlqcd_tpu_torch.config import build_hmc
    from tmlqcd_tpu_torch.config_tmlqcd import read_input
    from tmlqcd_tpu_torch.hmc import chrono_states, hmc_trajectory
    from tmlqcd_tpu_torch.io.checkpoint import (
        checkpoint_at,
        latest_checkpoint,
        load_checkpoint,
        save_checkpoint,
    )
    from tmlqcd_tpu_torch.ops.gauge_action import rectangle

    cfg = read_input(args.input)
    run_dir = args.output_dir or cfg.output_dir
    hmc = build_hmc(cfg)
    os.makedirs(run_dir, exist_ok=True)
    lat = cfg.lat
    key = rng.Key(cfg.seed)

    def hot_start():
        return su3.random_su3(rng.generator(key.fold(0), device), (4,) + lat.site_shape)

    start_traj = 0
    if cfg.start_condition == "continue":
        if isinstance(cfg.initial_store_counter, int):
            info = checkpoint_at(run_dir, cfg.initial_store_counter)
        else:
            info = latest_checkpoint(run_dir)
        if info is None:
            print(f"[hmc] no checkpoint in {run_dir}, falling back to hot start")
            u = hot_start()
        else:
            arr, start_traj, _ = load_checkpoint(info.path, lat)
            u = torch.as_tensor(arr, device=device)
            print(f"[hmc] resumed at trajectory {start_traj} from {info.path}")
    elif cfg.start_condition == "cold":
        u = torch.eye(3, dtype=torch.complex64, device=device).reshape(3, 3, 1, 1, 1, 1)
        u = u.expand((3, 3, 4) + lat.site_shape).contiguous()
    else:
        u = hot_start()

    chrono = chrono_states(hmc, device)
    stopper = _GracefulStop()
    n_acc = 0
    traj = start_traj - 1
    with open(os.path.join(run_dir, "output.data"), "a", buffering=1) as out:
        for traj in range(start_traj, start_traj + cfg.measurements):
            t0 = time.perf_counter()
            with torch.no_grad():
                u, st, chrono = hmc_trajectory(hmc, u, key.fold(traj + 1), chrono)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            dt = time.perf_counter() - t0
            acc = int(st.accepted)
            n_acc += acc
            iters = " ".join(str(i) for i in st.acc_iterations)
            fiters = " ".join(str(i) for i in st.force_iterations)
            rect = float(rectangle(u, lat))
            out.write(f"{traj:08d} {st.plaquette:.12f} {rect:.12f} {st.delta_h:+.6e} "
                      f"{st.exp_mdh:.6e} {acc} {dt:.3f} {iters}\n")
            if cfg.debug_level >= 1:
                print(f"[traj {traj}] plaq={st.plaquette:.6f} dH={st.delta_h:+.4f} "
                      f"acc={acc} ({dt:.1f}s) force_iters=[{fiters}]", flush=True)
            last = traj == start_traj + cfg.measurements - 1
            if (traj + 1) % cfg.nsave == 0 or last or stopper.stop:
                path = save_checkpoint(run_dir, u, traj + 1, cfg.seed, lat,
                                       fmt=cfg.checkpoint_format, plaquette=st.plaquette,
                                       beta=cfg.beta)
                if cfg.debug_level >= 1:
                    print(f"[traj {traj}] checkpoint -> {path}", flush=True)
            if stopper.stop:
                print(f"[hmc] graceful stop after trajectory {traj} "
                      f"(resume with StartCondition = continue)")
                break
    total = traj - start_traj + 1
    print(f"[hmc] done: {total} trajectories, acceptance {n_acc / max(total, 1):.2%}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
