"""HMC driver: the `hmc_tm -f input` equivalent of the port.

Port of `tmlqcd_tpu/cli/hmc.py`: read input -> the (t, y) slab mesh of
NrTProcs x NrYProcs (`parallel.mesh_from_procs`, else `parallel.auto_mesh`,
which gives none on one device; all slabs on the run's one device, every
solve on the slab kernels) -> start configuration
(hot/cold/continue) -> the interval check of the rational and polynomial
monomials (`hmc/validate.py`, a warning when spec(Q^2) leaves [StildeMin,
StildeMax]) -> trajectory loop writing output.data and printing one line
per trajectory, with the force monitor every 10 trajectories at DebugLevel
>= 2, the configured measurements (SFCOUPLING included) and the
ReversibilityCheck -> native or ILDG checkpoints every NSave and at the end.

Usage:
    python -m tmlqcd_tpu_torch.cli.hmc -f sample.input [-o rundir] [--cpu]
        [--checkpoint-format native|ildg] [--distributed [--backend gloo]]

Without --cpu the run needs a CUDA device and raises if there is none; with
--cpu it runs the plain PyTorch versions of the kernels on the CPU.

--distributed (the reference's flag, its multi-process JAX init): tmLQCD's
MPI model, one process per (t, y) slab.  Each process joins the group
(`parallel.init_distributed`: the environment `torchrun` sets, nccl between
cards, gloo with --cpu or --backend gloo) and holds its slab of every field
(the mesh of NrTProcs x NrYProcs over the ranks, which must number exactly
NrTProcs x NrYProcs).  Everything the one-process run runs runs on the
ranks: every monomial (NDPOLY and the Schrödinger functional's SFGAUGE
included), the interval check, the force monitor, ReversibilityCheck and
every measurement (ONLINE, PIONNORM, GRADIENTFLOW, POLYAKOV,
ORIENTEDPLAQUETTES, FIELDSTRENGTH, SFCOUPLING), each rank on its slab.
output.data, the checkpoints, the measurement files (sf_coupling.data
included) and stdout come from rank 0.  On a host with cards:
    torchrun --nproc-per-node 8 -m tmlqcd_tpu_torch.cli.hmc \
        -f sample-input/hmc5-multichip.input -o run5 --distributed

output.data, one line per trajectory:
    traj plaquette rectangle dH exp(-dH) accept seconds <acceptance-solve iterations>
(one count per monomial; for a rational monomial the multishift iterations).
"""

from __future__ import annotations

import argparse
import dataclasses
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
    ap.add_argument("--checkpoint-format", default=None, choices=["native", "ildg"],
                    help="conf.NNNNNN.npz (native, the default) or conf.NNNNNN.lime (ILDG)")
    ap.add_argument("--distributed", action="store_true",
                    help="one process per (t, y) slab over torch.distributed (start with torchrun)")
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                    help="the group's backend with --distributed (default: nccl on cards, "
                         "gloo with --cpu)")
    args = ap.parse_args(argv)

    from tmlqcd_tpu_torch import comm, parallel, rng, su3

    if args.distributed:
        device = parallel.init_distributed(backend=args.backend, cpu=args.cpu)
    elif args.cpu:
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: run on a GPU, or pass --cpu for the plain path")
        device = torch.device("cuda", torch.cuda.current_device())

    from tmlqcd_tpu_torch.config import build_hmc
    from tmlqcd_tpu_torch.config_tmlqcd import read_input
    from tmlqcd_tpu_torch.hmc import chrono_states, hmc_trajectory, reversibility_check
    from tmlqcd_tpu_torch.hmc.monitor import monitor_forces
    from tmlqcd_tpu_torch.io.checkpoint import (
        checkpoint_at,
        latest_checkpoint,
        load_checkpoint,
        save_checkpoint,
    )
    from tmlqcd_tpu_torch.meas.runner import run_measurements
    from tmlqcd_tpu_torch.ops.gauge_action import rectangle

    cfg = read_input(args.input)
    if args.checkpoint_format is not None:
        cfg = dataclasses.replace(cfg, checkpoint_format=args.checkpoint_format)
    run_dir = args.output_dir or cfg.output_dir
    # domain decomposition (reference: tmlqcd_mpi_init's Cartesian grid from
    # NrTProcs/NrYProcs): explicit hints win, else a mesh over all devices
    # (ranks); the mesh reaches every solve through the monomials
    mesh = parallel.mesh_from_procs(cfg.nr_procs, cfg.lat, device)
    if mesh is None:
        mesh = parallel.auto_mesh(cfg.lat, [device])
    if args.distributed and mesh is None and parallel._process_count() > 1:
        raise ValueError(f"{parallel._process_count()} ranks but no decomposition: set "
                         "NrTProcs x NrYProcs to the number of ranks")
    hmc = build_hmc(cfg, mesh=mesh)
    lat = hmc.lat  # the rank's slab on a distributed mesh
    distributed = mesh is not None and mesh.distributed
    lead = comm.lead()  # writes files and stdout
    if mesh is not None and lead:
        loc = mesh.local(cfg.lat)
        if distributed:
            print(f"[hmc] device mesh {mesh.shape} over {mesh.n_slabs} ranks ({mesh.backend}; "
                  f"t x y slabs: {loc.dims[0]} x {loc.dims[2]}, one slab per rank)", flush=True)
        else:
            print(f"[hmc] device mesh {mesh.shape} over 1 devices (t x y slabs: "
                  f"{loc.dims[0]} x {loc.dims[2]}, {mesh.n_slabs} slabs per device)", flush=True)
    if lead:
        os.makedirs(run_dir, exist_ok=True)
    key = rng.Key(cfg.seed)

    def hot_start():
        return rng.random_su3_field(key.fold(0), lat, device)

    start_traj = 0
    if cfg.start_condition == "continue":
        if isinstance(cfg.initial_store_counter, int):
            info = checkpoint_at(run_dir, cfg.initial_store_counter)
        else:
            info = latest_checkpoint(run_dir)
        if info is None:
            if lead:
                print(f"[hmc] no checkpoint in {run_dir}, falling back to hot start")
            u = hot_start()
        elif mesh is not None:
            u, start_traj, _ = parallel.load_gauge_sharded(info.path, mesh, cfg.lat)
            if lead:
                print(f"[hmc] resumed (sharded) at trajectory {start_traj} from {info.path}")
        else:
            arr, start_traj, _ = load_checkpoint(info.path, lat)
            u = torch.as_tensor(arr, device=device).to(torch.complex64)
            print(f"[hmc] resumed at trajectory {start_traj} from {info.path}")
    elif cfg.start_condition == "cold":
        u = torch.eye(3, dtype=torch.complex64, device=device).reshape(3, 3, 1, 1, 1, 1)
        u = u.expand((3, 3, 4) + lat.site_shape).contiguous()
    else:
        u = hot_start()

    # the rational monomials' intervals against the spectrum on the starting
    # configuration: a mis-bracketed interval spoils the heatbath's exactness
    if any(hasattr(m, "s_min") for m in hmc.monomials):
        from tmlqcd_tpu_torch.hmc.validate import check_rational_intervals

        check_rational_intervals(hmc, u, key=key.fold(10**6), verbose=lead)

    chrono = chrono_states(hmc, device)
    monitor_every = 10
    stopper = _GracefulStop()
    n_acc = 0
    traj = start_traj - 1
    with (open(os.path.join(run_dir, "output.data"), "a", buffering=1) if lead
          else open(os.devnull, "w")) as out:
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
            if cfg.debug_level >= 1 and lead:
                print(f"[traj {traj}] plaq={st.plaquette:.6f} dH={st.delta_h:+.4f} "
                      f"acc={acc} ({dt:.1f}s) force_iters=[{fiters}]", flush=True)
            if cfg.debug_level >= 2 and (traj + 1) % monitor_every == 0:
                # per-monomial force norms and the SU(3) drift of the links
                with torch.no_grad():
                    stats = monitor_forces(hmc, u, key.fold(-2 * traj - 2))
                for fs in stats:
                    msg = (f"# force {fs.name} ts={fs.timescale} |F|^2={fs.norm_sq:.6e} "
                           f"max={fs.max_abs:.6e} rms={fs.rms:.6e}")
                    if lead:
                        print(msg, flush=True)
                    out.write(msg + "\n")
                udef = float(su3.unitarity_defect(u))
                if lead:
                    print(f"# unitarity defect max|U^+U - 1| = {udef:.3e}", flush=True)
                out.write(f"# unitarity_defect {udef:.6e}\n")
            with torch.no_grad():
                run_measurements(cfg, u, lat, traj, run_dir, key)
            if cfg.reversibility_check and (traj + 1) % cfg.reversibility_interval == 0:
                with torch.no_grad():
                    ddh, du = reversibility_check(hmc, u, key.fold(-traj - 1))
                if lead:
                    print(f"[traj {traj}] reversibility: |ddH|={ddh:.3e} max|dU|={du:.3e}",
                          flush=True)
            last = traj == start_traj + cfg.measurements - 1
            if (traj + 1) % cfg.nsave == 0 or last or stopper.stop:
                # on a distributed mesh every rank takes part, rank 0 writes
                path = save_checkpoint(run_dir, u, traj + 1, cfg.seed, lat,
                                       fmt=cfg.checkpoint_format, plaquette=st.plaquette,
                                       beta=cfg.beta, precision=cfg.gauge_write_precision)
                if cfg.debug_level >= 1 and lead:
                    print(f"[traj {traj}] checkpoint -> {path}", flush=True)
            if distributed:  # a signal to one rank stops them all, after the same trajectory
                stopper.stop = bool(comm.global_max(torch.tensor(float(stopper.stop), device=device)))
            if stopper.stop:
                if lead:
                    print(f"[hmc] graceful stop after trajectory {traj} "
                          f"(resume with StartCondition = continue)")
                break
    total = traj - start_traj + 1
    if lead:
        print(f"[hmc] done: {total} trajectories, acceptance {n_acc / max(total, 1):.2%}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
