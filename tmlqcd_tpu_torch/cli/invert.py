"""Propagator-inversion driver: the `invert -f input` equivalent of the port.

Port of `tmlqcd_tpu/cli/invert.py`: read input -> read the gauge
configuration (`-c`, or `GaugeConfigInputFile.<InitialStoreCounter:04d>`) ->
for every BeginOperator block: prepare the sources, invert, write the
propagator.  A point source gives 12 spin-colour columns; with several
columns and `Solver = cg` (or `fastcg`) they run as ONE batched solve
(`invert_eo_rhs`) on the multi-RHS hopping kernel.  With `Solver =
increigcg` (not CLOVER) the columns run in sequence through
`invert_eo_increigcg`, each deflated by the low modes the earlier ones
harvested.  Otherwise they run column by column (`invert_eo`); for
`dflfgmres`, `dflgcr` and `dfl` (not CLOVER) the 2-level deflation setup is
built once per operator and gauge and reused by every column.  The solver
tolerance is sqrt(SolverPrecision).

Ported: the TMWILSON, WILSON and CLOVER operators with every solver the
inverter carries (`inverter.SOLVERS`).  As in the reference, a single column
of a CLOVER operator goes to `invert_clover_eo` and of any other operator to
`invert_eo`, which does not read CSW; the batched solve takes the clover
pipeline whenever CSW != 0.
The non-degenerate doublets DBTMWILSON and DBCLOVER (2Kappamubar,
2Kappaepsbar) go column by column to `invert_doublet_eo`: each spin-colour
source sits in the upper flavour slot and the solve returns the flavour
pair, written as one propagator file per flavour
(`propagator.NN.fl{0,1}.TTTTTT.lime`) or as `propagator_doublet` in the npz.
With UseStoutSmearing the gauge field is stout-smeared (StoutRho,
StoutNoIterations) before any operator or gauge copy is built, so every
kernel sees the smeared links; with UseSourceSmearing each source gets
JacobiIterations Jacobi sweeps (JacobiKappa) on the APE-smeared spatial
links (APEAlpha, APEIterations) of that same gauge field.  OVERLAP (m, s,
DegreeOfSignFunction, NoEigenvalues) builds the sign function's setup once
per gauge (`ops.overlap.make_overlap` with rho = 1 + s: Lanczos low modes
and the Chebyshev coefficients, every Q_W on K1), prints it, and solves the
columns one by one on the full lattice with `Solver = sumr` or `cgne`
(anything else runs sumr, as in the reference).

Usage:
    python -m tmlqcd_tpu_torch.cli.invert -f sample.input -c conf.000010.npz \
        [--source point|z2] [--timeslice 0] [--columns N] [--format lime|npz] [-o outdir]
        [--cpu] [--distributed]

`--columns N` inverts the first N of a point source's 12 spin-colour
columns (all 12 by default).

Without --cpu the run needs a CUDA device and raises if there is none; with
--cpu it runs the plain PyTorch versions of the kernels on the CPU.

--distributed, as the reference's: the processes join their group
(`parallel.init_distributed`, started by torchrun); the inverter builds no
mesh (Nr*Procs > 1 raises), so every rank runs the whole inversion and rank
0 writes the propagators and the log.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser(description="propagator inverter (PyTorch / CUDA)")
    ap.add_argument("-f", "--input", required=True)
    ap.add_argument("-c", "--config", default=None,
                    help="gauge checkpoint (.npz or ILDG); default: the input file's "
                    "GaugeConfigInputFile.<InitialStoreCounter>")
    ap.add_argument("--source", default=None, choices=["point", "z2"],
                    help="overrides the input file's SourceType")
    ap.add_argument("--timeslice", type=int, default=None,
                    help="overrides the input file's SourceTimeslice")
    ap.add_argument("--columns", type=int, default=12,
                    help="invert the first N spin-colour columns of a point source")
    ap.add_argument("--seed", type=int, default=171)
    ap.add_argument("--format", default="lime", choices=["lime", "npz"],
                    help="propagator output: SciDAC LIME records or npz")
    ap.add_argument("-o", "--output-dir", default=".")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU with the kernels' plain PyTorch versions")
    ap.add_argument("--distributed", action="store_true",
                    help="join the process group (torchrun); every rank inverts, rank 0 writes")
    args = ap.parse_args(argv)

    if args.distributed:
        # the reference's --distributed: the processes join, each runs the
        # whole inversion (the inverter builds no mesh), rank 0 writes the
        # files and the log; the others write into a scratch directory
        import tempfile

        import torch.distributed as dist

        from tmlqcd_tpu_torch import parallel

        device = parallel.init_distributed(cpu=args.cpu)
        rank, world = dist.get_rank(), dist.get_world_size()
        if rank == 0:
            print(f"[invert] distributed: process {rank} of {world}", flush=True)
            return _invert(args, device)
        with tempfile.TemporaryDirectory() as scratch, open(os.devnull, "w") as null, \
                contextlib.redirect_stdout(null):
            return _invert(argparse.Namespace(**{**vars(args), "output_dir": scratch}), device)
    if args.cpu:
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: run on a GPU, or pass --cpu for the plain path")
        device = torch.device("cuda", torch.cuda.current_device())
    return _invert(args, device)


def _invert(args, device) -> int:
    """The inversion of `main` on `device`."""
    from tmlqcd_tpu_torch import rng
    from tmlqcd_tpu_torch.config import check_invert_ported
    from tmlqcd_tpu_torch.config_tmlqcd import read_input
    from tmlqcd_tpu_torch.inverter import (
        invert_clover_eo,
        invert_doublet_eo,
        invert_eo,
        invert_eo_increigcg,
        invert_eo_rhs,
        make_deflation_setup,
    )
    from tmlqcd_tpu_torch.io.checkpoint import load_checkpoint
    from tmlqcd_tpu_torch.io.propagator import write_propagator
    from tmlqcd_tpu_torch.meas.smearing import ape_smear_spatial, jacobi_smear, stout_smear
    from tmlqcd_tpu_torch.meas.sources import point_source, z2_timeslice_source
    from tmlqcd_tpu_torch.ops import overlap as ov
    from tmlqcd_tpu_torch.ops.ndoublet import NDParams
    from tmlqcd_tpu_torch.ops.wilson import DiracParams
    from tmlqcd_tpu_torch.utils import to_host

    cfg = read_input(args.input)
    check_invert_ported(cfg)
    lat = cfg.lat
    conf = args.config
    if conf is None:
        if not cfg.gauge_config_input:
            print("[invert] no --config and no GaugeConfigInputFile in input", file=sys.stderr)
            return 1
        n = cfg.initial_store_counter
        conf = (f"{cfg.gauge_config_input}.{int(n):04d}" if isinstance(n, int)
                else cfg.gauge_config_input)
    arr, traj, _ = load_checkpoint(conf, lat)
    u = torch.as_tensor(arr, device=device).to(torch.complex64)
    os.makedirs(args.output_dir, exist_ok=True)

    if cfg.use_stout_smearing and cfg.stout_iterations > 0:
        # operator-level smearing: every operator and gauge copy below is
        # built on the smeared links
        u = stout_smear(u, lat, cfg.stout_rho, cfg.stout_iterations)
        print(f"[invert] stout smearing: rho={cfg.stout_rho} iters={cfg.stout_iterations}",
              flush=True)
    if cfg.use_source_smearing:
        # the sources' Jacobi sweeps run on APE-smeared spatial links of the
        # (stout-smeared) gauge field, built once
        u_ape = (ape_smear_spatial(u, lat, cfg.ape_alpha, cfg.ape_iterations)
                 if cfg.ape_iterations > 0 else u)

    if not cfg.operators:
        print("[invert] no BeginOperator block in input", file=sys.stderr)
        return 1

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    for iop, op in enumerate(cfg.operators):
        mu = op.two_kappa_mu / (2 * op.kappa) if op.kappa else 0.0
        params = DiracParams(kappa=op.kappa, mu=mu, c_sw=op.csw, theta=tuple(op.theta))
        is_clover = op.type.upper() == "CLOVER"
        is_doublet = op.type.upper() in ("DBTMWILSON", "DBCLOVER")
        is_overlap = op.type.upper() == "OVERLAP"
        inv = invert_clover_eo if is_clover else invert_eo
        tol = float(op.precision) ** 0.5
        solver = op.solver.lower()
        inv_kw = {"solver": solver}
        if solver in ("dflfgmres", "dflgcr", "dfl") and not (is_clover or is_doublet
                                                             or is_overlap):
            # the MG setup: once per gauge and operator, reused by every column
            sync()
            t0 = time.perf_counter()
            inv_kw["deflation_setup"] = make_deflation_setup(u, params, lat)
            sync()
            print(f"[invert] op {iop}: MG setup built in {time.perf_counter() - t0:.3f}s",
                  flush=True)

        # CLI flags override the input file's SourceType / SourceTimeslice
        src_kind = args.source or ("z2" if cfg.source_type.startswith("timeslice") else "point")
        ts = args.timeslice if args.timeslice is not None else cfg.source_timeslice
        if src_kind == "point":
            sources = [(s, c, point_source(lat, s, c, (ts, 0, 0, 0), device=device))
                       for s in range(4) for c in range(3)][:max(args.columns, 1)]
        else:
            sources = [(0, 0, z2_timeslice_source(lat, ts, rng.Key(args.seed), device=device))]
        if cfg.use_source_smearing:
            sources = [(s, c, jacobi_smear(src, u_ape, lat, cfg.jacobi_kappa,
                                           cfg.jacobi_iterations)) for s, c, src in sources]

        if is_doublet:
            two_k = 2.0 * op.kappa if op.kappa else 1.0
            nd_params = NDParams(kappa=op.kappa, mubar=op.two_kappa_mubar / two_k,
                                 epsbar=op.two_kappa_epsbar / two_k,
                                 c_sw=op.csw if op.type.upper() == "DBCLOVER" else 0.0,
                                 theta=tuple(op.theta))
            sol2 = np.zeros((len(sources), 2, 4, 3) + lat.site_shape, np.complex64)
            for i, (s, c, src) in enumerate(sources):
                sync()
                t0 = time.perf_counter()
                res = invert_doublet_eo(u, torch.stack([src, torch.zeros_like(src)]), nd_params,
                                        lat, tol=tol, maxiter=op.max_solver_iterations)
                sync()
                dt = time.perf_counter() - t0
                sol2[i] = to_host(res.x)
                print(f"[invert] op {iop} ({op.type}) source (s={s},c={c}): "
                      f"{res.iterations} iters, |r|^2={float(res.residual_sq):.3e}, {dt:.3f}s",
                      flush=True)
            if args.format == "lime":
                # one file per flavour: the strange / charm propagator pair
                for fl in range(2):
                    out = os.path.join(args.output_dir,
                                       f"propagator.{iop:02d}.fl{fl}.{traj:06d}.lime")
                    write_propagator(out, [sol2[i, fl] for i in range(len(sources))], lat,
                                     precision=op.propagator_precision)
                    print(f"[invert] wrote {out}", flush=True)
            else:
                out = os.path.join(args.output_dir, f"propagator.{iop:02d}.{traj:06d}.npz")
                np.savez_compressed(out, propagator_doublet=sol2,
                                    spin_color=[(s, c) for s, c, _ in sources], kappa=op.kappa,
                                    mubar=nd_params.mubar, epsbar=nd_params.epsbar,
                                    csw=nd_params.c_sw, dims=np.asarray(lat.dims),
                                    trajectory=traj)
                print(f"[invert] wrote {out}", flush=True)
            continue

        sol = np.zeros((len(sources), 4, 3) + lat.site_shape, np.complex64)
        if is_overlap:
            # the sign function's setup once per gauge, then full-lattice
            # solves column by column (no even/odd Schur complement)
            sync()
            t0 = time.perf_counter()
            ov_params = ov.OverlapParams(rho=1.0 + op.overlap_s, m=op.overlap_m,
                                         degree=op.sign_degree, n_ev=op.sign_n_ev,
                                         theta=tuple(op.theta))
            ov_setup = ov.make_overlap(u, ov_params, lat)
            sync()
            print(f"[invert] op {iop}: overlap setup ({op.sign_n_ev} modes, degree "
                  f"{op.sign_degree}, sign err {ov_setup.sign_err:.2e}, ev resid "
                  f"{ov_setup.ev_resid:.2e}, {ov_setup.lanczos_steps} Lanczos steps) built in "
                  f"{time.perf_counter() - t0:.3f}s", flush=True)
            ov_solver = solver if solver in ("sumr", "cgne") else "sumr"
            for i, (s, c, src) in enumerate(sources):
                sync()
                t0 = time.perf_counter()
                res = ov.invert_overlap(ov_setup, src, tol=tol, maxiter=op.max_solver_iterations,
                                        solver=ov_solver)
                sync()
                dt = time.perf_counter() - t0
                sol[i] = to_host(res.x)
                print(f"[invert] op {iop} ({op.type}, {ov_solver}) source (s={s},c={c}): "
                      f"{res.iterations} iters, |r|^2={float(res.residual_sq):.3e}, {dt:.3f}s",
                      flush=True)
        elif solver == "increigcg" and not is_clover:
            # sequential columns, each deflated by the low modes the earlier
            # ones harvested
            sync()
            t0 = time.perf_counter()
            results = invert_eo_increigcg(u, [src for _, _, src in sources], params, lat,
                                          tol=tol, maxiter=op.max_solver_iterations)
            sync()
            dt = time.perf_counter() - t0
            for i, res in enumerate(results):
                sol[i] = to_host(res.x)
            print(f"[invert] op {iop} ({op.type}) {len(sources)} sources incr-eigcg: iters "
                  f"{[r.iterations for r in results]}, max|r|^2="
                  f"{max(float(r.residual_sq) for r in results):.3e}, {dt:.3f}s", flush=True)
        elif len(sources) > 1 and solver in ("cg", "fastcg"):
            # all spin-colour columns as ONE batched solve on the multi-RHS
            # kernel: the gauge is read once for the whole batch
            sync()
            t0 = time.perf_counter()
            res = invert_eo_rhs(u, torch.stack([src for _, _, src in sources]), params, lat,
                                tol=tol, maxiter=op.max_solver_iterations)
            sync()
            dt = time.perf_counter() - t0
            sol[:] = to_host(res.x)
            print(f"[invert] op {iop} ({op.type}) {len(sources)} sources batched: "
                  f"{res.iterations} iters, max|r|^2={float(res.residual_sq.max()):.3e}, "
                  f"{dt:.3f}s", flush=True)
        else:
            for i, (s, c, src) in enumerate(sources):
                sync()
                t0 = time.perf_counter()
                res = inv(u, src, params, lat, tol=tol, maxiter=op.max_solver_iterations,
                          **inv_kw)
                sync()
                dt = time.perf_counter() - t0
                sol[i] = to_host(res.x)
                print(f"[invert] op {iop} ({op.type}) source (s={s},c={c}): "
                      f"{res.iterations} iters, |r|^2={float(res.residual_sq):.3e}, {dt:.3f}s",
                      flush=True)

        if args.format == "lime":
            out = os.path.join(args.output_dir, f"propagator.{iop:02d}.{traj:06d}.lime")
            # PropagatorPrecision = 32 writes single-precision propagators
            write_propagator(out, list(sol), lat, precision=op.propagator_precision)
        else:
            out = os.path.join(args.output_dir, f"propagator.{iop:02d}.{traj:06d}.npz")
            np.savez_compressed(out, propagator=sol, spin_color=[(s, c) for s, c, _ in sources],
                                kappa=op.kappa, mu=mu, csw=op.csw, dims=np.asarray(lat.dims),
                                trajectory=traj)
        print(f"[invert] wrote {out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
