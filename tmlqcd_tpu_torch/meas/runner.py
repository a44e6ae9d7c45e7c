"""Measurement dispatch: run the configured measurement list every
`frequency` trajectories.

Port of `tmlqcd_tpu/meas/runner.py`: ONLINE, PIONNORM, GRADIENTFLOW,
POLYAKOV, ORIENTEDPLAQUETTES, FIELDSTRENGTH and SFCOUPLING, each writing the
reference's file in its columns and formats.  A type that neither package
knows raises `ValueError` naming itself (`config.check_ported` refuses it
before the run starts), where the reference skips it without a word.

On one rank's slab of a distributed run (`lat` carries the mesh) every rank
runs every measurement (their solves, sums and gathers are collectives),
each returns the whole lattice's values, and rank 0 alone writes the files
(`comm.lead`); the timeslices run over the global T.
"""

from __future__ import annotations

import os

from tmlqcd_tpu_torch import comm, rng
from tmlqcd_tpu_torch.lattice import Lattice
from tmlqcd_tpu_torch.meas.correlators import online_measurement, pion_norm
from tmlqcd_tpu_torch.meas.gauge_obs import (
    field_strength_observables,
    oriented_plaquettes,
    polyakov_loop,
)
from tmlqcd_tpu_torch.meas.gradient_flow import wilson_flow
from tmlqcd_tpu_torch.ops.sf import sf_observables
from tmlqcd_tpu_torch.ops.wilson import DiracParams
from tmlqcd_tpu_torch.utils import to_host

__all__ = ["run_measurements", "PORTED"]

PORTED = ("ONLINE", "PIONNORM", "GRADIENTFLOW", "POLYAKOV", "ORIENTEDPLAQUETTES",
          "FIELDSTRENGTH", "SFCOUPLING")


def run_measurements(cfg, u, lat: Lattice, traj: int, run_dir: str, key: rng.Key,
                     draws: dict | None = None) -> None:
    """cfg: RunConfig; writes onlinemeas.NNNNNN, pionnorm.NNNNNN and
    gradflow.NNNNNN, and appends to polyakov.data, oriented_plaquettes.data,
    field_strength.data and sf_coupling.data.

    Each solving measurement draws from `key` folded with the trajectory and
    7000 + its index.  `draws` maps a measurement's index to keyword
    arguments that inject its draws instead (`t0` and `source` for ONLINE,
    `source` for PIONNORM), as `hmc_trajectory(draws=...)` does for a
    trajectory."""
    lead = comm.lead()
    t_all = lat.global_dims[0]
    for i, m in enumerate(cfg.meas):
        ty = m.type.upper()
        if ty not in PORTED:
            raise ValueError(f"unknown measurement type {m.type!r}")
        if m.frequency <= 0 or (traj + 1) % m.frequency != 0:
            continue
        if ty in ("ONLINE", "PIONNORM"):
            mkey = key.fold(traj, 7000 + i)
            params = DiracParams(kappa=m.kappa,
                                 mu=m.two_kappa_mu / (2 * m.kappa) if m.kappa else 0.0)
            kw = dict(tol=float(m.precision) ** 0.5, maxiter=m.max_solver_iterations,
                      **(draws or {}).get(i, {}))
        if ty == "ONLINE":
            cpp, cpa, _ = online_measurement(u, params, lat, mkey, **kw)
            if lead:
                with open(os.path.join(run_dir, f"onlinemeas.{traj:06d}"), "w") as f:
                    # column layout: type t C_PP C_PA
                    for t in range(t_all):
                        f.write(f"1 1 {t} {float(cpp[t]):.12e} {float(cpa[t]):.12e}\n")
        elif ty == "PIONNORM":
            cpn = pion_norm(u, params, lat, mkey, **kw)
            if lead:
                with open(os.path.join(run_dir, f"pionnorm.{traj:06d}"), "w") as f:
                    for t in range(t_all):
                        f.write(f"{t} {float(cpn[t]):.12e}\n")
        elif ty == "GRADIENTFLOW":
            res = wilson_flow(u, lat, eps=m.flow_eps, n_steps=m.flow_steps)
            if not lead:
                continue
            with open(os.path.join(run_dir, f"gradflow.{traj:06d}"), "w") as f:
                f.write("# t t2E_plaq t2E_clover\n")
                for t, ep, ec in zip(to_host(res.times), to_host(res.t2e_plaq),
                                     to_host(res.t2e_clover)):
                    f.write(f"{t:.6f} {ep:.10e} {ec:.10e}\n")
        elif ty == "POLYAKOV":
            pl = complex(polyakov_loop(u, lat, m.direction))
            if not lead:
                continue
            with open(os.path.join(run_dir, "polyakov.data"), "a") as f:
                f.write(f"{traj:08d} {m.direction} {pl.real:+.10e} {pl.imag:+.10e}\n")
        elif ty == "ORIENTEDPLAQUETTES":
            op = to_host(oriented_plaquettes(u, lat))
            if not lead:
                continue
            with open(os.path.join(run_dir, "oriented_plaquettes.data"), "a") as f:
                f.write(f"{traj:08d} " + " ".join(f"{v:.10f}" for v in op) + "\n")
        elif ty == "SFCOUPLING":
            obs = sf_observables(u, cfg.beta, lat, m.eta, m.nu, m.ct)
            if not lead:
                continue
            with open(os.path.join(run_dir, "sf_coupling.data"), "a") as f:
                # columns: traj dS/deta k S_sf (gbar^2 = k / <dS/deta>)
                f.write(f"{traj:08d} {float(obs['dS_deta']):+.10e} {float(obs['k']):.10e} "
                        f"{float(obs['action']):.10e}\n")
        else:  # FIELDSTRENGTH
            ep, ec, q = field_strength_observables(u, lat)
            if not lead:
                continue
            with open(os.path.join(run_dir, "field_strength.data"), "a") as f:
                # columns: traj E_plaq E_clover Q_clover
                f.write(f"{traj:08d} {float(ep):.10e} {float(ec):.10e} {float(q):+.10e}\n")
