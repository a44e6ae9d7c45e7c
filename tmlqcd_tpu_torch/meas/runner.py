"""Measurement dispatch: run the configured measurement list every
`frequency` trajectories.

Port of `tmlqcd_tpu/meas/runner.py` with the ONLINE and PIONNORM blocks; the
other measurement types raise `NotImplementedError` naming themselves (see
`config.check_ported`, which refuses them before the run starts).
"""

from __future__ import annotations

import os

from tmlqcd_tpu_torch import rng
from tmlqcd_tpu_torch.lattice import Lattice
from tmlqcd_tpu_torch.meas.correlators import online_measurement, pion_norm
from tmlqcd_tpu_torch.ops.wilson import DiracParams

__all__ = ["run_measurements", "PORTED"]

PORTED = ("ONLINE", "PIONNORM")


def run_measurements(cfg, u, lat: Lattice, traj: int, run_dir: str, key: rng.Key,
                     draws: dict | None = None) -> None:
    """cfg: RunConfig; writes onlinemeas.NNNNNN / pionnorm.NNNNNN files.

    Each measurement draws from `key` folded with the trajectory and 7000 +
    its index.  `draws` maps a measurement's index to keyword arguments that
    inject its draws instead (`t0` and `source` for ONLINE, `source` for
    PIONNORM), as `hmc_trajectory(draws=...)` does for a trajectory."""
    for i, m in enumerate(cfg.meas):
        ty = m.type.upper()
        if ty not in PORTED:
            raise NotImplementedError(
                f"measurement type {m.type!r} is not yet ported to tmlqcd_tpu_torch")
        if m.frequency <= 0 or (traj + 1) % m.frequency != 0:
            continue
        mkey = key.fold(traj, 7000 + i)
        params = DiracParams(kappa=m.kappa,
                             mu=m.two_kappa_mu / (2 * m.kappa) if m.kappa else 0.0)
        kw = dict(tol=float(m.precision) ** 0.5, maxiter=m.max_solver_iterations,
                  **(draws or {}).get(i, {}))
        if ty == "ONLINE":
            cpp, cpa, _ = online_measurement(u, params, lat, mkey, **kw)
            with open(os.path.join(run_dir, f"onlinemeas.{traj:06d}"), "w") as f:
                # column layout: type t C_PP C_PA
                for t in range(lat.dims[0]):
                    f.write(f"1 1 {t} {float(cpp[t]):.12e} {float(cpa[t]):.12e}\n")
        else:
            cpn = pion_norm(u, params, lat, mkey, **kw)
            with open(os.path.join(run_dir, f"pionnorm.{traj:06d}"), "w") as f:
                for t in range(lat.dims[0]):
                    f.write(f"{t} {float(cpn[t]):.12e}\n")
