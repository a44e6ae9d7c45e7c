"""Embedding API: the package as an inverter and sampler library.

Port of `tmlqcd_tpu/api.py` (reference: wrapper/lib_wrapper.c and
include/tmLQCD.h: `tmLQCD_init_parallel_and_read_input`,
`tmLQCD_read_gauge`, `tmLQCD_invert`, `tmLQCD_get_gauge_field_pointer`,
`tmLQCD_finalise`).  A session holds the typed config, its lattice and the
gauge field as a tensor on the session's device: the card unless
`device="cpu"` is asked for (then the kernels' plain PyTorch versions run).

    import tmlqcd_tpu_torch.api as tm
    s = tm.init("hmc.input")            # or tm.init(RunConfig(...), device="cpu")
    s.read_gauge("conf.000100.lime")    # or s.hot_start(seed)
    x = s.invert(source)                # the first configured operator
    u = s.gauge                         # the current gauge field
    s.run_hmc(n_trajectories=10)        # advance the Markov chain in-process
"""

from __future__ import annotations

import numpy as np
import torch

from tmlqcd_tpu_torch import rng, su3
from tmlqcd_tpu_torch.config import RunConfig, build_hmc
from tmlqcd_tpu_torch.lattice import Lattice

__all__ = ["Session", "init"]


def _device(device) -> torch.device:
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: run on a GPU, or pass device='cpu' for the "
                           "plain path")
    return torch.device(device) if device is not None else torch.device(
        "cuda", torch.cuda.current_device())


class Session:
    """One lattice, config and gauge field (the global state that
    lib_wrapper.c initialises, here explicit and instantiable)."""

    def __init__(self, cfg: RunConfig, device=None):
        self.cfg = cfg
        self.lat: Lattice = cfg.lat
        self.device = _device(device)
        self.gauge: torch.Tensor | None = None
        self.trajectory: int = 0
        self._hmc = None

    # -- gauge management (tmLQCD_read_gauge / get_gauge_field_pointer) ----

    def read_gauge(self, path: str) -> None:
        """Read a native (.npz) or ILDG checkpoint."""
        from tmlqcd_tpu_torch.io.checkpoint import load_checkpoint

        arr, traj, _ = load_checkpoint(path, self.lat)
        self.gauge = torch.as_tensor(arr, device=self.device).to(torch.complex64)
        self.trajectory = traj

    def write_gauge(self, path: str, fmt: str = "ildg") -> None:
        """Write the gauge field as ILDG (with its plaquette, trajectory and
        beta) or as an npz holding `gauge`."""
        from tmlqcd_tpu_torch.utils import to_host

        if fmt == "ildg":
            from tmlqcd_tpu_torch.io import ildg

            ildg.write_gauge_field(path, to_host(self.gauge), self.lat,
                                   plaquette=self.plaquette(), trajectory=self.trajectory,
                                   beta=self.cfg.beta)
        else:
            np.savez(path, gauge=to_host(self.gauge))

    def hot_start(self, seed: int | None = None) -> None:
        key = rng.Key(self.cfg.seed if seed is None else seed)
        self.gauge = su3.random_su3(rng.generator(key, self.device), (4,) + self.lat.site_shape)

    def cold_start(self) -> None:
        eye = torch.eye(3, dtype=torch.complex64, device=self.device).reshape(3, 3, 1, 1, 1, 1)
        self.gauge = eye.expand((3, 3, 4) + self.lat.site_shape).contiguous()

    def plaquette(self) -> float:
        from tmlqcd_tpu_torch.ops.gauge_action import plaquette

        return float(plaquette(self.gauge, self.lat))

    # -- inversion (tmLQCD_invert) ------------------------------------------

    def invert(self, source: torch.Tensor, op_index: int = 0, tol: float | None = None):
        """Solve M x = b for the op_index-th configured BeginOperator (a
        CLOVER operator through `invert_clover_eo`, any other through
        `invert_eo`); returns the full-lattice solution."""
        from tmlqcd_tpu_torch.inverter import invert_clover_eo, invert_eo
        from tmlqcd_tpu_torch.ops.wilson import DiracParams

        if not self.cfg.operators:
            raise ValueError("no BeginOperator configured")
        op = self.cfg.operators[op_index]
        mu = op.two_kappa_mu / (2 * op.kappa) if op.kappa else 0.0
        params = DiracParams(kappa=op.kappa, mu=mu, c_sw=op.csw, theta=tuple(op.theta))
        fn = invert_clover_eo if op.type.upper() == "CLOVER" else invert_eo
        with torch.no_grad():
            res = fn(self.gauge, source.to(self.device), params, self.lat,
                     tol=tol if tol is not None else float(op.precision) ** 0.5,
                     maxiter=op.max_solver_iterations, solver=op.solver)
        return res.x

    # -- sampling ------------------------------------------------------------

    def run_hmc(self, n_trajectories: int = 1, seed: int | None = None):
        """Advance the chain; returns the list of TrajectoryStats."""
        from tmlqcd_tpu_torch.hmc import hmc_trajectory

        if self._hmc is None:
            self._hmc = build_hmc(self.cfg)
        if self.gauge is None:
            self.hot_start(seed)
        key = rng.Key(self.cfg.seed if seed is None else seed)
        stats = []
        for _ in range(n_trajectories):
            self.trajectory += 1
            with torch.no_grad():
                self.gauge, st = hmc_trajectory(self._hmc, self.gauge, key.fold(self.trajectory))
            stats.append(st)
        return stats

    def finalize(self) -> None:
        """Drop the field references (tmLQCD_finalise)."""
        self.gauge = None
        self._hmc = None


def init(cfg_or_path, device=None) -> Session:
    """A session from a RunConfig or a tmLQCD-style input file, on the card
    (`device=None`) or on the CPU (`device="cpu"`)."""
    if isinstance(cfg_or_path, RunConfig):
        return Session(cfg_or_path, device)
    from tmlqcd_tpu_torch.config_tmlqcd import read_input

    return Session(read_input(str(cfg_or_path)), device)
