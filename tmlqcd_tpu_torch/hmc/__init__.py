"""HMC core: monomials, multi-timescale integrators, the trajectory update."""

from tmlqcd_tpu_torch.hmc.integrators import IntegratorConfig, Level  # noqa: F401
from tmlqcd_tpu_torch.hmc.monomials import (  # noqa: F401
    DetMonomial,
    DetRatioMonomial,
    GaugeMonomial,
)
from tmlqcd_tpu_torch.hmc.trajectory import (  # noqa: F401
    Draws,
    HMCConfig,
    TrajectoryStats,
    chrono_states,
    hmc_trajectory,
)
