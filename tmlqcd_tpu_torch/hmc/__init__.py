"""HMC core: monomials, multi-timescale integrators, the trajectory update."""

from tmlqcd_tpu_torch.hmc.integrators import IntegratorConfig, Level  # noqa: F401
from tmlqcd_tpu_torch.hmc.monomials import (  # noqa: F401
    CloverDetMonomial,
    CloverDetRatioMonomial,
    CloverTrlogMonomial,
    DetMonomial,
    DetRatioMonomial,
    GaugeMonomial,
)
from tmlqcd_tpu_torch.hmc.poly_monomials import NDPolyMonomial  # noqa: F401
from tmlqcd_tpu_torch.hmc.rational_monomials import (  # noqa: F401
    NDRatCorMonomial,
    NDRatMonomial,
    RatCorMonomial,
    RatMonomial,
)
from tmlqcd_tpu_torch.hmc.trajectory import (  # noqa: F401
    Draws,
    HMCConfig,
    TrajectoryStats,
    chrono_states,
    hmc_trajectory,
    reversibility_check,
)
