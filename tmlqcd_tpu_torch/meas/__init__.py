"""Measurements: sources and the online correlators."""

from tmlqcd_tpu_torch.meas.correlators import (  # noqa: F401
    effective_mass,
    online_measurement,
    pa_correlator,
    pion_correlator,
    pion_norm,
)
from tmlqcd_tpu_torch.meas.sources import (  # noqa: F401
    gaussian_timeslice_source,
    point_source,
    volume_source,
    z2_timeslice_source,
)
