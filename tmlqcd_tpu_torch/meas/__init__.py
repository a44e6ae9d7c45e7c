"""Measurements: sources, the online correlators, gauge observables, the
gradient flow and smearing."""

from tmlqcd_tpu_torch.meas.correlators import (  # noqa: F401
    effective_mass,
    online_measurement,
    pa_correlator,
    pion_correlator,
    pion_norm,
)
from tmlqcd_tpu_torch.meas.gauge_obs import (  # noqa: F401
    field_strength_observables,
    oriented_plaquettes,
    polyakov_loop,
    topological_charge,
)
from tmlqcd_tpu_torch.meas.gradient_flow import (  # noqa: F401
    FlowResult,
    energy_clover,
    energy_plaq,
    t0_scale,
    wilson_flow,
    wilson_flow_adaptive,
    wilson_flow_step,
)
from tmlqcd_tpu_torch.meas.sources import (  # noqa: F401
    gaussian_timeslice_source,
    point_source,
    volume_source,
    z2_timeslice_source,
)
