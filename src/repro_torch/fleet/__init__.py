"""Fleet subsystem: energy-aware autoscaling policies and
carbon/price-aware regions.

The port's own copy of the two leaf modules of ``repro.fleet``: the
control hook reads the autoscalers and the signal-aware routers read the
regions. The vectorized ``FleetEngine`` (``repro.fleet.engine``) waits
for ROADMAP A4(c)."""
from repro_torch.fleet.autoscale import (AUTOSCALERS, Autoscaler,
                                         FleetView, QueueDepthAutoscaler,
                                         TargetUtilizationAutoscaler,
                                         make_autoscaler)
from repro_torch.fleet.regions import (Region, Signal, assign_replicas,
                                       load_regions, sinusoid_region)

__all__ = [
    "Autoscaler", "FleetView", "TargetUtilizationAutoscaler",
    "QueueDepthAutoscaler", "AUTOSCALERS", "make_autoscaler",
    "Region", "Signal", "load_regions", "sinusoid_region",
    "assign_replicas",
]
