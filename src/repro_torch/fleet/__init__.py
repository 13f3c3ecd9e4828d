"""Fleet subsystem: vectorized cluster state, energy-aware
autoscaling, and carbon/price-aware geo-routing.

The port's own copy of ``repro.fleet``."""
from repro_torch.fleet.autoscale import (AUTOSCALERS, Autoscaler,
                                         FleetView, QueueDepthAutoscaler,
                                         TargetUtilizationAutoscaler,
                                         make_autoscaler)
from repro_torch.fleet.engine import FleetEngine, FleetReport, make_fleet
from repro_torch.fleet.regions import (Region, Signal, assign_replicas,
                                       load_regions, sinusoid_region)

__all__ = [
    "FleetEngine", "FleetReport", "make_fleet",
    "Autoscaler", "FleetView", "TargetUtilizationAutoscaler",
    "QueueDepthAutoscaler", "AUTOSCALERS", "make_autoscaler",
    "Region", "Signal", "load_regions", "sinusoid_region",
    "assign_replicas",
]
