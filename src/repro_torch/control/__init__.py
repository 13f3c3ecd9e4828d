"""Closed-loop control: model-predictive DVFS, admission, and
autoscaling inside the live scheduler.
The port's own copy of ``repro.control``.

The serving engines expose an observe/plan/act cycle at fixed
simulated-time boundaries: a :class:`Controller` reads a
:class:`ControlView` (per-replica queue depth, tokens in flight, batch
occupancy, rolling Wh/request, SLO attainment, region signals) and
stages actuator targets — per-replica DVFS ``freq_scale``, the
admission token-bucket refill rate, and (on the fleet engine) the
active replica count, actuated through the autoscaler lifecycle so
every transition joule stays billed.

:class:`MPCController` plans by *simulating itself*: it prices
candidate (freq, admission, replicas) tuples over a lookahead window
with the same :class:`~repro_torch.serving.backend.AnalyticBackend` the
engine bills with, then picks the cheapest plan that holds the SLO.
:class:`StaticController` and :class:`ReactiveController` are the
baselines the benchmark frontier compares against.
"""
from repro_torch.control.controllers import (CONTROLLERS, Controller,
                                       MPCController, PlannerContext,
                                       ReactiveController,
                                       StaticController,
                                       make_controller)
from repro_torch.control.hook import ControlHook, ControllerAutoscaler
from repro_torch.control.view import AdmissionBucket, ControlView, ReplicaObs

__all__ = [
    "AdmissionBucket",
    "CONTROLLERS",
    "ControlHook",
    "ControllerAutoscaler",
    "ControlView",
    "Controller",
    "MPCController",
    "PlannerContext",
    "ReactiveController",
    "ReplicaObs",
    "StaticController",
    "make_controller",
]
