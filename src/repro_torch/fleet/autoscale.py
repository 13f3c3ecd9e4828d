"""Energy-aware fleet autoscaling policies.
The port's own copy of ``repro.fleet.autoscale``.

An :class:`Autoscaler` is consulted by the fleet loop at arrival
instants (rate-limited by ``check_interval_s``) with a cheap
:class:`FleetView` of the current state and answers with a desired
active-replica count. The fleet engine owns the mechanics: spin-ups
pull replicas out of the off pool and become serviceable after the
device's ``spinup_latency_s``; scale-downs drain only workless
replicas. Both transitions bill the device's spin-up/drain energy into
the replica's transition ledger and the power trace, so fleet energy
still accounts to 100%.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

__all__ = ["FleetView", "Autoscaler", "TargetUtilizationAutoscaler",
           "QueueDepthAutoscaler", "AUTOSCALERS", "make_autoscaler"]


@dataclasses.dataclass
class FleetView:
    """What a policy may observe when deciding a scale action."""

    t: float            # simulation clock (the deciding arrival instant)
    n_active: int       # serviceable replicas (includes busy ones)
    n_total: int        # provisioned fleet size (active + off + warming)
    queued: int         # unfinished requests across active replicas
    busy: int           # active replicas currently mid-phase
    max_batch: int      # decode slots per replica

    @property
    def utilization(self) -> float:
        """Load-based utilization proxy: queued work over fleet decode
        capacity (can exceed 1.0 when queues back up)."""
        cap = max(self.n_active, 1) * max(self.max_batch, 1)
        return self.queued / cap


class Autoscaler:
    """Base policy: subclasses implement :meth:`desired`."""

    name = "base"

    def __init__(self, *, min_replicas: int = 1,
                 max_replicas: Optional[int] = None,
                 check_interval_s: float = 60.0):
        if min_replicas < 1:
            raise ValueError("min_replicas must be >= 1 (an empty "
                             "fleet can never serve)")
        if max_replicas is not None and max_replicas < min_replicas:
            raise ValueError("max_replicas < min_replicas")
        if check_interval_s <= 0:
            raise ValueError("check_interval_s must be > 0")
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.check_interval_s = check_interval_s

    def desired(self, view: FleetView) -> int:
        raise NotImplementedError

    def clamp(self, n: int, n_total: int) -> int:
        hi = n_total if self.max_replicas is None \
            else min(self.max_replicas, n_total)
        return max(self.min_replicas, min(n, hi))


class TargetUtilizationAutoscaler(Autoscaler):
    """Keep load-based utilization inside a band around ``target``.

    Outside the band the desired count is the one that restores
    utilization to ``target`` exactly: ``ceil(queued / (target *
    max_batch))``. The band keeps small fluctuations from thrashing
    spin-up energy."""

    name = "target_util"

    def __init__(self, *, target: float = 0.6, band: float = 0.15,
                 **kw):
        super().__init__(**kw)
        if not 0.0 < target <= 2.0:
            raise ValueError("target utilization must be in (0, 2]")
        if band < 0:
            raise ValueError("band must be >= 0")
        self.target = target
        self.band = band

    def desired(self, view: FleetView) -> int:
        util = view.utilization
        if abs(util - self.target) <= self.band:
            return view.n_active
        per = self.target * max(view.max_batch, 1)
        return int(math.ceil(view.queued / per)) if view.queued else 0


class QueueDepthAutoscaler(Autoscaler):
    """Scale on queued requests per active replica: grow above
    ``high``, shrink below ``low`` (to the count that restores a
    mid-band depth)."""

    name = "queue_depth"

    def __init__(self, *, high: float = 24.0, low: float = 4.0, **kw):
        super().__init__(**kw)
        if not 0 < low < high:
            raise ValueError("need 0 < low < high queue depths")
        self.high = high
        self.low = low

    def desired(self, view: FleetView) -> int:
        per = view.queued / max(view.n_active, 1)
        mid = 0.5 * (self.high + self.low)
        if per > self.high or per < self.low:
            return int(math.ceil(view.queued / mid)) if view.queued \
                else 0
        return view.n_active


AUTOSCALERS: Dict[str, type] = {
    cls.name: cls for cls in (TargetUtilizationAutoscaler,
                              QueueDepthAutoscaler)}


def make_autoscaler(name: str, params: Optional[Dict] = None
                    ) -> Autoscaler:
    """Autoscaler instance from its spec-axis name + params dict."""
    try:
        cls = AUTOSCALERS[name]
    except KeyError:
        raise ValueError(f"unknown autoscaler {name!r}; known: "
                         f"{sorted(AUTOSCALERS)}") from None
    return cls(**(params or {}))
