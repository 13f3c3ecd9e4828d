"""Observed state + actuators for one observe/plan/act window.
The port's own copy of ``repro.control.view``.

A :class:`~repro_torch.control.controllers.Controller` never touches an
engine directly: at each control boundary the engine-side
:class:`~repro_torch.control.hook.ControlHook` builds a :class:`ControlView`
— per-replica observations (queue depth, tokens in flight, batch
occupancy, rolling Wh/request, SLO attainment, region signals) plus a
smoothed arrival-rate estimate — hands it to the controller, and then
applies whatever targets the controller staged on it:

* ``set_freq_scale`` — per-replica (or fleet-wide) DVFS operating
  point, actuated through ``InferenceBackend.set_freq_scale``;
* ``set_admission_rate`` — the refill rate of the run's live
  :class:`AdmissionBucket` (``None`` = unlimited);
* ``set_replica_target`` — desired active replica count, actuated
  through the fleet autoscaler lifecycle (fleet engine only).

Which actuators exist depends on the engine: the single
``ServeEngine`` and the ``ClusterEngine`` expose frequency and
admission; the vectorized ``FleetEngine`` exposes frequency and
replica count (its arrival machinery is struct-of-arrays, so admission
shaping belongs to a scheduler there). Staging a target on a view that
cannot actuate it raises immediately, so a mis-wired controller fails
loudly instead of silently planning with a dead knob.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

#: sentinel distinguishing "controller did not touch admission" from
#: "controller explicitly set it to unlimited (None)"
_UNSET = object()


@dataclasses.dataclass
class ReplicaObs:
    """Observed state of one replica at a control boundary."""

    replica: int
    freq_scale: float               # current DVFS operating point
    queue_depth: int                # waiting in-engine + held at admission
    tokens_in_flight: float         # outstanding token work (prefill+decode)
    live: int                       # occupied decode slots
    max_batch: int
    energy_wh_per_request: float    # rolling Wh/request so far (NaN early)
    slo_attainment: float           # rolling, completed requests (NaN early)
    # region signals (fleet replicas assigned to a region; NaN otherwise)
    carbon_gco2_per_kwh: float = float("nan")
    price_usd_per_kwh: float = float("nan")

    @property
    def batch_occupancy(self) -> float:
        return self.live / self.max_batch if self.max_batch else 0.0


class AdmissionBucket:
    """Live token-bucket admission actuator.

    Unlike :class:`~repro_torch.serving.scheduler.PacedScheduler` (which
    shapes a whole arrival list up front), the bucket is consulted
    request-by-request while the run executes, and the controller may
    re-target its refill rate mid-run. State is ``(tokens, t_last)``;
    accrual is the closed-form refill over elapsed time, so admission
    instants are independent of how the engine discretizes time
    between calls — macro-stepped and single-stepped runs admit at
    bit-identical instants. ``rate=None`` means unlimited admission
    (the bucket is transparent; the default until a controller says
    otherwise).

    Rate changes conserve earned tokens: :meth:`set_rate` first
    accrues at the *old* rate up to the change instant, then switches
    — tokens earned before the change are never re-priced (tested by
    the mid-run conservation suite).
    """

    def __init__(self, rate_per_s: Optional[float] = None,
                 burst: int = 1):
        if burst < 1:
            raise ValueError("burst must be >= 1")
        if rate_per_s is not None and rate_per_s <= 0:
            raise ValueError("rate_per_s must be positive (or None "
                             "for unlimited admission)")
        self.rate = None if rate_per_s is None else float(rate_per_s)
        self.burst = float(burst)
        self.tokens = float(burst)
        self.t_last = 0.0

    def _accrue(self, t: float) -> None:
        if t > self.t_last:
            if self.rate is None:
                self.tokens = self.burst
            else:
                self.tokens = min(self.burst,
                                  self.tokens + (t - self.t_last)
                                  * self.rate)
            self.t_last = t

    def release_time(self, arrival: float) -> float:
        """Earliest instant a request arriving at ``arrival`` may be
        admitted (non-mutating — the engine polls this to bound its
        decode horizon before committing to an admission)."""
        if self.rate is None:
            return arrival
        t0 = max(self.t_last, arrival)
        tok = min(self.burst,
                  self.tokens + (t0 - self.t_last) * self.rate)
        if tok >= 1.0 - 1e-12:
            return t0
        return t0 + (1.0 - tok) / self.rate

    def take(self, t: float) -> None:
        """Consume one admission token at instant ``t``."""
        self._accrue(t)
        if self.rate is None:
            return
        self.tokens = max(self.tokens - 1.0, 0.0)

    def set_rate(self, rate_per_s: Optional[float], now: float,
                 burst: Optional[int] = None) -> None:
        """Re-target the refill rate at instant ``now``. Tokens earned
        before the change (at the old rate) are kept."""
        if rate_per_s is not None and rate_per_s <= 0:
            raise ValueError("rate_per_s must be positive (or None)")
        self._accrue(now)       # earn at the OLD rate up to the change
        self.rate = None if rate_per_s is None else float(rate_per_s)
        if burst is not None:
            if burst < 1:
                raise ValueError("burst must be >= 1")
            self.burst = float(burst)
            self.tokens = min(self.tokens, self.burst)


class ControlView:
    """What one controller firing sees and may do.

    Observations are read-only attributes; actuator calls *stage*
    targets which the owning hook applies after
    :meth:`~repro_torch.control.controllers.Controller.act` returns — so a
    controller that raises mid-plan changes nothing.
    """

    def __init__(self, t: float, replicas: List[ReplicaObs], *,
                 interval_s: float,
                 arrival_rate_per_s: float,
                 admission_rate: Optional[float],
                 n_active: int = 1,
                 min_replicas: int = 1, max_replicas: int = 1,
                 can_freq: bool = True, can_admit: bool = True,
                 can_scale: bool = False):
        self.t = t
        self.replicas = replicas
        self.interval_s = interval_s
        #: smoothed observed arrival rate (EMA over control windows)
        self.arrival_rate_per_s = arrival_rate_per_s
        #: current admission-bucket refill rate (None = unlimited)
        self.admission_rate = admission_rate
        self.n_active = n_active
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.can_freq = can_freq
        self.can_admit = can_admit
        self.can_scale = can_scale
        # staged targets (hook applies after act() returns)
        self.freq_targets: Dict[Optional[int], float] = {}
        self.admission_target = _UNSET
        self.replica_target: Optional[int] = None

    # -- aggregate observations ----------------------------------------
    @property
    def queue_depth(self) -> int:
        return sum(r.queue_depth for r in self.replicas)

    @property
    def tokens_in_flight(self) -> float:
        return sum(r.tokens_in_flight for r in self.replicas)

    @property
    def live(self) -> int:
        return sum(r.live for r in self.replicas)

    @property
    def mean_occupancy(self) -> float:
        if not self.replicas:
            return 0.0
        return (sum(r.batch_occupancy for r in self.replicas)
                / len(self.replicas))

    @property
    def freq_scale(self) -> float:
        """Mean current operating point across replicas."""
        if not self.replicas:
            return 1.0
        return (sum(r.freq_scale for r in self.replicas)
                / len(self.replicas))

    @property
    def energy_wh_per_request(self) -> float:
        vals = [r.energy_wh_per_request for r in self.replicas
                if math.isfinite(r.energy_wh_per_request)]
        return sum(vals) / len(vals) if vals else float("nan")

    @property
    def slo_attainment(self) -> float:
        vals = [r.slo_attainment for r in self.replicas
                if math.isfinite(r.slo_attainment)]
        return sum(vals) / len(vals) if vals else float("nan")

    # -- actuators ------------------------------------------------------
    def set_freq_scale(self, scale: float,
                       replica: Optional[int] = None) -> None:
        """Stage a DVFS target for one replica (or all, the default)."""
        if not self.can_freq:
            raise RuntimeError("this engine exposes no DVFS actuator "
                               "(backend lacks set_freq_scale)")
        if not 0.1 <= scale <= 1.5:
            raise ValueError(f"freq_scale {scale:g} outside [0.1, 1.5]")
        if replica is not None and not any(r.replica == replica
                                           for r in self.replicas):
            raise ValueError(f"unknown replica {replica}")
        self.freq_targets[replica] = float(scale)

    def set_admission_rate(self, rate_per_s: Optional[float],
                           burst: Optional[int] = None) -> None:
        """Stage a token-bucket refill rate (``None`` = unlimited)."""
        if not self.can_admit:
            raise RuntimeError(
                "this engine exposes no admission actuator (the "
                "vectorized fleet path shapes arrivals via schedulers)")
        if rate_per_s is not None and rate_per_s <= 0:
            raise ValueError("rate_per_s must be positive (or None)")
        if burst is not None and burst < 1:
            raise ValueError("burst must be >= 1")
        self.admission_target = (rate_per_s, burst)

    def set_replica_target(self, n: int) -> None:
        """Stage a desired active replica count (fleet engine only —
        actuated through the autoscaler lifecycle so every spin-up and
        drain joule is billed)."""
        if not self.can_scale:
            raise RuntimeError(
                "replica actuation requires the fleet engine "
                "(ExperimentSpec fleet='vector' with a controller)")
        n = int(n)
        self.replica_target = max(self.min_replicas,
                                  min(self.max_replicas, n))

    # -- hook side ------------------------------------------------------
    def staged(self) -> Tuple[Dict[Optional[int], float], object,
                              Optional[int]]:
        return self.freq_targets, self.admission_target, \
            self.replica_target
