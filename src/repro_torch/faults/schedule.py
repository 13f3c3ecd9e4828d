"""Deterministic, seeded fault schedules for the serving stack.
The port's own copy of ``repro.faults.schedule``.

A :class:`FaultSchedule` is an immutable, time-sorted list of
:class:`FaultEvent` entries describing *when* and *how* the simulated
hardware misbehaves:

``crash``
    The replica dies at ``t``: in-flight and queued requests enter
    ``RequestStatus.FAILED``, their KV pages are destroyed, and the
    joules already billed to them move to ``wasted_energy_j``. The
    replica draws nothing for ``downtime_s`` and then restarts empty.
``preempt``
    A spot-instance preemption: the notice lands at ``t`` and the kill
    follows at ``t + notice_s``. A retry policy with
    ``drain_on_notice`` uses the window to stop admitting and re-route
    queued work; whatever is still on the replica at kill time fails
    exactly like a crash.
``slowdown``
    Transient performance fault: the replica runs at
    ``freq_scale`` (DVFS actuation, same knob the controller uses)
    for ``duration_s`` and then returns to its base frequency.
``power_cap``
    A facility power cap, modelled identically to ``slowdown`` but
    kept as a distinct kind for reporting.
``link_degrade``
    The disaggregated prefill->decode interconnect degrades: handoff
    latency and energy are multiplied by ``link_factor`` for
    ``duration_s`` (disaggregated runs only; no replica state).

Events are pure data — engines consume them through
:meth:`FaultSchedule.boundaries`, which lowers each event to the
action timeline (notice/kill/slow_start/slow_end) a replica's serving
loop steps against. Fault boundaries are horizon stops: with no
schedule attached the fault path is never constructed and
macro-stepping stays bit-identical to single-stepping.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

FAULT_KINDS = ("crash", "preempt", "slowdown", "power_cap",
               "link_degrade")

#: boundary actions a replica loop dispatches on
_REPLICA_ACTIONS = ("notice", "kill", "slow_start", "slow_end")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault. Fields beyond ``t``/``kind``/``replica``
    only apply to some kinds (see module docstring)."""
    t: float
    kind: str
    replica: int = 0
    downtime_s: float = 0.0      # crash/preempt: dead time after kill
    notice_s: float = 0.0        # preempt: warning before the kill
    freq_scale: float = 1.0      # slowdown/power_cap: temporary DVFS
    duration_s: float = 0.0      # slowdown/power_cap/link_degrade
    link_factor: float = 1.0     # link_degrade: latency/energy mult

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; "
                f"expected one of {FAULT_KINDS}")
        if not (self.t >= 0.0):
            raise ValueError(f"fault time must be >= 0, got {self.t}")
        if self.replica < 0:
            raise ValueError("replica index must be >= 0")
        if self.kind in ("crash", "preempt"):
            if self.downtime_s < 0:
                raise ValueError("downtime_s must be >= 0")
        if self.kind == "preempt" and self.notice_s < 0:
            raise ValueError("notice_s must be >= 0")
        if self.kind in ("slowdown", "power_cap"):
            if not (0.1 <= self.freq_scale <= 1.5):
                raise ValueError(
                    f"freq_scale must be in [0.1, 1.5], "
                    f"got {self.freq_scale}")
            if not (self.duration_s > 0):
                raise ValueError("duration_s must be > 0")
        if self.kind == "link_degrade":
            if self.link_factor < 1.0:
                raise ValueError("link_factor must be >= 1.0")
            if not (self.duration_s > 0):
                raise ValueError("duration_s must be > 0")

    # -- spec-axis serialization (non-default fields only, so equal
    #    schedules hash equally) --------------------------------------
    def to_spec(self) -> Dict[str, object]:
        out: Dict[str, object] = {"t": self.t, "kind": self.kind}
        for f in dataclasses.fields(self):
            if f.name in ("t", "kind"):
                continue
            v = getattr(self, f.name)
            if v != f.default:
                out[f.name] = v
        return out

    @classmethod
    def from_spec(cls, d: Mapping[str, object]) -> "FaultEvent":
        return cls(**dict(d))

    # -- derived times ------------------------------------------------
    @property
    def t_kill(self) -> float:
        """Instant the replica actually dies (preempt kills after the
        notice window)."""
        return self.t + (self.notice_s if self.kind == "preempt"
                         else 0.0)

    @property
    def t_restart(self) -> float:
        return self.t_kill + self.downtime_s

    @property
    def t_end(self) -> float:
        """Last instant this event influences its replica."""
        if self.kind in ("crash", "preempt"):
            return self.t_restart
        return self.t + self.duration_s


@dataclasses.dataclass(frozen=True)
class FaultBoundary:
    """One scheduler-visible fault instant on a replica's timeline."""
    t: float
    action: str                  # "notice"/"kill"/"slow_start"/"slow_end"
    event: FaultEvent

    def __post_init__(self):
        if self.action not in _REPLICA_ACTIONS:
            raise ValueError(f"unknown boundary action {self.action!r}")


class FaultSchedule:
    """Immutable, validated, time-sorted fault schedule.

    ``events`` may arrive in any order; the schedule sorts by
    ``(t, replica)``. Per replica, crash/preempt/slowdown windows must
    not overlap (a replica cannot crash while already dead)."""

    def __init__(self, events: Sequence[FaultEvent]):
        evs = [e if isinstance(e, FaultEvent) else FaultEvent(**e)
               for e in events]
        evs.sort(key=lambda e: (e.t, e.replica))
        self.events: Tuple[FaultEvent, ...] = tuple(evs)
        self._validate()

    def _validate(self) -> None:
        last_end: Dict[int, float] = {}
        for e in self.events:
            if e.kind == "link_degrade":
                continue
            prev = last_end.get(e.replica, -math.inf)
            if e.t < prev - 1e-12:
                raise ValueError(
                    f"overlapping faults on replica {e.replica}: "
                    f"event at t={e.t} starts before the previous "
                    f"one ends at t={prev}")
            if math.isfinite(e.t_end):
                last_end[e.replica] = max(prev, e.t_end)
            else:
                last_end[e.replica] = math.inf

    def __len__(self) -> int:
        return len(self.events)

    def __iter__(self):
        return iter(self.events)

    def __eq__(self, other) -> bool:
        return (isinstance(other, FaultSchedule)
                and self.events == other.events)

    def __hash__(self) -> int:
        return hash(self.events)

    @property
    def max_replica(self) -> int:
        return max((e.replica for e in self.events), default=-1)

    def has_kind(self, *kinds: str) -> bool:
        return any(e.kind in kinds for e in self.events)

    def only_kinds(self, *kinds: str) -> bool:
        return all(e.kind in kinds for e in self.events)

    # -- engine lowering ----------------------------------------------
    def boundaries(self, replica: int) -> List[FaultBoundary]:
        """The action timeline replica ``replica`` steps against:
        crash -> kill@t; preempt -> notice@t + kill@t+notice;
        slowdown/power_cap -> slow_start@t + slow_end@t+duration.
        ``link_degrade`` has no replica boundary (see
        :meth:`link_factor`)."""
        out: List[FaultBoundary] = []
        for e in self.events:
            if e.replica != replica or e.kind == "link_degrade":
                continue
            if e.kind == "crash":
                out.append(FaultBoundary(e.t, "kill", e))
            elif e.kind == "preempt":
                out.append(FaultBoundary(e.t, "notice", e))
                out.append(FaultBoundary(e.t_kill, "kill", e))
            else:                       # slowdown / power_cap
                out.append(FaultBoundary(e.t, "slow_start", e))
                out.append(FaultBoundary(e.t + e.duration_s,
                                         "slow_end", e))
        out.sort(key=lambda b: b.t)
        return out

    def link_factor(self, t: float) -> float:
        """Interconnect degradation multiplier active at time ``t``
        (product over overlapping ``link_degrade`` windows)."""
        f = 1.0
        for e in self.events:
            if (e.kind == "link_degrade"
                    and e.t - 1e-12 <= t < e.t + e.duration_s - 1e-12):
                f *= e.link_factor
        return f

    # -- spec-axis serialization --------------------------------------
    def to_spec(self) -> Tuple[Dict[str, object], ...]:
        return tuple(e.to_spec() for e in self.events)

    @classmethod
    def from_spec(cls, events: Sequence[Mapping[str, object]]
                  ) -> "FaultSchedule":
        return cls([FaultEvent.from_spec(d) for d in events])


def random_fault_schedule(horizon_s: float, n_replicas: int = 1, *,
                          seed: int = 0,
                          rate_per_replica_hour: float = 4.0,
                          kinds: Sequence[str] = ("crash", "preempt",
                                                  "slowdown"),
                          mean_downtime_s: float = 20.0,
                          notice_s: float = 10.0,
                          slow_freq_scale: float = 0.6,
                          mean_slow_s: float = 30.0) -> FaultSchedule:
    """Seeded chaos generator: per replica, fault onsets arrive as a
    Poisson process at ``rate_per_replica_hour`` over ``[0, horizon_s)``
    with kinds drawn uniformly from ``kinds``; overlapping windows are
    dropped so the schedule always validates. Deterministic in
    ``seed``."""
    rng = np.random.default_rng(seed)
    events: List[FaultEvent] = []
    rate = rate_per_replica_hour / 3600.0
    for rep in range(n_replicas):
        t = 0.0
        while True:
            t += float(rng.exponential(1.0 / rate)) if rate > 0 else \
                math.inf
            if t >= horizon_s:
                break
            kind = str(rng.choice(list(kinds)))
            if kind == "crash":
                e = FaultEvent(t, "crash", replica=rep,
                               downtime_s=float(
                                   rng.exponential(mean_downtime_s)))
            elif kind == "preempt":
                e = FaultEvent(t, "preempt", replica=rep,
                               notice_s=notice_s,
                               downtime_s=float(
                                   rng.exponential(mean_downtime_s)))
            elif kind in ("slowdown", "power_cap"):
                e = FaultEvent(t, kind, replica=rep,
                               freq_scale=slow_freq_scale,
                               duration_s=max(
                                   1.0, float(
                                       rng.exponential(mean_slow_s))))
            elif kind == "link_degrade":
                e = FaultEvent(t, "link_degrade",
                               link_factor=4.0,
                               duration_s=max(
                                   1.0, float(
                                       rng.exponential(mean_slow_s))))
            else:
                raise ValueError(f"unknown fault kind {kind!r}")
            events.append(e)
            t = max(t, e.t_end)         # never overlap on this replica
    return FaultSchedule(events)


def make_faults(events: Optional[Sequence]) -> Optional[FaultSchedule]:
    """Coerce a spec-axis value (tuple of event dicts), an event list,
    or an existing schedule into a :class:`FaultSchedule`."""
    if events is None:
        return None
    if isinstance(events, FaultSchedule):
        return events
    return FaultSchedule([e if isinstance(e, FaultEvent)
                          else FaultEvent(**dict(e)) for e in events])
