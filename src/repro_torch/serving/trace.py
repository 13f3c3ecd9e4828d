"""Power-state telemetry for the serving timeline: the port's own copy
of ``repro.serving.trace``.

The paper attributes energy per *phase* (compute-bound prefill,
memory/idle-bound decode, idle gaps); the scheduler work in §5 only
makes sense if the saved joules are attributable to a phase on a
timeline. :class:`PowerTrace` records, per replica, every segment the
engine executes — ``prefill`` / ``decode`` / ``idle`` / ``gated`` —
with its time span, energy, and (for busy phases) batch size, and can
export the timeline as JSON so energy deltas between two runs can be
diffed segment-by-segment.

The recorder is conservative by construction: engines report each
accrual (one prefill batch, one decode step, one idle gap) at the
moment it is added to the energy books, so the trace's total energy
equals the report's total energy to float precision. Adjacent segments
in the same state are merged to keep exports compact (a 10k-step decode
run collapses into a handful of segments at the batch-size change
points).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional

#: canonical power states on the serving timeline
STATES = ("prefill", "decode", "idle", "gated")
#: fleet-autoscaler transition states — valid to record, but reported
#: by energy_by_state()/time_by_state() only when actually present, so
#: non-fleet traces (and their golden serializations) are unchanged
TRANSITION_STATES = ("spinup", "drain")
#: closed-loop controller action markers (:mod:`repro.control`) —
#: zero-duration, zero-energy segments stamping each observe/plan/act
#: firing onto the timeline. Like the transition states they surface in
#: the by-state summaries only when present, so controller-off traces
#: serialize byte-identically and 100%-energy accounting is unaffected.
CONTROL_STATES = ("control",)
#: fault-injection states (:mod:`repro.faults`) — ``down`` spans are a
#: dead replica's zero-energy wall-clock (the machine is off, not
#: idling). Present in by-state summaries only when recorded, so
#: fault-free traces serialize byte-identically.
FAULT_STATES = ("down",)


@dataclasses.dataclass
class Segment:
    replica: int
    state: str                  # one of STATES
    t0: float
    t1: float
    energy_j: float
    batch: float = 0.0          # time-weighted mean live batch (busy states)
    n_events: int = 1           # accruals merged into this segment
    #: DVFS operating point the segment executed at; serialized only
    #: when != 1.0 so pre-DVFS trace JSON is unchanged
    freq_scale: float = 1.0

    @property
    def duration_s(self) -> float:
        return self.t1 - self.t0

    @property
    def power_w(self) -> float:
        """Mean power over the segment (0.0 for zero-length segments)."""
        d = self.duration_s
        return self.energy_j / d if d > 0 else 0.0

    def as_dict(self) -> Dict:
        out = {"replica": self.replica, "state": self.state,
               "t0": self.t0, "t1": self.t1,
               "duration_s": self.duration_s,
               "energy_j": self.energy_j, "power_w": self.power_w,
               "batch": self.batch, "n_events": self.n_events}
        if self.freq_scale != 1.0:
            out["freq_scale"] = self.freq_scale
        return out


class PowerTrace:
    """Per-replica power-state timeline recorder."""

    def __init__(self, merge_tol_s: float = 1e-9):
        self.segments: List[Segment] = []
        self._last: Dict[int, Segment] = {}   # tail segment per replica
        self.merge_tol_s = merge_tol_s

    # ------------------------------------------------------------------
    def record(self, replica: int, state: str, t0: float, t1: float,
               energy_j: float, batch: float = 0.0,
               freq_scale: float = 1.0) -> None:
        if (state not in STATES and state not in TRANSITION_STATES
                and state not in CONTROL_STATES
                and state not in FAULT_STATES):
            raise ValueError(f"unknown power state {state!r}")
        if t1 < t0:
            raise ValueError(f"segment ends before it starts: {t0}..{t1}")
        tail = self._last.get(replica)
        if (tail is not None and tail.state == state
                and tail.freq_scale == freq_scale
                and abs(t0 - tail.t1) <= self.merge_tol_s):
            # merge contiguous same-state accruals; batch is
            # duration-weighted so decode batch decay stays visible
            d_old, d_new = tail.duration_s, t1 - t0
            d_tot = d_old + d_new
            if d_tot > 0:
                tail.batch = (tail.batch * d_old + batch * d_new) / d_tot
            elif batch:
                tail.batch = batch
            tail.t1 = t1
            tail.energy_j += energy_j
            tail.n_events += 1
            return
        seg = Segment(replica=replica, state=state, t0=t0, t1=t1,
                      energy_j=energy_j, batch=batch,
                      freq_scale=freq_scale)
        self.segments.append(seg)
        self._last[replica] = seg

    def record_action(self, replica: int, t: float,
                      freq_scale: float = 1.0) -> None:
        """Stamp a controller action onto the timeline: a zero-duration
        zero-energy ``control`` marker segment carrying the operating
        point the controller just set. Markers never merge (each firing
        stays a distinct segment) and add no energy, so 100%-energy
        accounting and coverage() are unchanged."""
        seg = Segment(replica=replica, state="control", t0=t, t1=t,
                      energy_j=0.0, batch=0.0, freq_scale=freq_scale)
        self.segments.append(seg)
        # deliberately NOT installed as the replica tail: the marker
        # must not break merging of the real power segments around it

    def record_run(self, replica: int, state: str, t0: float,
                   latencies, energies, batch: float = 0.0,
                   freq_scale: float = 1.0) -> None:
        """Record one engine macro-step (a fused run of same-state
        accruals, e.g. all decode steps inside one event horizon).

        The run coalesces into a single segment through the ordinary
        merge rule, but the per-accrual arithmetic — sequential energy
        adds, the duration-weighted batch fold, per-step time
        boundaries — is preserved exactly, so a traced macro-stepped
        run exports byte-identical segments to its single-stepped
        twin (including skipping zero-duration accruals, which the
        engine's per-step recorder drops)."""
        now = t0
        for lat, e in zip(latencies, energies):
            t1 = now + lat
            if t1 > now:
                self.record(replica, state, now, t1, e, batch,
                            freq_scale=freq_scale)
            now = t1

    # ------------------------------------------------------------------
    @property
    def n_replicas(self) -> int:
        return len({s.replica for s in self.segments})

    @property
    def total_energy_j(self) -> float:
        return sum(s.energy_j for s in self.segments)

    @property
    def span_s(self) -> float:
        if not self.segments:
            return 0.0
        return (max(s.t1 for s in self.segments)
                - min(s.t0 for s in self.segments))

    def energy_by_state(self) -> Dict[str, float]:
        out = {s: 0.0 for s in STATES}
        for seg in self.segments:
            out.setdefault(seg.state, 0.0)
            out[seg.state] += seg.energy_j
        return out

    def time_by_state(self, replica: Optional[int] = None
                      ) -> Dict[str, float]:
        out = {s: 0.0 for s in STATES}
        for seg in self.segments:
            if replica is None or seg.replica == replica:
                out.setdefault(seg.state, 0.0)
                out[seg.state] += seg.duration_s
        return out

    def coverage(self, reference_energy_j: float) -> float:
        """Fraction of a report's total energy this trace accounts for
        (the acceptance bar is >= 0.95; by construction it is ~1.0)."""
        if reference_energy_j <= 0:
            return 1.0 if self.total_energy_j <= 0 else 0.0
        return self.total_energy_j / reference_energy_j

    # ------------------------------------------------------------------
    def as_dict(self) -> Dict:
        return {
            "n_segments": len(self.segments),
            "n_replicas": self.n_replicas,
            "span_s": self.span_s,
            "total_energy_j": self.total_energy_j,
            "energy_by_state_j": self.energy_by_state(),
            "time_by_state_s": self.time_by_state(),
            "segments": [s.as_dict() for s in self.segments],
        }

    def to_json(self, path: Optional[str] = None, indent: int = 1) -> str:
        blob = json.dumps(self.as_dict(), indent=indent)
        if path is not None:
            with open(path, "w") as f:
                f.write(blob)
        return blob
