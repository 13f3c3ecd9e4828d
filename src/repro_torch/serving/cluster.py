"""Multi-replica cluster serving: N ``ServeEngine`` replicas behind a
routing policy, co-simulated against one shared arrival clock.
The port's own copy of ``repro.serving.cluster``.

This is the fleet-scale extension of the single-engine result: the
paper shows orchestration dominates per-request energy on one device;
at cluster scale the *router* decides how well each replica batches and
how much fleet idle power is burned. The co-simulation is a
conservative discrete-event loop over the replicas' stream primitives
(:meth:`ServeEngine.stream_step` etc.):

* the replica with work and the earliest local clock executes its next
  phase (so replicas interleave correctly on the shared timeline),
* when the next fleet event is an arrival, replicas without work are
  first advanced to the arrival instant — accruing idle power, or gated
  power when the policy gates idle replicas — and only then does the
  router observe the fleet and place the request,
* at the end, all replicas are aligned to the fleet wall clock, so
  fleet energy includes the tail idle of early-finishing replicas (this
  is what makes consolidate-and-gate policies comparable to spreading
  policies on equal footing).

Replicas may be heterogeneous: each owns its precision policy, device
spec, ``max_batch`` and energy model, and the energy-aware router
scores marginal energy per replica accordingly.
"""
from __future__ import annotations

import dataclasses
import math
from bisect import bisect_right as _bisect_right
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.serving.engine import (ServeEngine, ServeReport,
                                  _insert_pending, _remove_identity)
from repro_torch.serving.requests import Request, RequestStatus
from repro_torch.serving.router import Router, make_router
from repro_torch.serving.scheduler import (HorizonStop, Scheduler,
                                     apply_schedule)
from repro_torch.serving import slo
from repro_torch.serving.trace import PowerTrace


@dataclasses.dataclass
class ClusterReport:
    """Fleet-level aggregate over per-replica :class:`ServeReport`s."""

    replica_reports: List[ServeReport]
    policy: str
    wall_time_s: float
    # requests an admission-control scheduler rejected fleet-wide (never
    # routed; excluded from per-replica reports and every mean_*)
    shed: List[Request] = dataclasses.field(default_factory=list)
    # disaggregated serving: interconnect energy spent moving prefilled
    # KV caches from prefill to decode replicas (KV bytes x the device's
    # link_pj_per_byte), and how many requests were handed off. Part of
    # the fleet energy bill — disaggregation is not free.
    handoff_energy_j: float = 0.0
    n_handoffs: int = 0
    # workflow serving: per-task aggregation (repro_torch.workflows.TaskReport)
    # when a WorkflowSource drove the run
    tasks: List = dataclasses.field(default_factory=list)
    # fault injection (repro_torch.faults): terminal failures no replica owns
    # (delivery timeouts, requests stranded with every replica dead) —
    # empty without a fault schedule
    failed: List[Request] = dataclasses.field(default_factory=list)

    # -- fleet energy ---------------------------------------------------
    @property
    def total_energy_j(self) -> float:
        return (sum(r.total_energy_j for r in self.replica_reports)
                + self.handoff_energy_j)

    @property
    def busy_energy_j(self) -> float:
        return sum(r.busy_energy_j for r in self.replica_reports)

    @property
    def idle_energy_j(self) -> float:
        return sum(r.idle_energy_j for r in self.replica_reports)

    @property
    def gated_energy_j(self) -> float:
        return sum(r.gated_energy_j for r in self.replica_reports)

    @property
    def control(self) -> Optional[Dict]:
        """Closed-loop control telemetry (stored on replica 0's report
        — the controller is fleet-scoped); None on uncontrolled runs."""
        return (self.replica_reports[0].control
                if self.replica_reports else None)

    # -- fault injection ------------------------------------------------
    @property
    def n_failures(self) -> int:
        """Failure events fleet-wide (every crash-kill of an attempt,
        timeout, or stranding — one request can contribute several)."""
        return (sum(r.n_failures for r in self.replica_reports)
                + len(self.failed))

    @property
    def n_retries(self) -> int:
        return sum(r.n_retries for r in self.replica_reports)

    @property
    def wasted_energy_j(self) -> float:
        return sum(r.wasted_energy_j for r in self.replica_reports)

    @property
    def down_time_s(self) -> float:
        return sum(r.down_time_s for r in self.replica_reports)

    @property
    def n_failed(self) -> int:
        """Requests that ended terminally FAILED."""
        return sum(1 for r in self.requests
                   if r.status is RequestStatus.FAILED)

    @property
    def n_completed(self) -> int:
        return len(self.completed)

    @property
    def availability(self) -> float:
        """Fraction of fleet replica-time not spent dead."""
        denom = len(self.replica_reports) * self.wall_time_s
        if denom <= 0:
            return 1.0
        return 1.0 - self.down_time_s / denom

    @property
    def goodput_wh_per_request(self) -> float:
        """Fleet energy (waste included) per *completed* request."""
        n_done = len(self.completed)
        if n_done == 0:
            return math.inf if self.total_energy_j > 0 else 0.0
        return self.total_energy_j / n_done / 3600.0

    # -- requests -------------------------------------------------------
    @property
    def requests(self) -> List[Request]:
        """Every request the fleet owned: replica-served plus terminal
        failures no replica owns (so failure runs conserve counts)."""
        out = [r for rep in self.replica_reports for r in rep.requests]
        out.extend(self.failed)
        return out

    @property
    def n(self) -> int:
        return len(self.requests)

    @property
    def n_shed(self) -> int:
        return len(self.shed)

    @property
    def completed(self) -> List[Request]:
        return slo.completed(self.requests)

    @property
    def mean_energy_per_request_wh(self) -> float:
        if self.n == 0:
            return 0.0
        return self.total_energy_j / self.n / 3600.0

    @property
    def mean_energy_per_token_wh(self) -> float:
        """Fleet energy (incl. handoffs) per generated token, completed
        requests only — 0.0 on an empty or fully-shed run."""
        toks = sum(r.tokens_generated for r in self.completed)
        if toks == 0:
            return 0.0
        return self.total_energy_j / 3600.0 / toks

    @property
    def prefix_reused_tokens(self) -> int:
        """Prompt tokens fleet-wide whose KV was forked from a workflow
        parent instead of recomputed."""
        return sum(r.prefix_reused_tokens for r in self.replica_reports)

    @property
    def slo_attainment(self) -> float:
        """Fraction of offered load (served + shed) meeting its latency
        SLO; shed requests count as misses."""
        return slo.attainment(self.requests, self.shed)

    @property
    def requests_per_replica(self) -> List[int]:
        return [rep.n for rep in self.replica_reports]

    @property
    def utilization_per_replica(self) -> List[float]:
        # replica wall clocks are aligned to the fleet clock at end of
        # run, so per-replica utilization is fleet utilization share
        return [rep.utilization for rep in self.replica_reports]

    @property
    def idle_fraction_per_replica(self) -> List[float]:
        return [(rep.idle_time_s + rep.gated_time_s)
                / max(self.wall_time_s, 1e-12)
                for rep in self.replica_reports]

    def latency_percentiles(self, qs: Sequence[float] = (50, 90, 99)
                            ) -> Dict[str, float]:
        return slo.percentiles(self.requests, field="latency", qs=qs)

    def ttft_percentiles(self, qs: Sequence[float] = (50, 90, 99)
                         ) -> Dict[str, float]:
        return slo.percentiles(self.requests, field="ttft", qs=qs)

    def latency_percentiles_per_replica(
            self, qs: Sequence[float] = (50, 90, 99)
            ) -> List[Dict[str, float]]:
        """Per-replica latency percentiles; replicas that served zero
        requests (drained or never scaled up) yield 0.0-valued rows,
        never NaN."""
        return [slo.percentiles(rep.requests, field="latency", qs=qs)
                for rep in self.replica_reports]

    def ttft_percentiles_per_replica(
            self, qs: Sequence[float] = (50, 90, 99)
            ) -> List[Dict[str, float]]:
        return [slo.percentiles(rep.requests, field="ttft", qs=qs)
                for rep in self.replica_reports]

    def per_replica_summary(self) -> List[Dict[str, float]]:
        """One guarded row per replica — safe to tabulate for
        autoscaled fleets where some replicas never served a request."""
        rows = []
        for i, rep in enumerate(self.replica_reports):
            row = {"replica": i, "n_requests": rep.n,
                   "utilization": rep.utilization,
                   "idle_fraction": self.idle_fraction_per_replica[i],
                   "energy_j": rep.total_energy_j,
                   "mean_latency_s": rep.mean_latency_s,
                   "mean_ttft_s": rep.mean_ttft_s}
            for k, v in slo.percentiles(rep.requests,
                                        field="latency").items():
                row[f"latency_{k}_s"] = v
            rows.append(row)
        return rows

    def summary(self) -> Dict[str, float]:
        out = {
            "policy": self.policy,
            "n_replicas": len(self.replica_reports),
            "n_requests": self.n,
            "n_shed": self.n_shed,
            "slo_attainment": self.slo_attainment,
            "mean_energy_wh": self.mean_energy_per_request_wh,
            "fleet_energy_j": self.total_energy_j,
            "busy_energy_j": self.busy_energy_j,
            "idle_energy_j": self.idle_energy_j,
            "gated_energy_j": self.gated_energy_j,
            "handoff_energy_j": self.handoff_energy_j,
            "n_handoffs": self.n_handoffs,
            "wall_time_s": self.wall_time_s,
            "mean_utilization": float(
                np.mean(self.utilization_per_replica)),
            "mean_idle_fraction": float(
                np.mean(self.idle_fraction_per_replica)),
        }
        for k, v in self.latency_percentiles().items():
            out[f"latency_{k}_s"] = v
        for k, v in self.ttft_percentiles().items():
            out[f"ttft_{k}_s"] = v
        if (self.n_failures or self.n_retries or self.wasted_energy_j
                or self.down_time_s):
            out.update({
                "n_failures": self.n_failures,
                "n_retries": self.n_retries,
                "n_failed": self.n_failed,
                "n_completed": self.n_completed,
                "wasted_energy_wh": self.wasted_energy_j / 3600.0,
                "availability": self.availability,
                "goodput_wh_per_request": self.goodput_wh_per_request,
            })
        return out


class ClusterEngine:
    """N continuous-mode replicas driven by one router on a shared
    arrival clock."""

    def __init__(self, replicas: List[ServeEngine],
                 router: Optional[Router] = None, *,
                 policy: str = "round_robin"):
        if not replicas:
            raise ValueError("need at least one replica")
        for r in replicas:
            if r.mode != "continuous":
                raise ValueError(
                    "cluster replicas must be continuous-mode engines")
        self.replicas = replicas
        self.router = router if router is not None else \
            make_router(policy)
        # disaggregated prefill/decode fleets: every replica must name a
        # pool, and both pools must exist — arrivals route among the
        # prefill pool, prefilled KV caches hand off to the decode pool
        self.prefillers = [r for r in replicas if r.pool == "prefill"]
        self.decoders = [r for r in replicas if r.pool == "decode"]
        self.disaggregated = bool(self.prefillers or self.decoders)
        if self.disaggregated:
            if any(r.pool == "mixed" for r in replicas):
                raise ValueError(
                    "cannot mix pool='mixed' replicas with a "
                    "disaggregated prefill/decode fleet")
            if not self.prefillers or not self.decoders:
                raise ValueError(
                    "a disaggregated fleet needs at least one "
                    "pool='prefill' and one pool='decode' replica")

    # ------------------------------------------------------------------
    def run(self, requests: List[Request], *,
            scheduler: Optional[Scheduler] = None,
            trace: Optional[PowerTrace] = None,
            source: Optional[object] = None,
            controller: Optional[object] = None,
            control_interval_s: float = 1.0,
            faults: Optional[object] = None,
            retry: Optional[object] = None) -> ClusterReport:
        """Serve a request stream across the fleet. A scheduler shapes
        and admits the *shared* stream before the router sees it, so
        shaping composes with routing; a planning scheduler also lets
        work-less replicas power-gate the known gaps (same effect as a
        gating router, without changing placement).

        ``source`` is a :class:`~repro_torch.workflows.WorkflowSource`: each
        completion is reported back (with its replica), released
        successors join the shared arrival stream, and a child forking
        its parent's KV is affinity-routed to the parent's replica.

        ``controller`` is a :class:`~repro_torch.control.Controller` firing
        every ``control_interval_s`` of shared simulated time, with the
        fleet-wide actuators: per-replica DVFS and a cluster-level
        admission bucket gating releases before the router sees them.

        ``faults`` (a :class:`~repro_torch.faults.FaultSchedule`) injects
        per-replica crashes, preemptions and slowdowns; routing then
        always skips dead/draining replicas (health-aware failover).
        ``retry`` (a :class:`~repro_torch.faults.RetryPolicy`) re-queues
        failed work with backoff, optionally draining on preemption
        notices and hedging retried requests across two replicas."""
        if faults is not None:
            if controller is not None:
                raise ValueError("faults= cannot be combined with "
                                 "controller= (controlling a faulty "
                                 "fleet is future work)")
            if faults.max_replica >= len(self.replicas):
                raise ValueError(
                    f"fault schedule names replica "
                    f"{faults.max_replica} but the fleet has "
                    f"{len(self.replicas)} replicas")
            if self.disaggregated:
                if not faults.only_kinds("link_degrade"):
                    raise ValueError(
                        "disaggregated fleets only support "
                        "link_degrade faults (crash/preempt/slowdown "
                        "semantics for split pools is future work)")
                if retry is not None:
                    raise ValueError("retry= has no effect on a "
                                     "link_degrade-only schedule")
            else:
                if faults.has_kind("link_degrade"):
                    raise ValueError("link_degrade faults require a "
                                     "disaggregated fleet")
                if source is not None:
                    raise ValueError(
                        "faults= cannot be combined with a workflow "
                        "source on a cluster (run the workflow on a "
                        "single faulty ServeEngine instead)")
        if retry is not None and faults is None:
            raise ValueError("retry= without faults= has no effect; "
                             "attach a FaultSchedule")
        if controller is not None:
            if self.disaggregated:
                raise ValueError("controller= does not compose with "
                                 "disaggregated prefill/decode fleets")
            if source is not None:
                raise ValueError("controller= cannot be combined with "
                                 "a workflow source")
        reqs, shed = apply_schedule(requests, scheduler)
        if source is not None:
            source.bind(disaggregated=self.disaggregated,
                        page_size=self.replicas[0].batcher.kv.page_size,
                        kv_get=lambda i: self.replicas[i].batcher.kv)
            for r in shed:
                source.on_shed(r)
        gate = self.router.gates_idle or (scheduler is not None
                                          and scheduler.plans_gaps)
        for i, eng in enumerate(self.replicas):
            eng._trace = trace
            eng._trace_replica = i
        try:
            if self.disaggregated:
                rep = self._run_disaggregated(reqs, shed, gate,
                                              source=source,
                                              faults=faults)
            elif faults is not None:
                rep = self._run_faulty(reqs, shed, gate, faults, retry)
            else:
                hook = None
                if controller is not None:
                    from repro_torch.control.hook import ControlHook
                    hook = ControlHook(controller, control_interval_s)
                rep = self._run(reqs, shed, gate, source=source,
                                hook=hook)
        finally:
            for eng in self.replicas:
                eng._trace = None
        if source is not None:
            rep.tasks = source.task_reports()
        return rep

    def _run(self, reqs: List[Request], shed: List[Request],
             gate: bool, source: Optional[object] = None,
             hook: Optional[object] = None) -> ClusterReport:
        for eng in self.replicas:
            eng.stream_start()
        pending = list(reqs)
        head = 0
        seen = [0] * len(self.replicas)    # done cursors (source drain)
        self._gated = [False] * len(self.replicas)
        if hook is not None:
            hook.attach(list(enumerate(self.replicas)), pending)
            arrivals = [r.effective_arrival for r in pending]

            def fire(t: float) -> None:
                n_arr = _bisect_right(arrivals, t + 1e-12)
                hook.maybe_fire(t, n_arr, held=n_arr - head)

        def drain(i: int) -> None:
            done = self.replicas[i]._stream.done
            while seen[i] < len(done):
                r = done[seen[i]]
                seen[i] += 1
                if r.status is RequestStatus.DONE:
                    for child in source.on_finish(r, r.t_done,
                                                  replica=i):
                        _insert_pending(pending, head, child)

        while True:
            t_arr = (pending[head].effective_arrival
                     if head < len(pending) else None)
            if hook is not None and t_arr is not None:
                # the admission bucket may hold an arrival past its raw
                # arrival instant; the fleet delivers at the release
                t_arr = hook.release_time(t_arr)
            ready = [eng for eng in self.replicas
                     if eng.stream_can_step()]
            nxt = min(ready, key=lambda e: e.stream_now) if ready \
                else None
            # arrivals at or before the earliest steppable clock are
            # delivered FIRST — same-instant burst members must all be
            # admitted before the prefill batch is formed, exactly as
            # the single-engine loop admits arrivals <= now before
            # scheduling
            if nxt is not None and (t_arr is None
                                    or nxt.stream_now < t_arr - 1e-12):
                # per-replica decode horizons are clipped to the shared
                # arrival clock: a macro-step may run many decode steps
                # at once but never past the point where this loop
                # would have stopped stepping the replica
                bound = t_arr
                if source is not None:
                    # conservative co-sim bound for dynamic releases:
                    # any other steppable replica may complete a step
                    # and release a successor no earlier than its own
                    # clock, so never macro-step past it (the in-flight
                    # step still completes, exactly like the
                    # single-step loop) — this keeps macro_step on/off
                    # field-for-field identical under workflows
                    others = [e.stream_now for e in ready if e is not nxt]
                    if others:
                        o = min(others)
                        bound = o if bound is None else min(bound, o)
                if hook is not None:
                    # no phase runs past a control boundary, so actuator
                    # re-targets (freq, admission rate) stay causal
                    t_c = hook.next_boundary
                    bound = t_c if bound is None else min(bound, t_c)
                nxt.stream_step(
                    stop=None if bound is None
                    else HorizonStop(bound, mode="clock"))
                if source is not None:
                    drain(self.replicas.index(nxt))
                if hook is not None:
                    fire(nxt.stream_now)
                continue
            if t_arr is None:
                break
            if hook is not None and hook.next_boundary < t_arr - 1e-12:
                # the gap to the next arrival crosses a control
                # boundary: advance work-less replicas to the boundary
                # and fire there, so the controller keeps observing
                # (and may re-open admission) during lulls
                t_c = hook.next_boundary
                for j, eng in enumerate(self.replicas):
                    if (eng.stream_now < t_c
                            and not eng.stream_can_step()):
                        eng.stream_idle(t_c, gated=gate)
                        if gate:
                            self._gated[j] = True
                fire(t_c)
                continue
            # next fleet event is an arrival: bring work-less replicas
            # up to the arrival instant (idle or gated), then route
            for j, eng in enumerate(self.replicas):
                if eng.stream_now < t_arr and not eng.stream_can_step():
                    eng.stream_idle(t_arr, gated=gate)
                    if gate:
                        self._gated[j] = True
            req = pending[head]
            head += 1
            if hook is not None:
                hook.take(t_arr)
            aff = (source.route_affinity(req)
                   if source is not None else None)
            i = aff if aff is not None else \
                self.router.select(req, self.replicas, t_arr)
            if self._gated[i]:
                # waking a gated replica: clock ramp at idle power
                # before it can serve again
                self.replicas[i].stream_idle(
                    self.replicas[i].stream_now
                    + self.replicas[i].device.wake_latency_s)
                self._gated[i] = False
            self.replicas[i].stream_submit(req)
            if hook is not None:
                fire(t_arr)
        stuck = [i for i, eng in enumerate(self.replicas)
                 if eng.stream_stuck()]
        if stuck:
            raise RuntimeError(
                f"deadlock: replicas {stuck} hold waiting requests that "
                "can never be scheduled (KV pool too small)")
        # align every replica to the fleet wall clock so trailing idle
        # (or gated) time is part of the fleet energy bill
        t_end = max(eng.stream_now for eng in self.replicas)
        for eng in self.replicas:
            eng.stream_idle(t_end, gated=gate)
        reports = [eng.stream_report() for eng in self.replicas]
        if hook is not None:
            reports[0].control = hook.summary(t_end)
        return ClusterReport(replica_reports=reports,
                             policy=self.router.name,
                             wall_time_s=t_end, shed=shed)

    # -- fault-injected fleets ------------------------------------------
    def _run_faulty(self, reqs: List[Request], shed: List[Request],
                    gate: bool, faults, retry) -> ClusterReport:
        """Co-simulate the fleet under a fault schedule.

        Identical to :meth:`_run` between fault boundaries. Every
        replica's macro-steps are additionally bounded by the next
        unfired boundary of *any* replica, because a kill elsewhere can
        inject retried arrivals (and a preemption notice can re-route
        drained work) at boundary-derived instants — so macro-stepped
        and single-stepped faulty fleets stay bit-identical.

        Failover is routing-level: delivery only considers replicas
        that are neither dead (inside a downtime window) nor draining
        (inside a preemption-notice window under ``drain_on_notice``).
        With every replica unroutable the arrival is deferred to the
        earliest restart; if no restart is coming it fails terminally
        with ``fail_reason='no_capacity'``.

        Hedging (``retry.hedge``, fleets only): a *retried* request is
        submitted to two healthy replicas at once — the clone carries a
        fresh ``req_id`` and ``hedge_of`` — and the first completion
        wins; the loser is cancelled (its joules move to waste) and
        dropped from the reports, so each logical request is counted
        exactly once."""
        eps = 1e-12
        R = len(self.replicas)
        for eng in self.replicas:
            eng.stream_start()
        pending = list(reqs)
        head = 0
        seen = [0] * R                  # done cursors (hedge winners)
        self._gated = [False] * R
        tl = [faults.boundaries(i) for i in range(R)]
        fi = [0] * R
        base_freq = [eng.freq_scale for eng in self.replicas]
        down_until = [0.0] * R          # dead until (restart instant)
        routable_at = [0.0] * R         # earliest router-visible instant
        draining = [False] * R          # inside a preemption notice
        hedge_pairs: Dict[int, tuple] = {}  # req_id -> (partner, replica)
        next_id = max((r.req_id for r in reqs), default=-1) + 1
        failed_terminal: List[Request] = []
        drain_on = retry is not None and retry.drain_on_notice
        hedge_on = retry is not None and retry.hedge and R > 1
        timeout = retry.timeout_s if retry is not None else math.inf

        def requeue(i: int, failed: List[Request], t: float) -> None:
            """Crash aftermath: hedge copies with a live partner are
            dropped (the partner carries the attempt), retryable work
            re-enters the shared queue after backoff — free to route
            to any healthy replica — and exhausted work stays FAILED
            on the dead replica's report."""
            eng = self.replicas[i]
            for r in failed:
                pair = hedge_pairs.pop(r.req_id, None)
                if pair is not None:
                    hedge_pairs.pop(pair[0].req_id, None)
                    _remove_identity(eng._stream.submitted, r)
                    continue
                if (retry is not None
                        and r.n_attempts < retry.max_retries):
                    _remove_identity(eng._stream.submitted, r)
                    delay = retry.backoff(r.n_attempts)
                    r.n_attempts += 1
                    eng._stream.n_retries += 1
                    r.status = RequestStatus.QUEUED
                    r.fail_reason = None
                    r.release_time = t + delay
                    _insert_pending(pending, head, r)

        def apply_boundary(i: int) -> None:
            eng = self.replicas[i]
            b = tl[i][fi[i]]
            fi[i] += 1
            if b.action == "notice":
                if drain_on:
                    # graceful drain: router skips this replica until
                    # it restarts; queued-not-yet-running work re-
                    # routes to healthy replicas right now
                    draining[i] = True
                    routable_at[i] = b.event.t_restart
                    for r in eng.batcher.evict_waiting():
                        _remove_identity(eng._stream.submitted, r)
                        r.release_time = b.t
                        _insert_pending(pending, head, r)
            elif b.action == "kill":
                draining[i] = False
                down_until[i] = routable_at[i] = b.event.t_restart
                failed = eng.stream_crash(
                    "preempt" if b.event.kind == "preempt"
                    else "crash")
                requeue(i, failed, eng.stream_now)
            elif b.action == "slow_start":
                eng.set_freq_scale(b.event.freq_scale)
            else:                                   # slow_end
                eng.set_freq_scale(base_freq[i])

        def advance_to(j: int, t: float) -> None:
            """Advance a work-less replica's clock: dead time first
            (zero draw), idle/gated power for the rest."""
            eng = self.replicas[j]
            if eng.stream_now < down_until[j]:
                eng.stream_down(min(t, down_until[j]))
            if eng.stream_now < t:
                eng.stream_idle(t, gated=gate)
                if gate:
                    self._gated[j] = True

        def drain(i: int) -> None:
            """Hedge settlement: the first copy to finish wins, the
            partner is cancelled wherever it is."""
            done = self.replicas[i]._stream.done
            while seen[i] < len(done):
                r = done[seen[i]]
                seen[i] += 1
                if r.status is not RequestStatus.DONE:
                    continue
                pair = hedge_pairs.pop(r.req_id, None)
                if pair is None:
                    continue
                partner, pj = pair
                hedge_pairs.pop(partner.req_id, None)
                if partner.status is RequestStatus.DONE:
                    continue
                if not self.replicas[pj].stream_cancel(partner):
                    # evicted back to the shared queue by a drain
                    # notice: pull it before it is re-delivered
                    for idx in range(len(pending) - 1, head - 1, -1):
                        if pending[idx] is partner:
                            del pending[idx]
                            break

        while True:
            # fault boundaries reached by a replica's own clock fire
            # before anything else (the kill instant is exact: the
            # replica's macro-steps were bounded by it)
            fired = False
            for i in range(R):
                while (fi[i] < len(tl[i]) and self.replicas[i].stream_now
                        >= tl[i][fi[i]].t - eps):
                    apply_boundary(i)
                    fired = True
            if fired:
                continue
            t_arr = (pending[head].effective_arrival
                     if head < len(pending) else None)
            # next exogenous event: the shared arrival, or a boundary
            # on a replica that cannot reach it by stepping
            t_evt = t_arr
            for i in range(R):
                if (fi[i] < len(tl[i])
                        and not self.replicas[i].stream_can_step()):
                    t_b = tl[i][fi[i]].t
                    t_evt = t_b if t_evt is None else min(t_evt, t_b)
            ready = [eng for eng in self.replicas
                     if eng.stream_can_step()]
            nxt = min(ready, key=lambda e: e.stream_now) if ready \
                else None
            if nxt is not None and (t_evt is None
                                    or nxt.stream_now < t_evt - eps):
                bound = t_evt
                # any replica's next boundary may inject retried /
                # drained arrivals into the shared queue: never
                # macro-step past one (the in-flight step still
                # completes, exactly like the single-step loop)
                for j in range(R):
                    if fi[j] < len(tl[j]):
                        t_b = tl[j][fi[j]].t
                        bound = t_b if bound is None \
                            else min(bound, t_b)
                if hedge_on:
                    # a completion elsewhere may cancel this replica's
                    # hedge copy no earlier than that replica's clock
                    others = [e.stream_now for e in ready
                              if e is not nxt]
                    if others:
                        o = min(others)
                        bound = o if bound is None else min(bound, o)
                nxt.stream_step(
                    stop=None if bound is None
                    else HorizonStop(bound, mode="clock"))
                drain(self.replicas.index(nxt))
                continue
            if t_arr is None and nxt is None:
                # no work and no arrivals left: fire boundaries inside
                # the run window (they shape energy/availability), but
                # never extend the run for faults past the last clock
                t_max = max(e.stream_now for e in self.replicas)
                fired = False
                for j in range(R):
                    if (fi[j] < len(tl[j])
                            and tl[j][fi[j]].t <= t_max + eps):
                        advance_to(j, tl[j][fi[j]].t)
                        fired = True
                if fired:
                    continue
                break
            if t_arr is None or (t_evt is not None
                                 and t_evt < t_arr - eps):
                # a work-less replica's boundary precedes the arrival:
                # advance it there; the top-of-loop dispatcher fires it
                for j in range(R):
                    if (fi[j] < len(tl[j])
                            and not self.replicas[j].stream_can_step()
                            and tl[j][fi[j]].t <= t_evt + eps):
                        advance_to(j, tl[j][fi[j]].t)
                continue
            # deliver the arrival: bring work-less replicas up to the
            # instant, then route among healthy replicas only
            for j in range(R):
                if (self.replicas[j].stream_now < t_arr
                        and not self.replicas[j].stream_can_step()):
                    advance_to(j, t_arr)
            req = pending[head]
            head += 1
            if (retry is not None
                    and t_arr - req.arrival_time > timeout + eps):
                pair = hedge_pairs.pop(req.req_id, None)
                if pair is not None:
                    # a live partner carries the attempt: drop silently
                    hedge_pairs.pop(pair[0].req_id, None)
                    continue
                req.status = RequestStatus.FAILED
                req.fail_reason = "timeout"
                failed_terminal.append(req)
                continue
            rr = [j for j in range(R)
                  if t_arr >= down_until[j] - eps and not draining[j]]
            if not rr:
                t_ok = min(routable_at)
                if math.isinf(t_ok):
                    req.status = RequestStatus.FAILED
                    req.fail_reason = "no_capacity"
                    failed_terminal.append(req)
                    continue
                req.release_time = t_ok     # retry when one restarts
                _insert_pending(pending, head, req)
                continue
            k = self.router.select(
                req, [self.replicas[j] for j in rr], t_arr)
            i = rr[k]
            pair = hedge_pairs.get(req.req_id)
            if pair is not None:
                # re-delivery of a drained hedge member: keep the
                # partner's back-reference pointing at the new home
                hedge_pairs[pair[0].req_id] = (req, i)
            if self._gated[i]:
                self.replicas[i].stream_idle(
                    self.replicas[i].stream_now
                    + self.replicas[i].device.wake_latency_s)
                self._gated[i] = False
            self.replicas[i].stream_submit(req)
            if (hedge_on and req.n_attempts > 0
                    and req.hedge_of is None
                    and req.req_id not in hedge_pairs
                    and len(rr) >= 2):
                # a request that already failed once races on a second
                # healthy replica; first completion wins
                clone = Request(
                    req_id=next_id, prompt=req.prompt,
                    prompt_len=req.prompt_len,
                    max_new_tokens=req.max_new_tokens,
                    arrival_time=req.arrival_time,
                    priority=req.priority,
                    deadline_s=req.deadline_s,
                    slo_tier=req.slo_tier,
                    release_time=t_arr,
                    n_attempts=req.n_attempts,
                    hedge_of=req.req_id)
                next_id += 1
                rr2 = [j for j in rr if j != i]
                k2 = self.router.select(
                    clone, [self.replicas[j] for j in rr2], t_arr)
                i2 = rr2[k2]
                if self._gated[i2]:
                    self.replicas[i2].stream_idle(
                        self.replicas[i2].stream_now
                        + self.replicas[i2].device.wake_latency_s)
                    self._gated[i2] = False
                self.replicas[i2].stream_submit(clone)
                hedge_pairs[req.req_id] = (clone, i2)
                hedge_pairs[clone.req_id] = (req, i)
        stuck = [i for i, eng in enumerate(self.replicas)
                 if eng.stream_stuck()]
        if stuck:
            raise RuntimeError(
                f"deadlock: replicas {stuck} hold waiting requests that "
                "can never be scheduled (KV pool too small)")
        t_end = max(eng.stream_now for eng in self.replicas)
        for j in range(R):
            advance_to(j, t_end)
        reports = [eng.stream_report() for eng in self.replicas]
        return ClusterReport(replica_reports=reports,
                             policy=self.router.name,
                             wall_time_s=t_end, shed=shed,
                             failed=failed_terminal)

    # -- disaggregated prefill/decode fleets ---------------------------
    def _run_disaggregated(self, reqs: List[Request],
                           shed: List[Request], gate: bool,
                           source: Optional[object] = None,
                           faults: Optional[object] = None
                           ) -> ClusterReport:
        """Co-simulate a prefill pool and a decode pool.

        Arrivals route among the prefill replicas; the moment a prompt
        is fully prefilled, its KV cache travels to a decode replica —
        arriving ``kv_bytes / link_bw`` later and costing
        ``kv_bytes * link_pj_per_byte`` of interconnect energy (billed
        to the request and the fleet) — where the router places it and
        decode runs to completion without ever competing with a
        prefill for the device.

        Stepping is conservative like :meth:`_run`: prefill replicas
        are bounded by the next shared arrival; decode replicas are
        additionally bounded by the earliest in-flight handoff and by
        the earliest busy prefill clock (a busy prefiller may still
        emit an earlier handoff).  An event is delivered only once no
        replica may step under its bound, so no replica ever runs past
        an event that would have changed its queue.

        Request ownership: the decode replica's report owns each
        request (prefill replicas empty their ``requests`` list and
        report ``n_relayed`` instead), so fleet aggregates count every
        request exactly once.
        """
        import heapq

        from repro_torch.core.workload import kv_cache_bytes

        for eng in self.replicas:
            eng.stream_start()
        pending = list(reqs)
        head = 0
        inf = float("inf")
        gated = {id(eng): False for eng in self.replicas}
        events: List[tuple] = []    # (t_ready, seq, request) heap
        seq = 0
        hand_e = 0.0
        n_hand = 0
        dseen = {id(e): 0 for e in self.decoders}

        def drain_done(eng: ServeEngine) -> None:
            # workflow completions surface on decode replicas only (a
            # prefiller never finishes a request — it hands it off);
            # released children re-enter through the shared arrival
            # stream and route among the prefill pool like any arrival
            done = eng._stream.done
            i = self.replicas.index(eng)
            while dseen[id(eng)] < len(done):
                r = done[dseen[id(eng)]]
                dseen[id(eng)] += 1
                if r.status is RequestStatus.DONE:
                    for child in source.on_finish(r, r.t_done,
                                                  replica=i):
                        _insert_pending(pending, head, child)

        def drain(eng: ServeEngine) -> None:
            nonlocal seq, hand_e, n_hand
            for r in eng.stream_take_handoffs():
                nbytes = kv_cache_bytes(
                    eng.cfg, r.prompt_len + r.tokens_generated)
                # a degraded interconnect stretches the transfer and
                # burns proportionally more link energy (retransmits /
                # longer active-link time)
                lf = (faults.link_factor(eng.stream_now)
                      if faults is not None else 1.0)
                e = nbytes * eng.device.link_pj_per_byte * 1e-12 * lf
                r.energy_j += e
                hand_e += e
                n_hand += 1
                heapq.heappush(events, (
                    eng.stream_now
                    + nbytes * lf / eng.device.link_bw,
                    seq, r))
                seq += 1

        def wake(eng: ServeEngine) -> None:
            if gated[id(eng)]:
                eng.stream_idle(eng.stream_now
                                + eng.device.wake_latency_s)
                gated[id(eng)] = False

        def advance_idle(t: float) -> None:
            for eng in self.replicas:
                if eng.stream_now < t and not eng.stream_can_step():
                    eng.stream_idle(t, gated=gate)
                    if gate:
                        gated[id(eng)] = True

        while True:
            t_arr = (pending[head].effective_arrival
                     if head < len(pending) else inf)
            t_hand = events[0][0] if events else inf
            pf_busy = min((e.stream_now for e in self.prefillers
                           if e.stream_can_step()), default=inf)
            dec_bound = min(t_hand, t_arr, pf_busy)
            cands = [(e, t_arr, True) for e in self.prefillers
                     if e.stream_can_step()
                     and e.stream_now < t_arr - 1e-12]
            cands += [(e, dec_bound, False) for e in self.decoders
                      if e.stream_can_step()
                      and e.stream_now < dec_bound - 1e-12]
            if cands:
                eng, bound, is_prefiller = min(
                    cands, key=lambda c: c[0].stream_now)
                if source is not None and not is_prefiller:
                    # conservative co-sim bound for dynamic releases:
                    # another decoder may complete and release a
                    # successor no earlier than its own clock, so a
                    # macro decode run must not overshoot it (the
                    # in-flight step still completes) — keeps
                    # macro_step on/off field-for-field identical
                    others = [e.stream_now for e in self.decoders
                              if e is not eng and e.stream_can_step()]
                    if others:
                        bound = min(bound, min(others))
                eng.stream_step(stop=None if bound == inf
                                else HorizonStop(bound, mode="clock"))
                if is_prefiller:
                    drain(eng)
                elif source is not None:
                    drain_done(eng)
                continue
            if t_hand <= t_arr:
                if not events:
                    break               # both infinite: fully drained
                t, _, req = heapq.heappop(events)
                advance_idle(t)
                i = self.router.select(req, self.decoders, t)
                wake(self.decoders[i])
                self.decoders[i].stream_submit(req)
                continue
            req = pending[head]
            head += 1
            advance_idle(t_arr)
            i = self.router.select(req, self.prefillers, t_arr)
            wake(self.prefillers[i])
            self.prefillers[i].stream_submit(req)
        stuck = [i for i, eng in enumerate(self.replicas)
                 if eng.stream_stuck()]
        if stuck:
            raise RuntimeError(
                f"deadlock: replicas {stuck} hold waiting requests that "
                "can never be scheduled (KV pool too small)")
        t_end = max(eng.stream_now for eng in self.replicas)
        for eng in self.replicas:
            eng.stream_idle(t_end, gated=gate)
        reports = [eng.stream_report() for eng in self.replicas]
        for eng, rep in zip(self.replicas, reports):
            if eng.pool == "prefill":
                rep.requests = []       # decode replicas own them
        return ClusterReport(replica_reports=reports,
                             policy=self.router.name,
                             wall_time_s=t_end, shed=shed,
                             handoff_energy_j=hand_e,
                             n_handoffs=n_hand)


def make_cluster(cfg, n_replicas: int, *, policy: str = "round_robin",
                 fmt: str = "bfloat16", max_batch: int = 32,
                 **engine_kw) -> ClusterEngine:
    """Homogeneous-fleet convenience constructor.

    Builds a fresh :class:`~repro_torch.batching.policy.SlotCountPolicy` per
    replica (policies are stateful, so one instance must not be shared
    across engines); pass formation axes through
    :class:`~repro_torch.api.ExperimentSpec` for non-default policies."""
    from repro_torch.batching.policy import SlotCountPolicy
    if n_replicas > 1 and "batch_policy" in engine_kw:
        raise ValueError(
            "batch_policy= would be shared across replicas; build the "
            "replica list explicitly or use ExperimentSpec(batch_policy=)")
    mpb = engine_kw.pop("max_prefill_batch", 8)
    bucket = engine_kw.pop("bucket_prefill", True)
    replicas = []
    for _ in range(n_replicas):
        kw = dict(engine_kw)
        if "batch_policy" not in kw:
            kw["batch_policy"] = SlotCountPolicy(
                max_batch=max_batch, max_prefill_batch=mpb,
                bucket_prefill=bucket)
        replicas.append(ServeEngine(cfg, fmt=fmt, mode="continuous",
                                    **kw))
    return ClusterEngine(replicas, make_router(policy))
