"""Vectorized planet-scale fleet co-simulation.

The port's own copy of ``repro.fleet.engine``.

:class:`FleetEngine` serves the same request streams as
:class:`~repro_torch.serving.cluster.ClusterEngine`, but keeps the
co-simulation state — per-replica clocks, occupancy, idle/gated
accrual, power state — in struct-of-arrays numpy form, so the shared
arrival loop advances hundreds of replicas per masked array pass
instead of rescanning a Python object list per executed phase. The
legacy loop costs ``O(R)`` per engine phase (it re-derives the ready
set and the min clock each iteration); this loop costs ``O(1)`` per
phase plus a few short numpy passes per arrival.

Equivalence contract (pinned by the seeded parity suite): with
``autoscaler=None`` and any stock router, the fleet path is
**field-for-field identical** to ``ClusterEngine._run`` — same request
timings/energies, same per-replica report floats, same per-replica
power-trace segments. Two mechanisms make that possible:

* **Replica independence.** Between arrivals, non-disaggregated
  replicas interact only through the router. Advancing each busy
  replica to the arrival bound one replica at a time is bit-identical
  to the legacy global-min interleaving, because macro-step clipping is
  itself bit-invariant.
* **Saturation over-advance.** While a replica has zero free decode
  slots, no arrival could be admitted mid-run, so the loop may run it
  *past* the arrival bound with no stop (fewer, longer macro-steps).
  Completions collected early are held in a small pending ledger and
  become router-visible exactly when the serial loop would have
  collected them (when the final step's *start* falls behind the
  arrival clock — the serial loop's clipped run executes the crossing
  step and collects at its end). Routers that read more than queue
  depth (``reads`` of ``"work"``/``"state"``) disable over-advance and
  take the bounded, always-exact path.

On top of the vectorized state sit the fleet-scale features the serial
loop never had: an :class:`~repro_torch.fleet.autoscale.Autoscaler` hook
(spin-up/drain with transition energy billed into the trace, so the
fleet ledger still closes to 100%), a
:class:`~repro_torch.fleet.regions.Region` layer (time-varying carbon
intensity and energy price with exact per-window integrals, gCO2 and $
per request), and carbon-/price-aware geo-routing.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.fleet.autoscale import Autoscaler, FleetView
from repro_torch.fleet.regions import Region, assign_replicas, load_regions
from repro_torch.serving import slo
from repro_torch.serving.backend import AnalyticBackend, ReplayBackend
from repro_torch.serving.cluster import ClusterReport
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.requests import Request
from repro_torch.serving.router import Router, _SignalAwareRouter, make_router
from repro_torch.serving.scheduler import (HorizonStop, Scheduler,
                                     apply_schedule)
from repro_torch.serving.trace import PowerTrace

__all__ = ["FleetEngine", "FleetReport", "make_fleet"]

_EPS = 1e-12
_J_PER_KWH = 3.6e6
_BYTES_PER_TOKEN = 4.0      # serialized response-stream bytes per token

# replica lifecycle codes (autoscaler)
_ACTIVE, _WARMING, _OFF = 0, 1, 2


@dataclasses.dataclass
class FleetReport(ClusterReport):
    """:class:`ClusterReport` plus fleet telemetry: autoscaler
    transition accounting and (with a region layer) the carbon/price
    ledger and client-visible (RTT-inclusive) latency."""

    transition_energy_j: float = 0.0
    transition_time_s: float = 0.0
    n_transitions: int = 0
    # region layer (empty / None without regions=)
    region_names: List[str] = dataclasses.field(default_factory=list)
    region_of: List[int] = dataclasses.field(default_factory=list)
    rtt_s_of: List[float] = dataclasses.field(default_factory=list)
    gco2_total_g: Optional[float] = None
    usd_total: Optional[float] = None
    egress_usd_total: float = 0.0

    @property
    def gco2_per_request_g(self) -> Optional[float]:
        if self.gco2_total_g is None or self.n == 0:
            return self.gco2_total_g
        return self.gco2_total_g / self.n

    @property
    def usd_per_request(self) -> Optional[float]:
        if self.usd_total is None or self.n == 0:
            return self.usd_total
        return self.usd_total / self.n

    # -- client-visible latency (adds the serving region's RTT) -------
    def _client_values(self, field: str) -> List[float]:
        out: List[float] = []
        for i, rep in enumerate(self.replica_reports):
            rtt = self.rtt_s_of[i] if i < len(self.rtt_s_of) else 0.0
            out.extend(getattr(r, field) + rtt
                       for r in slo.completed(rep.requests))
        return out

    def client_latencies(self) -> List[float]:
        return self._client_values("latency")

    def client_ttfts(self) -> List[float]:
        return self._client_values("ttft")

    def client_latency_percentiles(self, qs: Sequence[float] = (50, 90, 99)
                                   ) -> Dict[str, float]:
        return slo.percentile_dict(self.client_latencies(), qs)

    def client_ttft_percentiles(self, qs: Sequence[float] = (50, 90, 99)
                                ) -> Dict[str, float]:
        return slo.percentile_dict(self.client_ttfts(), qs)

    def summary(self) -> Dict[str, float]:
        out = super().summary()
        out["transition_energy_j"] = self.transition_energy_j
        out["n_transitions"] = self.n_transitions
        if self.gco2_total_g is not None:
            out["gco2_total_g"] = self.gco2_total_g
            out["gco2_per_request_g"] = self.gco2_per_request_g
            out["usd_total"] = self.usd_total
            out["usd_per_request"] = self.usd_per_request
            for k, v in self.client_latency_percentiles().items():
                out[f"client_latency_{k}_s"] = v
        return out


class FleetEngine:
    """N continuous-mode replicas behind one router, co-simulated with
    struct-of-arrays state. Drop-in for :class:`ClusterEngine` on
    non-disaggregated fleets; adds ``autoscaler=`` / ``regions=``."""

    def __init__(self, replicas: List[ServeEngine],
                 router: Optional[Router] = None, *,
                 policy: str = "round_robin",
                 autoscaler: Optional[Autoscaler] = None,
                 regions: Optional[Sequence] = None):
        if not replicas:
            raise ValueError("need at least one replica")
        for r in replicas:
            if r.mode != "continuous":
                raise ValueError(
                    "fleet replicas must be continuous-mode engines")
            if r.pool != "mixed":
                raise ValueError(
                    "the vectorized fleet path does not support "
                    "disaggregated prefill/decode pools; use "
                    "ClusterEngine")
        self.replicas = replicas
        self.router = router if router is not None else \
            make_router(policy)
        self.autoscaler = autoscaler
        self.regions: List[Region] = (load_regions(list(regions))
                                      if regions else [])
        self.region_of = assign_replicas(self.regions, len(replicas)) \
            if self.regions else [0] * len(replicas)
        if isinstance(self.router, _SignalAwareRouter):
            if not self.regions:
                raise ValueError(
                    f"router {self.router.name!r} needs a region "
                    "layer; pass regions=")
            self.router.bind_regions(self.regions, self.region_of)

    # ------------------------------------------------------------------
    def run(self, requests: List[Request], *,
            scheduler: Optional[Scheduler] = None,
            trace: Optional[PowerTrace] = None,
            source: Optional[object] = None,
            controller: Optional[object] = None,
            control_interval_s: float = 1.0,
            faults: Optional[object] = None,
            retry: Optional[object] = None) -> FleetReport:
        if source is not None:
            raise ValueError(
                "the vectorized fleet path does not support workflow "
                "sources; use ClusterEngine")
        if faults is not None:
            # fault semantics live in the serial co-simulation loop
            # (field-for-field identical on non-disaggregated fleets by
            # the parity contract above); the vectorized over-advance
            # machinery is incompatible with mid-run replica death
            if self.autoscaler is not None or self.regions:
                raise ValueError(
                    "faults= does not compose with autoscaler= or "
                    "regions= (failure-aware autoscaling is future "
                    "work)")
            if controller is not None:
                raise ValueError("faults= cannot be combined with "
                                 "controller=")
            from repro_torch.serving.cluster import ClusterEngine
            crep = ClusterEngine(self.replicas, self.router).run(
                requests, scheduler=scheduler, trace=trace,
                faults=faults, retry=retry)
            return FleetReport(
                replica_reports=crep.replica_reports,
                policy=crep.policy, wall_time_s=crep.wall_time_s,
                shed=crep.shed, failed=crep.failed)
        hook = None
        if controller is not None:
            if self.autoscaler is not None:
                raise ValueError(
                    "controller= and autoscaler= are both replica-count "
                    "authorities; pass one (the controller scales via "
                    "set_replica_target)")
            from repro_torch.control.hook import ControlHook
            hook = ControlHook(controller, control_interval_s)
        reqs, shed = apply_schedule(requests, scheduler)
        gate = self.router.gates_idle or (scheduler is not None
                                          and scheduler.plans_gaps)
        for i, eng in enumerate(self.replicas):
            eng._trace = trace
            eng._trace_replica = i
        try:
            rep = self._run(reqs, shed, gate, trace, hook=hook)
        finally:
            for eng in self.replicas:
                eng._trace = None
        return rep

    # ------------------------------------------------------------------
    def _run(self, reqs: List[Request], shed: List[Request],
             gate: bool, trace: Optional[PowerTrace],
             hook: Optional[object] = None) -> FleetReport:
        replicas = self.replicas
        R = len(replicas)
        for eng in replicas:
            eng.stream_start()

        # --- struct-of-arrays co-simulation state ---------------------
        clock = np.zeros(R)             # stream_now mirror (busy replicas)
        iclock = np.zeros(R)            # accrual clock (workless replicas)
        busy = np.zeros(R, dtype=bool)  # stream_can_step mirror
        vload = np.zeros(R, dtype=np.int64)   # router-visible load
        gatedf = np.zeros(R, dtype=bool)
        idle_e = np.zeros(R)
        idle_t = np.zeros(R)
        gated_e = np.zeros(R)
        gated_t = np.zeros(R)
        trans_e = np.zeros(R)
        trans_t = np.zeros(R)
        # over-advance pending-completion ledger
        pend_n = np.zeros(R, dtype=np.int64)
        pend_pen = np.full(R, -np.inf)  # final-step start per batch
        maxb = np.array([e.max_batch for e in replicas], dtype=np.int64)

        # non-busy power per replica; non-"pure" backends (recording
        # wrappers, custom models) fall back to per-call backend.idle so
        # their side effects are preserved
        pure = np.zeros(R, dtype=bool)
        p_idle = np.zeros(R)
        p_gated = np.zeros(R)
        for i, eng in enumerate(replicas):
            b = eng.backend
            fn = type(b).idle
            if fn is AnalyticBackend.idle:
                pure[i] = True
                p_idle[i] = b.device.state_power("idle")
                p_gated[i] = b.device.state_power("gated")
            elif fn is ReplayBackend.idle:
                pure[i] = True
                p_idle[i] = b.idle_power_w
                p_gated[i] = b.gated_power_w
        all_pure = bool(pure.all())
        nb_state = "gated" if gate else "idle"
        p_nb = p_gated if gate else p_idle

        # region layer: carbon/price ledgers (per replica, gCO2 / $)
        geo = bool(self.regions)
        reg_of = np.asarray(self.region_of, dtype=np.int64)
        carbon_g = np.zeros(R)
        usd = np.zeros(R)
        egress_usd = 0.0
        w_open = np.zeros(R)            # open non-busy billing window

        def bill_span(i: int, t0: float, t1: float, p: float) -> None:
            """Bill a constant-power span of replica ``i`` to its
            region's signals (∫P·f = P·∫f, exact)."""
            r = self.regions[reg_of[i]]
            carbon_g[i] += p * r.carbon.integral(t0, t1) / _J_PER_KWH
            usd[i] += p * r.price.integral(t0, t1) / _J_PER_KWH

        def close_window(i: int, t_close: float) -> None:
            """Close replica ``i``'s open non-busy window at
            ``t_close`` (power was constant at the run's non-busy state
            over the whole window)."""
            if not geo or t_close <= w_open[i]:
                return
            bill_span(i, float(w_open[i]), t_close, float(p_nb[i]))
            w_open[i] = t_close

        # --- autoscaler lifecycle -------------------------------------
        scaler = self.autoscaler
        if hook is not None:
            # closed-loop control: the controller actuates per-replica
            # DVFS directly and the replica count through a
            # ControllerAutoscaler, so every controller-triggered
            # spin-up/drain is billed by the existing transition path.
            # It fires at arrival instants (rate-limited to the control
            # interval by the decide() machinery below).
            from repro_torch.control.hook import ControllerAutoscaler
            sig = None
            if self.regions:
                regions, reg_idx = self.regions, self.region_of

                def sig(i, t):
                    r = regions[reg_idx[i]]
                    return (float(r.carbon.at(t)), float(r.price.at(t)))
            hook.attach(list(enumerate(replicas)), reqs,
                        can_admit=False, can_scale=True,
                        min_replicas=1, max_replicas=R, n_active=1,
                        signals=sig)
            scaler = ControllerAutoscaler(hook, max_replicas=R)
        life = np.zeros(R, dtype=np.int8)
        ready_at = np.zeros(R)
        avail_at = np.zeros(R)
        n_transitions = 0
        last_check = 0.0
        if scaler is not None:
            n0 = scaler.clamp(getattr(scaler, "initial_replicas", None)
                              or scaler.min_replicas, R)
            life[n0:] = _OFF

        def bill_transition(i: int, state: str, t0: float, t1: float,
                            e: float) -> None:
            nonlocal n_transitions
            trans_e[i] += e
            trans_t[i] += t1 - t0
            n_transitions += 1
            if trace is not None and t1 > t0:
                trace.record(i, state, t0, t1, e)
            if geo:
                r = self.regions[reg_of[i]]
                carbon_g[i] += e * r.carbon.mean(t0, t1) / _J_PER_KWH
                usd[i] += e * r.price.mean(t0, t1) / _J_PER_KWH

        def activate_warm(t: float) -> None:
            """Replicas whose warm-up finished join the active set (at
            their ready instant, so the pre-arrival idle tail accrues
            in the normal pass)."""
            for i in np.nonzero((life == _WARMING) & (ready_at <= t))[0]:
                life[i] = _ACTIVE
                iclock[i] = ready_at[i]
                if geo:
                    w_open[i] = ready_at[i]

        def decide(t: float) -> None:
            """Consult the policy (rate-limited) and execute spin-ups /
            drains. Runs after the accrual pass, so every workless
            active replica sits exactly at ``t``."""
            nonlocal last_check
            if t - last_check < scaler.check_interval_s:
                return
            last_check = t
            alive = life == _ACTIVE
            n_active = int(alive.sum())
            view = FleetView(t=t, n_active=n_active, n_total=R,
                             queued=int(vload[alive].sum()),
                             busy=int((busy & alive).sum()),
                             max_batch=int(maxb.max()))
            desired = scaler.clamp(scaler.desired(view), R)
            coming = n_active + int((life == _WARMING).sum())
            if desired > coming:
                for i in np.nonzero(life == _OFF)[0][:desired - coming]:
                    dev = replicas[i].device
                    t0 = max(t, float(avail_at[i]))
                    life[i] = _WARMING
                    ready_at[i] = t0 + dev.spinup_latency_s
                    bill_transition(i, "spinup", t0, float(ready_at[i]),
                                    dev.spinup_energy_j)
            elif desired < n_active:
                idlers = np.nonzero(alive & ~busy & (vload == 0)
                                    & (pend_n == 0))[0]
                for i in idlers[::-1][:n_active - desired]:
                    dev = replicas[i].device
                    close_window(i, float(iclock[i]))
                    life[i] = _OFF
                    avail_at[i] = t + dev.drain_latency_s
                    # the drain span occupies the replica's wall clock
                    iclock[i] = avail_at[i]
                    bill_transition(i, "drain", t, float(avail_at[i]),
                                    dev.drain_energy_j)

        # --- per-replica advancing ------------------------------------
        # a controller may re-target DVFS at any arrival instant, so a
        # saturated replica must never run past the arrival clock (an
        # over-advanced run would price future steps at a stale freq)
        over_advance = (getattr(self.router, "reads", "state")
                        in ("none", "load")) and hook is None

        def advance(i: int, t: Optional[float]) -> None:
            """Run replica ``i``'s phases up to arrival bound ``t``
            (None: drain to completion), exactly as the serial loop
            would have stepped it."""
            eng = replicas[i]
            s = eng._stream
            # a pend can only exist if this replica over-ran an earlier
            # arrival; being behind the new bound makes it stale
            if pend_n[i]:
                pend_n[i] = 0
            while True:
                if t is not None and not s.now < t - _EPS:
                    break
                if not eng.stream_can_step():
                    break
                if (t is None or (over_advance
                                  and eng.batcher.free_count == 0)):
                    # saturated: no arrival could be admitted mid-run,
                    # so run unclipped to the natural decode horizon
                    d0 = len(s.done)
                    eng.stream_step(stop=None)
                    if t is not None and not s.now < t - _EPS:
                        dn = len(s.done) - d0
                        if dn and not eng._last_phase_start < t - _EPS:
                            # the serial loop would have stopped before
                            # the final step: hold these completions
                            # until its start falls behind the clock
                            pend_n[i] = dn
                            pend_pen[i] = eng._last_phase_start
                else:
                    eng.stream_step(stop=HorizonStop(t, mode="clock"))
            busy[i] = eng.stream_can_step()
            clock[i] = s.now
            vload[i] = eng.stream_load + pend_n[i]
            if not busy[i]:
                iclock[i] = s.now
                if geo:
                    w_open[i] = s.now

        def accrue(t: float) -> None:
            """Bring workless active replicas up to ``t`` on idle (or
            gated) power — the vectorized twin of the serial loop's
            per-arrival ``stream_idle`` pass."""
            mask = (~busy) & (iclock < t)
            if scaler is not None:
                mask &= life == _ACTIVE
            if not mask.any():
                return
            if all_pure:
                gap = t - iclock[mask]
                e = gap * p_nb[mask]
                if gate:
                    gated_e[mask] += e
                    gated_t[mask] += gap
                else:
                    idle_e[mask] += e
                    idle_t[mask] += gap
                if trace is not None:
                    for i in np.nonzero(mask)[0]:
                        trace.record(i, nb_state, float(iclock[i]), t,
                                     (t - float(iclock[i])) * p_nb[i])
            else:
                for i in np.nonzero(mask)[0]:
                    gap = t - float(iclock[i])
                    e = gap * p_nb[i] if pure[i] else \
                        replicas[i].backend.idle(gap, nb_state).energy_j
                    if gate:
                        gated_e[i] += e
                        gated_t[i] += gap
                    else:
                        idle_e[i] += e
                        idle_t[i] += gap
                    if trace is not None:
                        trace.record(i, nb_state, float(iclock[i]), t, e)
            if gate:
                gatedf[mask] = True
            iclock[mask] = t

        # --- routing --------------------------------------------------
        router = self.router
        rr_next = 0                     # autoscaled round-robin cursor
        HUGE = np.iinfo(np.int64).max
        sig_t = -np.inf                 # per-instant signal-row memo:
        sig_vals = None                 # burst members share one lookup
        is_signal = isinstance(router, _SignalAwareRouter)
        reads = getattr(router, "reads", "state")
        # same-instant (load, index) min-heap: members of one burst
        # route in O(log R) pops instead of one vload scan each —
        # identical picks, since ties break on the lower index in both
        lheap: Optional[list] = None

        def select(req: Request, t: float) -> int:
            nonlocal sig_t, sig_vals, rr_next, lheap
            routable = life == _ACTIVE if scaler is not None else None
            if is_signal:
                if t != sig_t:
                    sig_vals = np.array(
                        [router.signal_value(r, t)
                         for r in range(len(self.regions))])[reg_of]
                    sig_t = t
                vals = sig_vals
                ok = routable if routable is not None \
                    else np.ones(R, dtype=bool)
                free = ok & (vload < maxb)
                pool = free if free.any() else ok
                m = pool & (vals == vals[pool].min())
                m &= vload == vload[m].min()
                return int(np.argmax(m))
            if reads == "load":
                if routable is None:
                    if lheap is None:
                        lheap = [(int(vload[k]), k) for k in range(R)]
                        heapq.heapify(lheap)
                    load, k = lheap[0]
                    heapq.heapreplace(lheap, (load + 1, k))
                    return k
                return int(np.where(routable, vload, HUGE).argmin())
            if routable is None:
                return router.select(req, replicas, t)
            idx = np.nonzero(routable)[0]
            if reads == "none":
                i = int(idx[rr_next % len(idx)])
                rr_next += 1
                return i
            sub = [replicas[j] for j in idx]
            return int(idx[router.select(req, sub, t)])

        # --- the shared arrival loop ----------------------------------
        t_prev = -np.inf
        for n_seen, req in enumerate(reqs):
            t = req.effective_arrival
            if t != t_prev:
                # same-instant burst members skip straight to routing:
                # every replica already sits at (or beyond) t
                behind = busy & (clock < t - _EPS)
                for i in np.nonzero(behind)[0]:
                    advance(i, t)
                vis = (pend_n > 0) & (pend_pen < t - _EPS)
                if vis.any():
                    for i in np.nonzero(vis)[0]:
                        pend_n[i] = 0
                        vload[i] = replicas[i].stream_load
                if scaler is not None:
                    activate_warm(t)
                accrue(t)
                if scaler is not None:
                    if hook is not None:
                        hook._n_arr_hint = n_seen
                    decide(t)
                t_prev = t
                lheap = None            # loads moved: rebuild on demand
            i = select(req, t)
            eng = replicas[i]
            if gatedf[i]:
                # waking a gated replica: clock ramp at idle power
                if geo:
                    close_window(i, float(iclock[i]))
                until = float(iclock[i]) + eng.device.wake_latency_s
                gap = until - float(iclock[i])
                e = gap * p_idle[i] if pure[i] else \
                    eng.backend.idle(gap, "idle").energy_j
                idle_e[i] += e
                idle_t[i] += gap
                if trace is not None:
                    trace.record(i, "idle", float(iclock[i]), until, e)
                if geo:
                    bill_span(i, float(iclock[i]), until,
                              float(p_idle[i]))
                    w_open[i] = until
                iclock[i] = until
                gatedf[i] = False
            if not busy[i]:
                close_window(i, float(iclock[i]))
                eng._stream.now = float(iclock[i])
                eng.stream_submit(req)
                # only a workless replica can change state on a submit —
                # a busy one stays busy (head, slots and pages are all
                # untouched), so the re-check is skipped there
                busy[i] = eng.stream_can_step()
                clock[i] = eng._stream.now
            else:
                eng.stream_submit(req)
            vload[i] += 1

        # --- drain: run every busy replica to completion --------------
        for i in np.nonzero(busy)[0]:
            advance(i, None)
        stuck = [i for i, eng in enumerate(replicas)
                 if eng.stream_stuck()]
        if stuck:
            raise RuntimeError(
                f"deadlock: replicas {stuck} hold waiting requests that "
                "can never be scheduled (KV pool too small)")

        # --- align to the fleet wall clock ----------------------------
        if scaler is not None:
            # still-warming replicas finish their spin-up; their idle
            # tail to the fleet clock accrues like any active replica
            activate_warm(float(np.inf))
        alive = life == _ACTIVE
        t_end = float(iclock[alive].max()) if alive.any() else 0.0
        if (life == _OFF).any():
            t_end = max(t_end, float(avail_at[life == _OFF].max()))
        accrue(t_end)
        for i in np.nonzero(alive)[0]:
            close_window(i, float(iclock[i]))

        # --- flush arrays into the per-replica streams ----------------
        total_gco2 = None
        total_usd = None
        if geo:
            egress_usd = self._bill_requests(carbon_g, usd, reg_of)
            total_gco2 = float(carbon_g.sum())
            total_usd = float(usd.sum()) + egress_usd
        for i, eng in enumerate(replicas):
            s = eng._stream
            s.idle_e = float(idle_e[i])
            s.idle_t = float(idle_t[i])
            s.gated_e = float(gated_e[i])
            s.gated_t = float(gated_t[i])
            s.trans_e = float(trans_e[i])
            s.trans_t = float(trans_t[i])
            s.now = t_end if life[i] == _ACTIVE else float(iclock[i])
        reports = [eng.stream_report() for eng in replicas]
        if hook is not None:
            reports[0].control = hook.summary(t_end)
        return FleetReport(
            replica_reports=reports, policy=self.router.name,
            wall_time_s=t_end, shed=shed,
            transition_energy_j=float(trans_e.sum()),
            transition_time_s=float(trans_t.sum()),
            n_transitions=n_transitions,
            region_names=[r.name for r in self.regions],
            region_of=list(self.region_of),
            rtt_s_of=[self.regions[j].rtt_s if self.regions else 0.0
                      for j in self.region_of],
            gco2_total_g=total_gco2, usd_total=total_usd,
            egress_usd_total=float(egress_usd))

    # ------------------------------------------------------------------
    def _bill_requests(self, carbon_g: np.ndarray, usd: np.ndarray,
                       reg_of: np.ndarray) -> float:
        """Attribute busy-phase carbon/price per request: a request's
        attributed energy is spread uniformly over its service window
        [prefill start, done] and billed at the region signal's exact
        mean over that window (vectorized per replica). Egress bills
        the generated tokens at the region's $/GB (a deliberate
        simplification: response bytes only, one client hop). Returns
        the fleet-wide egress $."""
        egress = 0.0
        for i, eng in enumerate(self.replicas):
            region = self.regions[reg_of[i]]
            rs = [r for r in eng._stream.submitted if r.t_done >= 0.0]
            if not rs:
                continue
            e_kwh = np.array([r.energy_j for r in rs]) / _J_PER_KWH
            t0 = np.array([max(r.t_prefill_start, 0.0) for r in rs])
            t1 = np.array([r.t_done for r in rs])
            carbon_g[i] += float(
                (e_kwh * region.carbon.mean(t0, t1)).sum())
            usd[i] += float((e_kwh * region.price.mean(t0, t1)).sum())
            if region.egress_usd_per_gb:
                out_gb = sum(r.tokens_generated for r in rs) \
                    * _BYTES_PER_TOKEN / 1e9
                egress += region.egress_usd_per_gb * out_gb
        return egress


def make_fleet(cfg, n_replicas: int, *, policy: str = "round_robin",
               fmt: str = "bfloat16", max_batch: int = 32,
               autoscaler: Optional[Autoscaler] = None,
               regions: Optional[Sequence] = None,
               **engine_kw) -> FleetEngine:
    """Homogeneous vectorized-fleet convenience constructor (the
    :func:`~repro_torch.serving.cluster.make_cluster` twin)."""
    from repro_torch.batching.policy import SlotCountPolicy
    if n_replicas > 1 and "batch_policy" in engine_kw:
        raise ValueError(
            "batch_policy= would be shared across replicas; build the "
            "replica list explicitly or use ExperimentSpec(batch_policy=)")
    replicas = []
    for _ in range(n_replicas):
        kw = dict(engine_kw)
        if "batch_policy" not in kw:
            kw["batch_policy"] = SlotCountPolicy(max_batch=max_batch)
        replicas.append(ServeEngine(cfg, fmt=fmt, mode="continuous",
                                    **kw))
    return FleetEngine(replicas, make_router(policy),
                       autoscaler=autoscaler, regions=regions)
