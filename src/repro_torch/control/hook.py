"""Engine-side wiring for closed-loop control.
The port's own copy of ``repro.control.hook``.

A :class:`ControlHook` owns everything one controlled run needs:

* the controller and its firing grid (boundaries at ``k * interval_s``
  on the simulation clock; the engine's event loop stops decode
  macro-steps at each boundary via the ``control`` HorizonStop rule,
  so macro-stepped and single-stepped controlled runs fire at
  bit-identical instants);
* the live :class:`~repro_torch.control.view.AdmissionBucket` the engine
  consults before admitting each request;
* the action log, the time-weighted frequency timeline, and the host
  wall-clock spent inside ``controller.act`` — the run telemetry
  surfaced as ``RunResult.n_control_actions`` / ``mean_freq_scale`` /
  ``controller_overhead_s`` / ``control_actions``. The overhead is
  *host* time (``time.perf_counter``), the one documented
  non-deterministic field on an otherwise byte-reproducible result.

The simulation clock only ever moves at phase boundaries, so firing
"at" a grid instant means firing at the end of the first phase that
crosses it — the same semantics a wall-clock timer thread polling a
real serving engine would observe.
"""
from __future__ import annotations

import math
import time
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.control.controllers import Controller, PlannerContext
from repro_torch.control.view import (_UNSET, AdmissionBucket, ControlView,
                                ReplicaObs)
from repro_torch.fleet.autoscale import Autoscaler, FleetView
from repro_torch.serving import slo as _slo

_EPS = 1e-12


class ControlHook:
    """One controller's run-scoped state and engine adapter."""

    def __init__(self, controller: Controller,
                 interval_s: float = 1.0):
        if not isinstance(controller, Controller):
            raise TypeError("controller must be a repro_torch.control."
                            f"Controller, got {type(controller).__name__}")
        if interval_s <= 0:
            raise ValueError("control_interval_s must be positive")
        self.controller = controller
        self.dt = float(interval_s)
        self.bucket = AdmissionBucket()
        self.actions: List[Dict] = []
        self.overhead_s = 0.0
        self.replica_target: Optional[int] = None
        self._engines: List[Tuple[int, object]] = []
        self._freq_timeline: List[Tuple[float, float]] = []
        self._lam = 0.0
        self._have_lam = False
        self._lam_ema = 0.5
        self._n_prev = 0
        self._t_prev = 0.0
        self._t_next = 0.0
        self._can_admit = True
        self._can_scale = False
        self._can_freq = True
        self._min_r = 1
        self._max_r = 1
        self._n_active = 1
        self._signals = None        # fleet (replica, t) -> (gCO2, $)
        self._n_arr_hint = 0        # fleet loop's delivered-arrival count

    # -- lifecycle ------------------------------------------------------
    def attach(self, engines: Sequence[Tuple[int, object]],
               pending: Sequence, *, t0: float = 0.0,
               can_admit: bool = True, can_scale: bool = False,
               min_replicas: int = 1, max_replicas: int = 1,
               n_active: Optional[int] = None,
               signals=None, fire: bool = True) -> None:
        """Bind the hook to ``(replica, ServeEngine)`` pairs, prepare
        the controller from the plant's static context, and (by
        default) fire the initial action at ``t0``."""
        self._engines = list(engines)
        if not self._engines:
            raise ValueError("a controlled run needs >= 1 engine")
        self._can_admit = can_admit
        self._can_scale = can_scale
        self._can_freq = all(
            hasattr(eng.backend, "set_freq_scale")
            for _, eng in self._engines)
        self._min_r = int(min_replicas)
        self._max_r = int(max_replicas)
        self._n_active = (len(self._engines) if n_active is None
                          else int(n_active))
        self._signals = signals
        self.bucket.t_last = t0
        self._t_prev = t0
        self._t_next = t0
        eng = self._engines[0][1]
        prompts = [r.prompt_len for r in pending]
        outs = [r.max_new_tokens for r in pending]
        self.controller.prepare(PlannerContext(
            cfg=eng.cfg, device=eng.device, policy=eng.policy,
            n_chips=eng.n_chips, max_batch=eng.max_batch,
            stack=eng.stack,
            mean_prompt=(sum(prompts) / len(prompts)
                         if prompts else 1024.0),
            mean_output=(sum(outs) / len(outs) if outs else 128.0)))
        if fire:
            self.fire(t0, n_arrived=0)

    # -- admission actuator surface (engine event loops) ---------------
    @property
    def next_boundary(self) -> float:
        return self._t_next

    def release_time(self, arrival: float) -> float:
        return self.bucket.release_time(arrival)

    def take(self, t: float) -> None:
        self.bucket.take(t)

    # -- firing ---------------------------------------------------------
    def maybe_fire(self, now: float, n_arrived: int,
                   held: int = 0) -> None:
        """Fire iff the clock has crossed the next grid boundary."""
        if now < self._t_next - _EPS:
            return
        self.fire(now, n_arrived, held)

    def fire(self, now: float, n_arrived: int, held: int = 0,
             n_active: Optional[int] = None) -> None:
        if n_active is not None:
            self._n_active = int(n_active)
        elapsed = now - self._t_prev
        if elapsed > _EPS:
            inst = max(n_arrived - self._n_prev, 0) / elapsed
            self._lam = (inst if not self._have_lam
                         else self._lam_ema * inst
                         + (1.0 - self._lam_ema) * self._lam)
            self._have_lam = True
            self._n_prev = n_arrived
            self._t_prev = now
        view = ControlView(
            now, [self._obs(r, eng, held if i == 0 else 0, now)
                  for i, (r, eng) in enumerate(self._engines)],
            interval_s=self.dt, arrival_rate_per_s=self._lam,
            admission_rate=self.bucket.rate, n_active=self._n_active,
            min_replicas=self._min_r, max_replicas=self._max_r,
            can_freq=self._can_freq, can_admit=self._can_admit,
            can_scale=self._can_scale)
        t_host = time.perf_counter()
        try:
            self.controller.act(view)
        finally:
            self.overhead_s += time.perf_counter() - t_host
        self._apply(view, now)
        self._freq_timeline.append((now, self._mean_freq()))
        # next grid boundary strictly after ``now``
        self._t_next = (math.floor((now + _EPS) / self.dt) + 1) * self.dt

    def _mean_freq(self) -> float:
        return (sum(getattr(eng, "freq_scale", 1.0)
                    for _, eng in self._engines)
                / len(self._engines))

    def _obs(self, replica: int, eng, held: int,
             now: float) -> ReplicaObs:
        s = eng._stream
        carbon = price = float("nan")
        if self._signals is not None:
            sig = self._signals(replica, now)
            if sig is not None:
                carbon, price = sig
        if s is None:       # replica not yet streaming (warming/off)
            return ReplicaObs(
                replica=replica,
                freq_scale=getattr(eng, "freq_scale", 1.0),
                queue_depth=held, tokens_in_flight=0.0, live=0,
                max_batch=eng.max_batch,
                energy_wh_per_request=float("nan"),
                slo_attainment=float("nan"),
                carbon_gco2_per_kwh=carbon, price_usd_per_kwh=price)
        n_done = len(s.done)
        total_e = s.busy_e + s.idle_e + s.gated_e + s.trans_e
        return ReplicaObs(
            replica=replica,
            freq_scale=getattr(eng, "freq_scale", 1.0),
            queue_depth=eng.batcher.n_waiting + held,
            tokens_in_flight=eng.stream_outstanding_work(),
            live=eng.batcher.n_live,
            max_batch=eng.max_batch,
            energy_wh_per_request=(total_e / 3600.0 / n_done
                                   if n_done else float("nan")),
            slo_attainment=(_slo.attainment(s.done, [])
                            if n_done else float("nan")),
            carbon_gco2_per_kwh=carbon, price_usd_per_kwh=price)

    def _apply(self, view: ControlView, now: float) -> None:
        freq_targets, adm, rep_target = view.staged()
        changed = False
        freq_global = freq_targets.get(None)
        if freq_targets:
            for ridx, eng in self._engines:
                tgt = freq_targets.get(ridx, freq_global)
                if tgt is None:
                    continue
                if getattr(eng, "freq_scale", 1.0) != tgt:
                    eng.set_freq_scale(tgt)
                    changed = True
        if adm is not _UNSET:
            rate, burst = adm
            if (rate != self.bucket.rate
                    or (burst is not None
                        and float(burst) != self.bucket.burst)):
                self.bucket.set_rate(rate, now, burst=burst)
                changed = True
        if rep_target is not None:
            if rep_target != self._n_active:
                changed = True
            self.replica_target = rep_target
        if changed:
            self.actions.append({
                "t": now,
                "freq_scale": self._mean_freq(),
                "admission_rate": self.bucket.rate,
                "n_replicas": self.replica_target})
            for ridx, eng in self._engines:
                tr = getattr(eng, "_trace", None)
                if tr is not None:
                    tr.record_action(ridx, now,
                                     getattr(eng, "freq_scale", 1.0))

    # -- run telemetry --------------------------------------------------
    @property
    def n_actions(self) -> int:
        return len(self.actions)

    def summary(self, t_end: float) -> Dict:
        """The omit-when-None RunResult telemetry block."""
        tl = self._freq_timeline
        if not tl:
            mean_f = 1.0
        else:
            area = 0.0
            span = 0.0
            for (t0, f), (t1, _) in zip(tl, tl[1:]):
                area += f * (t1 - t0)
                span += t1 - t0
            tail = max(t_end - tl[-1][0], 0.0)
            area += tl[-1][1] * tail
            span += tail
            mean_f = area / span if span > 0 else tl[-1][1]
        return {"n_control_actions": self.n_actions,
                "mean_freq_scale": mean_f,
                "controller_overhead_s": self.overhead_s,
                "control_actions": [dict(a) for a in self.actions]}


class ControllerAutoscaler(Autoscaler):
    """Adapter that runs a :class:`ControlHook` through the fleet
    engine's existing autoscaler lifecycle.

    The fleet loop consults it at arrival instants (rate-limited by
    ``check_interval_s``, which defaults to the control interval);
    :meth:`desired` fires the controller — whose freq targets apply to
    the replicas immediately — and returns the staged replica target,
    so every controller-triggered spin-up and drain goes through
    ``bill_transition`` and is billed to the joule. ``initial_replicas``
    surfaces a target staged by the controller's t=0 firing, letting
    e.g. ``StaticController(n_replicas=4)`` size the fleet at start."""

    name = "controller"

    def __init__(self, hook: ControlHook, *, min_replicas: int = 1,
                 max_replicas: Optional[int] = None,
                 check_interval_s: Optional[float] = None):
        super().__init__(min_replicas=min_replicas,
                         max_replicas=max_replicas,
                         check_interval_s=(check_interval_s
                                           if check_interval_s is not None
                                           else hook.dt))
        self.hook = hook

    @property
    def initial_replicas(self) -> Optional[int]:
        return self.hook.replica_target

    def desired(self, view: FleetView) -> int:
        self.hook.fire(view.t, self.hook._n_arr_hint,
                       n_active=view.n_active)
        tgt = self.hook.replica_target
        return tgt if tgt is not None else view.n_active
