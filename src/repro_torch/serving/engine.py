"""Serving engine: sequential (transformers-style) and continuous
(TGI-style) event loops over a pluggable
:class:`~repro_torch.serving.backend.InferenceBackend`.

Counterpart of ``repro.serving.engine``. The engine is a discrete-event
simulator whose scheduling (arrival schedules, schedulers, batch
policies, the KV page pool, idle gaps) is real, while each phase's cost
comes from the backend:

* :class:`~repro_torch.serving.backend.AnalyticBackend`: the paper's
  phase-aware analytic energy model (the default; the clock advances by
  the model's latency);
* :class:`~repro_torch.serving.backend.ExecutedBackend`: the same
  costing plus the real model steps on the device (``execute=True``),
  so the scheduler's decisions drive real computation;
* :class:`~repro_torch.serving.backend.ReplayBackend`: recorded phase
  measurements replayed through the live scheduler.

Energy accounting (paper §5 methodology): every phase's energy is
shared equally among the requests in that batch; gaps where the device
waits for arrivals accrue idle energy at ``DeviceSpec.idle_power``
(or, for a gap a scheduler planned, gated power until the wake ramp);
``mean energy per request`` uses total energy (busy + idle + gated) /
n_requests, so arrival shaping shows its full effect.

Decode runs macro-step to the next event horizon (a completion, KV-page
exhaustion or the next release), folding the per-step additions in the
single-step loop's order (:func:`_fold`), so a report equals its
``macro_step=False`` twin, and the reference's, float for float.
``run`` also takes the reference's workflow source (``source=``),
closed-loop controller (``controller=``) and fault schedule with its
retry policy (``faults=``, ``retry=``); ``pool=`` names a replica's role
in a disaggregated :class:`~repro_torch.serving.cluster.ClusterEngine`.
An executed replica is refused in a disaggregated pool: the decode pool
would need the prefill pool's KV cache and first token, which no
backend hands over (ROADMAP C6).
"""
from __future__ import annotations

import dataclasses
import math
from bisect import bisect_right as _bisect_right
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.batching.continuous import ContinuousBatcher
from repro_torch.batching.policy import BatchPolicy, SlotCountPolicy
from repro_torch.configs.base import ModelConfig
from repro_torch.core.energy import EnergyModel
from repro_torch.core.hardware import H100_SXM, DeviceSpec
from repro_torch.core.precision import PrecisionPolicy, make_policy
from repro_torch.serving import slo
from repro_torch.serving.backend import (AnalyticBackend, DecodeBatch,
                                         ExecutedBackend, InferenceBackend,
                                         PrefillBatch)
from repro_torch.serving.requests import Request, RequestStatus
from repro_torch.serving.scheduler import (HorizonStop, Scheduler,
                                           apply_schedule)
from repro_torch.serving.trace import PowerTrace

#: why an executed replica cannot serve a disaggregated pool (ROADMAP C6)
C6 = ("an executed replica cannot serve a disaggregated pool: the decode "
      "pool never receives the prefill pool's KV cache or first token "
      "(no KV handoff between backends; ROADMAP C6), so its tokens would "
      "not be the request's own")


def _fold(init: float, values: np.ndarray) -> float:
    """Strict left fold ``((init + v0) + v1) + ...`` — the same float
    additions a per-step ``+=`` loop performs, so macro-step
    accumulators stay bit-identical to single-stepping. Vectorized via
    the (sequential) ``np.add.accumulate`` once the run is long enough
    to amortize the array setup."""
    k = len(values)
    if k == 0:
        return init
    if k < 64:
        out = init
        for v in values:
            out += v
        return float(out)
    buf = np.empty(k + 1)
    buf[0] = init
    buf[1:] = values
    return float(np.add.accumulate(buf)[-1])


def _fold_many(inits: np.ndarray, values: np.ndarray) -> np.ndarray:
    """Row-wise :func:`_fold`: every row starts from its own ``inits``
    entry and folds the same ``values`` sequence (per-request energy
    attribution across one macro-step)."""
    buf = np.empty((len(inits), len(values) + 1))
    buf[:, 0] = inits
    buf[:, 1:] = values
    return np.add.accumulate(buf, axis=1)[:, -1]


def _insert_pending(pending: List[Request], head: int,
                    req: Request) -> None:
    """Insert a released workflow request into the still-unconsumed
    suffix ``pending[head:]``, keeping it sorted by effective arrival
    (ties go after existing entries: FIFO in release order)."""
    t = req.effective_arrival
    lo, hi = head, len(pending)
    while lo < hi:
        mid = (lo + hi) // 2
        if pending[mid].effective_arrival <= t:
            lo = mid + 1
        else:
            hi = mid
    pending.insert(lo, req)


def _remove_identity(lst: List[Request], req: Request) -> bool:
    """Remove ``req`` from ``lst`` by object identity (Request's
    dataclass ``==`` would compare ndarray prompts)."""
    for i in range(len(lst) - 1, -1, -1):
        if lst[i] is req:
            del lst[i]
            return True
    return False


@dataclasses.dataclass
class ServeReport:
    """The reference's ``ServeReport``: energy, time and latency
    aggregates of one run."""

    requests: List[Request]
    total_energy_j: float          # busy + idle (+ gated)
    busy_energy_j: float
    idle_energy_j: float
    wall_time_s: float             # the analytic clock at the end
    busy_time_s: float
    mean_batch: float              # time-weighted live batch during decode
    n_prefill_batches: int = 0
    n_decode_steps: int = 0
    gated_energy_j: float = 0.0
    gated_time_s: float = 0.0
    idle_time_s: float = 0.0
    transition_energy_j: float = 0.0
    transition_time_s: float = 0.0
    shed: List[Request] = dataclasses.field(default_factory=list)
    prefill_computed_tokens: int = 0
    prefill_effective_tokens: int = 0
    prefill_chunks: int = 0
    n_relayed: int = 0
    prefix_reused_tokens: int = 0
    tasks: List = dataclasses.field(default_factory=list)
    control: Optional[Dict] = None
    n_failures: int = 0
    n_retries: int = 0
    wasted_energy_j: float = 0.0
    down_time_s: float = 0.0

    @property
    def prefill_padding_fraction(self) -> float:
        """Fraction of computed prefill tokens that were padding."""
        if self.prefill_computed_tokens == 0:
            return 0.0
        return 1.0 - (self.prefill_effective_tokens
                      / self.prefill_computed_tokens)

    @property
    def n(self) -> int:
        return len(self.requests)

    @property
    def n_shed(self) -> int:
        return len(self.shed)

    @property
    def n_failed(self) -> int:
        return sum(1 for r in self.requests
                   if r.status is RequestStatus.FAILED)

    @property
    def n_completed(self) -> int:
        return len(self.completed)

    @property
    def availability(self) -> float:
        if self.wall_time_s <= 0:
            return 1.0
        return 1.0 - self.down_time_s / self.wall_time_s

    @property
    def goodput_wh_per_request(self) -> float:
        """Total energy per completed request (``inf`` when energy was
        burned but nothing completed)."""
        n_done = len(self.completed)
        if n_done == 0:
            return math.inf if self.total_energy_j > 0 else 0.0
        return self.total_energy_j / n_done / 3600.0

    @property
    def completed(self) -> List[Request]:
        return slo.completed(self.requests)

    @property
    def utilization(self) -> float:
        return self.busy_time_s / max(self.wall_time_s, 1e-12)

    @property
    def mean_energy_per_request_wh(self) -> float:
        if self.n == 0:
            return 0.0
        return self.total_energy_j / self.n / 3600.0

    @property
    def mean_attributed_energy_wh(self) -> float:
        if not self.requests:
            return 0.0
        return float(np.mean([r.energy_j for r in self.requests])) / 3600.0

    @property
    def mean_latency_s(self) -> float:
        done = self.completed
        if not done:
            return 0.0
        return float(np.mean([r.latency for r in done]))

    @property
    def mean_ttft_s(self) -> float:
        done = self.completed
        if not done:
            return 0.0
        return float(np.mean([r.ttft for r in done]))

    @property
    def tokens_per_s(self) -> float:
        toks = sum(r.tokens_generated for r in self.completed)
        return toks / max(self.wall_time_s, 1e-12)

    @property
    def mean_energy_per_token_wh(self) -> float:
        """Total energy per generated token of the completed requests."""
        toks = sum(r.tokens_generated for r in self.completed)
        if toks == 0:
            return 0.0
        return self.total_energy_j / 3600.0 / toks

    def latency_percentiles(self, qs: Sequence[float] = (50, 90, 99)
                            ) -> Dict[str, float]:
        return slo.percentiles(self.requests, field="latency", qs=qs)

    def ttft_percentiles(self, qs: Sequence[float] = (50, 90, 99)
                         ) -> Dict[str, float]:
        return slo.percentiles(self.requests, field="ttft", qs=qs)

    @property
    def slo_attainment(self) -> float:
        return slo.attainment(self.requests, self.shed)

    def summary(self) -> Dict[str, float]:
        out = {
            "n_requests": self.n,
            "n_shed": self.n_shed,
            "mean_energy_wh": self.mean_energy_per_request_wh,
            "mean_attributed_wh": self.mean_attributed_energy_wh,
            "mean_latency_s": self.mean_latency_s,
            "mean_ttft_s": self.mean_ttft_s,
            "latency_p99_s": self.latency_percentiles()["p99"],
            "tokens_per_s": self.tokens_per_s,
            "mean_batch": self.mean_batch,
            "slo_attainment": self.slo_attainment,
            "idle_fraction": (self.idle_energy_j
                              / max(self.total_energy_j, 1e-12)),
            "gated_fraction": (self.gated_energy_j
                               / max(self.total_energy_j, 1e-12)),
        }
        if (self.n_failures or self.n_retries or self.wasted_energy_j
                or self.down_time_s):
            out.update({
                "n_failures": self.n_failures,
                "n_retries": self.n_retries,
                "n_failed": self.n_failed,
                "wasted_energy_wh": self.wasted_energy_j / 3600.0,
                "availability": self.availability,
                "goodput_wh_per_request": self.goodput_wh_per_request,
            })
        return out


@dataclasses.dataclass
class _StreamState:
    """Mutable per-run accounting for one continuous-mode stream.

    ``run()`` drives the engine through this state via the ``stream_*``
    primitives, so one replica can be advanced phase by phase against an
    external (shared) arrival clock: the single-engine ``run()`` and the
    cluster co-simulation both drive it.
    """

    now: float = 0.0
    busy_e: float = 0.0
    idle_e: float = 0.0
    gated_e: float = 0.0
    busy_t: float = 0.0
    idle_t: float = 0.0
    gated_t: float = 0.0
    trans_e: float = 0.0           # autoscaler spin-up/drain energy
    trans_t: float = 0.0
    batch_time: float = 0.0        # integral of live batch over decode time
    decode_time: float = 0.0
    n_prefills: int = 0
    n_decode: int = 0
    submitted: List[Request] = dataclasses.field(default_factory=list)
    done: List[Request] = dataclasses.field(default_factory=list)
    # batch-formation telemetry
    prefill_computed: int = 0      # padded prefill tokens computed
    prefill_effective: int = 0     # prompt tokens that needed computing
    prefill_chunks: int = 0
    n_relayed: int = 0
    prefix_reused: int = 0         # prompt tokens served from forked KV
    # fault injection (repro_torch.faults)
    wasted_e: float = 0.0          # joules billed to failed attempts
    down_t: float = 0.0            # wall-clock dead (zero power draw)
    n_failures: int = 0
    n_retries: int = 0
    # disaggregated serving: prefill-complete requests awaiting pickup
    # by the cluster loop (stream_take_handoffs drains this)
    handoffs: List[Request] = dataclasses.field(default_factory=list)


class ServeEngine:
    """Backend-agnostic serving event loop: the reference's constructor.

    ``cfg`` is the config the phases are priced for. With no
    ``backend`` the engine builds an
    :class:`~repro_torch.serving.backend.AnalyticBackend` from ``fmt``
    (bfloat16 by default), ``device``, ``n_chips`` and
    ``energy_model_cls``, or with ``execute=True`` an
    :class:`~repro_torch.serving.backend.ExecutedBackend` that runs
    ``model`` (on ``model.device``) with ``params`` and a decode cache
    of ``buf_len`` slots a lane, priced for ``cfg`` under the model's
    format (a ``fmt`` of another format is refused). Pass an
    ``ExecutedBackend`` as ``backend=`` to keep first-token logits
    (``record_logits``).

    Batch formation is owned by a
    :class:`~repro_torch.batching.policy.BatchPolicy` (``batch_policy=``,
    :class:`~repro_torch.batching.policy.SlotCountPolicy` by default),
    over a KV page pool of ``kv_pages`` pages of ``page_size`` tokens.

    ``pool`` names this engine's role in a disaggregated cluster:
    ``"mixed"`` (default) serves both phases; ``"prefill"`` relays each
    request to ``stream_take_handoffs()`` the moment its prompt is
    prefilled; ``"decode"`` adopts handed-off requests (prefill already
    billed elsewhere) and decodes them to completion. Both run on
    analytic or replayed backends only (ROADMAP C6).
    """

    def __init__(self, cfg: ModelConfig, *, fmt: Optional[str] = None,
                 device: DeviceSpec = H100_SXM, n_chips: int = 1,
                 mode: str = "continuous",
                 batch_policy: Optional[BatchPolicy] = None,
                 pool: str = "mixed",
                 kv_pages: int = 1 << 15, page_size: int = 128,
                 energy_model_cls=EnergyModel,
                 execute: bool = False, model=None, params=None,
                 buf_len: int = 256,
                 backend: Optional[InferenceBackend] = None,
                 macro_step: bool = True):
        if mode not in ("continuous", "sequential"):
            raise ValueError(mode)
        if pool not in ("mixed", "prefill", "decode"):
            raise ValueError(f"unknown pool {pool!r}; "
                             "known: ['mixed', 'prefill', 'decode']")
        if pool != "mixed" and mode != "continuous":
            raise ValueError("disaggregated pools require "
                             "mode='continuous'")
        if pool != "mixed" and (execute
                                or isinstance(backend, ExecutedBackend)):
            raise ValueError(f"pool={pool!r}: {C6}")
        # event-horizon macro-stepping (equal to single-stepping float
        # for float; macro_step=False forces the per-token loop)
        self.macro_step = macro_step
        self.cfg = cfg
        self.n_chips = n_chips
        self.mode = mode
        self.pool = pool
        self.stack = "fused" if mode == "continuous" else "eager"
        if batch_policy is not None:
            if (mode == "sequential"
                    and batch_policy.name != SlotCountPolicy.name):
                raise ValueError("mode='sequential' ignores batch "
                                 "formation; batch_policy= requires "
                                 "mode='continuous'")
        else:
            batch_policy = SlotCountPolicy()
        self.batch_policy = batch_policy
        self.max_batch = batch_policy.max_batch
        if (execute and backend is not None
                and not isinstance(backend, ExecutedBackend)):
            raise ValueError(
                "execute=True conflicts with an explicit non-executed "
                f"backend ({type(backend).__name__}); pass an "
                "ExecutedBackend or drop execute=")
        if backend is not None:
            # a backend that owns its cost identity wins over the engine
            # kwargs: refuse contradictions instead of silently billing
            # with something other than what the caller named
            bdev = getattr(backend, "device", None)
            if (bdev is not None and device is not H100_SXM
                    and bdev != device):
                raise ValueError(
                    f"device={device.name!r} conflicts with the "
                    f"backend's device {bdev.name!r}; configure the "
                    "backend instead")
            bpol = getattr(backend, "policy", None)
            if (bpol is not None and fmt is not None
                    and bpol.fmt != make_policy(fmt).fmt):
                raise ValueError(
                    f"fmt={fmt!r} conflicts with the backend's "
                    f"precision policy ({bpol.fmt!r}); configure the "
                    "backend instead")
        if backend is None:
            kw = dict(device=device, n_chips=n_chips,
                      energy_model_cls=energy_model_cls)
            if execute:
                backend = ExecutedBackend(cfg, model, params,
                                          max_batch=self.max_batch,
                                          buf_len=buf_len, fmt=fmt, **kw)
            else:
                backend = AnalyticBackend(
                    cfg, policy=make_policy(fmt or "bfloat16"), **kw)
        self.backend = backend
        self.policy: PrecisionPolicy = (getattr(backend, "policy", None)
                                        or make_policy(fmt or "bfloat16"))
        # the device whose power states govern gaps and gating, and the
        # analytic pricing model schedulers predict with: an
        # analytic-family backend owns both; a replay backend falls back
        # to the engine kwargs so prediction stays possible
        self.device = getattr(backend, "device", None) or device
        self.energy = getattr(backend, "energy", None) or \
            energy_model_cls(self.device, self.policy)
        self._batcher_kw = dict(kv_pages=kv_pages, page_size=page_size)
        self.batcher = ContinuousBatcher(policy=self.batch_policy,
                                         **self._batcher_kw)
        self._stream: Optional[_StreamState] = None
        # the DVFS operating point, threaded into trace segments
        self.freq_scale: float = getattr(self.device, "freq_scale", 1.0)
        # power-state telemetry: set per run by run(trace=...)
        self._trace: Optional[PowerTrace] = None
        self._trace_replica: int = 0

    # ------------------------------------------------------------------
    def set_freq_scale(self, target: float) -> None:
        """Re-target the DVFS operating point mid-run (the closed-loop
        control actuator). Delegates to the backend's actuator, then
        refreshes the engine-side device/pricing handles so gap pricing
        and router predictions follow the new clock."""
        actuate = getattr(self.backend, "set_freq_scale", None)
        if actuate is None:
            raise ValueError(
                f"{type(self.backend).__name__} exposes no DVFS "
                "actuator (set_freq_scale); closed-loop frequency "
                "control needs an analytic or replay backend")
        actuate(target)
        self.device = getattr(self.backend, "device", None) or self.device
        self.energy = getattr(self.backend, "energy", None) or self.energy
        self.freq_scale = float(target)

    # ------------------------------------------------------------------
    def run(self, requests: List[Request], *,
            scheduler: Optional[Scheduler] = None,
            trace: Optional[PowerTrace] = None,
            source: Optional["object"] = None,
            controller: Optional["object"] = None,
            control_interval_s: float = 1.0,
            faults: Optional["object"] = None,
            retry: Optional["object"] = None) -> ServeReport:
        """Serve a request list, optionally shaped/admitted by a
        :class:`~repro_torch.serving.scheduler.Scheduler` and recorded onto a
        :class:`~repro_torch.serving.trace.PowerTrace` timeline.

        ``source`` is a :class:`~repro_torch.workflows.WorkflowSource`: each
        completion is reported back to it and any dependent requests it
        releases join the arrival stream at their release times.

        ``controller`` is a :class:`~repro_torch.control.Controller`: it
        observes/plans/acts every ``control_interval_s`` of simulated
        time, actuating DVFS (``set_freq_scale``) and admission (a live
        token bucket gating releases into the batcher). With no
        controller the legacy event loop runs — no ``control`` stops
        are ever constructed, so results stay bit-identical.

        ``faults`` is a :class:`~repro_torch.faults.FaultSchedule` whose
        boundaries become horizon stops: crashes/preemptions fail
        in-flight work into ``RequestStatus.FAILED`` (joules move to
        ``wasted_energy_j``), slowdowns/power caps re-target DVFS for
        a window. ``retry`` (a :class:`~repro_torch.faults.RetryPolicy`)
        re-queues failures with exponential backoff until the budget
        is exhausted. With no schedule the fault path is never
        constructed and results stay bit-identical."""
        if faults is not None:
            if self.mode != "continuous":
                raise ValueError("faults= requires mode='continuous'")
            if controller is not None:
                raise ValueError("faults= cannot be combined with "
                                 "controller= (controlling a faulty "
                                 "replica is future work)")
            if self.pool != "mixed":
                raise ValueError("single-engine fault injection needs "
                                 "pool='mixed'; drive disaggregated "
                                 "faults through ClusterEngine")
            if faults.has_kind("link_degrade"):
                raise ValueError("link_degrade faults only apply to "
                                 "disaggregated cluster runs")
            if faults.max_replica > 0:
                raise ValueError(
                    f"fault schedule names replica "
                    f"{faults.max_replica} but this is a "
                    "single-replica run")
            if any(not math.isfinite(e.downtime_s)
                   for e in faults.events
                   if e.kind in ("crash", "preempt")):
                raise ValueError("single-replica fault injection "
                                 "needs finite downtime (nothing else "
                                 "can serve the retries)")
        if retry is not None and faults is None:
            raise ValueError("retry= without faults= has no effect; "
                             "attach a FaultSchedule")
        if controller is not None:
            if self.mode != "continuous":
                raise ValueError("controller= requires "
                                 "mode='continuous'")
            if source is not None:
                raise ValueError("controller= cannot be combined with "
                                 "a workflow source (control the "
                                 "workflow run's engine instead)")
        reqs, shed = apply_schedule(requests, scheduler)
        if source is not None:
            source.bind(sequential=(self.mode == "sequential"),
                        page_size=self.batcher.kv.page_size,
                        kv_get=lambda _i: self.batcher.kv)
            for r in shed:
                source.on_shed(r)
        self._trace = trace
        self._trace_replica = 0     # standalone run (cluster sets >0)
        plans_gaps = scheduler is not None and scheduler.plans_gaps
        try:
            if faults is not None:
                rep = self._run_faulty(reqs, faults, retry,
                                       plans_gaps=plans_gaps,
                                       source=source)
            elif controller is not None:
                from repro_torch.control.hook import ControlHook
                hook = ControlHook(controller, control_interval_s)
                rep = self._run_controlled(reqs, hook,
                                           plans_gaps=plans_gaps)
            elif self.mode == "sequential":
                rep = self._run_sequential(reqs, source=source)
            else:
                rep = self._run_continuous(reqs, plans_gaps=plans_gaps,
                                           source=source)
        finally:
            self._trace = None
        rep.shed = shed
        if source is not None:
            rep.tasks = source.task_reports()
        return rep

    def _record(self, state: str, t0: float, t1: float, energy_j: float,
                batch: float = 0.0) -> None:
        if self._trace is not None and t1 > t0:
            self._trace.record(self._trace_replica, state, t0, t1,
                               energy_j, batch,
                               freq_scale=self.freq_scale)

    # ------------------------------------------------------------------
    def _run_sequential(self, reqs: List[Request],
                        source: Optional[object] = None) -> ServeReport:
        self.backend.start()
        now, busy_e, idle_e, busy_t = 0.0, 0.0, 0.0, 0.0
        idle_t = 0.0
        pending = list(reqs)
        i = 0
        while i < len(pending):
            r = pending[i]
            i += 1
            if r.effective_arrival > now:
                gap = r.effective_arrival - now
                res = self.backend.idle(gap, "idle")
                idle_e += res.energy_j
                idle_t += gap
                self._record("idle", now, r.effective_arrival,
                             res.energy_j)
                now = r.effective_arrival
            r.t_prefill_start = now
            pre = self.backend.prefill(PrefillBatch(
                picks=[(None, r)], pad_len=r.prompt_len,
                stack=self.stack))
            now += pre.latency_s
            self._record("prefill", r.t_prefill_start, now,
                         pre.energy_j, 1.0)
            r.t_first_token = now
            r.prefilled_tokens = r.prompt_len
            r.tokens_generated = 1
            dec_steps = max(r.max_new_tokens - 1, 0)
            e = pre.energy_j
            if dec_steps:
                dec = self.backend.decode_tail(r, dec_steps,
                                               stack=self.stack)
                self._record("decode", now, now + dec.latency_s,
                             dec.energy_j, 1.0)
                now += dec.latency_s
                e += dec.energy_j
                r.tokens_generated += dec_steps
            busy_t += now - r.t_prefill_start
            r.energy_j = e
            busy_e += e
            r.t_done = now
            r.status = RequestStatus.DONE
            self.backend.finish_request(r)
            if source is not None:
                for child in source.on_finish(r, r.t_done):
                    _insert_pending(pending, i, child)
        return ServeReport(requests=pending,
                           total_energy_j=busy_e + idle_e,
                           busy_energy_j=busy_e, idle_energy_j=idle_e,
                           wall_time_s=now, busy_time_s=busy_t,
                           idle_time_s=idle_t,
                           mean_batch=1.0,
                           n_prefill_batches=len(pending),
                           n_decode_steps=sum(r.tokens_generated - 1
                                              for r in pending))

    # ------------------------------------------------------------------
    def _run_continuous(self, reqs: List[Request],
                        plans_gaps: bool = False,
                        source: Optional[object] = None) -> ServeReport:
        self.stream_start()
        s = self._stream
        pending = list(reqs)
        head = 0                        # head pointer, no pop(0) shifts
        seen = 0                        # done-list cursor (source drain)
        while len(s.done) < len(pending):
            n = len(pending)
            while (head < n and pending[head].effective_arrival
                    <= s.now + 1e-12):
                self.stream_submit(pending[head])
                head += 1
            if self.stream_can_step():
                # the next (shaped) release bounds the decode horizon
                stop = (HorizonStop(pending[head].effective_arrival,
                                    mode="admit")
                        if head < n else None)
                self.stream_step(stop=stop)
                if source is not None:
                    # report completions; released successors join the
                    # arrival stream at their release times. A step
                    # that terminated shed/failed aborts its whole
                    # task — successors must never be released.
                    done = s.done
                    while seen < len(done):
                        r = done[seen]
                        seen += 1
                        if r.status is RequestStatus.DONE:
                            for child in source.on_finish(r, r.t_done):
                                _insert_pending(pending, head, child)
                        elif r.status in (RequestStatus.SHED,
                                          RequestStatus.FAILED):
                            source.on_shed(r)
                continue
            if head < n:
                t_next = pending[head].effective_arrival
                gap = t_next - s.now
                wake = self.device.wake_latency_s
                if plans_gaps and gap > wake:
                    # the scheduler planned this gap, so the device can
                    # power-gate it and ramp back up (at idle power)
                    # just in time for the next release
                    self.stream_idle(t_next - wake, gated=True)
                self.stream_idle(t_next)
            else:   # waiting queue blocked on memory with nothing live
                if self.batcher.n_waiting:
                    raise RuntimeError("deadlock: waiting requests cannot "
                                       "be scheduled (KV pool too small)")
                break
        return self.stream_report()

    # ------------------------------------------------------------------
    def _run_controlled(self, reqs: List[Request], hook,
                        plans_gaps: bool = False) -> ServeReport:
        """Continuous event loop with a closed-loop controller.

        Identical to :meth:`_run_continuous` except that (a) each
        request's release is additionally gated by the hook's live
        admission bucket, (b) decode horizons stop at the next control
        boundary (``HorizonStop(mode="control")``), and (c) the hook
        fires at the end of the first phase crossing each boundary.
        All three are deterministic functions of the simulation clock,
        so macro-stepped and single-stepped controlled runs stay
        bit-identical."""
        self.stream_start()
        s = self._stream
        pending = list(reqs)
        hook.attach([(0, self)], pending)
        arrivals = [r.effective_arrival for r in pending]
        head = 0
        n = len(pending)
        while len(s.done) < n:
            while head < n:
                t_rel = hook.release_time(
                    pending[head].effective_arrival)
                if t_rel > s.now + 1e-12:
                    break
                hook.take(s.now)
                self.stream_submit(pending[head])
                head += 1
            t_c = hook.next_boundary
            if self.stream_can_step():
                stop = HorizonStop(t_c, mode="control")
                if head < n:
                    t_rel = hook.release_time(
                        pending[head].effective_arrival)
                    if t_rel <= t_c:
                        stop = HorizonStop(t_rel, mode="admit")
                self.stream_step(stop=stop)
            elif head < n:
                t_rel = hook.release_time(
                    pending[head].effective_arrival)
                t_to = min(t_rel, t_c)
                wake = self.device.wake_latency_s
                if (plans_gaps and t_rel <= t_c
                        and t_rel - s.now > wake):
                    self.stream_idle(t_rel - wake, gated=True)
                self.stream_idle(t_to)
            else:
                if self.batcher.n_waiting:
                    raise RuntimeError("deadlock: waiting requests "
                                       "cannot be scheduled (KV pool "
                                       "too small)")
                break
            n_arr = _bisect_right(arrivals, s.now + 1e-12)
            hook.maybe_fire(s.now, n_arr, held=n_arr - head)
        rep = self.stream_report()
        rep.control = hook.summary(rep.wall_time_s)
        return rep

    # ------------------------------------------------------------------
    def _run_faulty(self, reqs: List[Request], faults, retry,
                    plans_gaps: bool = False,
                    source: Optional[object] = None) -> ServeReport:
        """Continuous event loop under a fault schedule (single
        replica). Identical to :meth:`_run_continuous` between fault
        boundaries — each boundary is a horizon stop, so macro-stepped
        and single-stepped faulty runs stay bit-identical."""
        eps = 1e-12
        self.stream_start()
        s = self._stream
        pending = list(reqs)
        head = 0
        seen = 0
        n_total = len(reqs)             # grows only with source children
        tl = faults.boundaries(0)
        fi = 0
        base_freq = self.freq_scale
        drain = retry is not None and retry.drain_on_notice
        timeout = retry.timeout_s if retry is not None else math.inf
        draining_until: Optional[float] = None

        def drain_source() -> None:
            """Report every new terminal request to the workflow
            source: completions release successors into the arrival
            stream, shed/failed steps abort their whole task."""
            nonlocal seen, n_total
            if source is None:
                return
            done = s.done
            while seen < len(done):
                r = done[seen]
                seen += 1
                if r.status is RequestStatus.DONE:
                    for child in source.on_finish(r, r.t_done):
                        n_total += 1
                        _insert_pending(pending, head, child)
                elif r.status in (RequestStatus.SHED,
                                  RequestStatus.FAILED):
                    source.on_shed(r)

        while len(s.done) < n_total:
            # due fault boundaries fire before anything else
            if fi < len(tl) and s.now >= tl[fi].t - eps:
                b = tl[fi]
                fi += 1
                if b.action == "notice":
                    if drain:
                        # graceful drain: stop admitting, re-queue the
                        # waiting work past the restart
                        draining_until = b.event.t_restart
                        for r in self.batcher.evict_waiting():
                            _remove_identity(s.submitted, r)
                            r.release_time = b.event.t_restart
                            _insert_pending(pending, head, r)
                elif b.action == "kill":
                    draining_until = None
                    failed = self.stream_crash(
                        "preempt" if b.event.kind == "preempt"
                        else "crash")
                    t_restart = b.event.t_restart
                    for r in failed:
                        if (retry is not None
                                and r.n_attempts < retry.max_retries):
                            _remove_identity(s.submitted, r)
                            delay = retry.backoff(r.n_attempts)
                            r.n_attempts += 1
                            s.n_retries += 1
                            r.status = RequestStatus.QUEUED
                            r.fail_reason = None
                            r.release_time = max(s.now + delay,
                                                 t_restart)
                            _insert_pending(pending, head, r)
                        else:
                            s.done.append(r)
                    drain_source()
                    self.stream_down(t_restart)
                elif b.action == "slow_start":
                    self.set_freq_scale(b.event.freq_scale)
                else:                               # slow_end
                    self.set_freq_scale(base_freq)
                continue
            n = len(pending)
            while (head < n and pending[head].effective_arrival
                    <= s.now + eps):
                r = pending[head]
                head += 1
                if s.now - r.arrival_time > timeout + eps:
                    # queueing timeout: backoff delays pushed this
                    # request past its budget — fail instead of serve
                    r.status = RequestStatus.FAILED
                    r.fail_reason = "timeout"
                    s.n_failures += 1
                    s.submitted.append(r)
                    s.done.append(r)
                    drain_source()
                    n = len(pending)
                    continue
                if draining_until is not None:
                    # admissions are paused until the replica restarts
                    r.release_time = draining_until
                    _insert_pending(pending, head, r)
                    n = len(pending)
                    continue
                self.stream_submit(r)
            t_arr = (pending[head].effective_arrival
                     if head < len(pending) else None)
            t_f = tl[fi].t if fi < len(tl) else None
            if self.stream_can_step():
                if t_arr is not None and (t_f is None or t_arr <= t_f):
                    stop = HorizonStop(t_arr, mode="admit")
                elif t_f is not None:
                    stop = HorizonStop(t_f, mode="clock")
                else:
                    stop = None
                self.stream_step(stop=stop)
                drain_source()
                continue
            if t_arr is None and t_f is None:
                if self.batcher.n_waiting:
                    raise RuntimeError("deadlock: waiting requests "
                                       "cannot be scheduled (KV pool "
                                       "too small)")
                break
            next_is_arrival = (t_arr is not None
                               and (t_f is None or t_arr <= t_f))
            t_next = t_arr if t_f is None else (
                t_f if t_arr is None else min(t_arr, t_f))
            gap = t_next - s.now
            wake = self.device.wake_latency_s
            if plans_gaps and next_is_arrival and gap > wake:
                self.stream_idle(t_next - wake, gated=True)
            self.stream_idle(t_next)
        return self.stream_report()

    # -- stream primitives (single-engine run + cluster co-simulation) --
    def stream_start(self, t0: float = 0.0) -> None:
        """Begin a fresh continuous-mode stream at clock ``t0``."""
        if self.mode != "continuous":
            raise RuntimeError("streams require mode='continuous'")
        self.batch_policy.reset()
        self.batcher = ContinuousBatcher(policy=self.batch_policy,
                                         **self._batcher_kw)
        self._stream = _StreamState(now=t0)
        self.backend.start()

    @property
    def stream_now(self) -> float:
        return self._stream.now

    @property
    def stream_load(self) -> int:
        """Requests on this replica that are not finished."""
        return self.batcher.n_live + self.batcher.n_waiting

    def stream_outstanding_work(self) -> float:
        """Outstanding token work: un-prefilled prompt tokens (chunk
        remainders of partially prefilled slots included) plus the
        remaining decode tokens of queued and running requests."""
        return float(self.batch_policy.outstanding_tokens(self.batcher))

    def stream_submit(self, req: Request) -> None:
        self._stream.submitted.append(req)
        self.batcher.admit(req)

    def stream_take_handoffs(self) -> List[Request]:
        """Drain prefill-complete requests relayed by a
        ``pool='prefill'`` engine (disaggregated serving); the cluster
        loop re-submits them to a decode replica."""
        out = self._stream.handoffs
        self._stream.handoffs = []
        return out

    def stream_can_step(self) -> bool:
        """True if the scheduler can make progress right now (a prefill
        batch is admissible, or live slots can take a decode step)."""
        b = self.batcher
        if b.n_live:
            return True
        return bool(b.n_waiting) and self.batch_policy.can_admit(b)

    def stream_stuck(self) -> bool:
        """Waiting requests exist but can never be scheduled (KV pool
        too small and nothing live to release pages)."""
        return bool(self.batcher.n_waiting) and not self.stream_can_step()

    def stream_step(self, stop: Optional[HorizonStop] = None) -> float:
        """Execute one scheduler iteration through the backend,
        advancing the stream clock: one prefill batch (or chunk), or,
        when the live batch is frozen for several decode steps, one
        decode macro-step covering every step up to the next event
        (completion, KV-page exhaustion, or the ``stop`` boundary: the
        next shaped release). Returns the phase latency (0.0 if there
        was nothing to do)."""
        s, b = self._stream, self.batcher
        plan = self.batch_policy.schedule_prefill(b, s.now)
        if plan is not None and plan.picks:
            if plan.adopt:
                # prefill already ran elsewhere: the picks enter the
                # decode batch directly, no compute phase and no clock
                # advance
                for _, r in plan.picks:
                    r.status = RequestStatus.RUNNING
                self._finish_ready(b, s.done, s.now)
                return 0.0
            picks = plan.picks
            res = self.backend.prefill(PrefillBatch(
                picks=picks, pad_len=plan.pad_len, stack=self.stack,
                chunk_start=plan.chunk_start, chunk_len=plan.chunk_len))
            self._record("prefill", s.now, s.now + res.latency_s,
                         res.energy_j, float(len(picks)))
            s.now += res.latency_s
            s.busy_t += res.latency_s
            s.busy_e += res.energy_j
            s.n_prefills += 1
            if plan.is_chunk:
                slot, r = picks[0]
                if r.t_prefill_start < 0:
                    # first compute phase (a resumed child starts at
                    # chunk_start > 0: those tokens' KV was forked)
                    r.status = RequestStatus.RUNNING
                    r.t_prefill_start = s.now - res.latency_s
                    if plan.chunk_start:
                        s.prefix_reused += plan.chunk_start
                r.energy_j += res.energy_j
                s.prefill_chunks += 1
                s.prefill_computed += plan.chunk_len
                s.prefill_effective += plan.chunk_len
                if b.note_chunk(slot, plan.chunk_len):
                    r.t_first_token = s.now
                    r.tokens_generated = 1
                    if self.pool == "prefill":
                        self._relay([(slot, r)])
                    else:
                        self._finish_ready(b, s.done, s.now)
                return res.latency_s
            for slot, r in picks:
                r.status = RequestStatus.RUNNING
                r.t_prefill_start = s.now - res.latency_s
                r.t_first_token = s.now
                r.tokens_generated = 1
                r.energy_j += res.energy_j / len(picks)
                b.complete_prefill(slot)
            s.prefill_computed += len(picks) * plan.pad_len
            s.prefill_effective += sum(r.prompt_len for _, r in picks)
            if self.pool == "prefill":
                self._relay(picks)
            else:
                self._finish_ready(b, s.done, s.now)
            return res.latency_s
        live = b.decode_ready_slots()
        if live:
            reqs = [b.slots[i].request for i in live]
            k, completes = (self._decode_horizon(reqs)
                            if self.macro_step else (1, True))
            cap = self.batch_policy.decode_horizon_cap(b)
            if cap is not None and k > cap:
                k, completes = cap, False
            if k > 1:
                lat = self._decode_macro(live, reqs, k, completes,
                                         stop)
                self.batch_policy.note_decode()
                return lat
            res = self.backend.decode_step(DecodeBatch(
                slots=live, requests=reqs,
                cache_lens=[r.prompt_len + r.tokens_generated
                            for r in reqs],
                stack=self.stack))
            self._record("decode", s.now, s.now + res.latency_s,
                         res.energy_j, float(len(live)))
            s.now += res.latency_s
            s.busy_t += res.latency_s
            s.busy_e += res.energy_j
            s.decode_time += res.latency_s
            s.batch_time += res.latency_s * len(live)
            s.n_decode += 1
            b.step_decode_bookkeeping()
            for r in reqs:
                r.tokens_generated += 1
                r.energy_j += res.energy_j / len(live)
            self.batch_policy.note_decode()
            self._finish_ready(b, s.done, s.now)
            return res.latency_s
        return 0.0

    def _relay(self, picks) -> None:
        """Hand prefill-complete requests off the replica (disaggregated
        ``pool='prefill'``): free the slot and KV, and queue the request
        for the cluster loop to deliver to a decode replica."""
        s, b = self._stream, self.batcher
        for slot, r in picks:
            b.finish(slot)
            self.backend.release_slot(slot)
            s.done.append(r)
            s.handoffs.append(r)
            s.n_relayed += 1

    # -- event-horizon macro-stepping ----------------------------------
    def _decode_horizon(self, reqs: List[Request]
                        ) -> "tuple[int, bool]":
        """``(steps, completes)`` until the next scheduler-visible
        event: the earliest request completion, clipped to KV-page
        feasibility. Within the horizon the live batch cannot change:
        arrivals only land at ``stop`` boundaries, waiting requests stay
        blocked (free slots and KV pages only shrink during decode), and
        no request finishes before the one with the fewest tokens left.
        ``completes`` says whether requests finish at the horizon's last
        step (False when KV pages clipped it)."""
        k = min(r.max_new_tokens - r.tokens_generated for r in reqs)
        if k <= 1:
            return 1, True
        k_kv = self.batcher.kv.max_uniform_extend(
            [r.req_id for r in reqs], k)
        if k_kv >= k:
            return k, True
        # k_kv == 0: even one fused step would exhaust the pool; take
        # the single-step path so it fails exactly like the step loop
        return max(k_kv, 1), False

    def _decode_macro(self, live: List[int], reqs: List[Request],
                      k: int, completes: bool,
                      stop: Optional[HorizonStop]) -> float:
        """Execute up to ``k`` decode steps as one backend call,
        reproducing the single-step loop's accumulation order exactly
        (see :func:`_fold`)."""
        s, b = self._stream, self.batcher
        n = len(live)
        run = self.backend.decode_run(
            DecodeBatch(slots=live, requests=reqs,
                        cache_lens=[r.prompt_len + r.tokens_generated
                                    for r in reqs],
                        stack=self.stack),
            k, t_start=s.now, stop=stop)
        j = run.n_steps
        if self._trace is not None:
            # one coalesced decode segment per macro-step
            self._trace.record_run(self._trace_replica, "decode", s.now,
                                   run.latencies_s, run.energies_j,
                                   float(n),
                                   freq_scale=self.freq_scale)
        t0 = s.now
        s.now = run.t_end
        s.busy_t = _fold(s.busy_t, run.latencies_s)
        s.busy_e = _fold(s.busy_e, run.energies_j)
        s.decode_time = _fold(s.decode_time, run.latencies_s)
        s.batch_time = _fold(s.batch_time, run.latencies_s * float(n))
        s.n_decode += j
        b.bulk_decode_bookkeeping(j)
        shares = run.energies_j / float(n)
        new_e = _fold_many(np.array([r.energy_j for r in reqs]), shares)
        for i, r in enumerate(reqs):
            r.tokens_generated += j
            r.energy_j = float(new_e[i])
        if completes and j == k:
            # requests only finish at the completion horizon's last
            # step: a stop- or KV-clipped run has nothing to collect
            self._finish_ready(b, s.done, s.now)
        return float(run.t_end - t0)

    def stream_idle(self, until: float, gated: bool = False) -> None:
        """Advance the stream clock to ``until``, accruing idle power,
        or gated power for a gap the scheduler planned."""
        s = self._stream
        gap = until - s.now
        if gap <= 0:
            return
        state = "gated" if gated else "idle"
        res = self.backend.idle(gap, state)
        if gated:
            s.gated_e += res.energy_j
            s.gated_t += gap
        else:
            s.idle_e += res.energy_j
            s.idle_t += gap
        self._record(state, s.now, until, res.energy_j)
        s.now = until

    # -- fault primitives (the reference's fault paths drive these) -----
    def stream_down(self, until: float) -> None:
        """Advance the stream clock through a dead period: the replica
        draws nothing (the machine is off, not idling)."""
        s = self._stream
        if until <= s.now:
            return
        self._record("down", s.now, until, 0.0)
        s.down_t += until - s.now
        s.now = until

    def stream_crash(self, reason: str = "crash") -> List[Request]:
        """Kill this replica at the current stream clock: every live and
        queued request fails (status ``FAILED``, its joules move to
        waste) and the KV and slot state is rebuilt empty. Returns the
        failed requests."""
        s, b = self._stream, self.batcher
        failed: List[Request] = []
        for i in b.live_slots():
            failed.append(b.slots[i].request)
            self.backend.release_slot(i)
        failed.extend(b.evict_waiting())
        for r in failed:
            r.status = RequestStatus.FAILED
            r.fail_reason = reason
            r.wasted_energy_j += r.energy_j
            s.wasted_e += r.energy_j
            r.energy_j = 0.0
            r.tokens_generated = 0
            r.prefilled_tokens = 0
            r.t_prefill_start = -1.0
            r.t_first_token = -1.0
            r.generated = []
            # any forked-prefix KV died with the pool: a retry must
            # recompute the full prompt wherever it lands
            r.kv_parent = None
            s.n_failures += 1
        self.batch_policy.reset()
        self.batcher = ContinuousBatcher(policy=self.batch_policy,
                                         **self._batcher_kw)
        return failed

    def stream_cancel(self, req: Request,
                      reason: str = "hedge_loser") -> bool:
        """Evict one in-flight or queued request: its slot and KV free
        at once, its joules move to waste, and it leaves this replica's
        report. Returns False if ``req`` is not on this replica."""
        s, b = self._stream, self.batcher
        slot = b.find_slot(req)
        if slot is not None:
            b.finish(slot)
            self.backend.release_slot(slot)
        elif not b.remove_waiting(req):
            return False
        _remove_identity(s.submitted, req)
        req.status = RequestStatus.FAILED
        req.fail_reason = reason
        req.wasted_energy_j += req.energy_j
        s.wasted_e += req.energy_j
        req.energy_j = 0.0
        return True

    def stream_report(self) -> ServeReport:
        s = self._stream
        mean_batch = (s.batch_time / s.decode_time
                      if s.decode_time else 0.0)
        return ServeReport(
            requests=list(s.submitted),
            total_energy_j=s.busy_e + s.idle_e + s.gated_e + s.trans_e,
            busy_energy_j=s.busy_e, idle_energy_j=s.idle_e,
            wall_time_s=s.now, busy_time_s=s.busy_t,
            mean_batch=mean_batch, n_prefill_batches=s.n_prefills,
            n_decode_steps=s.n_decode, gated_energy_j=s.gated_e,
            gated_time_s=s.gated_t, idle_time_s=s.idle_t,
            transition_energy_j=s.trans_e, transition_time_s=s.trans_t,
            prefill_computed_tokens=s.prefill_computed,
            prefill_effective_tokens=s.prefill_effective,
            prefill_chunks=s.prefill_chunks, n_relayed=s.n_relayed,
            prefix_reused_tokens=s.prefix_reused,
            n_failures=s.n_failures, n_retries=s.n_retries,
            wasted_energy_j=s.wasted_e, down_time_s=s.down_t)

    def _finish_ready(self, b: ContinuousBatcher, done: List[Request],
                      now: float) -> None:
        for i in b.decode_ready_slots():
            r = b.slots[i].request
            if r.tokens_generated >= r.max_new_tokens:
                r.t_done = now
                r.status = RequestStatus.DONE
                b.finish(i)
                self.backend.release_slot(i)
                done.append(r)
