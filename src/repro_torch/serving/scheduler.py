"""SLO-aware request scheduling: arrival shaping and admission control.
The port's own copy of ``repro.serving.scheduler`` (numpy only); the
cluster that also reads it waits for ROADMAP A4(b).

The paper's §5 headline is that *when* requests reach the engine moves
per-request energy by up to two orders of magnitude. The repo's arrival
generators are passive; this module is the active layer between an
arrival stream and :class:`~repro_torch.serving.engine.ServeEngine`.
A scheduler consumes raw
requests and decides, per request,

* a **release time** (``Request.release_time`` >= arrival) — shaping:
  pacing, window coalescing, earliest-deadline ordering — or
* to **shed** it (``RequestStatus.SHED``) — admission control: the
  request never touches the engine and counts as an SLO miss.

Schedulers that *plan* release times (paced, window, deadline) know
the gaps between releases in advance, so the engine may power-gate
those gaps (``DeviceSpec.gated_power`` + wake ramp) instead of burning
idle power — the fleet-level mechanism behind the paper's shaping win,
now available on a single replica. Pure admission control
(energy_budget) releases at raw arrival times and therefore gates
nothing, exactly like passthrough. Shaping composes with routing: the
cluster applies the scheduler to the shared arrival stream before the
router sees it.

Shaped release times are also the simulator's **event horizon
boundaries** (:class:`HorizonStop`): between two releases the live
decode batch is frozen, so the engine fuses every step up to the next
release into one macro-step backend call — shaping doesn't just save
simulated energy, it makes the simulation itself run orders of
magnitude faster at fleet scale.

Policies
--------
``passthrough``    release = arrival (the unshaped baseline; no gating)
``paced``          token bucket: sustained ``rate_per_s`` with a
                   ``burst``-deep bucket; no request released before its
                   arrival, bucket conservation holds exactly
``window``         coalesce arrivals into batching windows of ``window_s``
                   (release at the window edge) so prefills consolidate
``deadline``       earliest-deadline-first over per-request SLOs with
                   priority tiers; releases paced at the engine's
                   estimated service rate; infeasible requests are shed
``energy_budget``  admit only while the predicted marginal Wh/request
                   (existing :class:`~repro_torch.core.energy.EnergyModel`)
                   stays under a cap — lone stragglers that cannot
                   amortize a batch are rejected
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core import workload as W
from repro_torch.core.energy import EnergyModel
from repro_torch.core.hardware import DeviceSpec, H100_SXM
from repro_torch.core.precision import make_policy
from repro_torch.serving.requests import Request, RequestStatus

if TYPE_CHECKING:   # keep engine import runtime-light
    from repro_torch.serving.engine import ServeEngine


@dataclasses.dataclass(frozen=True)
class HorizonStop:
    """An absolute-time event boundary that ends a decode macro-step.

    Shaped release times are exactly these boundaries: between two
    releases (and in the absence of completions or KV-page exhaustion)
    the live batch composition is frozen, so the engine may fuse every
    decode step up to the boundary into one
    :meth:`~repro_torch.serving.backend.InferenceBackend.decode_run` call.
    The two modes reproduce the exact float comparisons of the
    pre-macro event loops, so fused runs execute bit-identical step
    counts:

    * ``admit`` — :class:`~repro_torch.serving.engine.ServeEngine`'s arrival
      rule: a release at ``t_stop`` is admitted once
      ``t_stop <= now + eps``, so decoding stops after the first step
      whose end time satisfies that;
    * ``clock`` — the reference's ``ClusterEngine`` co-simulation rule:
      a replica keeps stepping while
      ``now < t_stop - eps``;
    * ``control`` — a closed-loop controller's observe/plan/act
      boundary (:mod:`repro.control`): decoding stops after the first
      step whose end time crosses ``t_stop`` so the controller fires
      with the same clock the single-step loop would see. With no
      controller attached no ``control`` stop is ever constructed, so
      macro-stepping stays bit-identical to HEAD.

    Either way the in-flight step always completes (the single-step
    loops only re-checked arrivals between steps).
    """

    t_stop: float
    mode: str = "admit"
    eps: float = 1e-12

    def __post_init__(self):
        if self.mode not in ("admit", "clock", "control"):
            raise ValueError(f"unknown horizon-stop mode {self.mode!r}")

    def hit(self, now: float) -> bool:
        """Whether the boundary has been reached at clock ``now``."""
        if self.mode == "admit":
            return self.t_stop <= now + self.eps
        return not (now < self.t_stop - self.eps)

    def n_steps(self, step_end_times) -> int:
        """Steps to execute given per-step end times: everything before
        the first boundary hit, plus the step that crosses it."""
        t = np.asarray(step_end_times, dtype=np.float64)
        if self.mode == "admit":
            hits = self.t_stop <= t + self.eps
        else:
            hits = t >= self.t_stop - self.eps
        idx = np.flatnonzero(hits)
        return int(idx[0]) + 1 if len(idx) else len(t)

    def merged(self, other: "Optional[HorizonStop]") -> "HorizonStop":
        """The earlier-stopping of two boundaries (``other`` may be
        None). Used to compose an admission horizon with a control
        boundary: decode stops at whichever rule trips first."""
        if other is None or self.n_first_leq(other):
            return self
        return other

    def n_first_leq(self, other: "HorizonStop") -> bool:
        """Whether this boundary stops no later than ``other`` for any
        step sequence: compares the effective cut times (an ``admit``
        stop at t trips once ``now >= t - eps``; ``clock``/``control``
        likewise) — with shared eps this reduces to ``t_stop``."""
        return self.t_stop <= other.t_stop


@dataclasses.dataclass
class ScheduleResult:
    """Outcome of shaping one arrival stream."""

    released: List[Request]     # admitted, release_time set, shaped order
    shed: List[Request]         # rejected; status=SHED, never served

    @property
    def n_released(self) -> int:
        return len(self.released)

    @property
    def n_shed(self) -> int:
        return len(self.shed)

    @property
    def shed_fraction(self) -> float:
        total = self.n_released + self.n_shed
        return self.n_shed / total if total else 0.0


class Scheduler:
    """Base scheduler: shape and/or admit an arrival stream."""

    name = "base"
    #: True when release times are planned ahead, letting the engine
    #: power-gate the known gaps between releases
    plans_gaps = False

    def schedule(self, requests: Sequence[Request]) -> ScheduleResult:
        raise NotImplementedError

    # ------------------------------------------------------------------
    @staticmethod
    def _by_arrival(requests: Sequence[Request]) -> List[Request]:
        return sorted(requests, key=lambda r: (r.arrival_time, r.req_id))

    @staticmethod
    def _shed(req: Request, reason: str) -> Request:
        req.status = RequestStatus.SHED
        req.shed_reason = reason
        req.release_time = None
        return req


class PassthroughScheduler(Scheduler):
    """Identity shaping — the unshaped baseline."""

    name = "passthrough"

    def schedule(self, requests: Sequence[Request]) -> ScheduleResult:
        reqs = self._by_arrival(requests)
        for r in reqs:
            r.release_time = r.arrival_time
        return ScheduleResult(released=reqs, shed=[])


class PacedScheduler(Scheduler):
    """Token-bucket arrival shaping.

    The bucket holds up to ``burst`` tokens and refills continuously at
    ``rate_per_s``. Each release consumes one token; a request arriving
    to an empty bucket waits for the refill. Invariants (tested):
    releases are monotone non-decreasing, never precede arrival, and at
    most ``burst + rate*dt`` requests are released in any interval dt.
    """

    name = "paced"
    plans_gaps = True

    def __init__(self, rate_per_s: float, burst: int = 1):
        if rate_per_s <= 0:
            raise ValueError("rate_per_s must be positive")
        if burst < 1:
            raise ValueError("burst must be >= 1")
        self.rate = float(rate_per_s)
        self.burst = int(burst)

    def schedule(self, requests: Sequence[Request]) -> ScheduleResult:
        reqs = self._by_arrival(requests)
        tokens = float(self.burst)
        t_clock = reqs[0].arrival_time if reqs else 0.0
        for r in reqs:
            t = r.arrival_time
            if t > t_clock:     # refill over the quiet gap
                tokens = min(float(self.burst),
                             tokens + (t - t_clock) * self.rate)
                t_clock = t
            if tokens >= 1.0 - 1e-12:
                tokens -= 1.0
                r.release_time = max(t, t_clock)
            else:
                wait = (1.0 - tokens) / self.rate
                r.release_time = t_clock + wait
                tokens = 0.0
                t_clock = r.release_time
        return ScheduleResult(released=reqs, shed=[])


class WindowScheduler(Scheduler):
    """Batching-window coalescing: requests arriving within one window
    of ``window_s`` are released together at the window edge, so the
    engine sees one consolidated prefill batch per window instead of a
    dribble of tiny ones. Max added delay < ``window_s``."""

    name = "window"
    plans_gaps = True

    def __init__(self, window_s: float):
        if window_s <= 0:
            raise ValueError("window_s must be positive")
        self.window_s = float(window_s)

    def schedule(self, requests: Sequence[Request]) -> ScheduleResult:
        reqs = self._by_arrival(requests)
        if not reqs:
            return ScheduleResult(released=[], shed=[])
        t0 = reqs[0].arrival_time
        w = self.window_s
        for r in reqs:
            k = math.ceil((r.arrival_time - t0) / w - 1e-9)
            r.release_time = max(t0 + k * w, r.arrival_time)
        return ScheduleResult(released=reqs, shed=[])


class DeadlineScheduler(Scheduler):
    """Earliest-deadline-first with priority tiers and load shedding.

    Releases are paced at ``service_rate_per_s`` (what the engine can
    absorb — see :func:`repro.serving.slo.estimate_service_rate`); at
    each release slot the backlog is drained in (priority desc, absolute
    deadline asc) order. A request whose release slot would already be
    past ``arrival + deadline_s - est_latency_s`` cannot meet its SLO
    and is shed instead of poisoning the queue — load shedding keeps
    the admitted set on time under overload.
    """

    name = "deadline"
    plans_gaps = True

    def __init__(self, service_rate_per_s: float, *,
                 est_latency_s: float = 0.0, shed_late: bool = True):
        if service_rate_per_s <= 0:
            raise ValueError("service_rate_per_s must be positive")
        self.rate = float(service_rate_per_s)
        self.est_latency_s = float(est_latency_s)
        self.shed_late = shed_late

    def _key(self, r: Request):
        return (-r.priority, r.abs_deadline, r.arrival_time, r.req_id)

    def schedule(self, requests: Sequence[Request]) -> ScheduleResult:
        pending = self._by_arrival(requests)
        inc = 1.0 / self.rate
        released: List[Request] = []
        shed: List[Request] = []
        heap: List[tuple] = []
        i = 0
        t = pending[0].arrival_time if pending else 0.0
        while i < len(pending) or heap:
            while (i < len(pending)
                   and pending[i].arrival_time <= t + 1e-12):
                heapq.heappush(heap, (self._key(pending[i]), pending[i]))
                i += 1
            if not heap:        # idle: jump to the next arrival
                t = max(t, pending[i].arrival_time)
                continue
            _, req = heapq.heappop(heap)
            latest_start = req.abs_deadline - self.est_latency_s
            if self.shed_late and t > latest_start + 1e-12:
                shed.append(self._shed(req, "deadline_infeasible"))
                continue        # shedding consumes no service slot
            req.release_time = t
            released.append(req)
            t += inc
        return ScheduleResult(released=released, shed=shed)


class EnergyBudgetScheduler(Scheduler):
    """Admission control on predicted marginal energy.

    The scheduler predicts the *marginal* Wh of each request: its own
    prefill plus its share of the decode-step energy increase from
    growing the predicted concurrent batch (the same marginal model the
    energy-aware router uses). Requests arriving within ``coalesce_s``
    of each other are priced as one group — a burst amortizes its own
    batch spin-up across its members, so burst members are cheap and
    pass, while a lone straggler that would spin the engine up for one
    sequence carries the full batch-of-one decode cost and is shed once
    that exceeds ``max_wh_per_request``.

    Admission control only: admitted requests are released at their raw
    arrival times, which stay unpredictable — so unlike the shaping
    policies this scheduler does NOT license planned-gap power gating.
    """

    name = "energy_budget"
    plans_gaps = False

    def __init__(self, max_wh_per_request: float, cfg, *,
                 fmt: str = "bfloat16", device: DeviceSpec = H100_SXM,
                 n_chips: int = 1, stack: str = "fused",
                 max_batch: int = 32, coalesce_s: float = 0.05,
                 energy_model: Optional[EnergyModel] = None):
        if max_wh_per_request <= 0:
            raise ValueError("max_wh_per_request must be positive")
        self.cap_wh = float(max_wh_per_request)
        self.cfg = cfg
        self.energy = energy_model or EnergyModel(device, make_policy(fmt))
        self.n_chips = n_chips
        self.stack = stack
        self.max_batch = max_batch
        self.coalesce_s = float(coalesce_s)
        self._cache: Dict[tuple, float] = {}

    @classmethod
    def for_engine(cls, eng: "ServeEngine", max_wh_per_request: float,
                   coalesce_s: float = 0.05) -> "EnergyBudgetScheduler":
        """Build a budget scheduler whose predictor matches an engine's
        config, precision, device, and batch limit."""
        return cls(max_wh_per_request, eng.cfg, n_chips=eng.n_chips,
                   stack=eng.stack, max_batch=eng.max_batch,
                   coalesce_s=coalesce_s, energy_model=eng.energy)

    # -- marginal-energy predictor -------------------------------------
    def _step(self, batch: int, ctx: int) -> "tuple[float, float]":
        """(energy_j, latency_s) of one decode step at ``batch``."""
        ctx = max(64, int(round(ctx / 64.0)) * 64)  # bucket the cache key
        key = (batch, ctx)
        if key not in self._cache:
            rep = self.energy.evaluate(
                W.decode_step_workload(self.cfg, batch, ctx,
                                       stack=self.stack), self.n_chips)
            self._cache[key] = (rep.energy_j, rep.latency)
        return self._cache[key]

    def predicted_marginal_wh(self, req: Request, inflight: int,
                              group_size: int = 1) -> float:
        """Marginal Wh of admitting ``req`` as one of ``group_size``
        co-arriving requests on top of ``inflight`` live ones."""
        pre = self.energy.evaluate(W.prefill_workload(
            self.cfg, 1, req.prompt_len, stack=self.stack), self.n_chips)
        ctx = req.prompt_len + req.max_new_tokens // 2
        k = max(group_size, 1)
        b0 = min(inflight, self.max_batch)
        b1 = min(inflight + k, self.max_batch)
        e1, _ = self._step(b1, ctx)
        if b1 > b0:
            e0 = self._step(b0, ctx)[0] if b0 else 0.0
            per_slot = (e1 - e0) / k        # group's batch-growth share
        else:                               # saturated: fair share
            per_slot = e1 / b1
        return (pre.energy_j + per_slot * req.max_new_tokens) / 3600.0

    def schedule(self, requests: Sequence[Request]) -> ScheduleResult:
        reqs = self._by_arrival(requests)
        released: List[Request] = []
        shed: List[Request] = []
        inflight: List[float] = []          # est finish times (heap)
        i = 0
        while i < len(reqs):
            # coalesce the co-arriving group
            j = i + 1
            t = reqs[i].arrival_time
            while (j < len(reqs)
                   and reqs[j].arrival_time <= t + self.coalesce_s):
                j += 1
            group = reqs[i:j]
            i = j
            while inflight and inflight[0] <= t:
                heapq.heappop(inflight)
            b0 = len(inflight)
            for r in group:
                wh = self.predicted_marginal_wh(r, b0, len(group))
                if wh > self.cap_wh:
                    shed.append(self._shed(r, "over_energy_budget"))
                    continue
                r.release_time = r.arrival_time
                released.append(r)
                b = min(b0 + len(group), self.max_batch)
                _, lat = self._step(b, r.prompt_len)
                heapq.heappush(inflight,
                               r.arrival_time + r.max_new_tokens * lat)
        return ScheduleResult(released=released, shed=shed)


# ---------------------------------------------------------------------------
SCHEDULERS = {cls.name: cls for cls in
              (PassthroughScheduler, PacedScheduler, WindowScheduler,
               DeadlineScheduler, EnergyBudgetScheduler)}


def apply_schedule(requests: Sequence[Request],
                   scheduler: Optional[Scheduler]
                   ) -> "tuple[List[Request], List[Request]]":
    """Shape/admit a raw request list for an engine: returns
    ``(released, shed)`` with released sorted by (release time, id) —
    the shared preamble of :meth:`ServeEngine.run` and
    :meth:`ClusterEngine.run`."""
    reqs = list(requests)
    shed: List[Request] = []
    if scheduler is not None:
        res = scheduler.schedule(reqs)
        reqs, shed = list(res.released), list(res.shed)
    reqs.sort(key=lambda r: (r.effective_arrival, r.req_id))
    return reqs, shed


def make_scheduler(policy: str, **kw) -> Scheduler:
    try:
        cls = SCHEDULERS[policy]
    except KeyError:
        raise ValueError(f"unknown scheduling policy {policy!r}; "
                         f"known: {list(SCHEDULERS)}")
    return cls(**kw)
