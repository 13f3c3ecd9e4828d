"""Controllers: observe/plan/act policies over a :class:`ControlView`.
The port's own copy of ``repro.control.controllers``.

Three policies ship, in increasing sophistication:

* :class:`StaticController` — pins a fixed operating point (the
  open-loop baseline; with no arguments it is the identity policy);
* :class:`ReactiveController` — threshold rules stepping the DVFS
  level (and, on fleets, the replica target) up when occupancy or
  queueing crosses a high-water mark and down when the plant idles;
* :class:`MPCController` — model-predictive control: at every
  boundary it simulates candidate ``(freq, admission, n_replicas)``
  tuples over a lookahead window against a quasi-steady fluid model
  built from :class:`~repro_torch.serving.backend.AnalyticBackend` phase
  reports (the same analytic substrate the simulator prices with),
  scores each candidate on predicted Wh/request × an SLO-attainment
  penalty, and actuates the argmin (with hysteresis so 1-ulp score
  noise cannot make it thrash).

The MPC's planner model is *explicitly allowed to be wrong*: when the
plant is a :class:`~repro_torch.serving.backend.ReplayBackend` trace whose
coefficients differ from the planner's, the observed queue depth and
arrival rate feed back into every re-plan, so a too-optimistic plan
raises the congestion penalty at the next boundary and the controller
climbs back to a feasible operating point — graceful degradation
rather than divergence (pinned by the model-mismatch tests).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.core.hardware import DeviceSpec
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.control.view import ControlView


@dataclasses.dataclass(frozen=True)
class PlannerContext:
    """What a controller may assume about the plant before the run:
    the model/precision being served, the *nominal* device, and the
    workload shape (mean prompt/output lengths of the offered load).
    Timing — arrivals, queueing, the plant's true costs — is only ever
    observed through the view."""

    cfg: ModelConfig
    device: DeviceSpec              # nominal operating point
    policy: PrecisionPolicy
    n_chips: int
    max_batch: int
    stack: str = "fused"
    mean_prompt: float = 1024.0
    mean_output: float = 128.0


class Controller:
    """Protocol: one observe/plan/act cycle per control boundary.

    ``observe`` is reading the view's attributes, ``plan`` is internal,
    ``act`` stages targets on the view's actuators. Controllers must be
    deterministic functions of (prepare context, sequence of views) —
    run results are reproducible byte-for-byte given the same spec.
    """

    name = "base"

    def prepare(self, ctx: PlannerContext) -> None:
        """Called once before the run starts."""

    def act(self, view: ControlView) -> None:
        raise NotImplementedError


class StaticController(Controller):
    """Open-loop: pin a fixed operating point and hold it."""

    name = "static"

    def __init__(self, freq_scale: float = 1.0,
                 admission_rate: Optional[float] = None,
                 admission_burst: int = 1,
                 n_replicas: Optional[int] = None):
        if not 0.1 <= freq_scale <= 1.5:
            raise ValueError(f"freq_scale {freq_scale:g} outside "
                             "[0.1, 1.5]")
        self.freq_scale = float(freq_scale)
        self.admission_rate = admission_rate
        self.admission_burst = int(admission_burst)
        self.n_replicas = n_replicas

    def act(self, view: ControlView) -> None:
        if view.can_freq and view.freq_scale != self.freq_scale:
            view.set_freq_scale(self.freq_scale)
        if (view.can_admit and self.admission_rate is not None
                and view.admission_rate != self.admission_rate):
            view.set_admission_rate(self.admission_rate,
                                    burst=self.admission_burst)
        if view.can_scale and self.n_replicas is not None:
            view.set_replica_target(self.n_replicas)


class ReactiveController(Controller):
    """Threshold rules: step the DVFS level up under pressure
    (occupancy above ``high_occupancy`` or any queueing), down when
    the plant idles below ``low_occupancy`` with an empty queue. On
    fleets the replica target steps on queue-depth watermarks, like
    :class:`~repro_torch.fleet.autoscale.QueueDepthAutoscaler` but driven
    through the controller actuators."""

    name = "reactive"

    def __init__(self, freq_levels: Sequence[float] = (0.5, 0.7, 0.85,
                                                       1.0),
                 low_occupancy: float = 0.3,
                 high_occupancy: float = 0.75,
                 queue_high: int = 8, queue_low: int = 0):
        if not freq_levels:
            raise ValueError("freq_levels must be non-empty")
        levels = sorted(float(f) for f in freq_levels)
        for f in levels:
            if not 0.1 <= f <= 1.5:
                raise ValueError(f"freq level {f:g} outside [0.1, 1.5]")
        if not 0.0 <= low_occupancy < high_occupancy <= 1.0:
            raise ValueError("need 0 <= low_occupancy < high_occupancy "
                             "<= 1")
        self.levels = levels
        self.low = float(low_occupancy)
        self.high = float(high_occupancy)
        self.queue_high = int(queue_high)
        self.queue_low = int(queue_low)
        self._level = len(levels) - 1       # start at the top

    def act(self, view: ControlView) -> None:
        occ, q = view.mean_occupancy, view.queue_depth
        if occ > self.high or q > self.queue_high:
            self._level = len(self.levels) - 1      # jump to max
        elif occ >= self.low or q > self.queue_low:
            self._level = min(self._level + 1, len(self.levels) - 1)
        else:
            self._level = max(self._level - 1, 0)
        if view.can_freq:
            target = self.levels[self._level]
            if view.freq_scale != target:
                view.set_freq_scale(target)
        if view.can_scale:
            if q > self.queue_high:
                view.set_replica_target(view.n_active + 1)
            elif q <= self.queue_low and occ < self.low:
                view.set_replica_target(view.n_active - 1)


class MPCController(Controller):
    """Model-predictive control over (freq, admission, n_replicas).

    At each boundary the controller evaluates every candidate tuple
    against a quasi-steady fluid model over a ``lookahead_s`` window:

    * the expected concurrent batch is the fixed point of
      ``b = clamp(lam_r * T(b), 1, max_batch)`` where the residence
      time ``T(b)`` comes from the planner backend's prefill/decode
      phase reports at the candidate frequency;
    * service capacity ``mu = b / T(b)`` gives the busy fraction and a
      p99 proxy (service latency + backlog drain over the window);
    * predicted Wh/request = busy phases + the idle-floor share of
      the unutilized window, multiplied by an SLO penalty that grows
      quadratically once the p99 proxy exceeds ``slo_p99_s``.

    The argmin is actuated only when it beats the incumbent's score by
    ``hysteresis`` — re-planning is cheap, thrashing is not.
    """

    name = "mpc"

    def __init__(self, freq_grid: Sequence[float] = (0.4, 0.5, 0.6,
                                                     0.7, 0.85, 1.0),
                 slo_p99_s: float = 20.0,
                 lookahead_s: Optional[float] = None,
                 admission_grid: Sequence[Optional[float]] = (None,),
                 replica_span: int = 1,
                 ema: float = 0.5, hysteresis: float = 0.02,
                 slo_weight: float = 25.0,
                 capacity_margin: float = 0.8):
        if not freq_grid:
            raise ValueError("freq_grid must be non-empty")
        for f in freq_grid:
            if not 0.1 <= f <= 1.5:
                raise ValueError(f"freq {f:g} outside [0.1, 1.5]")
        if slo_p99_s <= 0:
            raise ValueError("slo_p99_s must be positive")
        if not 0.0 < ema <= 1.0:
            raise ValueError("ema must be in (0, 1]")
        if not 0.0 < capacity_margin <= 1.0:
            raise ValueError("capacity_margin must be in (0, 1]")
        self.freq_grid = tuple(sorted(float(f) for f in freq_grid))
        self.slo = float(slo_p99_s)
        self.lookahead_s = lookahead_s
        self.admission_grid = tuple(admission_grid)
        self.replica_span = int(replica_span)
        self.ema = float(ema)
        self.hysteresis = float(hysteresis)
        self.slo_weight = float(slo_weight)
        self.capacity_margin = float(capacity_margin)
        self._ctx: Optional[PlannerContext] = None
        self._backends: Dict[float, object] = {}
        self._reports: Dict[Tuple, Tuple[float, float]] = {}
        self._cur_freq: Optional[float] = None

    # -- planner substrate ---------------------------------------------
    def prepare(self, ctx: PlannerContext) -> None:
        self._ctx = ctx
        self._backends.clear()
        self._reports.clear()
        self._cur_freq = None

    def _backend(self, f: float):
        be = self._backends.get(f)
        if be is None:
            from repro_torch.serving.backend import AnalyticBackend
            ctx = self._ctx
            dev = (ctx.device if f == ctx.device.freq_scale
                   else ctx.device.with_freq_scale(
                       f / ctx.device.freq_scale))
            be = AnalyticBackend(ctx.cfg, device=dev, policy=ctx.policy,
                                 n_chips=ctx.n_chips)
            self._backends[f] = be
        return be

    def _prefill(self, f: float) -> Tuple[float, float]:
        """(latency_s, energy_j) of one batch-1 prefill at freq f."""
        key = ("p", f)
        if key not in self._reports:
            ctx = self._ctx
            rep = self._backend(f).prefill_report(
                1, max(int(ctx.mean_prompt), 1), stack=ctx.stack)
            self._reports[key] = (rep.latency, rep.energy_j)
        return self._reports[key]

    def _dstep(self, f: float, batch: int) -> Tuple[float, float]:
        """(latency_s, energy_j) of one decode step at freq f."""
        ctx = self._ctx
        b = max(1, min(int(batch), ctx.max_batch))
        clen = int(ctx.mean_prompt + ctx.mean_output / 2)
        clen = max(64, (clen // 64) * 64)
        key = ("d", f, b)
        if key not in self._reports:
            rep = self._backend(f).decode_step_report(b, clen,
                                                      stack=ctx.stack)
            self._reports[key] = (rep.latency, rep.energy_j)
        return self._reports[key]

    # -- candidate scoring ---------------------------------------------
    def _score(self, f: float, m: int, adm: Optional[float],
               lam: float, queued: float, live: float,
               horizon: float) -> Tuple[float, float]:
        """(objective, p99 proxy) of running the next window at
        frequency ``f`` with ``m`` active replicas and admission rate
        ``adm`` against offered load ``lam`` req/s."""
        ctx = self._ctx
        out = max(ctx.mean_output, 1.0)
        lam_off = max(lam, 1e-3)
        lam_adm = lam_off if adm is None else min(lam_off, adm)
        lam_r = lam_adm / m
        pre_lat, pre_e = self._prefill(f)
        # fluid batch estimate: fixed point of b = lam_r * T(b)
        b = max(1.0, min(float(ctx.max_batch),
                         (live + queued) / m + lam_r))
        for _ in range(2):
            tau, _ = self._dstep(f, int(round(b)))
            T = pre_lat + out * tau
            b = max(1.0, min(float(ctx.max_batch), lam_r * T))
        b_i = max(1, int(round(b)))
        tau, dec_e = self._dstep(f, b_i)
        T = pre_lat + out * tau
        # capacity: prefills serialize on the device while decode steps
        # are shared batch-wide, so device time per request at a *full*
        # batch is pre_lat + out*tau_full/max_batch -- prefill-bound
        # (and hence strongly frequency-dependent) for long prompts.
        # The fluid batch b_i always satisfies lam_r ~ b/T (Little), so
        # utilization must be measured against full-batch capacity, not
        # the self-balancing operating point.
        # ``capacity_margin`` derates the fluid capacity: mean-length
        # phase reports underestimate mean *work* (attention cost is
        # superlinear in prompt length, so the long tail of the length
        # distribution costs more than the mean-length request), and
        # running the plant at its fluid limit leaves no headroom for
        # arrival bursts.
        tau_full, _ = self._dstep(f, ctx.max_batch)
        mu = (self.capacity_margin
              / max(pre_lat + out * tau_full / ctx.max_batch, 1e-9))
        phi = min(1.0, lam_r / max(mu, 1e-12))
        # energy per admitted request (Wh): busy phases + idle share
        e_busy = pre_e + out * dec_e / b_i
        e_idle = ctx.device.idle_power * (1.0 - phi) * m / lam_adm
        e_wh = (e_busy + e_idle) / 3600.0
        # p99 proxy: residence latency + the *99th percentile* M/M/1
        # waiting time (P[W > w] = rho e^{-(mu-lam)w}, so
        # w_p99 = ln(100 rho)/(mu - lam) -- the tail is ~ln(100) = 4.6x
        # the mean wait, which is what a p99 target must price) +
        # backlog drain over the window
        growth = max(0.0, lam_r - mu)
        q_end = queued / m + growth * horizon
        gap = mu - lam_r
        if gap > 1e-9:
            wait = max(0.0, math.log(100.0 * min(phi, 1.0))) / gap
            wait = min(wait, horizon)
        else:
            wait = horizon
        p99 = T + wait + q_end / max(mu, 1e-9)
        # shed penalty: admission below offered load trades energy for
        # SLO misses on the rejected tail — price it like lateness
        shed = max(0.0, 1.0 - lam_adm / lam_off)
        over = max(0.0, p99 / self.slo - 1.0)
        penalty = 1.0 + self.slo_weight * (over * over + shed)
        return e_wh * penalty, p99

    def act(self, view: ControlView) -> None:
        if self._ctx is None:
            raise RuntimeError("MPCController.act before prepare()")
        horizon = (self.lookahead_s if self.lookahead_s is not None
                   else 4.0 * view.interval_s)
        lam = view.arrival_rate_per_s
        queued = float(view.queue_depth)
        live = float(view.live)
        m_cur = max(view.n_active, 1)
        if view.can_scale and self.replica_span > 0:
            lo = max(view.min_replicas, m_cur - self.replica_span)
            hi = min(view.max_replicas, m_cur + self.replica_span)
            m_cands = range(lo, hi + 1)
        else:
            m_cands = (m_cur,)
        adm_cands = (self.admission_grid if view.can_admit
                     else (None,))
        best = None
        for f in self.freq_grid:
            for m in m_cands:
                for adm in adm_cands:
                    score, p99 = self._score(f, m, adm, lam, queued,
                                             live, horizon)
                    if best is None or score < best[0]:
                        best = (score, f, m, adm)
        _, f_best, m_best, adm_best = best
        # hysteresis: keep the incumbent unless the winner clearly wins
        f_cur = (self._cur_freq if self._cur_freq is not None
                 else view.freq_scale)
        cur_score, _ = self._score(f_cur, m_cur, view.admission_rate,
                                   lam, queued, live, horizon)
        if best[0] >= cur_score * (1.0 - self.hysteresis):
            f_best, m_best = f_cur, m_cur
            adm_best = view.admission_rate
        if view.can_freq and f_best != view.freq_scale:
            view.set_freq_scale(f_best)
        self._cur_freq = f_best
        if view.can_admit and adm_best != view.admission_rate:
            burst = max(1, int(math.ceil((adm_best or 1.0)
                                         * view.interval_s)))
            view.set_admission_rate(adm_best, burst=burst)
        if view.can_scale and m_best != view.n_active:
            view.set_replica_target(m_best)


CONTROLLERS = {cls.name: cls for cls in
               (StaticController, ReactiveController, MPCController)}


def make_controller(name: str, **params) -> Controller:
    try:
        cls = CONTROLLERS[name]
    except KeyError:
        raise ValueError(f"unknown controller {name!r}; "
                         f"known: {list(CONTROLLERS)}")
    return cls(**params)
