"""Serving loop over the executed backend, with the reference's analytic
clock and energy report.

Counterpart of the part of ``repro.serving.engine`` that serves a request
list through ``ExecutedBackend``, with the reference's scheduling
decisions and accounting:

* ``mode="continuous"`` (the fused stack): ``SlotCountPolicy`` admission.
  Waiting requests are taken first come first served into the lowest
  free decode slots, up to ``max_prefill_batch`` per prefill phase,
  grouped by prompt-length bucket with the queue head. A phase is a
  prefill whenever a request can be admitted, else one decode step over
  the live slots. A phase's analytic energy is shared equally among the
  requests it served; a request leaves its slot once it has
  ``max_new_tokens`` tokens.
* ``mode="sequential"`` (the eager stack): each request alone, costed as
  a prefill of its prompt and a decode tail, then generated for real.

The clock is the backend's analytic latency, summed left to right in the
reference's order, so the report matches the reference float for float
(its macro-steps fold the same additions). ``phases`` keeps every
phase's :class:`~repro_torch.serving.backend.PhaseResult`, whose
``wall_s`` is the host wall time of the real execution.

All requests arrive at t=0, so no idle energy accrues; the KV page pool
is not modelled (the reference's default pool of 2**15 pages of 128
tokens never blocks at the sizes this engine serves). Arrival schedules,
schedulers, traces, the page pool and the fault, fleet, workflow and
control paths wait for ROADMAP A4(a); their report fields keep their
defaults.
"""
from __future__ import annotations

import bisect
import dataclasses
import math
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.batching.static import bucket_length
from repro_torch.core.energy import EnergyModel
from repro_torch.core.hardware import H100_SXM, DeviceSpec
from repro_torch.serving import slo
from repro_torch.serving.backend import (DecodeBatch, ExecutedBackend,
                                         PhaseResult, PrefillBatch)
from repro_torch.serving.requests import Request, RequestStatus


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


class ServeEngine:
    """Serve a request list through an :class:`ExecutedBackend` built for
    ``model`` (its config and precision policy) on the analytic
    ``device`` of ``n_chips`` chips, priced by ``energy_model_cls``.
    ``fmt``, when given, must be the model's format."""

    def __init__(self, model, params, *, mode: str = "continuous",
                 max_batch: int = 32, max_prefill_batch: int = 8,
                 buf_len: int = 256, record_logits: bool = False,
                 fmt: Optional[str] = None, device: DeviceSpec = H100_SXM,
                 n_chips: int = 1, energy_model_cls=EnergyModel):
        if mode not in ("continuous", "sequential"):
            raise ValueError(mode)
        if max_batch < 1 or max_prefill_batch < 1:
            raise ValueError("max_batch and max_prefill_batch must be >= 1")
        if fmt is not None and fmt != model.policy.fmt:
            raise ValueError(f"fmt={fmt!r} conflicts with the model's "
                             f"precision policy ({model.policy.fmt!r})")
        self.mode = mode
        self.max_batch = max_batch
        self.max_prefill_batch = max_prefill_batch
        self.stack = "fused" if mode == "continuous" else "eager"
        self.backend = ExecutedBackend(
            model, params, max_batch=max_batch, buf_len=buf_len,
            record_logits=record_logits, device=device, n_chips=n_chips,
            energy_model_cls=energy_model_cls)
        self.phases: List[PhaseResult] = []

    def run(self, requests: List[Request]) -> ServeReport:
        late = [r.req_id for r in requests if r.effective_arrival > 0]
        if late:
            raise ValueError(f"requests {late} arrive after t=0; arrival "
                             "schedules wait for ROADMAP A4(a)")
        self.phases = []
        if self.mode == "sequential":
            return self._run_sequential(requests)
        return self._run_continuous(requests)

    # ------------------------------------------------------------------
    def _run_sequential(self, reqs: List[Request]) -> ServeReport:
        b = self.backend
        b.start()
        now, busy_e, busy_t = 0.0, 0.0, 0.0
        for r in reqs:
            r.status = RequestStatus.RUNNING
            r.t_prefill_start = now
            pre = b.prefill(PrefillBatch(picks=[(None, r)],
                                         pad_len=r.prompt_len,
                                         stack=self.stack))
            self.phases.append(pre)
            now += pre.latency_s
            r.t_first_token = now
            r.prefilled_tokens = r.prompt_len
            r.tokens_generated = 1
            dec_steps = max(r.max_new_tokens - 1, 0)
            e = pre.energy_j
            if dec_steps:
                dec = b.decode_tail(r, dec_steps, stack=self.stack)
                self.phases.append(dec)
                now += dec.latency_s
                e += dec.energy_j
                r.tokens_generated += dec_steps
            busy_t += now - r.t_prefill_start
            r.energy_j = e
            busy_e += e
            r.t_done = now
            r.status = RequestStatus.DONE
            b.finish_request(r)
        return ServeReport(requests=list(reqs), total_energy_j=busy_e,
                           busy_energy_j=busy_e, idle_energy_j=0.0,
                           wall_time_s=now, busy_time_s=busy_t,
                           mean_batch=1.0, n_prefill_batches=len(reqs),
                           n_decode_steps=sum(r.tokens_generated - 1
                                              for r in reqs))

    def _admit(self, waiting: List[Request], free: List[int]):
        """SlotCountPolicy.admit_now with bucket grouping."""
        picks = []
        if not (waiting and free):
            return picks
        head_bucket = bucket_length(waiting[0].prompt_len)
        i = 0
        while i < len(waiting) and free \
                and len(picks) < self.max_prefill_batch:
            req = waiting[i]
            if picks and bucket_length(req.prompt_len) != head_bucket:
                i += 1
                continue
            del waiting[i]
            picks.append((free.pop(0), req))
        return picks

    def _run_continuous(self, reqs: List[Request]) -> ServeReport:
        b = self.backend
        b.start()
        waiting = list(reqs)
        free = list(range(self.max_batch))          # sorted ascending
        ready: List[int] = []                       # live slots, sorted
        slots: List[Request] = [None] * self.max_batch
        now = busy_e = busy_t = batch_time = decode_time = 0.0
        n_prefills = n_decode = computed = effective = 0
        n_done = 0
        while n_done < len(reqs):
            picks = self._admit(waiting, free)
            if picks:
                pad = bucket_length(max(r.prompt_len for _, r in picks))
                res = b.prefill(PrefillBatch(picks, pad, stack=self.stack))
                self.phases.append(res)
                now += res.latency_s
                busy_t += res.latency_s
                busy_e += res.energy_j
                n_prefills += 1
                for slot, r in picks:
                    r.status = RequestStatus.RUNNING
                    r.t_prefill_start = now - res.latency_s
                    r.t_first_token = now
                    r.tokens_generated = 1
                    r.energy_j += res.energy_j / len(picks)
                    r.prefilled_tokens = r.prompt_len
                    slots[slot] = r
                    bisect.insort(ready, slot)
                computed += len(picks) * pad
                effective += sum(r.prompt_len for _, r in picks)
            elif ready:
                live = list(ready)
                live_reqs = [slots[i] for i in live]
                res = b.decode_step(DecodeBatch(
                    slots=live, requests=live_reqs,
                    cache_lens=[r.prompt_len + r.tokens_generated
                                for r in live_reqs],
                    stack=self.stack))
                self.phases.append(res)
                now += res.latency_s
                busy_t += res.latency_s
                busy_e += res.energy_j
                decode_time += res.latency_s
                batch_time += res.latency_s * len(live)
                n_decode += 1
                for r in live_reqs:
                    r.tokens_generated += 1
                    r.energy_j += res.energy_j / len(live)
            else:
                raise RuntimeError("no request can be scheduled")
            for i in list(ready):
                r = slots[i]
                if r.tokens_generated >= r.max_new_tokens:
                    r.t_done = now
                    r.status = RequestStatus.DONE
                    ready.remove(i)
                    slots[i] = None
                    bisect.insort(free, i)
                    b.release_slot(i)
                    n_done += 1
        return ServeReport(
            requests=list(reqs), total_energy_j=busy_e,
            busy_energy_j=busy_e, idle_energy_j=0.0, wall_time_s=now,
            busy_time_s=busy_t,
            mean_batch=batch_time / decode_time if decode_time else 0.0,
            n_prefill_batches=n_prefills, n_decode_steps=n_decode,
            prefill_computed_tokens=computed,
            prefill_effective_tokens=effective)
