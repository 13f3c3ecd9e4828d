"""Serving loop over the executed backend.

Counterpart of the part of ``repro.serving.engine.ServeEngine`` that
slice 1 needs, with the reference's scheduling decisions:

* ``mode="continuous"``: ``SlotCountPolicy`` admission. Waiting requests
  are taken first come first served into the lowest free decode slots,
  up to ``max_prefill_batch`` per prefill phase, grouped by prompt-length
  bucket with the queue head. A phase is a prefill whenever a request can
  be admitted, else one decode step over the live slots. A request
  leaves its slot once it has ``max_new_tokens`` tokens.
* ``mode="sequential"``: each request runs alone, start to end.

All requests arrive at t=0. The KV page pool is not modelled: the
reference's default pool (2**15 pages of 128 tokens) never blocks at the
sizes this engine serves. Arrival schedules, schedulers, traces, faults
and the energy report wait for ROADMAP A5. ``run`` returns the requests
with ``generated`` filled in; ``phases`` holds each executed phase.
"""
from __future__ import annotations

import bisect
from typing import List

from repro_torch.batching.static import bucket_length
from repro_torch.serving.backend import (DecodeBatch, ExecutedBackend,
                                         PhaseResult, PrefillBatch)
from repro_torch.serving.requests import Request, RequestStatus


class ServeEngine:
    def __init__(self, model, params, *, mode: str = "continuous",
                 max_batch: int = 32, max_prefill_batch: int = 8,
                 buf_len: int = 256, record_logits: bool = False):
        if mode not in ("continuous", "sequential"):
            raise ValueError(mode)
        if max_batch < 1 or max_prefill_batch < 1:
            raise ValueError("max_batch and max_prefill_batch must be >= 1")
        self.mode = mode
        self.max_batch = max_batch
        self.max_prefill_batch = max_prefill_batch
        self.backend = ExecutedBackend(model, params, max_batch=max_batch,
                                       buf_len=buf_len,
                                       record_logits=record_logits)
        self.phases: List[PhaseResult] = []

    def run(self, requests: List[Request]) -> List[Request]:
        self.phases = []
        if self.mode == "sequential":
            self._run_sequential(requests)
        else:
            self._run_continuous(requests)
        return requests

    # ------------------------------------------------------------------
    def _run_sequential(self, reqs: List[Request]) -> None:
        self.backend.start()
        for r in reqs:
            r.status = RequestStatus.RUNNING
            self.backend.finish_request(r)
            r.prefilled_tokens = r.prompt_len
            r.tokens_generated = r.max_new_tokens
            r.status = RequestStatus.DONE

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

    def _run_continuous(self, reqs: List[Request]) -> None:
        b = self.backend
        b.start()
        waiting = list(reqs)
        free = list(range(self.max_batch))          # sorted ascending
        ready: List[int] = []                       # live slots, sorted
        slots: List[Request] = [None] * self.max_batch
        n_done = 0
        while n_done < len(reqs):
            picks = self._admit(waiting, free)
            if picks:
                pad = bucket_length(max(r.prompt_len for _, r in picks))
                self.phases.append(b.prefill(PrefillBatch(picks, pad)))
                for slot, r in picks:
                    r.status = RequestStatus.RUNNING
                    r.prefilled_tokens = r.prompt_len
                    r.tokens_generated = 1
                    slots[slot] = r
                    bisect.insort(ready, slot)
            elif ready:
                live = list(ready)
                live_reqs = [slots[i] for i in live]
                self.phases.append(b.decode_step(
                    DecodeBatch(slots=live, requests=live_reqs)))
                for r in live_reqs:
                    r.tokens_generated += 1
            else:
                raise RuntimeError("no request can be scheduled")
            for i in list(ready):
                r = slots[i]
                if r.tokens_generated >= r.max_new_tokens:
                    r.status = RequestStatus.DONE
                    ready.remove(i)
                    slots[i] = None
                    bisect.insort(free, i)
                    b.release_slot(i)
                    n_done += 1
