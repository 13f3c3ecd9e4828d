"""Executed inference backend: real model steps behind the serving loop.

Counterpart of the execution half of ``repro.serving.backend.
ExecutedBackend`` (lines 430-547 there). The engine decides which phase
runs next; the backend runs it on the model and moves rows between the
prefill cache and the decode slots (``repro_torch.batching.continuous``).
The reference's choices are kept:

* a prefill batch is right-padded to a multiple of 8 tokens, capped at
  ``buf_len``;
* ``release_slot`` zeroes the slot's feed token and does not evict the
  cache lane (lanes are independent);
* ``finish_request`` (sequential mode) is a fresh greedy run per request.

The method names are the ``InferenceBackend`` protocol's. Each phase
returns a :class:`PhaseResult` with the phase's host wall time, taken
after the device finished (the argmax is read back). The analytic clock
and energy model wait for ROADMAP A5.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.batching.continuous import insert_cache_slot


@dataclasses.dataclass(frozen=True)
class PhaseResult:
    """What one executed phase took and produced."""

    phase: str                  # "prefill" | "decode"
    latency_s: float            # host wall time, device work included
    tokens: int = 0             # new tokens this phase produced
    batch: float = 0.0          # rows the phase computed for requests


@dataclasses.dataclass
class PrefillBatch:
    """One prefill iteration as the scheduler formed it: ``(slot,
    request)`` pairs (slot None in sequential mode) and the padded length
    the scheduler planned."""

    picks: List[Tuple[Optional[int], Any]]
    pad_len: int

    @property
    def n(self) -> int:
        return len(self.picks)


@dataclasses.dataclass
class DecodeBatch:
    """One decode step: the live slots and their requests."""

    slots: List[int]
    requests: List[Any]


class ExecutedBackend:
    """Greedy execution of prefill and decode phases on a model.

    ``record_logits``: keep each request's first-token logits (f32, on
    the host) in ``first_logits[req_id]``, for checks against a
    sequential run."""

    name = "executed"

    def __init__(self, model, params, *, max_batch: int,
                 buf_len: int = 256, record_logits: bool = False):
        self.model = model
        self.params = params
        self.max_batch = max_batch
        self.buf_len = buf_len
        self.record_logits = record_logits
        self.first_logits: Dict[int, torch.Tensor] = {}
        self.start()

    def start(self) -> None:
        self.cache = self.model.init_cache(self.max_batch, self.buf_len)
        self.slot_tokens = torch.zeros((self.max_batch, 1),
                                       dtype=torch.long,
                                       device=self.model.device)

    # -- protocol -------------------------------------------------------
    def prefill(self, batch: PrefillBatch) -> PhaseResult:
        t0 = time.perf_counter()
        self._execute_prefill(batch.picks)
        return PhaseResult(phase="prefill",
                           latency_s=time.perf_counter() - t0,
                           tokens=batch.n, batch=float(batch.n))

    def decode_step(self, batch: DecodeBatch) -> PhaseResult:
        t0 = time.perf_counter()
        self._execute_decode(batch)
        return PhaseResult(phase="decode",
                           latency_s=time.perf_counter() - t0,
                           tokens=len(batch.slots),
                           batch=float(len(batch.slots)))

    def release_slot(self, slot: int) -> None:
        # zeroing just the feed token keeps freed lanes deterministic;
        # the full lane evict is not run per finish (lanes are
        # independent, so stale state cannot change live outputs)
        self.slot_tokens[slot, 0] = 0

    def finish_request(self, request: Any) -> None:
        """Sequential mode: the real greedy generation end to end, with a
        fresh per-request cache and no slot machinery."""
        r = request
        toks = torch.as_tensor(r.prompt[None, :], dtype=torch.long,
                               device=self.model.device)
        logits, cache = self.model.prefill(
            self.params, {"tokens": toks},
            buf_len=r.prompt_len + r.max_new_tokens + 1)
        self._record(r, logits[0])
        tok = torch.argmax(logits, -1)[:, None]
        r.generated = [int(tok[0, 0])]
        for _ in range(r.max_new_tokens - 1):
            logits, cache = self.model.decode_step(self.params, tok, cache)
            tok = torch.argmax(logits, -1)[:, None]
            r.generated.append(int(tok[0, 0]))

    # -- real execution -------------------------------------------------
    def _record(self, r, logits: torch.Tensor) -> None:
        if self.record_logits:
            self.first_logits[r.req_id] = logits.float().cpu()

    def _execute_prefill(self, picks) -> None:
        exec_pad = max(r.prompt_len for _, r in picks)
        exec_pad = min(((exec_pad + 7) // 8) * 8, self.buf_len)
        toks = np.zeros((len(picks), exec_pad), np.int64)
        lens = np.zeros((len(picks),), np.int32)
        for j, (_, r) in enumerate(picks):
            toks[j, :r.prompt_len] = r.prompt[:exec_pad]
            lens[j] = r.prompt_len
        dev = self.model.device
        logits, pcache = self.model.prefill(
            self.params, {"tokens": torch.from_numpy(toks).to(dev)},
            buf_len=self.buf_len, lengths=torch.from_numpy(lens).to(dev))
        first = torch.argmax(logits, -1).cpu().numpy()
        for j, (slot, r) in enumerate(picks):
            self._record(r, logits[j])
            r.generated = [int(first[j])]
            insert_cache_slot(self.cache, pcache, j, slot)
            self.slot_tokens[slot, 0] = int(first[j])

    def _execute_decode(self, batch: DecodeBatch) -> None:
        logits, self.cache = self.model.decode_step(
            self.params, self.slot_tokens, self.cache)
        nxt = torch.argmax(logits, -1)
        self.slot_tokens = nxt[:, None]
        arr = nxt.cpu().numpy()
        for slot, req in zip(batch.slots, batch.requests):
            req.generated.append(int(arr[slot]))
