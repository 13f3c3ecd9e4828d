"""Continuous (token-level) batching scheduler — TGI/Orca-style: the
port's own copy of ``repro.batching.continuous``, with the decode-cache
slot management of the executed backend updated in place (below).

Slots are the device-side decode batch; requests join at token
boundaries after their prefill and leave the moment they finish
(completed sequences are dropped automatically — the paper's §4
"output tokens are always effective").

Scheduling policy per engine iteration:
  1. admit arrivals into the waiting queue,
  2. ask the :class:`~repro_torch.batching.policy.BatchPolicy` for a prefill
     plan (admission happens inside the policy; the default
     :class:`~repro_torch.batching.policy.SlotCountPolicy` reproduces the
     historical bucketed slot-count behavior bit for bit),
  3. else if any slot is prefill-complete ("ready"): run a DECODE step
     for the ready slots,
  4. else: idle until the next arrival.

The batcher itself is policy-free bookkeeping: queue, slots, paged KV,
and the live/ready/partial slot sets that chunked prefill and
disaggregated handoff need.  The base shape is deliberately the same
policy TGI's router implements (waiting queue + running batch, prefill
preemption), so the arrival-shaping results in §5 transfer.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import TYPE_CHECKING, List, Optional

import torch

from repro_torch.batching.kvcache import PagedKVAllocator
from repro_torch.models.layers import PREFILL_PAST_RING

if TYPE_CHECKING:   # avoid a batching <-> serving import cycle
    from repro_torch.batching.policy import BatchPolicy
    from repro_torch.serving.requests import Request


@dataclasses.dataclass
class SlotState:
    request: Optional["Request"] = None

    @property
    def live(self) -> bool:
        return self.request is not None


class ContinuousBatcher:
    """Slot/queue bookkeeping for the continuous engine.

    Hot-path data structures are incremental so a million-request run
    never rescans: live/free slot sets are maintained sorted on every
    occupy/finish, and the waiting queue is an append-only list behind a
    head pointer with tombstoned mid-queue picks (compacted once the
    dead prefix dominates) — no ``pop(0)``/``pop(i)`` shifting.
    """

    def __init__(self, max_batch: Optional[int] = None, *,
                 kv_pages: int = 1 << 14, page_size: int = 128,
                 max_prefill_batch: Optional[int] = None,
                 bucket_prefill: Optional[bool] = None,
                 policy: Optional["BatchPolicy"] = None):
        from repro_torch.batching.policy import SlotCountPolicy
        if policy is None:
            policy = SlotCountPolicy(
                max_batch=32 if max_batch is None else max_batch,
                max_prefill_batch=(8 if max_prefill_batch is None
                                   else max_prefill_batch),
                bucket_prefill=(True if bucket_prefill is None
                                else bucket_prefill))
        elif max_prefill_batch is not None or bucket_prefill is not None:
            raise ValueError(
                "max_prefill_batch=/bucket_prefill= conflict with "
                "policy=; configure the policy instead")
        elif max_batch is not None and max_batch != policy.max_batch:
            raise ValueError(
                f"max_batch={max_batch} conflicts with "
                f"policy.max_batch={policy.max_batch}")
        self.policy = policy
        max_batch = policy.max_batch
        self.slots = [SlotState() for _ in range(max_batch)]
        self._waiting: List[Optional[Request]] = []
        self._whead = 0             # first possibly-live queue index
        self._n_waiting = 0         # live (non-tombstone) entries
        self._waiting_tokens = 0    # prompt+output tokens queued
        self.kv = PagedKVAllocator(kv_pages, page_size)
        self.max_prefill_batch = policy.max_prefill_batch
        self.bucket_prefill = policy.bucket_prefill
        self._free: List[int] = list(range(max_batch))   # sorted asc
        self._live: List[int] = []                       # sorted asc
        self._ready: List[int] = []     # live, prefill complete (sorted)
        self._partial: List[int] = []   # live, mid-chunked-prefill
        self._live_tokens = 0           # committed prompt+output tokens

    # ------------------------------------------------------------------
    @property
    def waiting(self) -> List["Request"]:
        """Queued requests in FIFO order (materialized view; hot paths
        use :attr:`n_waiting` / :meth:`waiting_head` instead)."""
        return [r for r in self._waiting[self._whead:] if r is not None]

    @property
    def n_waiting(self) -> int:
        return self._n_waiting

    @property
    def waiting_tokens(self) -> int:
        """Outstanding prompt + decode tokens of the queued requests
        (maintained incrementally for the shortest-work router)."""
        return self._waiting_tokens

    def waiting_head(self) -> "Request":
        self._skip_tombstones()
        return self._waiting[self._whead]

    def _skip_tombstones(self) -> None:
        w, i = self._waiting, self._whead
        while i < len(w) and w[i] is None:
            i += 1
        self._whead = i
        if i > 512 and i * 2 > len(w):      # compact the dead prefix
            del w[:i]
            self._whead = 0

    def admit(self, req: "Request") -> None:
        self._waiting.append(req)
        self._n_waiting += 1
        self._waiting_tokens += req.prompt_len + req.max_new_tokens

    def free_slots(self) -> List[int]:
        return list(self._free)

    def live_slots(self) -> List[int]:
        return list(self._live)

    def decode_ready_slots(self) -> List[int]:
        """Live slots whose prefill is complete — the decode batch."""
        return list(self._ready)

    def partial_slots(self) -> List[int]:
        """Live slots mid-chunked-prefill (KV allocated, prompt tokens
        still outstanding)."""
        return list(self._partial)

    @property
    def n_live(self) -> int:
        return len(self._live)

    @property
    def n_ready(self) -> int:
        return len(self._ready)

    @property
    def n_partial(self) -> int:
        return len(self._partial)

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def live_committed_tokens(self) -> int:
        """Committed prompt + max-output tokens of every live slot —
        what :class:`~repro_torch.batching.policy.TokenBudgetPolicy` caps."""
        return self._live_tokens

    # ------------------------------------------------------------------
    def _take(self, i: int, req: "Request") -> int:
        """Consume waiting entry ``i`` into the lowest free slot."""
        self._waiting[i] = None
        self._n_waiting -= 1
        self._waiting_tokens -= req.prompt_len + req.max_new_tokens
        slot = self._free.pop(0)
        if (req.kv_parent is not None
                and 0 < req.prefilled_tokens < req.prompt_len):
            if self.kv.has_seq(req.kv_parent):
                # workflow child: co-own the parent's prefix pages and
                # only allocate fresh pages for the unprefilled
                # remainder
                self.kv.fork_prefix(req.kv_parent, req.req_id,
                                    req.prefilled_tokens,
                                    req.prompt_len)
            else:
                # parent KV no longer resident (destroyed by a crash,
                # or the request failed over to a different replica):
                # fall back to recomputing the full prompt
                req.kv_parent = None
                req.prefilled_tokens = 0
                self.kv.allocate(req.req_id, req.prompt_len)
        else:
            self.kv.allocate(req.req_id, req.prompt_len)
        if req.kv_pin:
            self.kv.pin(req.req_id, req.kv_pin)
        self.slots[slot].request = req
        bisect.insort(self._live, slot)
        if req.prefilled_tokens >= req.prompt_len:
            bisect.insort(self._ready, slot)    # adopted handoff
        else:
            bisect.insort(self._partial, slot)
        self._live_tokens += req.prompt_len + req.max_new_tokens
        return slot

    def schedule_prefill(self) -> List[tuple]:
        """Legacy direct-batcher entry point: admit via the attached
        policy and mark each pick's prefill complete immediately (a
        direct caller treats the prefill as instantaneous bookkeeping;
        the engine instead drives ``policy.schedule_prefill`` so chunked
        plans and backend phases happen in between).

        With the default :class:`~repro_torch.batching.policy.SlotCountPolicy`
        this is the historical bucket-grouped FIFO behavior, verbatim.
        """
        picks = self.policy.admit_now(self, 0.0)
        for slot, _ in picks:
            self.complete_prefill(slot)
        return picks

    def complete_prefill(self, slot: int) -> None:
        """Mark ``slot``'s prompt fully prefilled: it joins the decode
        batch at the next step."""
        req = self.slots[slot].request
        req.prefilled_tokens = req.prompt_len
        if slot in self._partial:
            self._partial.remove(slot)
            bisect.insort(self._ready, slot)

    def note_chunk(self, slot: int, n_tokens: int) -> bool:
        """Account ``n_tokens`` of chunked prefill on ``slot``; returns
        True when the prompt is now fully prefilled (and moves the slot
        into the decode batch)."""
        req = self.slots[slot].request
        req.prefilled_tokens += n_tokens
        if req.prefilled_tokens >= req.prompt_len:
            self.complete_prefill(slot)
            return True
        return False

    def step_decode_bookkeeping(self) -> List[int]:
        """Extend KV for every decode-ready slot by one token; returns
        the ready slots."""
        ready = self.decode_ready_slots()
        slots = self.slots
        self.kv.extend_many([slots[i].request.req_id for i in ready], 1)
        return ready

    def bulk_decode_bookkeeping(self, k: int) -> None:
        """Extend KV for every decode-ready slot by ``k`` tokens at once
        — the macro-step form of ``k`` ``step_decode_bookkeeping`` calls
        (identical page counts; feasibility is pre-checked by the
        engine via :meth:`PagedKVAllocator.max_uniform_extend`)."""
        slots = self.slots
        self.kv.extend_many([slots[i].request.req_id
                             for i in self._ready], k)

    def outstanding_tokens(self) -> int:
        """Tokens of work not yet performed anywhere: queued prompt and
        output tokens plus, for live slots, un-prefilled chunk
        remainders and un-generated outputs.  The single accounting
        method every policy/router sees; conserved against
        ``prefilled_tokens + tokens_generated`` of admitted requests."""
        out = self._waiting_tokens
        slots = self.slots
        for i in self._live:
            r = slots[i].request
            out += ((r.prompt_len - r.prefilled_tokens)
                    + (r.max_new_tokens - r.tokens_generated))
        return out

    # -- fault injection (repro.faults) --------------------------------
    def evict_waiting(self) -> List["Request"]:
        """Drain the waiting queue (graceful drain on a preemption
        notice, or a crash failing queued work): returns the queued
        requests in FIFO order and leaves the queue empty. Live slots
        are untouched."""
        out = [r for r in self._waiting[self._whead:] if r is not None]
        self._waiting = []
        self._whead = 0
        self._n_waiting = 0
        self._waiting_tokens = 0
        return out

    def remove_waiting(self, req: "Request") -> bool:
        """Tombstone one specific queued request (hedged-duplicate
        cancellation). Returns False if it is not queued here."""
        w = self._waiting
        for i in range(self._whead, len(w)):
            if w[i] is req:
                w[i] = None
                self._n_waiting -= 1
                self._waiting_tokens -= (req.prompt_len
                                         + req.max_new_tokens)
                return True
        return False

    def find_slot(self, req: "Request") -> Optional[int]:
        """Slot index currently holding ``req``, if any."""
        for i in self._live:
            if self.slots[i].request is req:
                return i
        return None

    def finish(self, slot: int) -> "Request":
        req = self.slots[slot].request
        self.kv.release(req.req_id)
        self.slots[slot].request = None
        self._live.remove(slot)
        try:
            self._ready.remove(slot)
        except ValueError:
            self._partial.remove(slot)
        self._live_tokens -= req.prompt_len + req.max_new_tokens
        bisect.insort(self._free, slot)
        return req


# --------------------------------------------------------------------------
# decode-cache slot management (the executed serving backend imports
# these). The reference returns a new cache; here the decode cache is
# updated in place (a full copy of a full-width cache per request would
# cost as much memory as the cache itself).
# --------------------------------------------------------------------------
#: batch-axis position of each cache leaf: attention K/V stack layers on
#: axis 0, so the request batch is axis 1; per-slot position counters are
#: batch-major. Unlike the reference's table, the int8-KV scales
#: (L, B, W, Kv) are listed too: with the reference's default axis 0 a
#: prefill batch of 2 cannot be inserted into a decode cache of 4 slots
#: (ROADMAP, faults found against the reference).
CACHE_BATCH_AXIS = {"k": 1, "v": 1, "ssm_state": 1, "conv": 1,
                    "shared_k": 1, "shared_v": 1, "enc_k": 1, "enc_v": 1,
                    "k_scale": 1, "v_scale": 1,
                    "slot_pos": 0, "pos": 0}


def insert_cache_slot(cache: dict, pcache: dict, row: int,
                      slot: int) -> dict:
    """Copy batch row ``row`` of a prefill cache into decode-cache slot
    ``slot``, in place; a prefill padded past the ring marks the decode
    cache with :data:`PREFILL_PAST_RING`. Returns ``cache``."""
    for key, val in cache.items():
        if not torch.is_tensor(val):
            continue
        ax = CACHE_BATCH_AXIS.get(key, 0)
        src = torch.select(pcache[key], ax, row)
        torch.select(val, ax, slot).copy_(src)
    if pcache.get(PREFILL_PAST_RING):
        cache[PREFILL_PAST_RING] = True
    return cache


def evict_cache_slot(cache: dict, slot: int) -> dict:
    """Zero decode-cache slot ``slot`` (a freed request lane), in place.
    Live lanes are independent, so eviction never changes their outputs;
    the serving path skips it, as the reference does. Returns
    ``cache``."""
    for key, val in cache.items():
        if torch.is_tensor(val):
            torch.select(val, CACHE_BATCH_AXIS.get(key, 0), slot).zero_()
    return cache
