"""Batch-formation policies: admission and prefill scheduling as a
first-class, pluggable API.

The paper's batching result is phase-dependent: memory-bound decode
amortizes weight traffic with depth, while compute-bound prefill
saturates early and pays for every padded token.  *How* the serving
engine forms batches — how many requests to admit, which ones, and what
shape each prefill batch takes — therefore decides where a
configuration lands on the Wh/request x p99 frontier.  A
:class:`BatchPolicy` owns exactly those decisions for the continuous
engine:

* :class:`SlotCountPolicy` — admit by free slot count, FIFO with
  head-bucket length grouping.  Bit-identical to the historical engine
  (pinned against ``tests/data/golden_pre_refactor.json``).
* :class:`TokenBudgetPolicy` — cap *committed tokens* in flight
  (prompt + max output), not request count, so a 4k-token prompt counts
  for what it costs.  This is the vLLM/TGI-style token-budget admission
  that holds tail latency under heavy-tailed prompt mixes.
* :class:`LengthSortedPolicy` — admit a minimal-padding window of
  similar-length requests from a bounded lookahead, cutting the padded
  prefill tokens the slot-count policy burns.
* :class:`ChunkedPrefillPolicy` — split long prompts into fixed-size
  chunks interleaved with decode steps (Sarathi-style chunked prefill),
  bounding how long a live decode stalls behind one giant prompt.

The engine's loop never inspects the queue itself: it asks the policy
for a :class:`PrefillPlan` (admission happens inside the call) and
otherwise decodes the ready slots.  Policies see the
:class:`~repro_torch.batching.continuous.ContinuousBatcher` — queue, live
slots, and paged-KV allocator — plus the stream clock, and make all
head-of-line memory-admission decisions through ``batcher.kv`` so the
deadlock accounting of the engine is policy-independent.

Policies are small mutable objects (a few ints of state); build one
per engine replica — sharing an instance across engines shares its
state.  ``make_batch_policy(name, **params)`` is the registry entry
point.

The port's own copy of ``repro.batching.policy``; the adoption path
(``_adopt``) serves the reference's disaggregated handoff, which waits
for ROADMAP A4(b) in the port.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, List, Optional, Tuple

from repro_torch.batching.static import bucket_length

if TYPE_CHECKING:                                     # pragma: no cover
    from repro_torch.batching.continuous import ContinuousBatcher
    from repro_torch.serving.requests import Request

__all__ = [
    "PrefillPlan", "BatchPolicy", "SlotCountPolicy", "TokenBudgetPolicy",
    "LengthSortedPolicy", "ChunkedPrefillPolicy", "BATCH_POLICIES",
    "make_batch_policy",
]


@dataclasses.dataclass
class PrefillPlan:
    """One prefill phase the engine should execute next.

    ``picks`` are ``(slot, request)`` pairs already admitted into the
    batcher by the policy.  For a full prefill, ``pad_len`` is the
    padded sequence length every pick is computed at.  For a chunk
    (``chunk_len > 0``), the plan covers ``chunk_len`` prompt tokens of
    a single request starting at offset ``chunk_start``, and
    ``pad_len == chunk_len`` (chunks are exact, never padded).
    ``adopt`` marks requests whose prefill already ran elsewhere
    (disaggregated handoff): the engine performs no compute phase.
    """
    picks: List[Tuple[int, "Request"]]
    pad_len: int
    chunk_start: int = 0
    chunk_len: int = 0
    adopt: bool = False

    @property
    def is_chunk(self) -> bool:
        return self.chunk_len > 0


class BatchPolicy:
    """Base class: owns admission (``admit_now``) and prefill shaping
    (``schedule_prefill``).  Subclasses override ``admit_now`` and, when
    the batch shape differs from pad-to-bucket, ``_pad`` or ``_plan``."""

    name = "base"
    #: Constructor kwargs accepted via ``policy_params`` in the spec.
    PARAMS: Tuple[str, ...] = ("max_batch", "max_prefill_batch",
                               "bucket_prefill")

    def __init__(self, *, max_batch: int = 32, max_prefill_batch: int = 8,
                 bucket_prefill: bool = True):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_prefill_batch < 1:
            raise ValueError(
                f"max_prefill_batch must be >= 1, got {max_prefill_batch}")
        self.max_batch = int(max_batch)
        self.max_prefill_batch = int(max_prefill_batch)
        self.bucket_prefill = bool(bucket_prefill)

    # -- lifecycle ----------------------------------------------------
    def reset(self) -> None:
        """Clear per-run state; called by ``ServeEngine.stream_start``."""

    # -- admission ----------------------------------------------------
    def can_admit(self, batcher: "ContinuousBatcher") -> bool:
        """Head-of-line admissibility: used by ``stream_can_step`` (and
        the cluster deadlock check) when nothing is live.  Must be
        consistent with ``admit_now``: if this returns True with an
        otherwise-idle batcher, ``schedule_prefill`` must make
        progress."""
        if not (batcher.n_waiting and batcher.free_count):
            return False
        head = batcher.waiting_head()
        need = head.prompt_len + head.max_new_tokens
        if (head.kv_parent is not None
                and 0 < head.prefilled_tokens < head.prompt_len
                and batcher.kv.has_seq(head.kv_parent)):
            need -= head.prefilled_tokens    # prefix pages are forked
        return batcher.kv.can_allocate(need)

    def admit_now(self, batcher: "ContinuousBatcher",
                  now: float) -> List[Tuple[int, "Request"]]:
        """Admit waiting requests into free slots; return the picks."""
        raise NotImplementedError

    # -- prefill shaping ----------------------------------------------
    def schedule_prefill(self, batcher: "ContinuousBatcher",
                         now: float) -> Optional[PrefillPlan]:
        """Return the next prefill phase, or None if decode should run
        (or nothing is admissible).  Adoption of already-prefilled
        requests (disaggregated handoff) is handled here for every
        policy before its own planning."""
        plan = self._adopt(batcher)
        if plan is not None:
            return plan
        plan = self._resume(batcher)
        if plan is not None:
            return plan
        return self._plan(batcher, now)

    def _plan(self, batcher: "ContinuousBatcher",
              now: float) -> Optional[PrefillPlan]:
        picks = self.admit_now(batcher, now)
        if not picks:
            return None
        return PrefillPlan(
            picks=picks,
            pad_len=self._pad([r.prompt_len for _, r in picks]))

    def _pad(self, lens: List[int]) -> int:
        return bucket_length(max(lens)) if self.bucket_prefill \
            else max(lens)

    def _adopt(self, batcher: "ContinuousBatcher") -> Optional[PrefillPlan]:
        """Admit a run of already-prefilled requests at the queue head
        (KV handed off from a prefill replica) without a compute
        phase."""
        if not (batcher.n_waiting and batcher.free_count):
            return None
        head = batcher.waiting_head()
        if head.prefilled_tokens < head.prompt_len:
            return None
        picks: List[Tuple[int, "Request"]] = []
        w = batcher._waiting
        i = batcher._whead
        while i < len(w) and batcher.free_count:
            req = w[i]
            if req is None:
                i += 1
                continue
            if req.prefilled_tokens < req.prompt_len:
                break
            if not batcher.kv.can_allocate(req.prompt_len
                                           + req.max_new_tokens):
                break
            picks.append((batcher._take(i, req), req))
        batcher._skip_tombstones()
        if not picks:
            return None
        return PrefillPlan(picks=picks, pad_len=0, adopt=True)

    def _resume_take(self, batcher: "ContinuousBatcher"):
        """Admit a head-of-line workflow child whose KV prefix still
        lives in the allocator (``kv_parent``): ``_take`` forks the
        parent's prefix pages, so only the unprefilled remainder needs
        fresh pages.  Returns ``(slot, request)`` or None.  A child
        whose parent KV is gone (shed / evicted) falls back to a full
        prefill."""
        if not (batcher.n_waiting and batcher.free_count):
            return None
        head = batcher.waiting_head()
        if not (0 < head.prefilled_tokens < head.prompt_len):
            return None
        if (head.kv_parent is None
                or not batcher.kv.has_seq(head.kv_parent)):
            head.prefilled_tokens = 0
            head.kv_parent = None
            return None
        if not batcher.kv.can_allocate(
                head.prompt_len + head.max_new_tokens
                - head.prefilled_tokens):
            return None                  # head-of-line KV block
        slot = batcher._take(batcher._whead, head)
        batcher._skip_tombstones()
        return slot, head

    def _resume(self, batcher: "ContinuousBatcher") \
            -> Optional[PrefillPlan]:
        """Plan the admitted child's prompt remainder as one exact
        chunk: the compute phase attends to the reused prefix KV but
        only processes the new tokens (the chunked-prefill cost
        model)."""
        taken = self._resume_take(batcher)
        if taken is None:
            return None
        slot, head = taken
        remainder = head.prompt_len - head.prefilled_tokens
        return PrefillPlan(picks=[(slot, head)], pad_len=remainder,
                           chunk_start=head.prefilled_tokens,
                           chunk_len=remainder)

    # -- decode hooks -------------------------------------------------
    def decode_horizon_cap(self,
                           batcher: "ContinuousBatcher") -> Optional[int]:
        """Cap on the macro-step decode horizon, or None for no cap."""
        return None

    def note_decode(self) -> None:
        """Called by the engine after each decode phase executes."""

    # -- accounting ---------------------------------------------------
    def outstanding_tokens(self, batcher: "ContinuousBatcher") -> int:
        """Tokens of work not yet performed: queued prompt + output
        tokens, plus un-prefilled chunk remainders and un-generated
        outputs of live requests.  The single policy-visible accounting
        method used by routers/schedulers (``stream_outstanding_work``)
        and the conservation tests."""
        return batcher.outstanding_tokens()

    def __repr__(self) -> str:                        # pragma: no cover
        return (f"{type(self).__name__}(max_batch={self.max_batch}, "
                f"max_prefill_batch={self.max_prefill_batch})")


class SlotCountPolicy(BatchPolicy):
    """The historical engine behavior, verbatim: FIFO admission into
    free slots up to ``max_prefill_batch`` per phase, head-of-line KV
    blocking, and (optionally) bucket grouping so a 4000-token prompt
    is not padded together with 150-token ones."""

    name = "slot_count"

    def admit_now(self, batcher, now):
        picks: List[Tuple[int, "Request"]] = []
        if not (batcher._n_waiting and batcher._free):
            return picks
        head = batcher.waiting_head()
        kv = batcher.kv
        if not kv.can_allocate(head.prompt_len + head.max_new_tokens):
            return picks                 # head-of-line block: wait
        head_bucket = bucket_length(head.prompt_len) \
            if self.bucket_prefill else None
        i = batcher._whead
        w = batcher._waiting
        free = batcher._free             # alias: mutated in place
        take = batcher._take
        mpb = self.max_prefill_batch
        while i < len(w) and free and len(picks) < mpb:
            req = w[i]
            if req is None:
                i += 1
                continue
            if 0 < req.prefilled_tokens < req.prompt_len:
                break                    # workflow child resumes at head
            if (head_bucket is not None and picks
                    and bucket_length(req.prompt_len) != head_bucket):
                i += 1
                continue
            if not kv.can_allocate(req.prompt_len + req.max_new_tokens):
                break
            picks.append((take(i, req), req))
        batcher._skip_tombstones()
        return picks


class TokenBudgetPolicy(SlotCountPolicy):
    """Admission capped by committed tokens in flight rather than slot
    count: a request commits ``prompt_len + max_new_tokens`` and the
    running sum may not exceed ``token_budget``.  Long prompts count
    for what they cost, so a heavy-tailed mix cannot overfill the batch
    the way slot counting lets it.  A single oversized request is still
    admitted when the engine is otherwise idle (progress guarantee)."""

    name = "token_budget"
    PARAMS = SlotCountPolicy.PARAMS + ("token_budget",)

    def __init__(self, *, token_budget: Optional[int] = None, **kw):
        super().__init__(**kw)
        if token_budget is None:
            raise ValueError(
                "token_budget is required for TokenBudgetPolicy "
                "(e.g. policy_params={'token_budget': 8192})")
        if token_budget < 1:
            raise ValueError(
                f"token_budget must be >= 1 token, got {token_budget}")
        self.token_budget = int(token_budget)

    def admit_now(self, batcher, now):
        picks: List[Tuple[int, "Request"]] = []
        if not (batcher._n_waiting and batcher._free):
            return picks
        head = batcher.waiting_head()
        if not batcher.kv.can_allocate(head.prompt_len
                                       + head.max_new_tokens):
            return picks
        head_bucket = bucket_length(head.prompt_len) \
            if self.bucket_prefill else None
        i = batcher._whead
        w = batcher._waiting
        while (i < len(w) and batcher._free
               and len(picks) < self.max_prefill_batch):
            req = w[i]
            if req is None:
                i += 1
                continue
            if 0 < req.prefilled_tokens < req.prompt_len:
                break                    # workflow child resumes at head
            if (head_bucket is not None and picks
                    and bucket_length(req.prompt_len) != head_bucket):
                i += 1
                continue
            need = req.prompt_len + req.max_new_tokens
            if (batcher.live_committed_tokens + need > self.token_budget
                    and (batcher.n_live or picks)):
                break                    # budget full; stay FIFO-fair
            if not batcher.kv.can_allocate(need):
                break
            picks.append((batcher._take(i, req), req))
        batcher._skip_tombstones()
        return picks


class LengthSortedPolicy(BatchPolicy):
    """Admit the minimal-padding window of similar-length requests from
    a bounded FIFO lookahead of ``window`` queued requests: sort the
    candidates by prompt length and pick the contiguous run of
    ``k = min(max_prefill_batch, free slots, candidates)`` whose padded
    waste ``k * max(lens) - sum(lens)`` is smallest (earliest run on
    ties).  Padding per batch is provably <= the FIFO head batch drawn
    from the same lookahead.  ``patience`` bounds starvation: after
    that many batches formed without the queue head, only windows
    containing the head qualify."""

    name = "length_sorted"
    PARAMS = BatchPolicy.PARAMS + ("window", "patience")

    def __init__(self, *, window: int = 32, patience: int = 4, **kw):
        super().__init__(**kw)
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if patience < 0:
            raise ValueError(f"patience must be >= 0, got {patience}")
        self.window = int(window)
        self.patience = int(patience)
        self._head_skips = 0

    def reset(self):
        self._head_skips = 0

    def _pad(self, lens):
        return max(lens)                 # exact pad; sorting did the work

    def admit_now(self, batcher, now):
        picks: List[Tuple[int, "Request"]] = []
        if not (batcher._n_waiting and batcher._free):
            return picks
        head = batcher.waiting_head()
        if not batcher.kv.can_allocate(head.prompt_len
                                       + head.max_new_tokens):
            return picks                 # preserve head-of-line blocking
        # Candidate lookahead: first `window` queued requests, FIFO.
        cands: List[Tuple[int, "Request"]] = []     # (queue index, req)
        w = batcher._waiting
        i = batcher._whead
        while i < len(w) and len(cands) < self.window:
            r = w[i]
            if r is not None and not (0 < r.prefilled_tokens
                                      < r.prompt_len):
                cands.append((i, r))     # resumable children excluded
            i += 1
        k = min(self.max_prefill_batch, batcher.free_count, len(cands))
        if k == 0:
            return picks
        order = sorted(range(len(cands)),
                       key=lambda j: (cands[j][1].prompt_len, j))
        lens = [cands[j][1].prompt_len for j in order]
        prefix = [0]
        for n in lens:
            prefix.append(prefix[-1] + n)
        head_pos = next(p for p, j in enumerate(order) if j == 0)
        must_include_head = self._head_skips >= self.patience
        best = None                      # (padding cost, start)
        for s0 in range(len(cands) - k + 1):
            if must_include_head and not (s0 <= head_pos < s0 + k):
                continue
            cost = k * lens[s0 + k - 1] - (prefix[s0 + k] - prefix[s0])
            if best is None or cost < best[0]:
                best = (cost, s0)
        _, s0 = best
        chosen = sorted(cands[j] for j in order[s0:s0 + k])
        for qi, req in chosen:           # FIFO order within the window
            if not batcher.kv.can_allocate(req.prompt_len
                                           + req.max_new_tokens):
                break
            picks.append((batcher._take(qi, req), req))
        batcher._skip_tombstones()
        if picks:
            if any(r is head for _, r in picks):
                self._head_skips = 0
            else:
                self._head_skips += 1
        return picks


class ChunkedPrefillPolicy(SlotCountPolicy):
    """Split prompts longer than ``chunk_tokens`` into fixed-size
    prefill chunks interleaved with single decode steps, so live
    decodes advance while a long prompt fills its KV cache instead of
    stalling behind one monolithic prefill.  Chunks are exact (no
    padding); each chunk re-reads the weights, which is the real energy
    cost of chunking.  Prompts at or under ``chunk_tokens`` batch
    normally (slot-count admission restricted to short prompts)."""

    name = "chunked_prefill"
    PARAMS = SlotCountPolicy.PARAMS + ("chunk_tokens",)

    def __init__(self, *, chunk_tokens: int = 512, **kw):
        super().__init__(**kw)
        if chunk_tokens < 1:
            raise ValueError(
                f"chunk_tokens must be >= 1, got {chunk_tokens}")
        self.chunk_tokens = int(chunk_tokens)
        self._interleave = False

    def reset(self):
        self._interleave = False

    def note_decode(self):
        self._interleave = False

    def _resume(self, batcher):
        # admit only: the forked child lands as a partial slot, and
        # _plan's existing partial path chunks the remainder starting
        # from prefilled_tokens (in chunk_tokens pieces)
        self._resume_take(batcher)
        return None

    def decode_horizon_cap(self, batcher):
        # While a partial prefill is outstanding, decode one token at a
        # time so the next chunk is never delayed by a macro horizon.
        return 1 if batcher.n_partial else None

    def _plan(self, batcher, now):
        part = batcher.partial_slots()
        if part:
            if self._interleave and batcher.n_ready:
                return None              # let the ready slots decode
            slot = part[0]
            req = batcher.slots[slot].request
            chunk = min(self.chunk_tokens,
                        req.prompt_len - req.prefilled_tokens)
            self._interleave = True
            return PrefillPlan(picks=[(slot, req)], pad_len=chunk,
                               chunk_start=req.prefilled_tokens,
                               chunk_len=chunk)
        picks = self.admit_now(batcher, now)
        if not picks:
            return None
        if picks[0][1].prompt_len > self.chunk_tokens:
            slot, req = picks[0]         # long head admitted alone
            chunk = min(self.chunk_tokens, req.prompt_len)
            self._interleave = True
            return PrefillPlan(picks=picks, pad_len=chunk,
                               chunk_start=0, chunk_len=chunk)
        return PrefillPlan(
            picks=picks,
            pad_len=self._pad([r.prompt_len for _, r in picks]))

    def admit_now(self, batcher, now):
        if not (batcher._n_waiting and batcher._free):
            return []
        head = batcher.waiting_head()
        if not batcher.kv.can_allocate(head.prompt_len
                                       + head.max_new_tokens):
            return []
        if head.prompt_len > self.chunk_tokens:
            picks = [(batcher._take(batcher._whead, head), head)]
            batcher._skip_tombstones()
            return picks
        head_bucket = bucket_length(head.prompt_len) \
            if self.bucket_prefill else None
        picks: List[Tuple[int, "Request"]] = []
        i = batcher._whead
        w = batcher._waiting
        while (i < len(w) and batcher._free
               and len(picks) < self.max_prefill_batch):
            req = w[i]
            if req is None:
                i += 1
                continue
            if 0 < req.prefilled_tokens < req.prompt_len:
                break                    # workflow child resumes at head
            if req.prompt_len > self.chunk_tokens:
                i += 1                   # long one chunks on its own later
                continue
            if (head_bucket is not None and picks
                    and bucket_length(req.prompt_len) != head_bucket):
                i += 1
                continue
            if not batcher.kv.can_allocate(req.prompt_len
                                           + req.max_new_tokens):
                break
            picks.append((batcher._take(i, req), req))
        batcher._skip_tombstones()
        return picks


_POLICY_CLASSES = {
    SlotCountPolicy.name: SlotCountPolicy,
    TokenBudgetPolicy.name: TokenBudgetPolicy,
    LengthSortedPolicy.name: LengthSortedPolicy,
    ChunkedPrefillPolicy.name: ChunkedPrefillPolicy,
}

BATCH_POLICIES = tuple(_POLICY_CLASSES)


def make_batch_policy(name: str, **params) -> BatchPolicy:
    """Construct a batch policy by registry name.

    Unknown names and unknown/invalid parameters raise ``ValueError``
    with the same structured style as the other experiment axes."""
    try:
        cls = _POLICY_CLASSES[name]
    except KeyError:
        raise ValueError(f"unknown batch policy {name!r}; "
                         f"known: {list(_POLICY_CLASSES)}") from None
    bad = sorted(set(params) - set(cls.PARAMS))
    if bad:
        raise ValueError(f"unknown policy_params for {name!r}: {bad}; "
                         f"known: {sorted(cls.PARAMS)}")
    return cls(**params)
