"""Paged KV-cache accounting (vLLM-style): the port's own copy of
``repro.batching.kvcache``.

The allocator is host-side bookkeeping: sequences own chains of
fixed-size pages. It is the pool the scheduler admits by, not the
device cache: the executed backend keeps one ring a decode slot
(``Model.init_cache``), which the paged attention kernel reads through
its own page view.

The serving engine uses this for admission control (a request is only
scheduled when its worst-case page demand fits) and to measure memory
fragmentation — which feeds the energy model's batch-size ceiling.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np


@dataclasses.dataclass
class PageTable:
    """Per-sequence page chain. ``pages[i]`` backs tokens
    [i*page_size, (i+1)*page_size)."""
    seq_id: int
    pages: List[int]
    n_tokens: int = 0


class PagedKVAllocator:
    def __init__(self, n_pages: int, page_size: int = 128):
        self.n_pages = n_pages
        self.page_size = page_size
        self.free: List[int] = list(range(n_pages - 1, -1, -1))
        self.tables: Dict[int, PageTable] = {}
        #: owner count for pages held by >1 table (absent == 1 owner)
        self._shared: Dict[int, int] = {}
        #: outstanding prefix-fork reservations per sequence
        self._pins: Dict[int, int] = {}
        #: released-but-pinned tables kept alive for pending forks
        self.lingering: Dict[int, PageTable] = {}

    # ------------------------------------------------------------------
    def pages_needed(self, n_tokens: int) -> int:
        return (n_tokens + self.page_size - 1) // self.page_size

    def can_allocate(self, n_tokens: int) -> bool:
        return len(self.free) >= self.pages_needed(n_tokens)

    def allocate(self, seq_id: int, n_tokens: int) -> PageTable:
        if seq_id in self.tables:
            raise KeyError(f"seq {seq_id} already allocated")
        need = self.pages_needed(n_tokens)
        if need > len(self.free):
            raise MemoryError(
                f"need {need} pages, {len(self.free)} free")
        if need:
            pages = self.free[-need:][::-1]    # == [pop() * need]
            del self.free[-need:]
        else:
            pages = []
        t = PageTable(seq_id=seq_id, pages=pages, n_tokens=n_tokens)
        self.tables[seq_id] = t
        return t

    def extend(self, seq_id: int, n_new_tokens: int = 1) -> PageTable:
        t = self.tables[seq_id]
        new_total = t.n_tokens + n_new_tokens
        need = self.pages_needed(new_total) - len(t.pages)
        if need > len(self.free):
            raise MemoryError("out of KV pages")
        for _ in range(need):
            t.pages.append(self.free.pop())
        t.n_tokens = new_total
        return t

    def extend_many(self, seq_ids: List[int], k: int) -> None:
        """Extend every sequence in ``seq_ids`` by ``k`` tokens — the
        macro-step form of per-step :meth:`extend` calls (identical
        page pops, one pass)."""
        free, tables, ps = self.free, self.tables, self.page_size
        for sid in seq_ids:
            t = tables[sid]
            new_total = t.n_tokens + k
            need = (new_total + ps - 1) // ps - len(t.pages)
            if need > 0:
                if need > len(free):
                    raise MemoryError("out of KV pages")
                for _ in range(need):
                    t.pages.append(free.pop())
            t.n_tokens = new_total

    def release(self, seq_id: int) -> None:
        t = self.tables.pop(seq_id)
        if self._pins.get(seq_id, 0) > 0:
            self.lingering[seq_id] = t       # kept alive for forks
        else:
            self._free_pages(t.pages)

    def _free_pages(self, pages: List[int]) -> None:
        """Drop one ownership per page; a page returns to the free
        list (historical reversed-append order) only at zero owners."""
        shared = self._shared
        if not shared:                  # no co-owned pages anywhere
            self.free.extend(reversed(pages))
            return
        for p in reversed(pages):
            c = shared.get(p)
            if c is None:
                self.free.append(p)
            elif c == 2:
                del shared[p]
            else:
                shared[p] = c - 1

    # -- prefix sharing ------------------------------------------------
    def pin(self, seq_id: int, n: int = 1) -> None:
        """Reserve ``seq_id``'s pages for ``n`` future prefix forks:
        release() then parks the table in :attr:`lingering` instead of
        freeing it, until every pin is consumed."""
        if n > 0:
            self._pins[seq_id] = self._pins.get(seq_id, 0) + n

    def unpin(self, seq_id: int) -> None:
        """Consume one pin; at zero a lingering table is freed."""
        c = self._pins.get(seq_id, 0)
        if c <= 1:
            self._pins.pop(seq_id, None)
            t = self.lingering.pop(seq_id, None)
            if t is not None:
                self._free_pages(t.pages)
        else:
            self._pins[seq_id] = c - 1

    def unpin_all(self, seq_id: int) -> None:
        """Drop every outstanding pin on ``seq_id`` (a fault aborted
        the forks it was reserved for); a lingering table is freed."""
        if self._pins.pop(seq_id, None) is not None:
            t = self.lingering.pop(seq_id, None)
            if t is not None:
                self._free_pages(t.pages)

    def has_seq(self, seq_id: int) -> bool:
        return seq_id in self.tables or seq_id in self.lingering

    def fork_prefix(self, parent_id: int, child_id: int,
                    share_tokens: int, total_tokens: int) -> PageTable:
        """Allocate ``child_id`` reusing the parent's first
        ``share_tokens`` (page-aligned) tokens of KV: those pages are
        co-owned, the remainder up to ``total_tokens`` comes fresh from
        the free pool. Consumes one pin on the parent."""
        if child_id in self.tables:
            raise KeyError(f"seq {child_id} already allocated")
        parent = self.tables.get(parent_id)
        if parent is None:
            parent = self.lingering.get(parent_id)
        if parent is None:
            raise KeyError(f"fork parent {parent_id} not resident")
        ps = self.page_size
        if share_tokens % ps:
            raise ValueError("share_tokens must be page-aligned")
        n_share = share_tokens // ps
        if n_share > len(parent.pages) or share_tokens > total_tokens:
            raise ValueError("shared prefix exceeds parent/child extent")
        need = self.pages_needed(total_tokens) - n_share
        if need > len(self.free):
            raise MemoryError(
                f"need {need} pages, {len(self.free)} free")
        shared_pages = parent.pages[:n_share]
        for p in shared_pages:
            self._shared[p] = self._shared.get(p, 1) + 1
        pages = list(shared_pages)
        pages += [self.free.pop() for _ in range(need)]
        t = PageTable(seq_id=child_id, pages=pages,
                      n_tokens=total_tokens)
        self.tables[child_id] = t
        self.unpin(parent_id)
        return t

    # ------------------------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self.free)

    @property
    def used_pages(self) -> int:
        return self.n_pages - len(self.free)

    def max_uniform_extend(self, seq_ids: List[int], k: int) -> int:
        """Largest ``j <= k`` such that extending every sequence in
        ``seq_ids`` by ``j`` tokens fits the free pool.

        This is the KV-page-exhaustion bound of a decode event horizon:
        within ``j`` steps no ``extend`` can raise ``MemoryError``, and
        the first infeasible step (if any) is ``j + 1``. Page demand is
        monotone in ``j``, so a quick full-``k`` check falls back to
        binary search only when the pool actually binds.
        """
        if k <= 0 or not seq_ids:
            return max(k, 0)
        free = len(self.free)
        ps = self.page_size
        # O(1) sufficiency check: k new tokens cross at most
        # k // page_size + 1 page boundaries per sequence
        if len(seq_ids) * (k // ps + 1) <= free:
            return k
        toks = [self.tables[s].n_tokens for s in seq_ids]
        held = sum(len(self.tables[s].pages) for s in seq_ids)

        def need(j: int) -> int:
            return sum((t + j + ps - 1) // ps for t in toks) - held

        if need(k) <= free:
            return k
        lo, hi = 0, k               # need(lo) <= free < need(hi)
        while hi - lo > 1:
            mid = (lo + hi) // 2
            if need(mid) <= free:
                lo = mid
            else:
                hi = mid
        return lo

    def utilization(self) -> float:
        """Fraction of *allocated* slots actually holding tokens —
        1 - internal fragmentation."""
        used = self.used_pages
        if used == 0:
            return 1.0
        toks = sum(t.n_tokens for t in self.tables.values())
        return toks / (used * self.page_size)

    def page_table_array(self, seq_id: int, max_pages: int) -> np.ndarray:
        """Fixed-width int32 page table row for the device kernel."""
        t = self.tables[seq_id]
        row = np.full((max_pages,), -1, np.int32)
        row[:len(t.pages)] = t.pages
        return row

    def check_invariants(self) -> None:
        """Ownership counts match the share table, free+owned == all
        (property tests)."""
        counts: Dict[int, int] = {}
        for t in list(self.tables.values()) + list(
                self.lingering.values()):
            for p in t.pages:
                counts[p] = counts.get(p, 0) + 1
        for p, c in counts.items():
            assert c == self._shared.get(p, 1), \
                f"page {p}: {c} owners, share table says " \
                f"{self._shared.get(p, 1)}"
        assert not (set(self._shared) - set(counts)), "stale share entry"
        assert len(self.free) == len(set(self.free)), "free-list dup"
        assert not (set(counts) & set(self.free)), "owned page in free"
        assert set(counts) | set(self.free) == set(range(self.n_pages)), \
            "page leak"
        for sid in self.lingering:
            assert self._pins.get(sid, 0) > 0, "unpinned lingering table"
