"""Decode-cache slot management for continuous batching.

Counterpart of ``repro.batching.continuous`` lines 319-360. The reference
returns a new cache; here the decode cache is updated in place (a full
copy of a full-width cache per request would cost as much memory as the
cache itself).
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import PREFILL_PAST_RING

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
