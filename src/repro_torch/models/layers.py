"""Shared primitives: norms, RoPE, GQA attention (direct and chunked
online-softmax), the ring-buffer KV cache, the gated MLP.

Counterpart of ``repro.models.layers``, with the same layouts at every
public function: q (B, S, H, hd), k/v (B, T, Kv, hd), caches
(L, B, W, Kv, hd). :func:`attention` and :func:`chunked_attention` are
plain PyTorch, as the reference computes them outside any Pallas kernel;
the model's prefill and decode call the attention kernels instead
(``repro_torch.kernels.flash_attention``, ``paged_attention``, the latter
over :func:`ring_cache_pages`). Scores, softmax and sums are f32. The
norm, RoPE of q and k, and the gated activation run through the fused
kernels on the card (``repro_torch.kernels.fused``), one launch each.

Where the reference builds new arrays, the cache functions here write
into the cache tensors in place (:func:`write_rows`; on
DTensors, in the dry run, shard by shard).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from repro_torch.core.precision import PrecisionPolicy
from repro_torch.core.sharded import (gather_dim, is_sharded, on_shards,
                                     split_lookup)
# apply_rope (of one tensor; halves, not interleaved) and
# rope_frequencies are the plain version of rope_qk
from repro_torch.kernels.fused.kernel import (  # noqa: F401
    apply_rope, rope_frequencies)
from repro_torch.kernels.fused.ops import (  # noqa: F401
    rms_norm, rope_qk, silu_mul)
from repro_torch.kernels.paged_attention.kernel import slot_mask
from repro_torch.quant.apply import linear_apply

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------
def embed(tokens: torch.Tensor, table: torch.Tensor,
          dtype=torch.bfloat16) -> torch.Tensor:
    """Rows of the table. On DTensors (the dry run) a table split on its
    vocabulary is looked up shard by shard and the rows summed (one
    all-reduce), the reference's lowering."""
    if is_sharded(tokens, table):
        return split_lookup(
            lambda tab, idx, inside: torch.where(
                inside[..., None], tab[idx], torch.zeros((), dtype=tab.dtype,
                                                         device=tab.device)),
            table, tokens, tokens.placements, 0).to(dtype)
    return table[tokens.long()].to(dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: (B,S,Kv,G,hd)  k: (B,T,Kv,hd) -> (B,Kv,G,S,T), f32."""
    return torch.matmul(q.float().permute(0, 2, 3, 1, 4),
                        k.float().permute(0, 2, 3, 1)[:, :, None])


def _gqa_values(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """p: (B,Kv,G,S,T)  v: (B,T,Kv,hd) -> (B,S,Kv,G,hd), f32 sums of p
    rounded to v's dtype."""
    out = torch.matmul(p.to(v.dtype).float(),
                       v.float().permute(0, 2, 1, 3)[:, :, None])
    return out.permute(0, 3, 1, 2, 4)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              mask: Optional[torch.Tensor] = None,
              causal: bool = False,
              window: Optional[int] = None,
              q_offset: int = 0) -> torch.Tensor:
    """Direct GQA attention.

    q: (B, S, H, hd); k/v: (B, T, Kv, hd). H must be a multiple of Kv.
    ``mask``: optional (B, S, T) boolean of *allowed* positions.
    ``q_offset``: absolute position of q[0].
    Returns (B, S, H, hd) in q's dtype."""
    B, S, H, hd = q.shape
    T, Kv = k.shape[1], k.shape[2]
    G = H // Kv
    if is_sharded(q):
        q = gather_dim(q, 2, Kv)
    scores = _gqa_scores(q.reshape(B, S, Kv, G, hd), k) / math.sqrt(hd)
    qpos = torch.arange(S, device=q.device) + q_offset
    kpos = torch.arange(T, device=q.device)
    allow = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        allow &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        allow &= kpos[None, :] > qpos[:, None] - window
    full = allow[None, None, None]                    # (1,1,1,S,T)
    if mask is not None:
        full = full & mask[:, None, None]
    scores = torch.where(full, scores, torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1)
    out = _gqa_values(p, v)
    return out.reshape(B, S, H, hd).to(q.dtype)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True,
                      window: Optional[int] = None,
                      chunk_q: int = 512,
                      chunk_k: int = 512) -> torch.Tensor:
    """Flash-style online-softmax attention over (chunk_q, chunk_k)
    tiles, so memory grows with chunk_q * chunk_k instead of S^2.
    Shapes as :func:`attention`; odd shapes fall back to it, as in the
    reference."""
    B, S, H, hd = q.shape
    T, Kv = k.shape[1], k.shape[2]
    G = H // Kv
    if S % chunk_q or T % chunk_k:
        return attention(q, k, v, causal=causal, window=window)
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(B, S, Kv, G, hd)
    outs = []
    for qi in range(S // chunk_q):
        q_chunk = qg[:, qi * chunk_q:(qi + 1) * chunk_q]
        qpos = qi * chunk_q + torch.arange(chunk_q, device=q.device)
        m = torch.full((B, Kv, G, chunk_q), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, Kv, G, chunk_q), dtype=torch.float32,
                        device=q.device)
        acc = torch.zeros((B, Kv, G, chunk_q, hd), dtype=torch.float32,
                          device=q.device)
        for ki in range(T // chunk_k):
            k_chunk = k[:, ki * chunk_k:(ki + 1) * chunk_k]
            v_chunk = v[:, ki * chunk_k:(ki + 1) * chunk_k]
            kpos = ki * chunk_k + torch.arange(chunk_k, device=q.device)
            s = _gqa_scores(q_chunk, k_chunk) * scale
            allow = torch.ones((chunk_q, chunk_k), dtype=torch.bool,
                               device=q.device)
            if causal:
                allow &= kpos[None, :] <= qpos[:, None]
            if window is not None:
                allow &= kpos[None, :] > qpos[:, None] - window
            s = torch.where(allow[None, None, None], s,
                            torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] \
                + _gqa_values(p, v_chunk).permute(0, 2, 3, 1, 4)
            m = m_new
        out = acc / torch.clamp(l, min=1e-20)[..., None]   # (B,Kv,G,cq,hd)
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(B, chunk_q, H, hd))
    return torch.cat(outs, dim=1).to(q.dtype)


# ---------------------------------------------------------------------------
# KV cache (ring buffer when windowed)
# ---------------------------------------------------------------------------
def init_kv_cache(n_layers: int, batch: int, buf_len: int, n_kv: int,
                  head_dim: int, dtype=torch.bfloat16,
                  device="cuda") -> Dict[str, Any]:
    """Per-row positions: every slot (batch row) holds its own sequence,
    so ``pos`` is (B,) and ``slot_pos`` is (B, W)."""
    return {
        "k": torch.zeros((n_layers, batch, buf_len, n_kv, head_dim),
                         dtype=dtype, device=device),
        "v": torch.zeros((n_layers, batch, buf_len, n_kv, head_dim),
                         dtype=dtype, device=device),
        # absolute position held in each slot (-1 = empty)
        "slot_pos": torch.full((batch, buf_len), -1, dtype=torch.int32,
                               device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def write_rows(slot: torch.Tensor, *pairs) -> None:
    """dst[b, slot[b]] = value[b] for every row b of each (dst, value) of
    ``pairs``, in place: dst (B, W, ...), slot (B,) int, value (B, ...).
    On DTensors (the dry run) each rank writes its own shards."""
    dst, value = pairs[0]
    if is_sharded(dst, slot, value):
        for dst, value in pairs:
            _write_shards(_write_rows_local, dst, 1, slot, value)
        return
    rows = torch.arange(dst.shape[0], device=dst.device)
    for dst, value in pairs:
        dst[rows, slot] = value.to(dst.dtype)


def _write_rows_local(dst, slot, value) -> None:
    rows = torch.arange(dst.shape[0], device=dst.device)
    dst[rows, slot % dst.shape[1]] = value.to(dst.dtype)


def _write_shards(fn, dst: torch.Tensor, gone: int, *args) -> None:
    """``fn(dst, *args)`` on each rank's shards, the arguments placed to
    match dst's shards: dst's dim ``gone`` is indexed away in them (the
    ring slot, or the layer), so a dim after it is one lower there; a
    (B,) slot index follows dst's rows."""
    from torch.distributed.tensor import Replicate, Shard
    pls = []
    for a in args:
        pl = []
        for p in dst.placements:
            d = p.dim if isinstance(p, Shard) else None
            if d is None or d == gone or (a.ndim == 1 and d != 0):
                pl.append(Replicate())
            else:
                pl.append(Shard(d - 1 if d > gone else d))
        pls.append(pl)
    on_shards(fn, None, dst, *args, in_placements=[dst.placements] + pls)


def cache_write_decode(cache_layer_k: torch.Tensor,
                       cache_layer_v: torch.Tensor,
                       k: torch.Tensor, v: torch.Tensor,
                       pos: torch.Tensor) -> None:
    """Write one token's K/V at per-row ring slot pos % W, in place.

    cache_layer_k/v: (B, W, Kv, hd); k/v: (B, 1, Kv, hd); pos: (B,)."""
    write_rows(pos.long() % cache_layer_k.shape[1], (cache_layer_k, k[:, 0]),
               (cache_layer_v, v[:, 0]))


def decode_attention_mask(slot_pos: torch.Tensor, pos: torch.Tensor,
                          window: Optional[int]) -> torch.Tensor:
    """(B, W) bool: which cache slots each row's current token may see;
    the paged kernel's position test (its plain version's
    :func:`~repro_torch.kernels.paged_attention.kernel.slot_mask`)."""
    return slot_mask(slot_pos, pos, window)


def slot_positions_after_prefill(buf_len: int, lengths: torch.Tensor,
                                 padded_len: int) -> torch.Tensor:
    """(B, buf) slot_pos after a (possibly padded) prefill: slot i of row
    b holds absolute position start+i (start > 0 only when the padded
    prompt exceeded the buffer); pad slots (>= lengths[b]) are -1."""
    idx = torch.arange(buf_len, device=lengths.device)[None, :]
    pos = max(padded_len - buf_len, 0) + idx
    return torch.where(pos < lengths[:, None], pos,
                       torch.full_like(pos, -1)).to(torch.int32)


#: page sizes the ring cache is cut into for paged decode attention,
#: largest first
RING_PAGE_SIZES = (64, 32, 16, 8)


def ring_page_size(buf_len: int) -> int:
    """The largest of :data:`RING_PAGE_SIZES` that divides the ring's
    length, else the length itself (one page per row)."""
    return next((p for p in RING_PAGE_SIZES if buf_len % p == 0), buf_len)


def ring_cache_pages(k: torch.Tensor, v: torch.Tensor, pos: torch.Tensor):
    """The ring cache (..., B, W, Kv, hd) as a page pool
    (..., B*W/page, page, Kv, hd), a view without a copy, with the page
    table (B, W/page) int32 in which row b owns pages b*W/page + j, and
    seq_lens = min(pos + 1, W) int32, for
    :func:`repro_torch.kernels.paged_attention.ops.paged_attention`.

    After this step's K/V is written, the first seq_lens[b] slots of row
    b hold every slot :func:`decode_attention_mask` allows: before the
    ring wraps, a slot at or past pos + 1 holds no position <= pos (a
    prefill keeps positions start + i in slot i, start >= 0, and decode
    writes position p at slot p); after it wraps, the prefix is the whole
    ring. The prefix may also hold slots the mask refuses (-1 pad slots
    of a prefill padded past the ring, positions outside a window): the
    kernel's position test over :func:`ring_pages` of ``slot_pos`` drops
    them."""
    if is_sharded(k, v, pos):
        return _ring_cache_pages_sharded(k, v, pos)
    *lead, B, W, Kv, hd = k.shape
    page = ring_page_size(W)
    n = W // page
    k_pages = k.view(*lead, B * n, page, Kv, hd)
    v_pages = v.view(*lead, B * n, page, Kv, hd)
    page_table = torch.arange(B * n, dtype=torch.int32,
                              device=k.device).view(B, n)
    seq_lens = torch.clamp(pos + 1, max=W).to(torch.int32)
    return k_pages, v_pages, page_table, seq_lens


def _pool_placements(placements, b_dim: int) -> list:
    """The placements of a ring tensor's page view: its pages axis
    (``b_dim``) is sharded wherever the rows or the ring are."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for p in placements:
        d = p.dim if isinstance(p, Shard) else None
        if d in (b_dim, b_dim + 1):
            out.append(Shard(b_dim))
        else:
            out.append(Replicate() if d is None else
                       Shard(d - 1 if d > b_dim else d))
    return out


def _ring_cache_pages_sharded(k, v, pos):
    """:func:`ring_cache_pages` on each rank's shards (the dry run): the
    pool's page axis is sharded wherever the rows or the ring are, the
    page table on its rows and pages, the lengths on the rows."""
    from torch.distributed.tensor import Replicate, Shard
    b_dim = k.ndim - 4
    table, lens = [], []
    for p in k.placements:
        d = p.dim if isinstance(p, Shard) else None
        if d in (b_dim, b_dim + 1):
            table.append(Shard(d - b_dim))
            lens.append(Shard(0) if d == b_dim else Replicate())
        else:
            table.append(Replicate())
            lens.append(Replicate())
    pool = _pool_placements(k.placements, b_dim)
    return on_shards(ring_cache_pages, (pool, pool, table, lens), k, v, pos,
                     in_placements=[k.placements, k.placements, lens])


def ring_pages(x: torch.Tensor, b_dim: int) -> torch.Tensor:
    """A tensor laid out along the ring, (..., B, W, ...) with the rows
    at dim ``b_dim``, viewed as pages (..., B*W/page, page, ...) without a
    copy, aligned with :func:`ring_cache_pages`' pool: the int8 cache's
    scales (L, B, W, Kv) at ``b_dim`` 1, ``slot_pos`` (B, W) at 0. On
    DTensors (the dry run) placed as the pool."""
    if is_sharded(x):
        return on_shards(lambda t: ring_pages(t, b_dim),
                         _pool_placements(x.placements, b_dim), x)
    B, W = x.shape[b_dim], x.shape[b_dim + 1]
    page = ring_page_size(W)
    return x.view(*x.shape[:b_dim], B * (W // page), page,
                  *x.shape[b_dim + 2:])


def encoder_kv_pages(k: torch.Tensor, v: torch.Tensor):
    """The encoder K/V (..., B, T_enc, Kv, hd) as a page pool, a view
    without a copy as :func:`ring_cache_pages` makes it, with
    seq_lens = T_enc for every row: a decode step's cross-attention sees
    every frame, as the reference's unmasked attention does."""
    B, T = k.shape[-4], k.shape[-3]
    return ring_cache_pages(k, v, torch.full((B,), T - 1, dtype=torch.int32,
                                             device=k.device))


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------
def gated_mlp(p: Dict[str, Any], x: torch.Tensor,
              policy: PrecisionPolicy) -> torch.Tensor:
    g = linear_apply(p["w_gate"], x, policy)
    u = linear_apply(p["w_up"], x, policy)
    return linear_apply(p["w_down"], silu_mul(g, u), policy)
