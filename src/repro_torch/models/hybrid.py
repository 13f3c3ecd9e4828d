"""Zamba2-style hybrid: a Mamba2 backbone and ONE shared attention block
applied after every ``attn_period``-th Mamba layer [arXiv:2411.15242].

Counterpart of ``repro.models.hybrid``. The attention block's weights
are shared by its sites, and each site (n_sites = num_layers //
attn_period) keeps its own KV ring. The reference's ``lax.cond`` over the
layer index is a plain ``if`` here. Prefill attention at each site is
the flash attention kernel; decode attention is the paged attention
kernel over that site's ring viewed as pages
(:func:`repro_torch.models.layers.ring_cache_pages`).

Why the page view is exact here: :func:`forward_seq` sizes the rings at
buf = max(buf_len, S), so a hybrid cache never holds a prefill past its
ring (no -1 pad slot lies among a row's first min(pos + 1, W) slots) and
the model has no sliding window. Those are the two conditions under
which ``ring_cache_pages``' slots are exactly those of the reference's
decode mask. The serving backend caps a padded prefill at its buffer,
and its decode cache has the same ring length, so a cache slotted in
from a prefill keeps the property.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.core.sharded import is_sharded, on_shards
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (cache_write_decode, gated_mlp,
                                       ring_cache_pages, rms_norm, rope_qk,
                                       write_rows)
from repro_torch.models.transformer import _project_qkv, init_decoder_layer
from repro_torch.quant.apply import linear_apply


def n_attn_sites(cfg: ModelConfig) -> int:
    return cfg.num_layers // cfg.attn_period


def _shared_attn_seq(shared: Dict[str, Any], x: torch.Tensor,
                     cfg: ModelConfig, policy: PrecisionPolicy
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The shared block over a sequence: causal attention, then the gated
    MLP, each with its residual. Returns (x, k_rot, v)."""
    B, S = x.shape[0], x.shape[1]
    xn = rms_norm(x, shared["attn_norm"])
    q, k, v = _project_qkv(shared["attn"], xn, cfg, policy)
    positions = torch.arange(S, device=x.device)
    q, k = rope_qk(q, k, positions, cfg.rope_theta)
    o = flash_attention(q, k, v, causal=True)
    x = x + linear_apply(shared["attn"]["wo"], o.reshape(B, S, -1), policy)
    xn = rms_norm(x, shared["mlp_norm"])
    return x + gated_mlp(shared["mlp"], xn, policy), k, v


def forward_seq(params: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig,
                policy: PrecisionPolicy, buf_len: int,
                lengths: torch.Tensor):
    """Full-sequence forward over a right-padded x (B, S, D) whose rows
    hold ``lengths`` real tokens: the Mamba2 stack
    (:func:`repro_torch.models.ssm.forward_seq`) with the shared block
    after every ``attn_period``-th layer.

    Returns (hidden, cache). The cache is the stack's (``ssm_state``,
    ``conv``, ``pos``) and ``shared_k``/``shared_v`` (n_sites, B, buf,
    Kv, hd), ``slot_pos`` (B, buf). ``buf_len``: the ring length for the
    decode that follows; buf = max(buf_len, S), so a prompt is never cut
    to the ring (module docstring)."""
    B, S, _ = x.shape
    period = cfg.attn_period
    buf = max(buf_len, S)
    ks, vs = [], []

    def site(i, x):
        if (i + 1) % period:
            return x
        x, k, v = _shared_attn_seq(params["shared"], x, cfg, policy)
        ks.append(k)
        vs.append(v)
        return x

    x, cache = ssm_mod.forward_seq(params["layers"], x, cfg, policy,
                                   lengths, after_layer=site)

    def ring(kv):            # the sites' K or V, padded to the ring
        if not kv:
            return torch.zeros((0, B, buf, cfg.num_kv_heads, cfg.head_dim),
                               dtype=x.dtype, device=x.device)
        stacked = torch.stack(kv)
        if is_sharded(stacked):              # the dry run: shard by shard
            return on_shards(_pad_ring, list(stacked.placements), stacked,
                             buf - S)
        return _pad_ring(stacked, buf - S)

    idx = torch.arange(buf, device=x.device)[None, :]
    cache.update(
        shared_k=ring(ks), shared_v=ring(vs),
        slot_pos=torch.where(idx < lengths[:, None], idx,
                             torch.full_like(idx, -1)).to(torch.int32))
    return x, cache


def _pad_ring(kv: torch.Tensor, n: int) -> torch.Tensor:
    """The sites' K or V (sites, B, S, Kv, hd) padded by n empty slots
    along S."""
    return F.pad(kv, (0, 0, 0, 0, 0, n))


def decode_step(params: Dict[str, Any], x: torch.Tensor,
                cache: Dict[str, Any], cfg: ModelConfig,
                policy: PrecisionPolicy) -> torch.Tensor:
    """One-token step. x: (B, 1, D). ``cache`` (see :func:`forward_seq`)
    is updated in place: the SSM states and conv caches, this token's K/V
    at each site, its slot position, and ``pos`` advanced by one. Returns
    the hidden state (B, 1, D)."""
    B = x.shape[0]
    period = cfg.attn_period
    shared = params["shared"]
    pos = cache["pos"]                                   # (B,)
    W = cache["shared_k"].shape[2]
    write_rows(pos.long() % W, (cache["slot_pos"], pos))
    k_pages, v_pages, page_table, seq_lens = ring_cache_pages(
        cache["shared_k"], cache["shared_v"], pos)
    pos1 = pos[:, None]

    def site(i, x2d):
        if (i + 1) % period:
            return x2d
        s = i // period
        xn = rms_norm(x2d[:, None, :], shared["attn_norm"])
        q, k, v = _project_qkv(shared["attn"], xn, cfg, policy)
        q, k = rope_qk(q, k, pos1, cfg.rope_theta)
        cache_write_decode(cache["shared_k"][s], cache["shared_v"][s],
                           k, v, pos)
        o = paged_attention(q[:, 0], k_pages[s], v_pages[s], page_table,
                            seq_lens)
        x2d = x2d + linear_apply(shared["attn"]["wo"], o.reshape(B, -1),
                                 policy)
        xn = rms_norm(x2d, shared["mlp_norm"])
        return x2d + gated_mlp(shared["mlp"], xn, policy)

    return ssm_mod.decode_step(params["layers"], x[:, 0, :], cache, cfg,
                               policy, after_layer=site)[:, None, :]


def init_params(generator: torch.Generator, cfg: ModelConfig, dtype,
                prepare: Callable[[Any], Any]) -> Dict[str, Any]:
    """``layers``, a list of Mamba layers, and ``shared``, one decoder
    layer, drawn in that order; ``prepare`` (quantization, or the
    identity) takes each layer as soon as it is drawn."""
    layers = [prepare(ssm_mod.init_mamba_layer(generator, cfg, dtype))
              for _ in range(cfg.num_layers)]
    return {"layers": layers,
            "shared": prepare(init_decoder_layer(generator, cfg, dtype))}
