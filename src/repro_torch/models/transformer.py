"""The dense decoder stack: init, attention and FFN blocks, full-sequence
forward (prefill) and one-token decode against a ring-buffer KV cache.

Counterpart of the dense parts of ``repro.models.transformer``. The
reference scans over layers stacked on a leading axis; here the layers
are a list of per-layer parameter dicts and a Python loop walks them.
Decode writes the cache in place. Prefill attention, at every length,
is the flash attention kernel, which computes what the reference's
``attention``/``chunked_attention`` compute; decode attention is the
paged attention kernel over the ring cache viewed as pages, except for
windowed and int8-KV models (see :func:`decoder_decode_step`). MoE and
cross-attention raise NotImplementedError (ROADMAP A4).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.models.layers import (apply_rope, attention,
                                       cache_write_decode,
                                       decode_attention_mask, gated_mlp,
                                       PREFILL_PAST_RING, ring_cache_pages,
                                       rms_norm)
from repro_torch.quant.apply import linear_apply


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def linear_init(generator: torch.Generator, in_dim: int, out_dim: int,
                dtype, scale: Optional[float] = None) -> torch.Tensor:
    """Normal (in, out) weight with std in_dim**-0.5, drawn in f32 on the
    generator's device."""
    if scale is None:
        scale = in_dim ** -0.5
    w = torch.randn((in_dim, out_dim), generator=generator,
                    dtype=torch.float32, device=generator.device)
    return (w * scale).to(dtype)


def init_attn_params(generator: torch.Generator, cfg: ModelConfig,
                     dtype) -> Dict[str, Any]:
    D, hd = cfg.d_model, cfg.head_dim
    dev = generator.device
    p = {
        "wq": linear_init(generator, D, cfg.num_heads * hd, dtype),
        "wk": linear_init(generator, D, cfg.num_kv_heads * hd, dtype),
        "wv": linear_init(generator, D, cfg.num_kv_heads * hd, dtype),
        "wo": linear_init(generator, cfg.num_heads * hd, D, dtype),
    }
    if cfg.use_bias:
        p["bq"] = torch.zeros((cfg.num_heads * hd,), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((cfg.num_kv_heads * hd,), dtype=dtype,
                              device=dev)
        p["bv"] = torch.zeros((cfg.num_kv_heads * hd,), dtype=dtype,
                              device=dev)
    return p


def init_mlp_params(generator: torch.Generator, cfg: ModelConfig,
                    dtype) -> Dict[str, Any]:
    D, F = cfg.d_model, cfg.d_ff
    return {
        "w_gate": linear_init(generator, D, F, dtype),
        "w_up": linear_init(generator, D, F, dtype),
        "w_down": linear_init(generator, F, D, dtype),
    }


def init_decoder_layer(generator: torch.Generator, cfg: ModelConfig,
                       dtype) -> Dict[str, Any]:
    if cfg.is_moe:
        raise NotImplementedError("MoE layers are not ported yet "
                                  "(ROADMAP A4)")
    dev = generator.device
    return {
        "attn_norm": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
        "attn": init_attn_params(generator, cfg, dtype),
        "mlp_norm": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
        "mlp": init_mlp_params(generator, cfg, dtype),
    }


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------
def _project_qkv(p: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig,
                 policy: PrecisionPolicy):
    B, S = x.shape[0], x.shape[1]
    hd = cfg.head_dim
    q = linear_apply(p["wq"], x, policy)
    k = linear_apply(p["wk"], x, policy)
    v = linear_apply(p["wv"], x, policy)
    if "bq" in p:
        q = q + p["bq"].to(q.dtype)
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    return (q.reshape(B, S, cfg.num_heads, hd),
            k.reshape(B, S, cfg.num_kv_heads, hd),
            v.reshape(B, S, cfg.num_kv_heads, hd))


def attn_block_seq(p: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig,
                   policy: PrecisionPolicy, *, causal: bool = True,
                   window: Optional[int] = None,
                   positions: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Self-attention over a full sequence. Returns (out, k_rot, v)."""
    B, S = x.shape[0], x.shape[1]
    xn = rms_norm(x, p["attn_norm"])
    q, k, v = _project_qkv(p["attn"], xn, cfg, policy)
    if positions is None:
        positions = torch.arange(S, device=x.device)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = flash_attention(q, k, v, causal=causal, window=window)
    o = linear_apply(p["attn"]["wo"], o.reshape(B, S, -1), policy)
    return x + o, k, v


def ffn_block(p: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig,
              policy: PrecisionPolicy) -> torch.Tensor:
    if cfg.is_moe:
        raise NotImplementedError("the MoE FFN is not ported yet "
                                  "(ROADMAP A4)")
    return x + gated_mlp(p["mlp"], rms_norm(x, p["mlp_norm"]), policy)


def quantize_kv(x: torch.Tensor):
    """absmax int8 quantization over head_dim (the last axis).

    x: (..., hd) -> (codes int8 (..., hd), scale f32 (...,))."""
    x32 = x.float()
    absmax = x32.abs().amax(dim=-1)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    codes = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127) \
        .to(torch.int8)
    return codes, scale.float()


def dequantize_kv(codes: torch.Tensor, scale: torch.Tensor,
                  dtype) -> torch.Tensor:
    return (codes.float() * scale[..., None]).to(dtype)


def decoder_forward_seq(layers: List[Dict[str, Any]], x: torch.Tensor,
                        cfg: ModelConfig, policy: PrecisionPolicy, *,
                        causal: bool = True,
                        window: Optional[int] = None,
                        collect_kv: bool = False):
    """Run the decoder stack over a full sequence.

    Returns (hidden, (k, v) stacked as (L, B, S, Kv, hd) or None)."""
    ks, vs = [], []
    for lp in layers:
        x, k, v = attn_block_seq(lp, x, cfg, policy, causal=causal,
                                 window=window)
        x = ffn_block(lp, x, cfg, policy)
        if collect_kv:
            ks.append(k)
            vs.append(v)
    kv = (torch.stack(ks), torch.stack(vs)) if collect_kv else None
    return x, kv


def decoder_decode_step(layers: List[Dict[str, Any]], x: torch.Tensor,
                        cache: Dict[str, Any], cfg: ModelConfig,
                        policy: PrecisionPolicy, *,
                        window: Optional[int] = None) -> torch.Tensor:
    """One-token decode. x: (B, 1, D). ``cache`` (see
    ``layers.init_kv_cache``; int8 K/V when it holds ``k_scale``) is
    updated in place: this token's K/V and slot position are written and
    ``pos`` advances by one. Returns the hidden state (B, 1, D)."""
    pos = cache["pos"]                                         # (B,)
    W = cache["k"].shape[2]
    B = x.shape[0]
    rows = torch.arange(B, device=x.device)
    slot = pos.long() % W
    cache["slot_pos"][rows, slot] = pos
    quant = "k_scale" in cache
    # The paged kernel sees the first min(pos + 1, W) slots of each row,
    # which are exactly the slots the decode mask allows while every row
    # came from a prefill no longer than the ring (ring_cache_pages); a
    # cache marked PREFILL_PAST_RING keeps -1 pad slots among them. The
    # kernel reads no int8 codes, so int8-KV models keep the masked
    # attention. So do windowed models: their ring is at most the window
    # long and their prompts routinely run past it, which marks most of
    # their caches anyway, and one decode path per model is simpler to
    # hold against the reference.
    paged = (window is None and not quant
             and not cache.get(PREFILL_PAST_RING, False))
    if paged:
        k_pages, v_pages, page_table, seq_lens = ring_cache_pages(
            cache["k"], cache["v"], pos)
    else:
        allow = decode_attention_mask(cache["slot_pos"], pos, window)
        mask = allow[:, None, :]                               # (B, 1, W)
    pos1 = pos[:, None]
    for i, lp in enumerate(layers):
        ck, cv = cache["k"][i], cache["v"][i]
        xn = rms_norm(x, lp["attn_norm"])
        q, k, v = _project_qkv(lp["attn"], xn, cfg, policy)
        q = apply_rope(q, pos1, cfg.rope_theta)
        k = apply_rope(k, pos1, cfg.rope_theta)
        if quant:
            kq, ksc = quantize_kv(k)
            vq, vsc = quantize_kv(v)
            cache_write_decode(ck, cv, kq, vq, pos)
            ks, vs = cache["k_scale"][i], cache["v_scale"][i]
            ks[rows, slot] = ksc[:, 0]
            vs[rows, slot] = vsc[:, 0]
            kf = dequantize_kv(ck, ks, policy.activation_dtype)
            vf = dequantize_kv(cv, vs, policy.activation_dtype)
            o = attention(q, kf, vf, mask=mask)
        else:
            cache_write_decode(ck, cv, k, v, pos)
            if paged:
                o = paged_attention(q[:, 0], k_pages[i], v_pages[i],
                                    page_table, seq_lens)[:, None]
            else:
                o = attention(q, ck, cv, mask=mask)
        x = x + linear_apply(lp["attn"]["wo"], o.reshape(B, 1, -1), policy)
        x = ffn_block(lp, x, cfg, policy)
    cache["pos"] = pos + 1
    return x
