"""The decoder stack of the dense, MoE, vlm and audio families: init,
attention, cross-attention and FFN blocks (a gated MLP, or the MoE FFN of
:mod:`repro_torch.models.moe`), full-sequence forward (prefill, and the
audio encoder) and one-token decode against a ring-buffer KV cache.

Counterpart of ``repro.models.transformer``. The reference scans over
layers stacked on a leading axis; here the layers are a list of
per-layer parameter dicts and a Python loop walks them. Decode writes
the cache in place. Prefill attention, at every length, is the flash
attention kernel, which computes what the reference's
``attention``/``chunked_attention`` compute, causal in a decoder and not
in the audio encoder or a cross-attention; decode attention is the paged
attention kernel over the ring cache viewed as pages, for every cache
(16-bit, f32 or int8 K/V; windowed models; caches from a prefill padded
past the ring: see :func:`decoder_decode_step`), and a decode step's
cross-attention is the paged kernel over the encoder K/V
viewed as pages (:func:`repro_torch.models.layers.encoder_kv_pages`).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import moe as moe_mod
from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.core.sharded import split_heads
from repro_torch.models.layers import (cache_write_decode,
                                       encoder_kv_pages, gated_mlp,
                                       ring_cache_pages, ring_pages,
                                       rms_norm, rope_qk, write_rows)
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


def init_moe_params(generator: torch.Generator, cfg: ModelConfig,
                    dtype) -> Dict[str, Any]:
    """The router (D, E), kept in f32, and the experts' stacked
    projections (E, D, F), (E, D, F), (E, F, D), drawn in f32 on the
    generator's device, as the reference's ``init_moe_params`` lays them
    out."""
    D, F, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    dev = generator.device

    def normal(shape, scale):
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=dev)
        return w * scale

    return {
        "w_router": normal((D, E), D ** -0.5),
        "experts_gate": normal((E, D, F), D ** -0.5).to(dtype),
        "experts_up": normal((E, D, F), D ** -0.5).to(dtype),
        "experts_down": normal((E, F, D), F ** -0.5).to(dtype),
    }


def init_decoder_layer(generator: torch.Generator, cfg: ModelConfig,
                       dtype, cross_attention: bool = False
                       ) -> Dict[str, Any]:
    """One decoder layer; with ``cross_attention`` (the audio decoder)
    also ``cross_norm`` and the cross-attention projections ``cross``."""
    dev = generator.device
    p = {
        "attn_norm": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
        "attn": init_attn_params(generator, cfg, dtype),
        "mlp_norm": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
    }
    if cfg.is_moe:
        p["moe"] = init_moe_params(generator, cfg, dtype)
    else:
        p["mlp"] = init_mlp_params(generator, cfg, dtype)
    if cross_attention:
        p["cross_norm"] = torch.ones((cfg.d_model,), dtype=dtype,
                                     device=dev)
        p["cross"] = init_attn_params(generator, cfg, dtype)
    return p


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------
def _project_qkv(p: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig,
                 policy: PrecisionPolicy):
    hd = cfg.head_dim
    q = linear_apply(p["wq"], x, policy)
    k = linear_apply(p["wk"], x, policy)
    v = linear_apply(p["wv"], x, policy)
    if "bq" in p:
        q = q + p["bq"].to(q.dtype)
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    return (split_heads(q, cfg.num_heads, hd),
            split_heads(k, cfg.num_kv_heads, hd),
            split_heads(v, cfg.num_kv_heads, hd))


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
    q, k = rope_qk(q, k, positions, cfg.rope_theta)
    o = flash_attention(q, k, v, causal=causal, window=window)
    o = linear_apply(p["attn"]["wo"], o.reshape(B, S, -1), policy)
    return x + o, k, v


def cross_attn_block(p: Dict[str, Any], x: torch.Tensor,
                     enc_k: Optional[torch.Tensor],
                     enc_v: Optional[torch.Tensor], cfg: ModelConfig,
                     policy: PrecisionPolicy, *, pages=None) -> torch.Tensor:
    """Cross-attention against precomputed encoder K/V (B, T_enc, Kv, hd),
    no rope, every frame visible: the flash kernel, non-causal. With
    ``pages`` (k_pages, v_pages, page_table, seq_lens of
    :func:`~repro_torch.models.layers.encoder_kv_pages`, one layer's) a
    one-token x attends through the paged kernel instead, and
    enc_k/enc_v are not read."""
    B, S = x.shape[0], x.shape[1]
    xn = rms_norm(x, p["cross_norm"])
    q = split_heads(linear_apply(p["cross"]["wq"], xn, policy),
                    cfg.num_heads, cfg.head_dim)
    if pages is None:
        o = flash_attention(q, enc_k, enc_v, causal=False)
    else:
        o = paged_attention(q[:, 0], *pages)[:, None]
    return x + linear_apply(p["cross"]["wo"], o.reshape(B, S, -1), policy)


def ffn_block(p: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig,
              policy: PrecisionPolicy, *, with_aux: bool = True
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The FFN sublayer with its residual: (x, the MoE router's aux
    metrics, empty for a dense layer or without ``with_aux``). An MoE
    layer routes the B * S tokens of x as one set."""
    xn = rms_norm(x, p["mlp_norm"])
    if cfg.is_moe:
        B, S, D = xn.shape
        y, aux = moe_mod.moe_ffn(p["moe"], xn.reshape(B * S, D),
                                 top_k=cfg.experts_per_token, policy=policy,
                                 capacity_factor=cfg.moe_capacity_factor,
                                 with_aux=with_aux)
        return x + y.reshape(B, S, D), aux
    return x + gated_mlp(p["mlp"], xn, policy), {}


#: the MoE router metrics a forward returns (layer means)
MOE_AUX = ("load_balance_loss", "router_z_loss", "dropped_fraction")


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
                        collect_kv: bool = False,
                        enc_kv: Optional[Tuple[torch.Tensor,
                                               torch.Tensor]] = None,
                        remat: bool = False):
    """Run the decoder stack over a full sequence.

    Returns (hidden, (k, v) stacked as (L, B, S, Kv, hd) or None, aux):
    aux is the layer mean of the MoE router metrics (zeros for a dense
    stack), summed layer by layer and divided once, as the reference's
    scan does. ``enc_kv``: the encoder K/V of every layer, each
    (L, B, T_enc, Kv, hd), for a cross-attention after each layer's
    self-attention. ``remat``: each layer under
    ``torch.utils.checkpoint`` (non-reentrant), the reference's
    ``jax.checkpoint``: its activations are recomputed in the backward
    instead of kept."""
    ks, vs = [], []
    aux = {k: torch.zeros((), dtype=torch.float32, device=x.device)
           for k in MOE_AUX}

    def layer(x, i, lp):
        x, k, v = attn_block_seq(lp, x, cfg, policy, causal=causal,
                                 window=window)
        if enc_kv is not None:
            x = cross_attn_block(lp, x, enc_kv[0][i], enc_kv[1][i], cfg,
                                 policy)
        x, a = ffn_block(lp, x, cfg, policy)
        return x, k, v, a

    for i, lp in enumerate(layers):
        if remat:
            x, k, v, a = torch.utils.checkpoint.checkpoint(
                layer, x, i, lp, use_reentrant=False)
        else:
            x, k, v, a = layer(x, i, lp)
        if cfg.is_moe:
            aux = {key: aux[key] + a[key] for key in aux}
        if collect_kv:
            ks.append(k)
            vs.append(v)
    kv = (torch.stack(ks), torch.stack(vs)) if collect_kv else None
    return x, kv, {k: v / cfg.num_layers for k, v in aux.items()}


def decoder_decode_step(layers: List[Dict[str, Any]], x: torch.Tensor,
                        cache: Dict[str, Any], cfg: ModelConfig,
                        policy: PrecisionPolicy, *,
                        window: Optional[int] = None,
                        enc_kv: Optional[Tuple[torch.Tensor,
                                               torch.Tensor]] = None
                        ) -> torch.Tensor:
    """One-token decode. x: (B, 1, D). ``cache`` (see
    ``layers.init_kv_cache``; int8 K/V when it holds ``k_scale``) is
    updated in place: this token's K/V and slot position are written and
    ``pos`` advances by one. ``enc_kv``: the encoder K/V of every layer
    (L, B, T_enc, Kv, hd), which each layer's cross-attention reads
    through the paged kernel. Returns the hidden state (B, 1, D).

    Every layer's attention is one paged call over the ring viewed as
    pages (int8 pages with their scales for an int8 cache), with the
    slot positions, ``pos`` and ``window`` as its position test: the
    reference's ``decode_attention_mask`` over the prefix of each row
    that :func:`~repro_torch.models.layers.ring_cache_pages` describes,
    which holds every slot the mask allows."""
    pos = cache["pos"]                                         # (B,)
    W = cache["k"].shape[2]
    B = x.shape[0]
    slot = pos.long() % W
    write_rows(slot, (cache["slot_pos"], pos))
    quant = "k_scale" in cache
    k_pages, v_pages, page_table, seq_lens = ring_cache_pages(
        cache["k"], cache["v"], pos)
    slots = dict(slot_pos=ring_pages(cache["slot_pos"], 0), pos=pos,
                 window=window)
    if quant:
        k_scales = ring_pages(cache["k_scale"], 1)
        v_scales = ring_pages(cache["v_scale"], 1)
    if enc_kv is not None:
        ek_pages, ev_pages, enc_table, enc_lens = encoder_kv_pages(*enc_kv)
    pos1 = pos[:, None]
    for i, lp in enumerate(layers):
        ck, cv = cache["k"][i], cache["v"][i]
        xn = rms_norm(x, lp["attn_norm"])
        q, k, v = _project_qkv(lp["attn"], xn, cfg, policy)
        q, k = rope_qk(q, k, pos1, cfg.rope_theta)
        if quant:
            kq, ksc = quantize_kv(k)
            vq, vsc = quantize_kv(v)
            write_rows(slot, (ck, kq[:, 0]), (cv, vq[:, 0]),
                       (cache["k_scale"][i], ksc[:, 0]),
                       (cache["v_scale"][i], vsc[:, 0]))
            scales = dict(k_scale=k_scales[i], v_scale=v_scales[i])
        else:
            cache_write_decode(ck, cv, k, v, pos)
            scales = {}
        o = paged_attention(q[:, 0].to(policy.activation_dtype), k_pages[i],
                            v_pages[i], page_table, seq_lens, **scales,
                            **slots)[:, None]
        x = x + linear_apply(lp["attn"]["wo"], o.reshape(B, 1, -1), policy)
        if enc_kv is not None:
            x = cross_attn_block(lp, x, None, None, cfg, policy,
                                 pages=(ek_pages[i], ev_pages[i], enc_table,
                                        enc_lens))
        x, _ = ffn_block(lp, x, cfg, policy, with_aux=False)
    pos.add_(1)
    return x
