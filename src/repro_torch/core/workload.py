"""Analytic per-phase workload descriptors: the port's own copy of
``repro.core.workload``.

Converts (ModelConfig, phase, batch, seq, cache_len) into the
:class:`~repro_torch.core.energy.PhaseWorkload` the energy model
consumes: matmul FLOPs, weight/activation/KV traffic and kernel-launch
counts per family, in the reference's order of operations, so both
packages give the same floats.

Conventions
-----------
* FLOPs count multiply-adds as 2 ops (matmul m*n*k -> 2mnk).
* ``weight_bytes_16`` is the 16-bit-equivalent weight traffic per step —
  the precision policy rescales it inside the energy model.
* decode workloads describe ONE autoregressive step; callers scale by the
  number of generated tokens via ``PhaseWorkload.scaled`` or ``n_steps``.
"""
from __future__ import annotations

import functools

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.energy import PhaseWorkload

_ACT_BYTES = 2  # activations move in bf16


# --------------------------------------------------------------------------
# per-layer matmul FLOPs for one token (excludes attention score/value ops)
# --------------------------------------------------------------------------
def _dense_layer_matmul_flops(cfg: ModelConfig) -> float:
    d, hd = cfg.d_model, cfg.head_dim
    attn = 2 * d * (cfg.num_heads * hd + 2 * cfg.num_kv_heads * hd
                    + cfg.num_heads * hd)
    ffn = 2 * 3 * d * cfg.d_ff
    return attn + ffn


def _moe_layer_matmul_flops(cfg: ModelConfig) -> float:
    d, hd = cfg.d_model, cfg.head_dim
    attn = 2 * d * (cfg.num_heads * hd + 2 * cfg.num_kv_heads * hd
                    + cfg.num_heads * hd)
    router = 2 * d * cfg.num_experts
    experts = cfg.experts_per_token * 2 * 3 * d * cfg.d_ff
    return attn + router + experts


def _ssm_layer_matmul_flops(cfg: ModelConfig) -> float:
    d, di, ds = cfg.d_model, cfg.d_inner, cfg.ssm_state
    in_proj = 2 * d * (2 * di + 2 * cfg.ssm_ngroups * ds + cfg.ssm_nheads)
    out_proj = 2 * di * d
    # SSD state update/readout per token: h = h*dA + B x ; y = C h
    scan = 2 * 2 * di * ds
    conv = 2 * (di + 2 * cfg.ssm_ngroups * ds) * cfg.ssm_conv_width
    return in_proj + out_proj + scan + conv


def _attn_score_flops(cfg: ModelConfig, q_tokens: float,
                      kv_tokens: float) -> float:
    """QK^T + AV FLOPs for q_tokens attending to kv_tokens (per layer)."""
    return 2 * 2 * q_tokens * kv_tokens * cfg.num_heads * cfg.head_dim


def _effective_kv(cfg: ModelConfig, cache_len: int) -> int:
    if cfg.sliding_window is not None:
        return min(cache_len, cfg.sliding_window)
    return cache_len


def _kv_bytes_per_token_layer(cfg: ModelConfig,
                              bytes_per_elem: float = 2.0) -> float:
    return 2 * cfg.num_kv_heads * cfg.head_dim * bytes_per_elem


# Kernel launches per layer by serving stack. Eager transformers issues
# ~30 kernels/layer (projections, norms, rope, reshapes, KV concat,
# softmax, residual adds, casts); a fused TGI-like stack issues ~8
# (fused QKV, flash attention, fused MLP, fused norm/residual).
_LAUNCHES_PER_LAYER = {"eager": 30, "fused": 8}
_MATMULS_PER_LAYER = {"dense": 7, "moe": 7, "ssm": 2, "hybrid": 2,
                      "vlm": 7, "audio": 7}


def _attn_layer_count(cfg: ModelConfig) -> int:
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.num_layers // max(cfg.attn_period, 1)
    if cfg.family == "audio":
        return cfg.enc_layers + 2 * cfg.num_layers  # self + cross in dec
    return cfg.num_layers


def _layer_matmul_flops(cfg: ModelConfig) -> float:
    if cfg.family == "moe":
        return _moe_layer_matmul_flops(cfg)
    if cfg.family == "ssm":
        return _ssm_layer_matmul_flops(cfg)
    if cfg.family == "hybrid":
        # per mamba layer; shared attn amortized over the period
        attn_share = (_dense_layer_matmul_flops(cfg)
                      / max(cfg.attn_period, 1))
        return _ssm_layer_matmul_flops(cfg) + attn_share
    return _dense_layer_matmul_flops(cfg)


def _total_layers(cfg: ModelConfig) -> int:
    return cfg.num_layers + cfg.enc_layers


# --------------------------------------------------------------------------
# public API
# --------------------------------------------------------------------------
def prefill_workload(cfg: ModelConfig, batch: int, seq: int,
                     stack: str = "eager") -> PhaseWorkload:
    """Forward pass over the full prompt (paper's prefill split)."""
    tokens = batch * seq
    L = _total_layers(cfg)
    flops = tokens * (_layer_matmul_flops(cfg) * cfg.num_layers
                      + (_dense_layer_matmul_flops(cfg) * cfg.enc_layers
                         if cfg.enc_layers else 0.0))
    # causal attention: avg kv length = s/2 (window-clipped)
    if cfg.has_attention:
        kv_avg = _effective_kv(cfg, seq) / 2
        flops += _attn_score_flops(cfg, tokens, kv_avg) \
            * _attn_layer_count(cfg)
    flops += 2 * tokens * cfg.d_model * cfg.vocab_size  # LM head
    weight_bytes = 2.0 * cfg.param_count(active_only=False)
    act_bytes = tokens * cfg.d_model * _ACT_BYTES * 8 * L
    if cfg.has_attention:
        act_bytes += tokens * _kv_bytes_per_token_layer(cfg) \
            * _attn_layer_count(cfg)             # KV write
    n_matmuls = _MATMULS_PER_LAYER[cfg.family] * L
    launches = _LAUNCHES_PER_LAYER[stack] * L + 4
    return PhaseWorkload(phase="prefill", flops=flops,
                         weight_bytes_16=weight_bytes, act_bytes=act_bytes,
                         n_matmuls=n_matmuls, n_kernel_launches=launches,
                         stack=stack)


def prefill_chunk_workload(cfg: ModelConfig, batch: int, chunk_len: int,
                           ctx_len: int,
                           stack: str = "eager") -> PhaseWorkload:
    """One chunked-prefill continuation: ``chunk_len`` new prompt
    tokens per sequence attending to ``ctx_len`` tokens already in the
    KV cache (Sarathi-style chunked prefill).

    At ``ctx_len == 0`` this is term-for-term
    :func:`prefill_workload` over ``chunk_len`` tokens — the causal
    average kv length ``(eff(ctx) + eff(ctx + chunk)) / 2`` reduces to
    ``eff(chunk)/2`` — so splitting a prompt conserves attention FLOPs
    and KV-write traffic.  What chunking genuinely adds is re-reading
    the full weights once per chunk and re-reading the cached prefix's
    KV, which is exactly the energy overhead the formation benchmark
    measures.
    """
    tokens = batch * chunk_len
    L = _total_layers(cfg)
    flops = tokens * (_layer_matmul_flops(cfg) * cfg.num_layers
                      + (_dense_layer_matmul_flops(cfg) * cfg.enc_layers
                         if cfg.enc_layers else 0.0))
    if cfg.has_attention:
        kv_avg = (_effective_kv(cfg, ctx_len)
                  + _effective_kv(cfg, ctx_len + chunk_len)) / 2
        flops += _attn_score_flops(cfg, tokens, kv_avg) \
            * _attn_layer_count(cfg)
    flops += 2 * tokens * cfg.d_model * cfg.vocab_size  # LM head
    weight_bytes = 2.0 * cfg.param_count(active_only=False)
    act_bytes = tokens * cfg.d_model * _ACT_BYTES * 8 * L
    if cfg.has_attention:
        act_bytes += tokens * _kv_bytes_per_token_layer(cfg) \
            * _attn_layer_count(cfg)             # KV write
        act_bytes += batch * _effective_kv(cfg, ctx_len) \
            * _kv_bytes_per_token_layer(cfg) \
            * _attn_layer_count(cfg)             # cached-prefix KV read
    n_matmuls = _MATMULS_PER_LAYER[cfg.family] * L
    launches = _LAUNCHES_PER_LAYER[stack] * L + 4
    return PhaseWorkload(phase="prefill", flops=flops,
                         weight_bytes_16=weight_bytes, act_bytes=act_bytes,
                         n_matmuls=n_matmuls, n_kernel_launches=launches,
                         stack=stack)


def kv_cache_bytes(cfg: ModelConfig, tokens: int,
                   bytes_per_elem: float = 2.0) -> float:
    """Bytes of per-request cache state after ``tokens`` of context:
    attention KV (window-clipped) plus recurrent SSM state for
    ssm/hybrid families.  This is the payload a disaggregated cluster
    moves over the interconnect when a prefill replica hands a request
    to a decode replica."""
    total = 0.0
    if cfg.has_attention:
        total += _effective_kv(cfg, tokens) \
            * _kv_bytes_per_token_layer(cfg, bytes_per_elem) \
            * _attn_layer_count(cfg)
    if cfg.family in ("ssm", "hybrid"):
        total += cfg.num_layers * (cfg.ssm_nheads * cfg.ssm_headdim
                                   * cfg.ssm_state) * 4
    return total


def decode_step_workload(cfg: ModelConfig, batch: int, cache_len: int,
                         stack: str = "eager",
                         kv_bytes_per_elem: float = 2.0) -> PhaseWorkload:
    """ONE autoregressive decode step with a cache of ``cache_len``.

    ``kv_bytes_per_elem``: 2.0 for a bf16 cache, ~1.1 for the int8
    KV cache (codes + absmax scales) — §Perf H3.
    """
    L = _total_layers(cfg)
    flops = batch * _layer_matmul_flops(cfg) * cfg.num_layers
    if cfg.enc_layers:
        # decoder cross-attn projections already folded into audio family
        pass
    kv_eff = _effective_kv(cfg, cache_len)
    if cfg.has_attention:
        flops += _attn_score_flops(cfg, batch, kv_eff) \
            * _attn_layer_count(cfg)
    flops += 2 * batch * cfg.d_model * cfg.vocab_size
    weight_bytes = 2.0 * cfg.param_count(active_only=True)
    # KV/state cache read traffic — the decode phase's defining term
    if cfg.family == "ssm":
        state_bytes = batch * cfg.num_layers * (
            cfg.ssm_nheads * cfg.ssm_headdim * cfg.ssm_state) * 4
        cache_bytes = 2.0 * state_bytes  # read + write
    elif cfg.family == "hybrid":
        state_bytes = batch * cfg.num_layers * (
            cfg.ssm_nheads * cfg.ssm_headdim * cfg.ssm_state) * 4
        kv_bytes = batch * kv_eff * _kv_bytes_per_token_layer(
            cfg, kv_bytes_per_elem) * _attn_layer_count(cfg)
        cache_bytes = 2.0 * state_bytes + kv_bytes
    else:
        cache_bytes = batch * kv_eff * _kv_bytes_per_token_layer(
            cfg, kv_bytes_per_elem) * _attn_layer_count(cfg)
    act_bytes = cache_bytes + batch * cfg.d_model * _ACT_BYTES * 8 * L
    n_matmuls = _MATMULS_PER_LAYER[cfg.family] * L
    launches = _LAUNCHES_PER_LAYER[stack] * L + 4
    return PhaseWorkload(phase="decode", flops=flops,
                         weight_bytes_16=weight_bytes, act_bytes=act_bytes,
                         n_matmuls=n_matmuls, n_kernel_launches=launches,
                         stack=stack)


@functools.lru_cache(maxsize=512)
def _decode_step_consts(cfg: ModelConfig, batch: int, stack: str,
                        kv_bytes_per_elem: float):
    """Step-invariant pieces of :func:`decode_step_workload` for one
    (config, batch, stack) point, memoized so a run of decode steps
    derives them once."""
    L = _total_layers(cfg)
    flops0 = batch * _layer_matmul_flops(cfg) * cfg.num_layers
    attn_coef = (2 * 2 * batch * cfg.num_heads * cfg.head_dim
                 * _attn_layer_count(cfg)) if cfg.has_attention else 0
    lm_head = 2 * batch * cfg.d_model * cfg.vocab_size
    weight_bytes = 2.0 * cfg.param_count(active_only=True)
    kvb = _kv_bytes_per_token_layer(cfg, kv_bytes_per_elem)
    if cfg.family in ("ssm", "hybrid"):
        state2 = 2.0 * (batch * cfg.num_layers
                        * (cfg.ssm_nheads * cfg.ssm_headdim
                           * cfg.ssm_state) * 4)
    else:
        state2 = 0.0
    attn_L = _attn_layer_count(cfg)
    act_const = batch * cfg.d_model * _ACT_BYTES * 8 * L
    n_matmuls = _MATMULS_PER_LAYER[cfg.family] * L
    launches = _LAUNCHES_PER_LAYER[stack] * L + 4
    return (flops0, attn_coef, lm_head, weight_bytes, kvb, state2,
            attn_L, act_const, n_matmuls, launches)


def decode_step_arrays(cfg: ModelConfig, batch: int, cache_lens,
                       stack: str = "eager",
                       kv_bytes_per_elem: float = 2.0):
    """Vectorized :func:`decode_step_workload`: per-step ``flops`` /
    ``act_bytes`` arrays for a run of decode steps whose cache lengths
    are ``cache_lens`` (one entry per step, same batch throughout).

    Returns ``(template, flops, act_bytes)`` where ``template`` carries
    every step-invariant field (weight traffic, matmul/launch counts,
    stack) plus the first step's varying terms. The arrays are
    **bit-identical** to evaluating :func:`decode_step_workload` once
    per step: every float multiply/add below mirrors the scalar code's
    operation order, and all integer-valued intermediates stay exact in
    float64 (well under 2**53); ``tests/test_torch_energy.py`` holds it
    elementwise against the reference.
    """
    lens = np.asarray(cache_lens, dtype=np.int64)
    (flops0, attn_coef, lm_head, weight_bytes, kvb, state2, attn_L,
     act_const, n_matmuls, launches) = _decode_step_consts(
        cfg, batch, stack, kv_bytes_per_elem)
    if cfg.sliding_window is not None:
        kv_eff = np.minimum(lens, cfg.sliding_window)
    else:
        kv_eff = lens
    # flops: (batch * layer_flops * num_layers) + attn(kv_eff) + lm_head,
    # added in the scalar order (layer_flops is float for hybrid, so the
    # fold order matters there)
    flops = np.full(len(lens), flops0, dtype=np.float64)
    if attn_coef:
        flops = flops + (attn_coef * kv_eff).astype(np.float64)
    flops = flops + float(lm_head)
    # act_bytes: cache traffic (the kv_eff-dependent term) + activations
    if cfg.family == "ssm":
        cache_bytes = np.full(len(lens), state2)
    elif cfg.family == "hybrid":
        kv_bytes = ((batch * kv_eff).astype(np.float64) * kvb * attn_L)
        cache_bytes = state2 + kv_bytes
    else:
        cache_bytes = ((batch * kv_eff).astype(np.float64) * kvb * attn_L)
    act_bytes = cache_bytes + float(act_const)
    template = PhaseWorkload(phase="decode", flops=float(flops[0]),
                             weight_bytes_16=weight_bytes,
                             act_bytes=float(act_bytes[0]),
                             n_matmuls=n_matmuls,
                             n_kernel_launches=launches, stack=stack)
    return template, flops, act_bytes


def decode_workload(cfg: ModelConfig, batch: int, prompt_len: int,
                    new_tokens: int, stack: str = "eager") -> PhaseWorkload:
    """Whole decode phase: ``new_tokens`` sequential steps, growing cache."""
    if new_tokens <= 0:
        raise ValueError("new_tokens must be > 0")
    mid = prompt_len + new_tokens // 2
    step = decode_step_workload(cfg, batch, mid, stack=stack)
    w = step.scaled(float(new_tokens))
    return PhaseWorkload(phase="decode", flops=w.flops,
                         weight_bytes_16=w.weight_bytes_16,
                         act_bytes=w.act_bytes, n_matmuls=w.n_matmuls,
                         n_kernel_launches=w.n_kernel_launches,
                         n_steps=new_tokens, stack=stack)


def train_step_workload(cfg: ModelConfig, batch: int, seq: int,
                        stack: str = "fused") -> PhaseWorkload:
    """fwd + bwd + optimizer update (~3x forward FLOPs, AdamW traffic)."""
    fwd = prefill_workload(cfg, batch, seq, stack=stack)
    n_params = cfg.param_count(active_only=False)
    opt_bytes = n_params * 4 * 4  # read p,m,v + write (fp32 master)
    return PhaseWorkload(
        phase="train", flops=3.0 * fwd.flops,
        weight_bytes_16=3.0 * fwd.weight_bytes_16,
        act_bytes=3.0 * fwd.act_bytes + opt_bytes,
        n_matmuls=3 * fwd.n_matmuls,
        n_kernel_launches=3 * fwd.n_kernel_launches,
        stack=stack,
    )


def model_flops_6nd(cfg: ModelConfig, tokens: float,
                    train: bool = False) -> float:
    """The 6·N·D (or 2·N·D inference) useful-FLOPs yardstick, MoE-active."""
    n = cfg.param_count(active_only=True)
    per_token = 6.0 * n if train else 2.0 * n
    return per_token * tokens
