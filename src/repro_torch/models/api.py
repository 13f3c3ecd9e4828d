"""Model facade for the dense decoder family.

Counterpart of ``repro.models.api`` for ``family == "dense"``. A
:class:`Model` bundles (config, precision policy, device) and exposes

* ``init(generator)``                      -> params tree
* ``quantize(params)``                     -> params with int8/nf4 leaves
* ``prefill(params, batch, buf_len, lengths)`` -> (last logits, cache)
* ``decode_step(params, tokens, cache)``   -> (logits, cache)
* ``init_cache(batch, buf_len)``           -> empty decode cache
* ``logits(params, hidden)``               -> LM-head projection

The params tree is a dict: ``embed`` (V, D), ``final_norm`` (D,),
``lm_head`` (D, V) and ``layers``, a list of per-layer dicts. Other
families raise NotImplementedError (ROADMAP A4).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.precision import PrecisionPolicy, make_policy
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (PREFILL_PAST_RING, embed,
                                       init_kv_cache, rms_norm,
                                       slot_positions_after_prefill)
from repro_torch.quant.apply import linear_apply, quantize_params

PORTED_FAMILIES = ("dense",)


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    policy: PrecisionPolicy
    # sliding-window override; None = use cfg.sliding_window
    window_override: Optional[int] = None
    # int8 KV cache: absmax per (token, head) over head_dim
    kv_quant: bool = False
    device: torch.device = torch.device("cuda")

    def __post_init__(self):
        if self.cfg.family not in PORTED_FAMILIES:
            raise NotImplementedError(
                f"family {self.cfg.family!r} is not ported yet "
                f"(ROADMAP A4); the port runs {PORTED_FAMILIES}")
        self.device = torch.device(self.device)

    @property
    def window(self) -> Optional[int]:
        return (self.window_override if self.window_override is not None
                else self.cfg.sliding_window)

    @property
    def adt(self) -> torch.dtype:
        return self.policy.activation_dtype

    # ------------------------------------------------------------------
    def init(self, generator: torch.Generator) -> Dict[str, Any]:
        """Random weights in the policy's master dtype, drawn from
        ``generator`` on its device (which must be the model's)."""
        if generator.device.type != self.device.type:
            raise ValueError(f"generator on {generator.device}, model on "
                             f"{self.device}")
        cfg, dtype = self.cfg, self.policy.param_dtype
        table = torch.randn((cfg.vocab_size, cfg.d_model),
                            generator=generator, dtype=torch.float32,
                            device=generator.device)
        params: Dict[str, Any] = {
            "embed": (table * 0.02).to(dtype),
            "final_norm": torch.ones((cfg.d_model,), dtype=dtype,
                                     device=generator.device),
            "lm_head": tfm.linear_init(generator, cfg.d_model,
                                       cfg.vocab_size, dtype),
        }
        del table
        params["layers"] = [tfm.init_decoder_layer(generator, cfg, dtype)
                            for _ in range(cfg.num_layers)]
        return params

    def quantize(self, params: Dict[str, Any]) -> Dict[str, Any]:
        """Post-training quantization under the model's policy."""
        return quantize_params(params, self.policy)

    # ------------------------------------------------------------------
    def logits(self, params, hidden: torch.Tensor) -> torch.Tensor:
        return linear_apply(params["lm_head"], hidden, self.policy).float()

    def prefill(self, params, batch: Dict[str, torch.Tensor],
                buf_len: Optional[int] = None,
                lengths: Optional[torch.Tensor] = None):
        """Forward over the prompt, build the decode cache.

        ``lengths``: (B,) true prompt lengths when the batch is
        right-padded; defaults to the full width. Returns
        (last_token_logits (B, V) f32, cache) with logits taken at each
        row's final *real* token."""
        tokens = batch["tokens"]
        x = embed(tokens, params["embed"], self.adt)
        B, S = x.shape[0], x.shape[1]
        if lengths is None:
            lengths = torch.full((B,), S, dtype=torch.int32,
                                 device=x.device)
        lengths = torch.as_tensor(lengths, dtype=torch.int32,
                                  device=x.device)
        buf = self._buf_len(S, buf_len)
        h, kv = tfm.decoder_forward_seq(params["layers"], x, self.cfg,
                                        self.policy, causal=True,
                                        window=self.window, collect_kv=True)
        cache = self._kv_cache_from_prefill(kv, S, buf, lengths)
        h = rms_norm(h, params["final_norm"])
        last = h[torch.arange(B, device=x.device), lengths.long() - 1]
        return self.logits(params, last), cache

    def _buf_len(self, S: int, buf_len: Optional[int]) -> int:
        if self.window is not None:
            return min(buf_len or (S + 32), self.window)
        return buf_len or (S + 32)

    def _kv_cache_from_prefill(self, kv, S: int, W: int,
                               lengths: torch.Tensor) -> Dict[str, Any]:
        k, v = kv                              # (L, B, S, Kv, hd)
        if S >= W:
            k, v = k[:, :, S - W:], v[:, :, S - W:]
        else:
            pad = (0, 0, 0, 0, 0, W - S)
            k = torch.nn.functional.pad(k, pad)
            v = torch.nn.functional.pad(v, pad)
        cache = {
            "slot_pos": slot_positions_after_prefill(W, lengths, S),
            "pos": lengths.to(torch.int32),
        }
        if S > W:
            cache[PREFILL_PAST_RING] = True
        if self.kv_quant:
            cache["k"], cache["k_scale"] = tfm.quantize_kv(k)
            cache["v"], cache["v_scale"] = tfm.quantize_kv(v)
        else:
            cache["k"], cache["v"] = k.contiguous(), v.contiguous()
        return cache

    # ------------------------------------------------------------------
    def decode_step(self, params, tokens: torch.Tensor, cache):
        """tokens: (B, 1). Returns (logits (B, V) f32, cache); the cache
        is updated in place and returned for symmetry with prefill."""
        x = embed(tokens, params["embed"], self.adt)
        h = tfm.decoder_decode_step(params["layers"], x, cache, self.cfg,
                                    self.policy, window=self.window)
        h = rms_norm(h, params["final_norm"])
        return self.logits(params, h[:, -1]), cache

    def init_cache(self, batch: int, buf_len: int) -> Dict[str, Any]:
        cfg = self.cfg
        W = min(buf_len, self.window) if self.window else buf_len
        c = init_kv_cache(cfg.num_layers, batch, W, cfg.num_kv_heads,
                          cfg.head_dim, self.adt, self.device)
        if self.kv_quant:
            c["k"] = torch.zeros(c["k"].shape, dtype=torch.int8,
                                 device=self.device)
            c["v"] = torch.zeros(c["v"].shape, dtype=torch.int8,
                                 device=self.device)
            c["k_scale"] = torch.zeros(c["k"].shape[:-1],
                                       dtype=torch.float32,
                                       device=self.device)
            c["v_scale"] = torch.zeros(c["v"].shape[:-1],
                                       dtype=torch.float32,
                                       device=self.device)
        return c


def build_model(cfg: ModelConfig, fmt: str = "bfloat16",
                window_override: Optional[int] = None,
                kv_quant: bool = False, device="cuda") -> Model:
    return Model(cfg=cfg, policy=make_policy(fmt),
                 window_override=window_override, kv_quant=kv_quant,
                 device=torch.device(device))
