"""Unified model facade over the six architecture families.

Counterpart of ``repro.models.api``. A :class:`Model` bundles (config,
precision policy, device) and exposes

* ``init(generator, quantize=False)``      -> params tree
* ``quantize(params)``                     -> params with int8/nf4 leaves
* ``forward_train(params, batch, remat=False)`` -> (hidden, aux) over the
                                              full sequence (training)
* ``prefill(params, batch, buf_len, lengths, with_aux=False)``
                                           -> (last logits, cache[, aux])
* ``decode_step(params, tokens, cache)``   -> (logits, cache)
* ``init_cache(batch, buf_len, enc_len=0)`` -> empty decode cache (audio:
                                              with ``enc_len`` frames)
* ``logits(params, hidden)``               -> LM-head projection
* ``abstract_params(quantize=False)``      -> the params tree on ``meta``
* ``input_specs(shape)``                   -> meta stand-ins for the inputs

Families: dense, moe and vlm share the decoder stack
(:mod:`repro_torch.models.transformer`); audio adds a bidirectional
encoder and cross-attention; ssm is the Mamba2 stack
(:mod:`repro_torch.models.ssm`); hybrid is Mamba2 with one shared
attention block (:mod:`repro_torch.models.hybrid`). The vlm patch
embeddings (``batch["patches"]``, (B, num_patches, D), optional) and the
audio frame embeddings (``batch["frames"]``, (B, T_enc, D), required)
are stub inputs, as in the reference.

The params tree is a dict: ``embed`` (V, D), ``final_norm`` (D,),
``lm_head`` (D, V) and ``layers``, a list of per-layer dicts (an MoE
layer's ``moe`` entry holds the router and the experts' stacked
projections; an audio decoder layer's ``cross`` the cross-attention);
audio adds ``enc_layers`` and ``enc_norm``, hybrid ``shared``, one
decoder layer. ``prefill(..., with_aux=True)`` also returns the layer
means of the MoE router metrics of that forward (zeros for every family
without experts). ``kv_quant`` applies to the attention families' self-
attention caches (dense, moe, vlm, audio), as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.precision import PrecisionPolicy, make_policy
from repro_torch.core.sharded import split_heads
from repro_torch.models import hybrid as hybrid_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (embed, init_kv_cache, rms_norm,
                                       slot_positions_after_prefill)
from repro_torch.quant.apply import linear_apply, quantize_params

#: the families whose decode cache is a self-attention KV ring per layer
ATTENTION_FAMILIES = ("dense", "moe", "vlm", "audio")


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
        self.device = torch.device(self.device)

    @property
    def window(self) -> Optional[int]:
        return (self.window_override if self.window_override is not None
                else self.cfg.sliding_window)

    @property
    def adt(self) -> torch.dtype:
        return self.policy.activation_dtype

    # ------------------------------------------------------------------
    def init(self, generator: torch.Generator,
             quantize: bool = False) -> Dict[str, Any]:
        """Random weights in the policy's master dtype, drawn from
        ``generator`` on its device (which must be the model's). With
        ``quantize``, each layer is quantized under the model's policy as
        soon as it is drawn, before the next is drawn, so that the masters
        of the whole stack are never resident together; the bytes are
        those of :meth:`quantize` on the whole tree (the draws are the
        same, in the same order)."""
        if generator.device.type != self.device.type:
            raise ValueError(f"generator on {generator.device}, model on "
                             f"{self.device}")
        cfg, dtype = self.cfg, self.policy.param_dtype
        dev = generator.device
        table = torch.randn((cfg.vocab_size, cfg.d_model),
                            generator=generator, dtype=torch.float32,
                            device=dev)
        params: Dict[str, Any] = {
            "embed": (table * 0.02).to(dtype),
            "final_norm": torch.ones((cfg.d_model,), dtype=dtype,
                                     device=dev),
            "lm_head": tfm.linear_init(generator, cfg.d_model,
                                       cfg.vocab_size, dtype),
        }
        del table

        def prepare(layer):
            return quantize_params(layer, self.policy) if quantize else layer

        def stack(n, draw):
            return [prepare(draw()) for _ in range(n)]

        if cfg.family in ("dense", "moe", "vlm"):
            params["layers"] = stack(cfg.num_layers, lambda: (
                tfm.init_decoder_layer(generator, cfg, dtype)))
        elif cfg.family == "audio":
            params["enc_layers"] = stack(cfg.enc_layers, lambda: (
                tfm.init_decoder_layer(generator, cfg, dtype)))
            params["enc_norm"] = torch.ones((cfg.d_model,), dtype=dtype,
                                            device=dev)
            params["layers"] = stack(cfg.num_layers, lambda: (
                tfm.init_decoder_layer(generator, cfg, dtype,
                                       cross_attention=True)))
        elif cfg.family == "ssm":
            params["layers"] = stack(cfg.num_layers, lambda: (
                ssm_mod.init_mamba_layer(generator, cfg, dtype)))
        elif cfg.family == "hybrid":
            params.update(hybrid_mod.init_params(generator, cfg, dtype,
                                                 prepare))
        else:
            raise ValueError(cfg.family)
        return params

    def quantize(self, params: Dict[str, Any]) -> Dict[str, Any]:
        """Post-training quantization under the model's policy."""
        return quantize_params(params, self.policy)

    def abstract_params(self, quantize: bool = False) -> Dict[str, Any]:
        """The tree :meth:`init` builds (quantized with ``quantize``), with
        no draw: every leaf an empty tensor of its shape and dtype on the
        ``meta`` device, the reference's ``jax.eval_shape(model.init)``.
        :meth:`init` runs on a CPU twin of the model under a fake-tensor
        mode, which allocates nothing, and :meth:`quantize` on the meta
        masters; the CPU and CUDA draws are not touched."""
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.utils._pytree import tree_map
        twin = dataclasses.replace(self, device=torch.device("cpu"))
        with FakeTensorMode():
            fake = twin.init(torch.Generator())
        params = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                                device="meta"), fake)
        return self.quantize(params) if quantize else params

    # ------------------------------------------------------------------
    def _embed_inputs(self, params, batch: Dict[str, torch.Tensor]):
        """Token embeddings; for vlm, the patch embeddings in front."""
        x = embed(batch["tokens"], params["embed"], self.adt)
        if self.cfg.family == "vlm" and "patches" in batch:
            x = torch.cat([batch["patches"].to(x.device, self.adt), x],
                          dim=1)
        return x

    def _encode_audio(self, params, frames: torch.Tensor) -> torch.Tensor:
        """The bidirectional encoder over the stub frame embeddings."""
        h, _, _ = tfm.decoder_forward_seq(
            params["enc_layers"], frames.to(self.device, self.adt),
            self.cfg, self.policy, causal=False)
        return rms_norm(h, params["enc_norm"])

    def _cross_kv(self, params, enc_out: torch.Tensor):
        """Each decoder layer's cross-attention K/V from the encoder
        output, stacked: two (L, B, T_enc, Kv, hd)."""
        cfg = self.cfg
        B, T = enc_out.shape[0], enc_out.shape[1]
        ks, vs = [], []
        for lp in params["layers"]:
            ks.append(split_heads(
                linear_apply(lp["cross"]["wk"], enc_out, self.policy),
                cfg.num_kv_heads, cfg.head_dim))
            vs.append(split_heads(
                linear_apply(lp["cross"]["wv"], enc_out, self.policy),
                cfg.num_kv_heads, cfg.head_dim))
        return torch.stack(ks), torch.stack(vs)

    # ------------------------------------------------------------------
    def forward_train(self, params, batch: Dict[str, torch.Tensor],
                      remat: bool = False):
        """Returns (hidden (B, S_total, D) after the final norm, aux): the
        stacks prefill runs, over every position, with no cache kept. aux
        is the layer-mean MoE router metrics for the decoder families
        (zeros without experts) and empty for ssm and hybrid, as in the
        reference. ``remat`` recomputes each decoder layer in the
        backward (the reference's ``jax.checkpoint``; the SSM and hybrid
        stacks take no remat there either)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        if cfg.family in ("dense", "moe", "vlm"):
            x = self._embed_inputs(params, batch)
            h, _, aux = tfm.decoder_forward_seq(
                params["layers"], x, cfg, self.policy, causal=True,
                window=self.window, remat=remat)
        elif cfg.family == "audio":
            enc_kv = self._cross_kv(
                params, self._encode_audio(params, batch["frames"]))
            x = embed(tokens, params["embed"], self.adt)
            h, _, aux = tfm.decoder_forward_seq(
                params["layers"], x, cfg, self.policy, causal=True,
                window=self.window, enc_kv=enc_kv, remat=remat)
        elif cfg.family in ("ssm", "hybrid"):
            x = embed(tokens, params["embed"], self.adt)
            B, S = tokens.shape
            lengths = torch.full((B,), S, dtype=torch.int32,
                                 device=tokens.device)
            if cfg.family == "ssm":
                h, _ = ssm_mod.forward_seq(params["layers"], x, cfg,
                                           self.policy, lengths)
            else:
                h, _ = hybrid_mod.forward_seq(params, x, cfg, self.policy,
                                              S, lengths)
            aux = {}
        else:
            raise ValueError(cfg.family)
        return rms_norm(h, params["final_norm"]), aux

    def logits(self, params, hidden: torch.Tensor) -> torch.Tensor:
        return linear_apply(params["lm_head"], hidden, self.policy).float()

    def prefill(self, params, batch: Dict[str, torch.Tensor],
                buf_len: Optional[int] = None,
                lengths: Optional[torch.Tensor] = None,
                with_aux: bool = False):
        """Forward over the prompt, build the decode cache.

        ``lengths``: (B,) true prompt lengths when the batch is
        right-padded; defaults to the full width (for vlm, the patch
        prefix counts toward every row's length). Returns
        (last_token_logits (B, V) f32, cache) with logits taken at each
        row's final *real* token; with ``with_aux``, (logits, cache, aux),
        aux the layer-mean MoE router metrics of the forward (zeros
        without experts)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        B, T = tokens.shape
        if lengths is None:
            lengths = torch.full((B,), T, dtype=torch.int32)
        lengths = torch.as_tensor(lengths, dtype=torch.int32,
                                  device=tokens.device)
        aux = {k: torch.zeros((), dtype=torch.float32, device=tokens.device)
               for k in tfm.MOE_AUX}
        if cfg.family in ("dense", "moe", "vlm"):
            x = self._embed_inputs(params, batch)
            S = x.shape[1]
            lengths = lengths + (S - T)
            h, kv, aux = tfm.decoder_forward_seq(
                params["layers"], x, cfg, self.policy, causal=True,
                window=self.window, collect_kv=True)
            cache = self._kv_cache_from_prefill(kv, S, self._buf_len(
                S, buf_len), lengths)
        elif cfg.family == "audio":
            enc_kv = self._cross_kv(
                params, self._encode_audio(params, batch["frames"]))
            x = embed(tokens, params["embed"], self.adt)
            h, kv, aux = tfm.decoder_forward_seq(
                params["layers"], x, cfg, self.policy, causal=True,
                window=self.window, collect_kv=True, enc_kv=enc_kv)
            cache = self._kv_cache_from_prefill(kv, T, self._buf_len(
                T, buf_len), lengths)
            cache["enc_k"], cache["enc_v"] = enc_kv
        elif cfg.family == "ssm":
            x = embed(tokens, params["embed"], self.adt)
            h, cache = ssm_mod.forward_seq(params["layers"], x, cfg,
                                           self.policy, lengths)
        elif cfg.family == "hybrid":
            x = embed(tokens, params["embed"], self.adt)
            h, cache = hybrid_mod.forward_seq(
                params, x, cfg, self.policy, self._buf_len(T, buf_len),
                lengths)
        else:
            raise ValueError(cfg.family)
        h = rms_norm(h, params["final_norm"])
        last = h[torch.arange(B, device=h.device), lengths.long() - 1]
        logits = self.logits(params, last)
        return (logits, cache, aux) if with_aux else (logits, cache)

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
            "pos": lengths.to(torch.int32, copy=True),
        }
        if self.kv_quant:
            cache["k"], cache["k_scale"] = tfm.quantize_kv(k)
            cache["v"], cache["v_scale"] = tfm.quantize_kv(v)
        else:
            cache["k"], cache["v"] = k.contiguous(), v.contiguous()
        return cache

    # ------------------------------------------------------------------
    def decode_step(self, params, tokens: torch.Tensor, cache):
        """tokens: (B, 1). Returns (logits (B, V) f32, cache); the cache
        is updated in place, every tensor of it (``pos`` too) keeping its
        storage so that a captured CUDA graph can replay the step, and
        returned for symmetry with prefill."""
        cfg = self.cfg
        x = embed(tokens, params["embed"], self.adt)
        if cfg.family in ATTENTION_FAMILIES:
            cross = ({"enc_kv": (cache["enc_k"], cache["enc_v"])}
                     if cfg.family == "audio" else {})
            h = tfm.decoder_decode_step(params["layers"], x, cache, cfg,
                                        self.policy, window=self.window,
                                        **cross)
        elif cfg.family == "ssm":
            h = ssm_mod.decode_step(params["layers"], x[:, 0, :], cache,
                                    cfg, self.policy)[:, None, :]
        elif cfg.family == "hybrid":
            h = hybrid_mod.decode_step(params, x, cache, cfg, self.policy)
        else:
            raise ValueError(cfg.family)
        h = rms_norm(h, params["final_norm"])
        return self.logits(params, h[:, -1]), cache

    def init_cache(self, batch: int, buf_len: int,
                   enc_len: int = 0) -> Dict[str, Any]:
        """The empty decode cache of ``batch`` lanes and a ring of
        ``buf_len`` slots (at most the window). An audio cache holds its
        encoder's K/V: with ``enc_len`` > 0 they are empty (zeros) over
        that many frames, the reference's ``init_cache``; without, only
        :meth:`prefill` computes them, and asking for the cache raises."""
        cfg, dev, adt = self.cfg, self.device, self.adt
        if cfg.family == "audio" and enc_len <= 0:
            raise ValueError(f"{cfg.name}: an audio decode cache holds the "
                             f"encoder K/V of its frames; build it with "
                             f"prefill, or give enc_len")
        W = min(buf_len, self.window) if self.window else buf_len
        if cfg.family in ATTENTION_FAMILIES:
            c = init_kv_cache(cfg.num_layers, batch, W, cfg.num_kv_heads,
                              cfg.head_dim, adt, dev)
            if self.kv_quant:
                c["k"] = torch.zeros(c["k"].shape, dtype=torch.int8,
                                     device=dev)
                c["v"] = torch.zeros(c["v"].shape, dtype=torch.int8,
                                     device=dev)
                c["k_scale"] = torch.zeros(c["k"].shape[:-1],
                                           dtype=torch.float32, device=dev)
                c["v_scale"] = torch.zeros(c["v"].shape[:-1],
                                           dtype=torch.float32, device=dev)
            if cfg.family == "audio":
                enc = (cfg.num_layers, batch, enc_len, cfg.num_kv_heads,
                       cfg.head_dim)
                c["enc_k"] = torch.zeros(enc, dtype=adt, device=dev)
                c["enc_v"] = torch.zeros(enc, dtype=adt, device=dev)
            return c
        dims = ssm_mod.ssm_dims(cfg)
        c = {
            "ssm_state": torch.zeros(
                (cfg.num_layers, batch, dims["nheads"], dims["headdim"],
                 dims["dstate"]), dtype=torch.float32, device=dev),
            "conv": torch.zeros((cfg.num_layers, batch,
                                 cfg.ssm_conv_width - 1,
                                 dims["conv_channels"]), dtype=adt,
                                device=dev),
            "pos": torch.zeros((batch,), dtype=torch.int32, device=dev),
        }
        if cfg.family == "hybrid":
            kv = (hybrid_mod.n_attn_sites(cfg), batch, W, cfg.num_kv_heads,
                  cfg.head_dim)
            c["shared_k"] = torch.zeros(kv, dtype=adt, device=dev)
            c["shared_v"] = torch.zeros(kv, dtype=adt, device=dev)
            c["slot_pos"] = torch.full((batch, W), -1, dtype=torch.int32,
                                       device=dev)
        return c

    def input_specs(self, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
        """Empty ``meta`` stand-ins for every input of a step at ``shape``:
        tokens; labels for train; patches for vlm; frames for audio."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len

        def meta(*dims, dtype=torch.int32):
            return torch.empty(dims, dtype=dtype, device="meta")

        specs = {"tokens": meta(B, S)}
        if shape.kind == "train":
            specs["labels"] = meta(B, S)
        if cfg.family == "vlm":
            specs["patches"] = meta(B, cfg.num_patches, cfg.d_model,
                                    dtype=self.adt)
        if cfg.family == "audio":
            specs["frames"] = meta(B, S // cfg.enc_frames_ratio, cfg.d_model,
                                   dtype=self.adt)
        return specs


def build_model(cfg: ModelConfig, fmt: str = "bfloat16",
                window_override: Optional[int] = None,
                kv_quant: bool = False, device="cuda") -> Model:
    return Model(cfg=cfg, policy=make_policy(fmt),
                 window_override=window_override, kv_quant=kv_quant,
                 device=torch.device(device))
