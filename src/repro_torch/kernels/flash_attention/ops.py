"""Prefill attention backed by the flash attention kernel.

Counterpart of ``repro.kernels.flash_attention.ops``: the entry point the
port's model calls (:func:`repro_torch.models.transformer.attn_block_seq`),
in the same layout, q (B, S, H, d) and k, v (B, T, Kv, d). There are no
``bq``/``bkv`` arguments: the tiles are the kernel's own. Inputs are made
contiguous (a no-op on the model path) and brought to q's dtype.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention import kernel as _kernel


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    return _kernel.flash_attention(
        q.contiguous(), k.to(q.dtype).contiguous(),
        v.to(q.dtype).contiguous(), causal=causal, window=window)
