"""Decode attention backed by the paged attention kernel.

Counterpart of ``repro.kernels.paged_attention.ops``: the entry point the
port's decode step calls (:func:`repro_torch.models.transformer.
decoder_decode_step`, over the ring cache viewed as pages by
:func:`repro_torch.models.layers.ring_cache_pages`, its int8 scales and
slot positions by :func:`repro_torch.models.layers.ring_pages`). q is
brought to the pool's dtype (kept in its own over int8 pages) and made
contiguous; the page table, lengths, slot positions and ``pos`` to
int32.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.paged_attention import kernel as _kernel


def _i32(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if t is None else t.to(torch.int32).contiguous()


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, page_table: torch.Tensor,
                    seq_lens: torch.Tensor, *,
                    k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None,
                    slot_pos: Optional[torch.Tensor] = None,
                    pos: Optional[torch.Tensor] = None,
                    window: Optional[int] = None) -> torch.Tensor:
    if k_scale is None:
        q = q.to(k_pages.dtype)
    return _kernel.paged_attention(
        q.contiguous(), k_pages, v_pages, _i32(page_table), _i32(seq_lens),
        k_scale=k_scale, v_scale=v_scale, slot_pos=_i32(slot_pos),
        pos=_i32(pos), window=window)
