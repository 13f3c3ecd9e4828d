"""Decode attention backed by the paged attention kernel.

Counterpart of ``repro.kernels.paged_attention.ops``: the entry point the
port's decode step calls (:func:`repro_torch.models.transformer.
decoder_decode_step`, over the ring cache viewed as pages by
:func:`repro_torch.models.layers.ring_cache_pages`). q is brought to the
pool's dtype and made contiguous; the page table and lengths to int32.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.paged_attention import kernel as _kernel


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, page_table: torch.Tensor,
                    seq_lens: torch.Tensor) -> torch.Tensor:
    return _kernel.paged_attention(
        q.to(k_pages.dtype).contiguous(), k_pages, v_pages,
        page_table.to(torch.int32).contiguous(),
        seq_lens.to(torch.int32).contiguous())
