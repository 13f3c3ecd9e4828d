"""f32 oracle for paged decode attention (counterpart of
``repro.kernels.paged_attention.ref``): gather the pages into a
contiguous cache and run masked attention in f32."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def paged_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, page_table: torch.Tensor,
                        seq_lens: torch.Tensor) -> torch.Tensor:
    """Shapes as :func:`repro_torch.kernels.paged_attention.kernel.
    paged_attention`. Returns (B, H, d) f32."""
    B, H, d = q.shape
    page, Kv = k_pages.shape[1], k_pages.shape[2]
    G = H // Kv
    n_max = page_table.shape[1]
    T = n_max * page
    pt = page_table.long().clamp(min=0)
    k = k_pages[pt].reshape(B, T, Kv, d).float()
    v = v_pages[pt].reshape(B, T, Kv, d).float()
    qg = q.reshape(B, Kv, G, d).float()
    s = torch.einsum("bkgh,btkh->bkgt", qg, k) / (d ** 0.5)
    slot = torch.arange(T, device=q.device)[None, :]
    valid = (slot < seq_lens[:, None]) \
        & (page_table.repeat_interleave(page, dim=1) >= 0)
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgt,btkh->bkgh", p, v)
    return o.reshape(B, H, d)
