"""f32 oracle for flash attention (counterpart of
``repro.kernels.flash_attention.ref``): direct masked softmax attention,
f32 throughout."""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True,
                  window: Optional[int] = None) -> torch.Tensor:
    """q: (B, S, H, d); k/v: (B, T, Kv, d). Returns (B, S, H, d) f32."""
    B, S, H, d = q.shape
    T, Kv = k.shape[1], k.shape[2]
    G = H // Kv
    qg = q.reshape(B, S, Kv, G, d).float()
    s = torch.einsum("bskgh,btkh->bkgst", qg, k.float()) / (d ** 0.5)
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(T, device=q.device)[None, :]
    allow = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        allow &= kpos <= qpos
    if window is not None:
        allow &= kpos > qpos - window
    s = torch.where(allow, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,btkh->bskgh", p, v.float())
    return o.reshape(B, S, H, d)
