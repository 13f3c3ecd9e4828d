"""LM losses with sequence-chunked logits.

Counterpart of ``repro.training.losses``. Full logits for a large
vocabulary over a long batch would not fit beside the activations, so
the LM head is applied per sequence chunk of ``LOSS_CHUNK`` positions (a
Python loop here, a ``lax.scan`` in the reference): at most one chunk's
logits are computed at a time, though autograd keeps each chunk's for
the backward. logsumexp and the gold logit are taken in f32.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core.precision import PrecisionPolicy
from repro_torch.core.sharded import (is_sharded, reduce_partial,
                                     split_lookup)
from repro_torch.quant.apply import linear_apply

LOSS_CHUNK = 512


def chunked_cross_entropy(hidden: torch.Tensor, lm_head: Any,
                          labels: torch.Tensor, policy: PrecisionPolicy,
                          mask: Optional[torch.Tensor] = None,
                          chunk: int = LOSS_CHUNK
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean next-token cross-entropy.

    hidden: (B, S, D); labels: (B, S), already shifted by the caller.
    Returns (loss, n_tokens), both f32 scalars."""
    B, S, _ = hidden.shape
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=hidden.device)
    if S % chunk:
        chunk = S
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, S, chunk):
        logits = linear_apply(lm_head, hidden[:, c0:c0 + chunk],
                              policy).float()
        logz = _logsumexp(logits)
        gold = gold_logits(logits, labels[:, c0:c0 + chunk])
        mc = mask[:, c0:c0 + chunk]
        tot = tot + ((logz - gold) * mc).sum()
        cnt = cnt + mc.sum()
    return tot / torch.clamp(cnt, min=1.0), cnt


def _logsumexp(logits: torch.Tensor) -> torch.Tensor:
    """logsumexp over the last dim; on DTensors with the vocabulary split,
    by a max and a sum each all-reduced (the reference's lowering)."""
    if not is_sharded(logits):
        return torch.logsumexp(logits, dim=-1)
    m = reduce_partial(logits.detach().amax(dim=-1))
    return reduce_partial((logits - m[..., None]).exp().sum(dim=-1)).log() \
        + m


def gold_logits(logits: torch.Tensor, labels: torch.Tensor
                ) -> torch.Tensor:
    """logits (..., V) at labels (...). On DTensors (the dry run) with
    the vocabulary split, each rank picks the labels in its part and one
    all-reduce sums them, the reference's lowering."""
    if not is_sharded(logits, labels):
        return torch.gather(logits, -1, labels[..., None].long())[..., 0]

    def pick(lg, idx, inside):
        g = torch.gather(lg, -1, idx[..., None])[..., 0]
        return torch.where(inside, g, torch.zeros_like(g))

    # the labels follow the logits' rows
    return split_lookup(pick, logits, labels, logits.placements, -1)


def lm_loss(model, params, batch: Dict[str, torch.Tensor],
            aux_weights: Optional[Dict[str, float]] = None,
            remat: bool = False) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Next-token LM loss for any family; adds the MoE aux losses."""
    aux_weights = aux_weights or {"load_balance_loss": 0.01,
                                  "router_z_loss": 1e-3}
    hidden, aux = model.forward_train(params, batch, remat=remat)
    tokens = batch["tokens"]
    labels = batch.get("labels")
    if labels is None:
        labels = torch.nn.functional.pad(tokens[:, 1:], (0, 1))
    S = tokens.shape[1]
    if hidden.shape[1] != S:      # vlm: drop patch positions
        hidden = hidden[:, hidden.shape[1] - S:]
    # last position has no next token
    mask = torch.ones(labels.shape, dtype=torch.float32,
                      device=hidden.device)
    mask[:, -1] = 0.0
    loss, n_tok = chunked_cross_entropy(hidden, params["lm_head"], labels,
                                        model.policy, mask)
    metrics = {"lm_loss": loss, "n_tokens": n_tok}
    total = loss
    for k, wgt in aux_weights.items():
        if aux and k in aux:
            total = total + wgt * aux[k]
            metrics[k] = aux[k]
    if aux and "dropped_fraction" in aux:
        metrics["dropped_fraction"] = aux["dropped_fraction"]
    metrics["total_loss"] = total
    return total, metrics
