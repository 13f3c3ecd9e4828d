"""Top-k Mixture-of-Experts FFN with capacity-based dispatch.

Counterpart of ``repro.models.moe`` on one device (its
``_moe_ffn_local``; the expert-parallel ``shard_map`` path waits for
ROADMAP A7). Tokens are sorted by expert id and scattered into a dense
(experts, capacity, d_model) buffer, the experts run as one batched
product per projection, and the results gather back, weighted by their
gates. An expert that is routed more than ``capacity`` tokens drops the
rest (Switch/GShard semantics); every expert runs its whole buffer,
routed or not, as the reference does.

Routing and dispatch are plain tensor ops, each made to decide as the
reference does:

* the router's logits are summed in f64 and rounded to f32, so that a
  token's routing does not depend on the other tokens of the batch;
* top-k takes the k largest router probabilities, the lower expert id
  first on a tie (``jax.lax.top_k``), by a stable descending sort;
* the assignments are sorted by expert with a stable sort
  (``jnp.argsort``), so within an expert they keep token order;
* the dispatch scatter writes every kept assignment to its own row; only
  the trash row ``E * C`` takes several writes, and it is discarded;
* the combine adds each token's k weighted expert outputs in f32, in
  ascending expert id, one addition after another from zero: the order in
  which the reference's sequential scatter-add meets them. No atomics,
  so the sums, and the tokens after them, are the same run to run.

Under int8/nf4 each expert product is one grouped launch of the
dequant-matmul kernel over all experts (``quant_matmul``'s
``*_grouped``); under fp32/fp16/bf16 a batched ``torch.matmul``, as the
reference leaves it to XLA.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.precision import PrecisionPolicy
from repro_torch.quant.apply import linear_apply


def expert_capacity(n_tokens: int, n_experts: int, top_k: int,
                    capacity_factor: float = 1.25) -> int:
    """Rows of each expert's buffer: the capacity factor times the mean
    load, rounded up to a multiple of 8, at least 8."""
    c = int(capacity_factor * n_tokens * top_k / n_experts)
    return max(8, ((c + 7) // 8) * 8)


def route(x: torch.Tensor, w_router: torch.Tensor, top_k: int):
    """Router logits (T, E) f32, probabilities, and the top-k (gates
    renormalised over the k, expert ids) of each token, the lower expert
    id first on a tie.

    The logits are summed in f64 and rounded to f32 once. An f32 product
    sums in an order that depends on how many tokens are routed together
    (the library picks its kernel per shape), which moves a token's
    logits by an ulp and flips its top-k at near-ties: a request then
    routes differently alone and in a batch. The products of f32 values
    are exact in f64 and their f64 sums round to the same f32 in any
    order but at a rounding boundary, so routing does not depend on the
    batch; the logits stay within an f32 ulp of the reference's."""
    logits = torch.matmul(x.double(), w_router.double()).float()
    probs = torch.softmax(logits, dim=-1)
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_ids = vals[:, :top_k], ids[:, :top_k]
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    return logits, probs, gate_vals, expert_ids


def moe_ffn(p: Dict[str, Any], x: torch.Tensor, *, top_k: int,
            policy: PrecisionPolicy, capacity_factor: float = 1.25,
            with_aux: bool = True
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (T, D) -> (T, D) in the compute dtype, plus the router's aux
    metrics (``load_balance_loss``, ``router_z_loss``,
    ``dropped_fraction``; an empty dict without ``with_aux``).

    p: {"w_router": (D, E), "experts_gate"/"experts_up": (E, D, F),
        "experts_down": (E, F, D)}, the expert weights plain or quantized
    with a leading expert axis."""
    T, D = x.shape
    E = p["w_router"].shape[-1]
    C = expert_capacity(T, E, top_k, capacity_factor)
    dev = x.device
    logits, probs, gate_vals, expert_ids = route(x, p["w_router"], top_k)

    # ---- flatten the assignments and sort them by expert ---------------
    flat_expert = expert_ids.reshape(-1)                      # (T*k,)
    order = torch.argsort(flat_expert, stable=True)
    se = flat_expert[order]
    st = order // top_k                                       # its token
    sg = gate_vals.reshape(-1)[order]
    # position within the expert's run
    run_start = torch.searchsorted(se, torch.arange(E, device=dev),
                                   side="left")
    pos_in_expert = torch.arange(T * top_k, device=dev) - run_start[se]
    keep = pos_in_expert < C
    slot = torch.where(keep, se * C + pos_in_expert,
                       torch.full_like(se, E * C))            # E*C: trash

    # ---- dispatch -------------------------------------------------------
    buf = torch.zeros((E * C + 1, D), dtype=x.dtype, device=dev)
    buf[slot] = x[st] * keep[:, None].to(x.dtype)
    buf = buf[:E * C].reshape(E, C, D)

    # ---- expert compute: one batched product per projection -------------
    gate_w = _expert_dense(p["experts_gate"], buf, policy)
    up_w = _expert_dense(p["experts_up"], buf, policy)
    out_e = _expert_dense(p["experts_down"], F.silu(gate_w) * up_w,
                          policy)                             # (E, C, D)

    # ---- combine, in a fixed order -------------------------------------
    out_flat = out_e.reshape(E * C, D)
    gathered = torch.where(keep[:, None],
                           out_flat[torch.clamp(slot, max=E * C - 1)],
                           torch.zeros((), dtype=out_flat.dtype,
                                       device=dev)).float()
    contrib = gathered * sg[:, None]                          # sorted order
    # each token's k sorted positions, ascending: ascending expert id
    where_sorted = torch.empty_like(order)
    where_sorted[order] = torch.arange(T * top_k, device=dev)
    per_token = torch.sort(where_sorted.reshape(T, top_k), dim=-1).values
    y = torch.zeros((T, D), dtype=torch.float32, device=dev)
    for j in range(top_k):
        y = y + contrib[per_token[:, j]]
    y = y.to(policy.compute_dtype)
    if not with_aux:
        return y, {}

    # ---- aux metrics (Switch load-balance + router z-loss) -------------
    me = probs.mean(dim=0)                                    # (E,)
    top1 = (expert_ids[:, :1] == torch.arange(E, device=dev)).float()
    ce = top1.mean(dim=0)
    aux = {
        "load_balance_loss": E * (me * ce).sum(),
        "router_z_loss": torch.logsumexp(logits, dim=-1).square().mean(),
        "dropped_fraction": 1.0 - keep.float().mean(),
    }
    return y, aux


def _expert_dense(w: Any, x: torch.Tensor,
                  policy: PrecisionPolicy) -> torch.Tensor:
    """Batched per-expert product: w (E, in, out) [possibly quantized],
    x (E, C, in) -> (E, C, out). Quantized weights take the grouped
    kernel, one launch over all experts (``linear_apply``)."""
    return linear_apply(w, x, policy)
