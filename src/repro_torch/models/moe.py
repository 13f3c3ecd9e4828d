"""Top-k Mixture-of-Experts FFN with capacity-based dispatch.

Counterpart of ``repro.models.moe``. Tokens are sorted by expert id and
scattered into a dense (experts, capacity, d_model) buffer, the experts
run as one batched product per projection, and the results gather
back, weighted by their gates. An expert that is routed more than
``capacity`` tokens drops the rest (Switch/GShard semantics); every
expert runs its whole buffer, routed or not, as the reference does.

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
``*_grouped``), given each expert's kept-row count from the dispatch (on
the device, no sync): the kernel reads only the experts with a kept row
and computes only the kept rows, zeros for the rest, which the combine
never reads, so the layer computes the reference's function. Under
fp32/fp16/bf16 a batched ``torch.matmul`` over every row, as the
reference leaves it to XLA.

Expert parallelism (the reference's ``shard_map`` path): inside an
:func:`expert_parallel` context over a mesh whose ``model`` axis divides
the expert count, and with plain (unquantized) expert weights,
:func:`moe_ffn` takes :func:`_moe_ffn_expert_parallel`. Every rank routes
its block of tokens (the data axes' share), runs only its E/m experts,
and one all-reduce over the ``model`` axis sums the combine in the
compute dtype; the aux metrics are averaged over the data axes. The
collectives are functional collectives, so
:class:`~repro_torch.core.op_analysis.OpCounter` sees them. On DTensors
(the dry run) the body runs on each rank's shards; on plain tensors over
a real group (gloo, NCCL), every rank holds the whole batch and all the
weights, takes its own share of both, and the token blocks are gathered
back over the data axes at the end.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Dict, Tuple

import torch

from repro_torch.core.precision import PrecisionPolicy
from repro_torch.core.sharded import axis_size, is_sharded, on_shards
from repro_torch.models.layers import silu_mul
from repro_torch.quant.apply import linear_apply

# (mesh, data axes, model axis) while an expert_parallel context is open
_EP_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "moe_expert_parallel", default=None)


@contextlib.contextmanager
def expert_parallel(mesh, data_axes=("data",), model_axis="model"):
    """Route :func:`moe_ffn` through the expert-parallel path over
    ``mesh`` (a ``DeviceMesh``) while the context is open."""
    tok = _EP_CTX.set((mesh, tuple(data_axes), model_axis))
    try:
        yield
    finally:
        _EP_CTX.reset(tok)


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
    with a leading expert axis. Inside an :func:`expert_parallel` context
    whose model axis divides E, plain experts take the expert-parallel
    path."""
    kw = dict(top_k=top_k, policy=policy, capacity_factor=capacity_factor,
              with_aux=with_aux)
    ep = _EP_CTX.get()
    if ep is not None:
        mesh, dax, max_ = ep
        E = p["w_router"].shape[-1]
        if (E % axis_size(mesh, max_) == 0
                and isinstance(p["experts_gate"], torch.Tensor)):
            return _moe_ffn_expert_parallel(p, x, mesh=mesh, data_axes=dax,
                                            model_axis=max_, **kw)
    if is_sharded(x):
        return _local_on_shards(p, x, **kw)
    return _moe_ffn_local(p, x, **kw)


def _local_on_shards(p, x, **kw):
    """The local path on DTensors (the dry run): every token and every
    expert gathered to each rank (quantized experts, or an expert count
    the model axis does not divide), as the reference's sort/scatter
    dispatch replicates its buffers when it cannot partition them."""
    from torch.distributed.tensor import Replicate
    from torch.utils._pytree import tree_leaves
    rep = [Replicate()] * x.device_mesh.ndim
    n = len(tree_leaves(p))

    def local(p_, x_):
        y, aux = _moe_ffn_local(p_, x_, **kw)
        return y, [aux[k] for k in _AUX_KEYS] if aux else []

    y, aux = on_shards(local, (rep, rep, rep, rep) if kw["with_aux"]
                       else (rep,), p, x, in_placements=[rep] * (n + 1))
    return y, (dict(zip(_AUX_KEYS, aux)) if aux else {})


def _dispatch(x: torch.Tensor, w_router: torch.Tensor, top_k: int, E: int,
              C: int):
    """Route x (T, D), sort the assignments by expert and scatter them
    into the (E, C, D) buffer. Returns (buf, the routing: logits, probs,
    expert_ids, the combine's order, keep, slot, sg, and each expert's
    kept rows, int32 (E,): min(its assignments, C), which fill rows 0 ..
    count - 1 of its buffer)."""
    T, D = x.shape
    dev = x.device
    logits, probs, gate_vals, expert_ids = route(x, w_router, top_k)

    # ---- flatten the assignments and sort them by expert ---------------
    flat_expert = expert_ids.reshape(-1)                      # (T*k,)
    order = torch.argsort(flat_expert, stable=True)
    se = flat_expert[order]
    st = order // top_k                                       # its token
    sg = gate_vals.reshape(-1)[order]
    # each expert's run, [bounds[e], bounds[e + 1]); position within it
    bounds = torch.searchsorted(se, torch.arange(E + 1, device=dev),
                                side="left", out_int32=True)
    pos_in_expert = torch.arange(T * top_k, device=dev) - bounds[se]
    keep = pos_in_expert < C
    kept_rows = torch.diff(bounds).clamp_(max=C)
    slot = torch.where(keep, se * C + pos_in_expert, E * C)   # E*C: trash

    # ---- dispatch -------------------------------------------------------
    buf = torch.zeros((E * C + 1, D), dtype=x.dtype, device=dev)
    buf[slot] = x[st] * keep[:, None].to(x.dtype)
    buf = buf[:E * C].reshape(E, C, D)
    return buf, (logits, probs, expert_ids, order, keep, slot, sg,
                 kept_rows)


def _combine(out_e: torch.Tensor, routing, top_k: int) -> torch.Tensor:
    """Each token's k weighted expert outputs of out_e (E, C, D), summed
    in f32 in a fixed order: (T, D) f32."""
    _, _, _, order, keep, slot, sg, _ = routing
    E, C, D = out_e.shape
    T = order.shape[0] // top_k
    dev = out_e.device
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
    return y


def _aux(routing, E: int) -> Dict[str, torch.Tensor]:
    """The Switch load-balance loss, the router z-loss and the dropped
    fraction of one routing."""
    logits, probs, expert_ids, _, keep, _, _, _ = routing
    me = probs.mean(dim=0)                                    # (E,)
    top1 = (expert_ids[:, :1] == torch.arange(E, device=probs.device)
            ).float()
    ce = top1.mean(dim=0)
    return {
        "load_balance_loss": E * (me * ce).sum(),
        "router_z_loss": torch.logsumexp(logits, dim=-1).square().mean(),
        "dropped_fraction": 1.0 - keep.float().mean(),
    }


def _moe_ffn_local(p: Dict[str, Any], x: torch.Tensor, *, top_k: int,
                   policy: PrecisionPolicy, capacity_factor: float = 1.25,
                   with_aux: bool = True
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The single-device path: every expert on this device."""
    T = x.shape[0]
    E = p["w_router"].shape[-1]
    C = expert_capacity(T, E, top_k, capacity_factor)
    buf, routing = _dispatch(x, p["w_router"], top_k, E, C)

    # ---- expert compute: one batched product per projection -------------
    rows = routing[-1]
    gate_w = _expert_dense(p["experts_gate"], buf, policy, rows)
    up_w = _expert_dense(p["experts_up"], buf, policy, rows)
    out_e = _expert_dense(p["experts_down"], silu_mul(gate_w, up_w),
                          policy, rows)                       # (E, C, D)
    y = _combine(out_e, routing, top_k).to(policy.compute_dtype)
    return y, (_aux(routing, E) if with_aux else {})


def _expert_dense(w: Any, x: torch.Tensor, policy: PrecisionPolicy,
                  rows=None) -> torch.Tensor:
    """Batched per-expert product: w (E, in, out) [possibly quantized],
    x (E, C, in) -> (E, C, out). Quantized weights, and bf16 or float16
    ones under a bf16 compute dtype, take a grouped kernel, one launch
    over all experts (``linear_apply``), which with ``rows`` (each
    expert's kept rows) reads only the kept experts and computes only
    those rows. A 16-bit product that autograd records (MoE training) and
    f32 compute keep the batched ``torch.matmul``."""
    return linear_apply(w, x, policy, rows)


# ---------------------------------------------------------------------------
# expert parallelism
# ---------------------------------------------------------------------------
def _group(mesh, name: str):
    """A mesh axis as a functional collective's group."""
    return (mesh, mesh.mesh_dim_names.index(name))


def _waited(t: torch.Tensor) -> torch.Tensor:
    """The result of a functional collective, waited for."""
    return t.wait() if hasattr(t, "wait") else t


_AUX_KEYS = ("load_balance_loss", "router_z_loss", "dropped_fraction")


def _ep_body(wr, wg, wu, wd, x_loc, *, top_k: int, policy: PrecisionPolicy,
             capacity_factor: float, E: int, mesh, data_axes, model_axis,
             with_aux: bool):
    """One rank's share: route the token block x_loc (T_loc, D), run the
    local experts wg/wu/wd (E_loc of the E), sum the combine over the
    model axis in the compute dtype, average the aux metrics over the data
    axes. Returns (y (T_loc, D), aux (3,) f32)."""
    from torch.distributed import _functional_collectives as funcol
    T_loc, D = x_loc.shape
    E_loc = wg.shape[0]
    r = mesh.get_local_rank(model_axis)
    C = expert_capacity(T_loc, E, top_k, capacity_factor)
    buf, routing = _dispatch(x_loc, wr, top_k, E, C)
    mine = buf[r * E_loc:(r + 1) * E_loc]
    h = silu_mul(_expert_dense(wg, mine, policy),
                 _expert_dense(wu, mine, policy))
    cd = policy.compute_dtype
    out = torch.zeros((E, C, D), dtype=cd, device=x_loc.device)
    out[r * E_loc:(r + 1) * E_loc] = _expert_dense(wd, h, policy).to(cd)
    y = _combine(out, routing, top_k).to(cd)
    y = _waited(funcol.all_reduce(y, "sum", _group(mesh, model_axis)))
    if not with_aux:
        aux = torch.zeros((3,), dtype=torch.float32, device=x_loc.device)
    else:
        a = _aux(routing, E)
        aux = torch.stack([a[k].float() for k in _AUX_KEYS])
        for ax in data_axes:
            aux = _waited(funcol.all_reduce(aux, "sum", _group(mesh, ax))) \
                / axis_size(mesh, ax)
    return y, aux


def _moe_ffn_expert_parallel(p: Dict[str, Any], x: torch.Tensor, *,
                             top_k: int, policy: PrecisionPolicy,
                             capacity_factor: float, mesh, data_axes,
                             model_axis: str, with_aux: bool = True
                             ) -> Tuple[torch.Tensor,
                                        Dict[str, torch.Tensor]]:
    """The expert-parallel MoE layer over ``mesh`` (module docstring). A
    token count the data axes do not divide takes the local path, as in
    the reference; on DTensors, each data rank then routes every token
    and runs its own experts."""
    from torch.distributed import _functional_collectives as funcol
    from repro_torch.core.sharded import placements
    T = x.shape[0]
    E = p["w_router"].shape[-1]
    d_shards = 1
    for a in data_axes:
        d_shards *= axis_size(mesh, a)
    if T % d_shards:
        if not is_sharded(x):
            return _moe_ffn_local(p, x, top_k=top_k, policy=policy,
                                  capacity_factor=capacity_factor,
                                  with_aux=with_aux)
        # on DTensors: each data rank routes every token, experts split
        data_axes = ()
    dspec = tuple(data_axes) or None
    weights = (p["w_router"], p["experts_gate"], p["experts_up"],
               p["experts_down"])
    kw = dict(top_k=top_k, policy=policy, capacity_factor=capacity_factor,
              E=E, mesh=mesh, data_axes=data_axes, model_axis=model_axis,
              with_aux=with_aux)
    if is_sharded(x, *weights):
        experts = placements(mesh, (model_axis, None, None))
        y, aux_v = on_shards(
            lambda *a: _ep_body(*a, **kw),
            (placements(mesh, (dspec, None)), placements(mesh, ())),
            *weights, x,
            in_placements=[placements(mesh, (None, None)), experts, experts,
                           experts, placements(mesh, (dspec, None))])
    else:
        # a real group: every rank holds all tokens and all weights
        T_loc = T // d_shards
        d_idx = 0
        for a in data_axes:
            d_idx = d_idx * axis_size(mesh, a) + mesh.get_local_rank(a)
        m = axis_size(mesh, model_axis)
        E_loc = E // m
        r = mesh.get_local_rank(model_axis)
        local = [w[r * E_loc:(r + 1) * E_loc] for w in weights[1:]]
        gather = getattr(funcol, "all_gather_single",
                         funcol.all_gather_tensor)
        y, aux_v = _ep_body(weights[0], *local,
                            x[d_idx * T_loc:(d_idx + 1) * T_loc], **kw)
        for a in reversed(data_axes):
            y = _waited(gather(y, 0, _group(mesh, a)))
    aux = ({k: aux_v[i] for i, k in enumerate(_AUX_KEYS)} if with_aux
           else {})
    return y, aux
