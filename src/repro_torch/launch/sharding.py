"""Sharding rules: param / optimizer / input / cache specs, and their
DTensor placements.

Counterpart of ``repro.launch.sharding``, with the same policy:

* batch dims        -> ("pod",)+"data" (when divisible),
* attention q/kv projections, FFN hidden, MoE experts, SSM heads, vocab
                    -> "model" (tensor/expert parallel),
* KV-cache sequence dim -> "model" for decode,
* optimizer moments -> params' spec + an extra "data" shard on the first
  divisible replicated dim (ZeRO-style).

Every rule is divisibility-guarded: a dim only gets a mesh axis if its
size divides evenly. A spec is a tuple with one entry per tensor dim:
``None``, an axis name, or a tuple of axis names (the reference's
``PartitionSpec`` entries). The rules count dims from the end, so they
give the port's per-layer leaves (a list of layers, not a stacked layer
axis) the reference's specs with the layer axis dropped. The ZeRO shard
of a moment takes the first replicated dim that divides, which in the
reference can be the stacked layer axis: a per-layer moment then shards
another dim, or none.

:func:`named` turns specs into DTensor placements
(:func:`repro_torch.core.sharded.placements`) and :func:`place`
distributes a tree of tensors with them. How the model then runs on
those DTensors is :mod:`repro_torch.core.sharded`'s.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.sharded import axis_size, placements
from repro_torch.launch.mesh import data_axes

Spec = Tuple[Any, ...]

# leaf-name -> which dim gets "model"
_MODEL_AXIS_RULES = {
    # attention / mlp
    "wq": -1, "wk": -1, "wv": -1, "w_gate": -1, "w_up": -1, "w_in": -1,
    "bq": -1, "bk": -1, "bv": -1,
    "wo": -2, "w_down": -2, "w_out": -2,
    # moe: experts dim
    "experts_gate": -3, "experts_up": -3, "experts_down": -3,
    # ssm small tensors: shard heads/channels
    "conv_w": -1, "conv_b": -1, "A_log": -1, "D": -1, "dt_bias": -1,
    "gate_norm": -1,
    # embeddings
    "embed": -2, "lm_head": -1,
}
_REPLICATED = {"w_router", "norm", "attn_norm", "mlp_norm", "cross_norm",
               "final_norm", "enc_norm"}

# quantized-weight fields: codes/packed shard like their parent weight;
# scales/outliers are small and stay replicated
_QUANT_MAIN_FIELDS = ("codes", "packed")
_QUANT_SIDE_FIELDS = ("scale", "absmax", "outlier_idx", "outlier_w")


def _leaf_spec(path: str, shape, mesh) -> Spec:
    parts = path.split("/")
    name = parts[-1]
    ndim = len(shape)
    spec = [None] * ndim
    if name in _QUANT_SIDE_FIELDS or ndim == 0:
        return tuple(spec)
    if name in _QUANT_MAIN_FIELDS and len(parts) >= 2:
        name = parts[-2]                    # parent weight's rule
    if name in _REPLICATED:
        return tuple(spec)
    dim = _MODEL_AXIS_RULES.get(name)
    if dim is None:
        return tuple(spec)
    dim = ndim + dim if dim < 0 else dim
    if 0 <= dim < ndim and shape[dim] % axis_size(mesh, "model") == 0:
        spec[dim] = "model"
    return tuple(spec)


def map_tree(fn: Callable, tree: Any, *rest: Any, path: str = "") -> Any:
    """``fn(path, leaf, *rest_leaves)`` over the leaves of a params-like
    tree (dicts, lists of layers, NamedTuple quantized weights; anything
    else is a leaf, a spec tuple too) and the matching leaves of
    ``rest``, keeping the structure. A list index is a path part: the
    rules read only the last two parts."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(r[k] for r in rest),
                            path=f"{path}/{k}" if path else k)
                for k, v in tree.items()}
    if isinstance(tree, list) or (isinstance(tree, tuple)
                                  and hasattr(tree, "_fields")):
        names = getattr(tree, "_fields", range(len(tree)))
        out = [map_tree(fn, v, *(r[i] for r in rest), path=f"{path}/{n}")
               for i, (n, v) in enumerate(zip(names, tree))]
        return out if isinstance(tree, list) else type(tree)(*out)
    return fn(path, tree, *rest)


def param_specs(params, mesh):
    """Spec tree matching a params tree (by leaf name)."""
    return map_tree(lambda p, t: _leaf_spec(p, t.shape, mesh), params)


def opt_specs(opt_state, pspecs, mesh):
    """Optimizer moments: param spec + ZeRO 'data' shard on the first
    replicated dim that divides."""
    dsize = axis_size(mesh, "data")

    def zero_shard(path, spec: Spec, leaf) -> Spec:
        s = list(spec) + [None] * (len(leaf.shape) - len(spec))
        for i, (ax, dim) in enumerate(zip(s, leaf.shape)):
            if ax is None and dim % dsize == 0 and dim >= dsize:
                s[i] = "data"
                break
        return tuple(s)

    m_specs = map_tree(zero_shard, pspecs, opt_state["m"])
    return {"m": m_specs, "v": m_specs, "step": ()}


# ---------------------------------------------------------------------------
# inputs / caches
# ---------------------------------------------------------------------------
def _batch_axes(mesh, batch: int):
    dax = data_axes(mesh)
    total = int(np.prod([axis_size(mesh, a) for a in dax]))
    if batch % total == 0:
        return dax
    if batch % axis_size(mesh, "data") == 0:
        return ("data",)
    return None


def input_specs_sharding(cfg: ModelConfig, shape: ShapeConfig, mesh,
                         specs: Dict[str, Any]) -> Dict[str, Spec]:
    b_ax = _batch_axes(mesh, shape.global_batch)
    return {k: (b_ax,) + (None,) * (v.ndim - 1) for k, v in specs.items()}


def cache_specs(cfg: ModelConfig, cache, mesh,
                batch: int) -> Dict[str, Spec]:
    """Decode-cache specs: batch on data axes, cache length (or SSM
    heads / conv channels) on "model"."""
    b_ax = _batch_axes(mesh, batch)
    msz = axis_size(mesh, "model")

    def spec_for(key: str, leaf) -> Spec:
        shp = leaf.shape
        if key in ("k", "v", "shared_k", "shared_v", "enc_k", "enc_v"):
            w = "model" if shp[2] % msz == 0 else None   # (L, B, W, kv, hd)
            return (None, b_ax, w, None, None)
        if key == "ssm_state":                # (L, B, nh, hd, ds)
            h = "model" if shp[2] % msz == 0 else None
            return (None, b_ax, h, None, None)
        if key == "conv":                     # (L, B, K-1, C)
            c = "model" if shp[3] % msz == 0 else None
            return (None, b_ax, None, c)
        if key in ("k_scale", "v_scale"):     # (L, B, W, kv)
            w = "model" if shp[2] % msz == 0 else None
            return (None, b_ax, w, None)
        if key == "slot_pos":                 # (B, W)
            w = "model" if shp[1] % msz == 0 else None
            return (b_ax, w)
        if key == "pos":                      # (B,)
            return (b_ax,)
        return (None,) * len(shp)

    return {k: spec_for(k, v) for k, v in cache.items()}


# ---------------------------------------------------------------------------
# DTensor placements
# ---------------------------------------------------------------------------
def named(mesh, spec_tree):
    """The placements of every spec of ``spec_tree``."""
    return map_tree(lambda p, s: None if s is None else placements(mesh, s),
                    spec_tree)


def place(mesh, tree, spec_tree):
    """``tree``'s tensors distributed on ``mesh`` by ``spec_tree``
    (``distribute_tensor``); a leaf without a spec stays as it is."""
    from torch.distributed.tensor import distribute_tensor

    def one(path, t, spec):
        if spec is None or not isinstance(t, torch.Tensor):
            return t
        return distribute_tensor(t, mesh, placements(mesh, spec))

    return map_tree(one, tree, spec_tree)
