"""Weights carried across from the JAX package.

Counterpart of ``repro.training.checkpoint`` on the reading side (the
port's own ``repro_torch.training.checkpoint`` reads through :func:`nest`
and :func:`unstack_layers` too). The
reference's ``save_checkpoint`` writes an npz whose keys are the
parameter paths joined with ``//``; quantized leaves add a
``@Int8Weight.<field>`` / ``@NF4Weight.<field>`` component, and bf16
arrays are stored as their uint16 view under a key ending in ``@bf16``.
The reference stacks the decoder (or Mamba) layers and the audio
encoder's layers on a leading axis; the port keeps a list of per-layer
dicts, so that axis is unstacked here, quantized leaves included.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.quant.int8 import Int8Weight
from repro_torch.quant.nf4 import NF4Weight

_SEP = "//"
_TYPES = {"Int8Weight": Int8Weight, "NF4Weight": NF4Weight}
_BF16_TAG = "@bf16"
#: the stacked layer trees: the decoder (or Mamba) layers, and the audio
#: encoder's; hybrid's ``shared`` is one layer and stays a dict
_STACKS = ("layers", "enc_layers")


def _tensor(key: str, arr: np.ndarray, device) -> torch.Tensor:
    if key.endswith(_BF16_TAG):
        # torch.from_numpy refuses ml_dtypes' bfloat16: go through the
        # 16-bit integer view the checkpoint stores
        t = torch.from_numpy(np.asarray(arr, order="C").view(np.int16)) \
            .view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.asarray(arr, order="C"))
    return t.to(device)


def _rebuild(node: Any) -> Any:
    if not isinstance(node, dict):
        return node
    tagged = [k for k in node if k.startswith("@")]
    if tagged:
        tname = tagged[0][1:].split(".", 1)[0]
        fields = {k[1:].split(".", 1)[1]: node[k] for k in node}
        return _TYPES[tname](**fields)
    return {k: _rebuild(v) for k, v in node.items()}


def _unstack(node: Any, n: int) -> list:
    """Split a tree whose leaves all carry a leading layer axis of size
    ``n`` into ``n`` trees."""
    if isinstance(node, dict):
        parts = {k: _unstack(v, n) for k, v in node.items()}
        return [{k: parts[k][i] for k in node} for i in range(n)]
    if isinstance(node, (Int8Weight, NF4Weight)):
        fields = [_unstack(f, n) for f in node]
        return [type(node)(*(f[i] for f in fields)) for i in range(n)]
    if node.shape[0] != n:
        raise ValueError(f"leaf with leading axis {node.shape[0]}, "
                         f"expected {n} layers")
    return [node[i].contiguous() for i in range(n)]


def nest(flat: Mapping[str, np.ndarray], device="cuda") -> Dict[str, Any]:
    """The tree of a checkpoint's flattened entries (``//``-joined keys,
    bf16 under ``@bf16``, quantized leaves tagged), as tensors on
    ``device``, layers still stacked; ``__step__`` is skipped."""
    tree: Dict[str, Any] = {}
    for key, arr in flat.items():
        if key == "__step__":
            continue
        path = key[:-len(_BF16_TAG)] if key.endswith(_BF16_TAG) else key
        parts = path.split(_SEP)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _tensor(key, arr, device)
    return _rebuild(tree)


def unstack_layers(tree: Dict[str, Any]) -> Dict[str, Any]:
    """``tree`` (params, or an optimizer moment mirroring them) with its
    stacked layer trees (``layers``, ``enc_layers``) split into lists of
    per-layer trees."""
    tree = dict(tree)
    for key in _STACKS:
        if key in tree:
            first = tree[key]
            while isinstance(first, dict):
                first = next(iter(first.values()))
            n = (first[0] if isinstance(first, tuple) else first).shape[0]
            tree[key] = _unstack(tree[key], n)
    return tree


def params_from_numpy(flat: Mapping[str, np.ndarray],
                      device="cuda") -> Dict[str, Any]:
    """The port's params tree from the reference's flattened params
    (``save_checkpoint``'s keys; a leading ``params//`` is optional and
    other top-level entries, such as optimizer state, are skipped)."""
    flat = {(k[len("params") + len(_SEP):] if k.startswith("params" + _SEP)
             else k): v for k, v in flat.items()
            if k.split(_SEP)[0] not in ("opt", "__step__")}
    return unstack_layers(nest(flat, device))


def load_jax_checkpoint(path: str, device="cuda") -> Dict[str, Any]:
    """Read a ``repro.training.checkpoint.save_checkpoint`` npz into the
    port's params tree."""
    with np.load(path, allow_pickle=False) as data:
        flat = {k: data[k] for k in data.files}
    return params_from_numpy(flat, device)
