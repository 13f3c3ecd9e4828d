"""npz checkpointing for the params and optimizer state.

Counterpart of ``repro.training.checkpoint``, writing the reference's
layout so that either package reads what the other writes: keys are the
tree paths joined with ``//`` under ``params`` and ``opt``; a quantized
leaf adds an ``@Int8Weight.<field>`` / ``@NF4Weight.<field>`` component;
bf16 arrays are stored as their uint16 view under a key ending in
``@bf16``; ``__step__`` holds the step. The reference stacks the decoder
(or Mamba) layers and the audio encoder's layers on a leading axis,
where the port keeps a list of per-layer dicts: the writer stacks them,
in the params and in each optimizer moment, and the reader unstacks them
with :func:`repro_torch.weights.unstack_layers`.
"""
from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.quant.int8 import Int8Weight
from repro_torch.quant.nf4 import NF4Weight
from repro_torch.weights import _BF16_TAG, _SEP, _STACKS, nest, unstack_layers


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _stacked(layers: list) -> Any:
    """A list of per-layer trees of numpy leaves as one tree whose leaves
    carry a leading layer axis."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stacked([lp[k] for lp in layers]) for k in first}
    if isinstance(first, (Int8Weight, NF4Weight)):
        return type(first)(*(_stacked([lp[i] for lp in layers])
                             for i in range(len(first))))
    return np.stack(layers)


def _as_reference(tree: Dict[str, Any]) -> Dict[str, Any]:
    """The params tree (or a moment mirroring it) with numpy leaves and
    its layer lists stacked."""
    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (Int8Weight, NF4Weight)):
            return type(node)(*(walk(f) for f in node))
        if isinstance(node, list):
            return [walk(v) for v in node]
        return _numpy(node)

    out = walk(tree)
    for key in _STACKS:
        if key in out:
            out[key] = _stacked(out[key])
    return out


def _flatten(tree, prefix="") -> Dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}{_SEP}"))
    elif isinstance(tree, (Int8Weight, NF4Weight)):
        tname = type(tree).__name__
        for f, v in tree._asdict().items():
            out.update(_flatten(v, f"{prefix}@{tname}.{f}{_SEP}"))
    else:
        key = prefix[:-len(_SEP)]
        if tree.dtype == np.uint16:       # a bf16 view (_numpy)
            out[key + _BF16_TAG] = tree
        else:
            out[key] = tree
    return out


def save_checkpoint(path: str, params: Any, opt_state: Any = None,
                    step: int = 0) -> None:
    """Write ``params`` (and ``opt_state``: ``m``, ``v``, ``step``) to the
    npz at ``path``."""
    flat = _flatten({"params": _as_reference(params)})
    if opt_state is not None:
        opt = {"m": _as_reference(opt_state["m"]),
               "v": _as_reference(opt_state["v"]),
               "step": _numpy(torch.as_tensor(opt_state["step"]))}
        flat.update(_flatten({"opt": opt}))
    flat["__step__"] = np.asarray(step)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **flat)


def load_checkpoint(path: str, device="cuda"):
    """Returns (params, opt_state or None, step), tensors on ``device``,
    the layers as lists of per-layer trees."""
    with np.load(path, allow_pickle=False) as data:
        flat = {k: data[k] for k in data.files}
    step = int(flat.pop("__step__", 0))
    tree = nest(flat, device)
    params = unstack_layers(tree.get("params", {}))
    opt = tree.get("opt")
    if opt is not None:
        opt = dict(opt, m=unstack_layers(opt["m"]),
                   v=unstack_layers(opt["v"]))
    return params, opt, step
