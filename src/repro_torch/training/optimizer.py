"""AdamW in plain PyTorch (no ``torch.optim``).

Counterpart of ``repro.training.optimizer``. Moments are kept in f32
whatever the param dtype; the update is computed in f32 and cast back,
the standard mixed-precision recipe. Matrices (``ndim >= 2``) are
decayed, vectors are not. Gradients are clipped by their global norm.
The state mirrors the params tree (lists of per-layer dicts): ``m``,
``v`` and the step counter ``step``, an int32 tensor. The update runs
under ``torch.no_grad()`` on the params' device and returns new tensors;
it does not write into the old ones.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the tensor leaves of ``tree`` (dicts, lists and tuples,
    NamedTuples included) and the matching leaves of ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        if isinstance(tree, list):
            return out
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """The tensor leaves of ``tree`` in :func:`tree_map`'s order."""
    out: List[torch.Tensor] = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(like: Any, leaves: List[torch.Tensor]) -> Any:
    """``like``'s structure with ``leaves`` (in :func:`tree_leaves`'
    order) at its leaves."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def adamw_init(params) -> Dict[str, Any]:
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    device = tree_leaves(params)[0].device
    return {"m": zeros,
            "v": tree_map(torch.zeros_like, zeros),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp((step + 1).float() / cfg.warmup_steps, max=1.0)
    return cfg.lr * warm


def global_norm(tree) -> torch.Tensor:
    leaves = [g.float().square().sum() for g in tree_leaves(tree)]
    return torch.sqrt(torch.stack(leaves).sum())


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    step = state["step"] + 1
    gn = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / (gn + 1e-9), max=1.0)
    lr = _schedule(cfg, state["step"])
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()

    def upd(p, g, m, v):
        g = g.float() * clip
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g.square()
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if p.ndim >= 2:   # decay matrices only (standard practice)
            delta = delta + cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m, v

    new_p, new_m, new_v = [], [], []
    for p, g, m, v in zip(*(tree_leaves(t) for t in (
            params, grads, state["m"], state["v"]))):
        for acc, t in zip((new_p, new_m, new_v), upd(p, g, m, v)):
            acc.append(t)
    metrics = {"grad_norm": gn, "lr": lr}
    return (tree_unflatten(params, new_p),
            {"m": tree_unflatten(params, new_m),
             "v": tree_unflatten(params, new_v), "step": step}, metrics)
