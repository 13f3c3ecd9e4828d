"""Training loop: the train step (loss, backward, AdamW) and the loop
driver.

Counterpart of ``repro.training.train_loop``. The reference ``jit``s a
pure ``jax.value_and_grad`` step; here the step runs eagerly under torch
autograd, attention's gradient through the flash kernel's backward
(:class:`repro_torch.kernels.flash_attention.kernel.FlashAttention`).
``train`` draws the params with ``model.init`` from a ``torch.Generator``
seeded with ``seed`` on the run-time device ``torch_device`` ("cuda" by
default): without a CUDA device it raises unless the caller passes
``torch_device="cpu"``; it never falls back to the CPU.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np
import torch

from repro_torch.models.api import Model
from repro_torch.training.losses import lm_loss
from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                            adamw_update, tree_leaves,
                                            tree_unflatten)

#: the device ``train`` runs on unless ``torch_device=`` names another
DEFAULT_TORCH_DEVICE = "cuda"


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: int = 0


def make_train_step(model: Model, opt_cfg: Optional[AdamWConfig] = None,
                    remat: bool = False) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: ``lm_loss``, its gradient with respect to every param
    leaf, then ``adamw_update``. The metrics are ``lm_loss``'s and the
    update's (``grad_norm``, ``lr``), as detached tensors."""
    opt_cfg = opt_cfg or AdamWConfig()

    def train_step(params, opt_state, batch):
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        total, metrics = lm_loss(model, tree_unflatten(params, leaves),
                                 batch, remat=remat)
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        params, opt_state, opt_metrics = adamw_update(
            opt_cfg, params, tree_unflatten(params, grads), opt_state)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(opt_metrics)
        return params, opt_state, metrics

    return train_step


def _check_torch_device(torch_device) -> None:
    if (torch.device(torch_device).type == "cuda"
            and not torch.cuda.is_available()):
        raise ValueError(
            f"train runs its model on torch_device={str(torch_device)!r}, "
            f"and no CUDA device is visible; pass torch_device='cpu' to "
            f"train on the host")


def _tensor(v, device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(device)
    return torch.from_numpy(np.ascontiguousarray(v)).to(device)


def train(model: Model, batches: Iterable[Dict[str, Any]],
          n_steps: int, seed: int = 0,
          opt_cfg: Optional[AdamWConfig] = None,
          log_every: int = 10,
          callback: Optional[Callable[[int, Dict], None]] = None, *,
          torch_device=DEFAULT_TORCH_DEVICE) -> TrainState:
    """Train ``model`` (run on ``torch_device``) for ``n_steps`` over
    ``batches`` (dicts of numpy arrays or tensors), from params drawn
    with ``seed``; prints the reference's log line every ``log_every``
    steps and the last."""
    _check_torch_device(torch_device)
    device = torch.device(torch_device)
    if model.device != device:
        model = dataclasses.replace(model, device=device)
    params = model.init(torch.Generator(device=device).manual_seed(seed))
    opt_state = adamw_init(params)
    step_fn = make_train_step(model, opt_cfg)
    t0 = time.perf_counter()
    it = iter(batches)
    metrics: Dict[str, Any] = {}
    for step in range(n_steps):
        batch = {k: _tensor(v, device) for k, v in next(it).items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if callback is not None:
            callback(step, metrics)
        if log_every and (step % log_every == 0 or step == n_steps - 1):
            m = {k: float(v) for k, v in metrics.items()}
            dt = time.perf_counter() - t0
            print(f"step {step:5d}  loss={m['lm_loss']:.4f}  "
                  f"grad_norm={m['grad_norm']:.3f}  "
                  f"({dt:.1f}s elapsed)", flush=True)
    return TrainState(params=params, opt_state=opt_state, step=n_steps)
