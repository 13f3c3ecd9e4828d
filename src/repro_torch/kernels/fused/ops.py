"""The fused passes as the model's layers call them
(:mod:`repro_torch.models.layers`: ``rms_norm``, ``rope_qk``,
``silu_mul``).

Every call goes to the kernel's wrapper
(:mod:`repro_torch.kernels.fused.kernel`), which routes by the input: the
plain version for a CPU tensor, the kernel for a CUDA tensor (or an
error: never the plain version), a cost record for a meta tensor under a
cost analysis, each rank's shards for DTensors. A call that autograd
records (grad mode on and an input requiring grad, as in training) goes
through :class:`KernelWithPlainGrad`: its forward is the wrapper's, and
its backward the plain version's gradient, recomputed from the saved
inputs (the kernels have no backward of their own).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.fused import kernel as _kernel


class KernelWithPlainGrad(torch.autograd.Function):
    """``kernel(*tensors, *rest)`` forward; backward, the gradient of
    ``plain(*tensors, *rest)`` at the saved ``tensors``, its ops rerun
    under autograd."""

    @staticmethod
    def forward(ctx, kernel, plain, n, *args):
        ctx.plain, ctx.rest = plain, args[n:]
        ctx.save_for_backward(*args[:n])
        return kernel(*args)

    @staticmethod
    def backward(ctx, *grads):
        needs = ctx.needs_input_grad[3:]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(need)
                   for t, need in zip(ctx.saved_tensors, needs)]
            outs = ctx.plain(*ins, *ctx.rest)
        outs = outs if isinstance(outs, tuple) else (outs,)
        pairs = [(o, g) for o, g in zip(outs, grads) if o.requires_grad]
        got = iter(torch.autograd.grad(
            [o for o, _ in pairs], [t for t in ins if t.requires_grad],
            [g for _, g in pairs]))
        return (None, None, None, *(next(got) if t.requires_grad else None
                                    for t in ins),
                *(None,) * len(ctx.rest))


def _recorded(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """x (..., D) normalised over its last axis, f32 inside, rounded once
    to x's dtype."""
    if _recorded(x, gamma):
        return KernelWithPlainGrad.apply(
            _kernel.rms_norm, _kernel.rms_norm_plain, 2, x, gamma, eps)
    return _kernel.rms_norm(x, gamma, eps)


def rope_qk(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor,
            theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (B, S, H, hd) and k (B, S, Kv, hd) rotated by ``positions``
    (B, S) or (S,): two ``apply_rope`` calls, bit for bit (one launch for
    both on the card)."""
    if _recorded(q, k):
        return KernelWithPlainGrad.apply(
            _kernel.rope_qk, _kernel.rope_qk_plain, 3, q, k, positions,
            theta)
    return _kernel.rope_qk(q, k, positions, theta)


def silu_mul(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``F.silu(g) * u``."""
    if _recorded(g, u):
        return KernelWithPlainGrad.apply(
            _kernel.silu_mul, _kernel.silu_mul_plain, 2, g, u)
    return _kernel.silu_mul(g, u)
