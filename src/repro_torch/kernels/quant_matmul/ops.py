"""Quantized linear ops backed by the dequant-matmul kernels.

Counterpart of ``repro.kernels.quant_matmul.ops``: the entry points
:func:`repro_torch.quant.apply.linear_apply` uses for ``Int8Weight``,
``NF4Weight`` and a float16 weight under a bf16 compute dtype. Leading
dims are flattened into the kernel's M. The LLM.int8 outlier product,
which the reference leaves to XLA beside its Pallas kernel (``ops.py:43-
47`` there: a gather, a bf16 product with f32 sums, a cast and an add),
runs inside the int8 kernel with the same rounding points: one launch a
call, on the meta device one record of the whole call.

The ``*_grouped_kernel`` entry points take weights with a leading expert
axis (E, K, N) and x (E, C, K): one grouped launch over all experts,
what the reference's ``_expert_dense`` computes by ``jax.vmap`` of
``linear_apply`` over the experts, and optionally each expert's kept-row
count (``rows``, the dispatch's: the kernel then reads only the experts
with a kept row and zeros the rest), int8's with each expert's outlier
product. A plain bf16 or float16 expert stack under a bf16 compute
dtype takes :func:`f16_matmul_grouped_kernel` (the bf16 or fp16 grouped
kernel). A product that autograd records keeps ``torch.matmul``
instead, 2-D float16 ones too: the kernels have no backward, so
training does (``repro_torch.quant.apply``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.quant_matmul.kernel import (bf16_matmul_grouped,
                                                     fp16_matmul,
                                                     fp16_matmul_grouped,
                                                     int8_matmul,
                                                     int8_matmul_grouped,
                                                     nf4_matmul,
                                                     nf4_matmul_grouped)
from repro_torch.quant.int8 import Int8Weight
from repro_torch.quant.nf4 import NF4Weight


def _as_2d(x: torch.Tensor, compute_dtype):
    lead = tuple(x.shape[:-1])
    return x.reshape(-1, x.shape[-1]).to(compute_dtype).contiguous(), lead


def int8_matmul_kernel(x: torch.Tensor, q: Int8Weight,
                       compute_dtype=torch.bfloat16) -> torch.Tensor:
    x2, lead = _as_2d(x, compute_dtype)
    out = int8_matmul(x2, q.codes, q.scale, compute_dtype, *_outliers(q))
    return out.reshape(lead + (out.shape[-1],))


def _outliers(q: Int8Weight) -> tuple:
    """The weight's outlier fields, or none where it has no outlier row."""
    return (q.outlier_idx, q.outlier_w) if q.outlier_idx.shape[-1] else ()


def fp16_matmul_kernel(x: torch.Tensor, w: torch.Tensor,
                       compute_dtype=torch.bfloat16) -> torch.Tensor:
    """x (..., K) @ w float16 (K, N) in the compute dtype."""
    x2, lead = _as_2d(x, compute_dtype)
    out = fp16_matmul(x2, w, compute_dtype)
    return out.reshape(lead + (out.shape[-1],))


def nf4_matmul_kernel(x: torch.Tensor, q: NF4Weight,
                      compute_dtype=torch.bfloat16) -> torch.Tensor:
    x2, lead = _as_2d(x, compute_dtype)
    out = nf4_matmul(x2, q.packed, q.absmax, compute_dtype)
    return out.reshape(lead + (out.shape[-1],))


def int8_matmul_grouped_kernel(x: torch.Tensor, q: Int8Weight,
                               compute_dtype=torch.bfloat16,
                               rows=None) -> torch.Tensor:
    """x (E, C, K) @ q (E, K, N) -> (E, C, N), expert by expert."""
    return int8_matmul_grouped(x.to(compute_dtype).contiguous(), q.codes,
                               q.scale, compute_dtype, rows, *_outliers(q))


def nf4_matmul_grouped_kernel(x: torch.Tensor, q: NF4Weight,
                              compute_dtype=torch.bfloat16,
                              rows=None) -> torch.Tensor:
    """x (E, C, K) @ q (E, K, N) -> (E, C, N), expert by expert."""
    return nf4_matmul_grouped(x.to(compute_dtype).contiguous(), q.packed,
                              q.absmax, compute_dtype, rows)


def f16_matmul_grouped_kernel(x: torch.Tensor, w: torch.Tensor,
                              compute_dtype=torch.bfloat16,
                              rows=None) -> torch.Tensor:
    """x (E, C, K) @ w bf16 or float16 (E, K, N) -> (E, C, N), expert by
    expert: the grouped kernel of w's dtype."""
    fn = fp16_matmul_grouped if w.dtype == torch.float16 \
        else bf16_matmul_grouped
    return fn(x.to(compute_dtype).contiguous(), w, compute_dtype, rows)
