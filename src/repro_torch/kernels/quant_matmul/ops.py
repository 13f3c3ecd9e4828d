"""Quantized linear ops backed by the dequant-matmul kernels.

Counterpart of ``repro.kernels.quant_matmul.ops``: the entry points
:func:`repro_torch.quant.apply.linear_apply` uses for ``Int8Weight`` and
``NF4Weight``. Leading dims are flattened into the kernel's M. The
LLM.int8 outlier product stays a ``torch.matmul`` outside the kernel,
added to its output in the compute dtype, as the reference leaves it to
XLA (``ops.py:43-47`` there).

The ``*_grouped_kernel`` entry points take weights with a leading expert
axis (E, K, N) and x (E, C, K): one grouped launch over all experts,
what the reference's ``_expert_dense`` computes by ``jax.vmap`` of
``linear_apply`` over the experts. int8's outlier product stays outside,
per expert, with the 2-D path's rounding points: one batched gather of
each expert's outlier columns of x and one f32 ``torch.bmm``, rounded to
the compute dtype and added.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.quant_matmul.kernel import (int8_matmul,
                                                     int8_matmul_grouped,
                                                     nf4_matmul,
                                                     nf4_matmul_grouped)
from repro_torch.core.sharded import gather_last, is_sharded
from repro_torch.quant.int8 import Int8Weight
from repro_torch.quant.nf4 import NF4Weight


def _as_2d(x: torch.Tensor, compute_dtype):
    lead = tuple(x.shape[:-1])
    return x.reshape(-1, x.shape[-1]).to(compute_dtype).contiguous(), lead


def int8_matmul_kernel(x: torch.Tensor, q: Int8Weight,
                       compute_dtype=torch.bfloat16) -> torch.Tensor:
    x2, lead = _as_2d(x, compute_dtype)
    out = int8_matmul(x2, q.codes, q.scale, compute_dtype)
    if q.outlier_idx.shape[0]:
        if is_sharded(x2):        # the dry run: its rows, whole
            x2 = gather_last(x2)
        x_out = torch.index_select(x2, -1, q.outlier_idx.long())
        out = out + torch.matmul(
            x_out.float(), q.outlier_w.to(compute_dtype).float()
        ).to(out.dtype)
    return out.reshape(lead + (out.shape[-1],))


def nf4_matmul_kernel(x: torch.Tensor, q: NF4Weight,
                      compute_dtype=torch.bfloat16) -> torch.Tensor:
    x2, lead = _as_2d(x, compute_dtype)
    out = nf4_matmul(x2, q.packed, q.absmax, compute_dtype)
    return out.reshape(lead + (out.shape[-1],))


def int8_matmul_grouped_kernel(x: torch.Tensor, q: Int8Weight,
                               compute_dtype=torch.bfloat16) -> torch.Tensor:
    """x (E, C, K) @ q (E, K, N) -> (E, C, N), expert by expert."""
    x3 = x.to(compute_dtype).contiguous()
    out = int8_matmul_grouped(x3, q.codes, q.scale, compute_dtype)
    n_out = q.outlier_idx.shape[-1]
    if n_out:
        cols = q.outlier_idx.long()[:, None, :].expand(
            x3.shape[0], x3.shape[1], n_out)
        x_out = torch.gather(x3, 2, cols)
        out = out + torch.bmm(
            x_out.float(), q.outlier_w.to(compute_dtype).float()
        ).to(out.dtype)
    return out


def nf4_matmul_grouped_kernel(x: torch.Tensor, q: NF4Weight,
                              compute_dtype=torch.bfloat16) -> torch.Tensor:
    """x (E, C, K) @ q (E, K, N) -> (E, C, N), expert by expert."""
    return nf4_matmul_grouped(x.to(compute_dtype).contiguous(), q.packed,
                              q.absmax, compute_dtype)
