"""Quantized linear ops backed by the dequant-matmul kernels.

Counterpart of ``repro.kernels.quant_matmul.ops``: the entry points
:func:`repro_torch.quant.apply.linear_apply` uses for ``Int8Weight`` and
``NF4Weight``. Leading dims are flattened into the kernel's M. The
LLM.int8 outlier product stays a ``torch.matmul`` outside the kernel,
added to its output in the compute dtype, as the reference leaves it to
XLA (``ops.py:43-47`` there).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.quant_matmul.kernel import int8_matmul, nf4_matmul
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
