"""Vector-wise absmax int8 weight quantization (LLM.int8).

Counterpart of ``repro.quant.int8``: the same representation and the
same bytes. Per-output-column absmax scales, plus an optional thin bf16
slice of outlier *input rows* that is computed as a second matmul and
added back (the LLM.int8 decomposition). The int8 quant_matmul kernel
consumes exactly this representation.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class Int8Weight(NamedTuple):
    """Quantized (in_dim, out_dim) weight.

    ``codes``  int8  (in_dim, out_dim)
    ``scale``  f32   (out_dim,)           absmax / 127 per output column
    ``outlier_idx``  int32 (n_outliers,)  input rows kept in 16-bit
    ``outlier_w``    bf16  (n_outliers, out_dim)
    """
    codes: torch.Tensor
    scale: torch.Tensor
    outlier_idx: torch.Tensor
    outlier_w: torch.Tensor


def quantize_int8(w: torch.Tensor, outlier_fraction: float = 0.0
                  ) -> Int8Weight:
    """Vector-wise absmax quantization with optional outlier split.

    The outlier rows (largest L-inf norm; ties broken by index, as
    ``jnp.argsort`` does) are zeroed in the codes and kept in bf16."""
    if w.ndim != 2:
        raise ValueError(f"expected 2-D weight, got {tuple(w.shape)}")
    w = w.to(torch.float32)
    in_dim = w.shape[0]
    n_out = int(round(outlier_fraction * in_dim))
    if n_out > 0:
        row_mag = w.abs().amax(dim=1)
        outlier_idx = torch.argsort(-row_mag, stable=True)[:n_out] \
            .to(torch.int32)
        outlier_w = w[outlier_idx.long()].to(torch.bfloat16)
        w = w.clone()
        w[outlier_idx.long()] = 0.0
    else:
        outlier_idx = torch.zeros((0,), dtype=torch.int32, device=w.device)
        outlier_w = torch.zeros((0, w.shape[1]), dtype=torch.bfloat16,
                                device=w.device)
    absmax = w.abs().amax(dim=0)
    scale = torch.where(absmax > 0, absmax / 127.0,
                        torch.ones_like(absmax)).to(torch.float32)
    codes = torch.clamp(torch.round(w / scale[None, :]), -127, 127) \
        .to(torch.int8)
    return Int8Weight(codes=codes, scale=scale, outlier_idx=outlier_idx,
                      outlier_w=outlier_w)


def dequantize_int8(q: Int8Weight, dtype=torch.bfloat16) -> torch.Tensor:
    w = q.codes.to(torch.float32) * q.scale[None, :]
    if q.outlier_idx.shape[0]:
        w = w.index_add(0, q.outlier_idx.long(),
                        q.outlier_w.to(torch.float32))
    return w.to(dtype)


def int8_matmul(x: torch.Tensor, q: Int8Weight,
                compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Reference formula: dequantize (scale applied *before* the
    product), matmul with f32 accumulation, plus the outlier matmul.

    The model path does not use it: :func:`repro_torch.quant.apply.
    linear_apply` goes through the int8 kernel, which applies the scale
    in the epilogue, after the product."""
    w = (q.codes.to(torch.float32) * q.scale[None, :]).to(compute_dtype)
    main = torch.matmul(x.to(compute_dtype).float(), w.float())
    if q.outlier_idx.shape[0]:
        x_out = torch.index_select(x, -1, q.outlier_idx.long()) \
            .to(compute_dtype)
        main = main + torch.matmul(x_out.float(),
                                   q.outlier_w.to(compute_dtype).float())
    return main.to(compute_dtype)
