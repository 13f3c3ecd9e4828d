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
    """Quantized (in_dim, out_dim) weight, or a stack of E expert weights
    (E, in_dim, out_dim), each slice quantized on its own: every field
    then carries the leading expert axis.

    ``codes``  int8  ([E,] in_dim, out_dim)
    ``scale``  f32   ([E,] out_dim)           absmax / 127 per output column
    ``outlier_idx``  int32 ([E,] n_outliers)  input rows kept in 16-bit
    ``outlier_w``    bf16  ([E,] n_outliers, out_dim)
    """
    codes: torch.Tensor
    scale: torch.Tensor
    outlier_idx: torch.Tensor
    outlier_w: torch.Tensor


def quantize_int8(w: torch.Tensor, outlier_fraction: float = 0.0
                  ) -> Int8Weight:
    """Vector-wise absmax quantization with optional outlier split.

    The outlier rows (largest L-inf norm; ties broken by index, as
    ``jnp.argsort`` does) are zeroed in the codes and kept in bf16. A 3-D
    ``w`` (E, in_dim, out_dim) is quantized batched over its expert axis,
    to the bytes of quantizing each slice alone (the reference's
    ``quant/apply.py`` quantizes slice by slice)."""
    if w.ndim not in (2, 3):
        raise ValueError(f"expected a 2-D weight or an (E, in, out) stack, "
                         f"got {tuple(w.shape)}")
    w = w.to(torch.float32)
    lead, (in_dim, out_dim) = tuple(w.shape[:-2]), tuple(w.shape[-2:])
    n_out = int(round(outlier_fraction * in_dim))
    if n_out > 0:
        row_mag = w.abs().amax(dim=-1)
        outlier_idx = torch.argsort(-row_mag, dim=-1, stable=True) \
            [..., :n_out].to(torch.int32)
        rows = outlier_idx.long()[..., None].expand(lead + (n_out, out_dim))
        outlier_w = torch.gather(w, -2, rows).to(torch.bfloat16)
        w = w.scatter(-2, rows, 0.0)
    else:
        outlier_idx = torch.zeros(lead + (0,), dtype=torch.int32,
                                  device=w.device)
        outlier_w = torch.zeros(lead + (0, out_dim), dtype=torch.bfloat16,
                                device=w.device)
    absmax = w.abs().amax(dim=-2)
    scale = torch.where(absmax > 0, absmax / 127.0,
                        torch.ones_like(absmax)).to(torch.float32)
    codes = torch.clamp(torch.round(w / scale[..., None, :]), -127, 127) \
        .to(torch.int8)
    return Int8Weight(codes=codes, scale=scale, outlier_idx=outlier_idx,
                      outlier_w=outlier_w)


def dequantize_int8(q: Int8Weight, dtype=torch.bfloat16) -> torch.Tensor:
    w = q.codes.to(torch.float32) * q.scale[..., None, :]
    if q.outlier_idx.shape[-1]:
        rows = q.outlier_idx.long()[..., None].expand(q.outlier_w.shape)
        w = w.scatter_add(-2, rows, q.outlier_w.to(torch.float32))
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
