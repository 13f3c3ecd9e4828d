"""f32 oracle for the quant_matmul kernels (counterpart of
``repro.kernels.quant_matmul.ref``): dequantize in f32, then an f32
product. It is the exact result the kernels approximate in the compute
dtype."""
from __future__ import annotations

import torch

from repro_torch.quant.int8 import Int8Weight, dequantize_int8
from repro_torch.quant.nf4 import NF4Weight, dequantize_nf4


def nf4_matmul_ref(x: torch.Tensor, packed: torch.Tensor,
                   absmax: torch.Tensor) -> torch.Tensor:
    w = dequantize_nf4(NF4Weight(packed=packed, absmax=absmax),
                       torch.float32)
    return torch.matmul(x.float(), w)


def int8_weight_matmul_ref(x: torch.Tensor, q: Int8Weight) -> torch.Tensor:
    """Full LLM.int8 path including the outlier decomposition."""
    return torch.matmul(x.float(), dequantize_int8(q, torch.float32))
