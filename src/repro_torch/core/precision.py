"""Numerical-precision policy: the paper's first lever (§3).

Counterpart of ``repro.core.precision`` with torch dtypes. A
:class:`PrecisionPolicy` fixes the storage format of the weights
(fp32 / fp16 / bf16 / int8 / nf4), the compute dtype every matmul is fed
in, and the activation dtype of the residual stream.

Under ``float16`` the weights are *stored* in fp16, but compute and
activations are bf16, as in the reference. Integer formats dequantize
on the fly to bf16 inside the quant_matmul kernels.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

FLOAT32 = "float32"
FLOAT16 = "float16"
BFLOAT16 = "bfloat16"
INT8 = "int8"      # LLM.int8-style vector-wise absmax + outlier split
NF4 = "nf4"        # QLoRA NormalFloat4, block-wise, packed 2/byte

ALL_FORMATS = (FLOAT32, FLOAT16, BFLOAT16, INT8, NF4)
QUANTIZED_FORMATS = (INT8, NF4)


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """Numerical policy for one model instantiation."""

    fmt: str = BFLOAT16
    # dtype every matmul is fed in after (de)quantization
    compute_dtype: torch.dtype = torch.bfloat16
    # activations / residual stream dtype
    activation_dtype: torch.dtype = torch.bfloat16
    # int8: fraction of input rows kept in 16-bit (LLM.int8 outliers)
    outlier_fraction: float = 0.01
    # nf4: quantization block size along the input dim
    nf4_block_size: int = 64

    @property
    def weight_bits(self) -> float:
        return {
            FLOAT32: 32.0,
            FLOAT16: 16.0,
            BFLOAT16: 16.0,
            INT8: 8.0,
            # 4-bit codes + fp16 absmax per block (double quant ignored)
            NF4: 4.0 + 16.0 / self.nf4_block_size,
        }[self.fmt]

    @property
    def is_quantized(self) -> bool:
        return self.fmt in QUANTIZED_FORMATS

    @property
    def needs_dequant_pass(self) -> bool:
        """Integer formats are unpacked/dequantized before every matmul."""
        return self.is_quantized

    @property
    def tensor_core_path(self) -> bool:
        """fp16/bf16/int8 reach the H100's tensor cores; fp32 does not."""
        return self.fmt != FLOAT32

    @property
    def param_dtype(self) -> torch.dtype:
        """dtype in which *master* params are stored before quantization."""
        return {
            FLOAT32: torch.float32,
            FLOAT16: torch.float16,
            BFLOAT16: torch.bfloat16,
            INT8: torch.bfloat16,
            NF4: torch.bfloat16,
        }[self.fmt]


def make_policy(fmt: str, compute_dtype: Optional[torch.dtype] = None
                ) -> PrecisionPolicy:
    if fmt not in ALL_FORMATS:
        raise ValueError(f"unknown precision format {fmt!r}; "
                         f"expected one of {ALL_FORMATS}")
    if compute_dtype is None:
        compute_dtype = torch.float32 if fmt == FLOAT32 else torch.bfloat16
    act = torch.float32 if fmt == FLOAT32 else torch.bfloat16
    return PrecisionPolicy(fmt=fmt, compute_dtype=compute_dtype,
                           activation_dtype=act)
