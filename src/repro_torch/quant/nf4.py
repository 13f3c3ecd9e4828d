"""NormalFloat4 (NF4) block-wise quantization (QLoRA; Dettmers et al.
2023).

Counterpart of ``repro.quant.nf4``: the same representation and the
same bytes. Codes are packed two per byte along the *input* dim (the
even row in the low nibble); one f32 absmax per (block of input rows,
output column).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

# The 16 NF4 code points: quantiles of N(0,1) normalized to [-1, 1]
# (exact constants from Dettmers et al. 2023, bitsandbytes).
NF4_CODEBOOK = (
    -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
    -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
    0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
    0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
    0.7229568362236023, 1.0,
)

# elements of the (rows, cols, 16) distance tensor built per chunk
_NEAREST_CHUNK_ELEMS = 1 << 26


def codebook(device) -> torch.Tensor:
    return torch.tensor(NF4_CODEBOOK, dtype=torch.float32, device=device)


class NF4Weight(NamedTuple):
    """Quantized (in_dim, out_dim) weight, or a stack of E expert weights
    (E, in_dim, out_dim), each slice quantized on its own: both fields
    then carry the leading expert axis.

    ``packed``  uint8 ([E,] in_dim // 2, out_dim)  two 4-bit codes per
                byte, packed along the input dim (even row in low nibble).
    ``absmax``  f32   ([E,] in_dim // block, out_dim) per-block scale.
    """
    packed: torch.Tensor
    absmax: torch.Tensor

    @property
    def block(self) -> int:
        return 2 * self.packed.shape[-2] // self.absmax.shape[-2]


def _nearest_code(x: torch.Tensor) -> torch.Tensor:
    """Index of the nearest NF4 code point for x in [-1, 1] (first index
    on ties, as ``jnp.argmin``). Works in chunks along the last axis so
    that a full-width weight never builds its whole (..., 16) distance
    tensor at once."""
    cb = codebook(x.device)
    rows = x[..., :1].numel()
    step = max(1, _NEAREST_CHUNK_ELEMS // (16 * rows))
    out = torch.empty(x.shape, dtype=torch.uint8, device=x.device)
    for j in range(0, x.shape[-1], step):
        d = (x[..., j:j + step, None] - cb).abs()
        out[..., j:j + step] = torch.argmin(d, dim=-1).to(torch.uint8)
    return out


def quantize_nf4(w: torch.Tensor, block: int = 64) -> NF4Weight:
    """Block-wise NF4 quantization of a 2-D weight, or of an (E, in, out)
    stack batched over its expert axis, to the bytes of quantizing each
    slice alone."""
    if w.ndim not in (2, 3):
        raise ValueError(f"expected a 2-D weight or an (E, in, out) stack, "
                         f"got {tuple(w.shape)}")
    lead, (in_dim, out_dim) = tuple(w.shape[:-2]), tuple(w.shape[-2:])
    if in_dim % (2 * block) and in_dim % block:
        raise ValueError(f"in_dim {in_dim} not divisible by block {block}")
    if in_dim % 2:
        raise ValueError("in_dim must be even for 2-per-byte packing")
    wb = w.to(torch.float32).reshape(lead + (in_dim // block, block,
                                             out_dim))
    absmax = wb.abs().amax(dim=-2)                        # (.., nb, out)
    absmax = torch.where(absmax > 0, absmax, torch.ones_like(absmax))
    codes = _nearest_code(wb / absmax[..., None, :]) \
        .reshape(lead + (in_dim, out_dim))
    packed = codes[..., 0::2, :] | (codes[..., 1::2, :] << 4)
    return NF4Weight(packed=packed.contiguous(),
                     absmax=absmax.to(torch.float32))


def unpack_codes(packed: torch.Tensor) -> torch.Tensor:
    """([E,] K/2, N) uint8 -> ([E,] K, N) int64 codes, even rows from the
    low nibble."""
    lo = (packed & 0x0F).long()
    hi = ((packed >> 4) & 0x0F).long()
    return torch.stack([lo, hi], dim=-2) \
        .reshape(packed.shape[:-2] + (-1, packed.shape[-1]))


def dequantize_nf4(q: NF4Weight, dtype=torch.bfloat16) -> torch.Tensor:
    codes = unpack_codes(q.packed)
    lead, (in_dim, out_dim) = codes.shape[:-2], codes.shape[-2:]
    vals = codebook(codes.device)[codes]
    vals = vals.reshape(lead + (-1, q.block, out_dim)) \
        * q.absmax[..., None, :]
    return vals.reshape(lead + (in_dim, out_dim)).to(dtype)
