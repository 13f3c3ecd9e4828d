"""Precision-policy-dispatched linear layers and post-training quant.

Counterpart of ``repro.quant.apply``. Every matmul of the model goes
through :func:`linear_apply`, which dispatches on the parameter's
representation:

* plain tensor -> a matmul in the policy's compute dtype,
* Int8Weight   -> the int8 dequant-matmul kernel (+ outlier matmul),
* NF4Weight    -> the nf4 dequant-matmul kernel;

with an expert axis on the weight (E, in, out) and on x (E, C, in), the
grouped form of each: one launch over all experts, which takes the
dispatch's kept-row counts where it is given them.

There is no switch between a kernel and a reference path: for a CUDA
tensor the quantized ops launch the kernels, and for a CPU tensor they
run the kernels' plain versions.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.precision import INT8, NF4, PrecisionPolicy
from repro_torch.kernels.quant_matmul import ops as qops
from repro_torch.core.sharded import (is_sharded, reduce_partial,
                                     sharded_matmul)
from repro_torch.quant.int8 import Int8Weight, dequantize_int8, \
    quantize_int8
from repro_torch.quant.nf4 import NF4Weight, dequantize_nf4, quantize_nf4


def dequantize_weight(w: Any, dtype=torch.bfloat16) -> torch.Tensor:
    if isinstance(w, Int8Weight):
        return dequantize_int8(w, dtype)
    if isinstance(w, NF4Weight):
        return dequantize_nf4(w, dtype)
    return w.to(dtype)


def linear_apply(w: Any, x: torch.Tensor, policy: PrecisionPolicy,
                 rows=None) -> torch.Tensor:
    """y = x @ w under the precision policy; for an (E, in, out) weight
    and x (E, C, in), y[e] = x[e] @ w[e]. ``rows``: for a quantized
    (E, in, out) weight, each expert's kept rows (int32 (E,)); the grouped
    kernel then computes only those and zeros the rest. A plain weight's
    product ignores it.

    The output dtype is the compute dtype. For 16-bit policies the
    matmul accumulates in f32 and rounds its output to the compute dtype
    once, as the reference's ``preferred_element_type`` rule does; f32
    policies stay f32 end to end. On DTensors (the dry run) a plain
    weight's product is :func:`~repro_torch.core.sharded.
    sharded_matmul`, and the partial sums of a product sharded on its
    inner dim (``wo``, ``w_down``) are all-reduced at once, so that
    activations keep their features replicated between blocks, as the
    reference's sharding leaves them."""
    cd = policy.compute_dtype
    if not x.is_meta:
        return _linear(w, x, cd, rows)
    if isinstance(w, torch.Tensor) and is_sharded(x, w):
        return sharded_matmul(x, w, cd)
    y = _linear(w, x, cd, rows)
    return reduce_partial(y) if is_sharded(y) else y


def _linear(w: Any, x: torch.Tensor, cd, rows=None) -> torch.Tensor:
    if isinstance(w, Int8Weight):
        if w.codes.ndim == 3:
            return qops.int8_matmul_grouped_kernel(x, w, compute_dtype=cd,
                                                   rows=rows)
        return qops.int8_matmul_kernel(x, w, compute_dtype=cd)
    if isinstance(w, NF4Weight):
        if w.packed.ndim == 3:
            return qops.nf4_matmul_grouped_kernel(x, w, compute_dtype=cd,
                                                  rows=rows)
        return qops.nf4_matmul_kernel(x, w, compute_dtype=cd)
    return torch.matmul(x.to(cd), w.to(cd))


# ---------------------------------------------------------------------------
# post-training quantization of the attention and FFN projections
# (paper §2: bitsandbytes PTQ)
# ---------------------------------------------------------------------------
_QUANTIZABLE_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                     "w_in", "w_out", "experts_gate", "experts_up",
                     "experts_down")
_MIN_QUANT_DIM = 32     # skip tiny weights (norms, biases, dt, A, conv)


def _quantize_leaf(path: str, leaf: Any, policy: PrecisionPolicy) -> Any:
    if not isinstance(leaf, torch.Tensor) or leaf.ndim < 2:
        return leaf
    if path.split("/")[-1] not in _QUANTIZABLE_KEYS:
        return leaf
    if leaf.shape[-1] < _MIN_QUANT_DIM or leaf.shape[-2] < _MIN_QUANT_DIM:
        return leaf
    if leaf.ndim > 3:
        raise ValueError(f"{path}: expected (in, out) or (experts, in, out),"
                         f" got {tuple(leaf.shape)}")
    # an (experts, in, out) stack is quantized slice by slice, as the
    # reference does (its quant/apply.py), batched over the expert axis
    if policy.fmt == INT8:
        return quantize_int8(leaf, policy.outlier_fraction)
    blk = policy.nf4_block_size
    while leaf.shape[-2] % blk or blk % 2:
        blk //= 2
    return quantize_nf4(leaf, max(blk, 2))


def quantize_params(params: Any, policy: PrecisionPolicy) -> Any:
    """Post-training-quantize the attention/FFN projection weights of a
    parameter tree (dicts, and lists for the per-layer stack). Returns a
    new tree; the other leaves are shared with the input."""
    if policy.fmt not in (INT8, NF4):
        return params

    def walk(tree, path=""):
        if isinstance(tree, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, path) for v in tree]
        return _quantize_leaf(path, tree, policy)

    return walk(params)
