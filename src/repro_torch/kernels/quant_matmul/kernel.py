"""The two dequant-matmul kernels: CUDA C++ for Hopper, bound with ctypes.

Counterpart of ``repro.kernels.quant_matmul.kernel`` (the Pallas
``int8_matmul_pallas`` / ``nf4_matmul_pallas``). Sources are
``csrc/int8_matmul.cu`` and ``csrc/nf4_matmul.cu``; each is compiled at
first use with ``nvcc -gencode arch=compute_90a,code=sm_90a`` into a
shared library with a plain C interface under ``build/kernels/`` at the
root of the checkout, and loaded with ``ctypes``.

Each wrapper takes a 2-D problem. For a tensor on the CPU it returns its
plain PyTorch version (``*_plain``: the kernel's exact rounding points,
used by the CPU tests). For a CUDA tensor it checks device, dtype, shape
and contiguity, raises on anything the kernel does not take, allocates
the output with ``torch.empty``, launches on the current stream, raises
if the launch reports an error, and adds one to its count in
:data:`LAUNCHES`. Nothing falls back from the kernel to the plain
version.
"""
from __future__ import annotations

import shutil  # noqa: F401  (the build finds nvcc with shutil.which)
from pathlib import Path
from typing import Dict, List

import torch

from repro_torch.kernels import cuda_build
from repro_torch.kernels.cuda_build import I, P, check as _check
from repro_torch.quant.nf4 import codebook, unpack_codes

KERNELS = ("int8_matmul", "nf4_matmul")
CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = cuda_build.BUILD_DIR
SOURCES = {
    # x, codes, scale, out, M, N, K, is_bf16
    "int8_matmul": cuda_build.Source("int8_matmul", CSRC,
                                     (P, P, P, P, I, I, I, I),
                                     ("quant_matmul.cuh",)),
    # x, packed, absmax, out, M, N, K, block, is_bf16
    "nf4_matmul": cuda_build.Source("nf4_matmul", CSRC,
                                    (P, P, P, P, I, I, I, I, I),
                                    ("quant_matmul.cuh",)),
}

#: launches of each CUDA kernel since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}

_COMPUTE_DTYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0


def _library_path(name: str) -> Path:
    return cuda_build.library_path(SOURCES[name], BUILD_DIR)


def build(names=KERNELS) -> List[Path]:
    """Compile the kernels whose libraries are missing, all in parallel
    (:func:`repro_torch.kernels.cuda_build.build`). Returns the library
    paths."""
    return cuda_build.build([SOURCES[n] for n in names], BUILD_DIR)


# ---------------------------------------------------------------------------
# plain versions: the kernels' arithmetic in PyTorch
# ---------------------------------------------------------------------------
def int8_matmul_plain(x: torch.Tensor, codes: torch.Tensor,
                      scale: torch.Tensor,
                      compute_dtype=torch.bfloat16) -> torch.Tensor:
    """x and the codes cast to the compute dtype, an f32 product (exact
    products of compute-dtype values, f32 sums), the per-column scale,
    one rounding to the compute dtype."""
    acc = torch.matmul(x.to(compute_dtype).float(),
                       codes.to(compute_dtype).float())
    return (acc * scale[None, :]).to(compute_dtype)


def nf4_matmul_plain(x: torch.Tensor, packed: torch.Tensor,
                     absmax: torch.Tensor,
                     compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Each weight dequantized in f32 (codebook value times its block's
    absmax) and rounded to the compute dtype, then an f32 product and one
    rounding of the result."""
    codes = unpack_codes(packed)
    block = codes.shape[0] // absmax.shape[0]
    w = codebook(codes.device)[codes] \
        * absmax.repeat_interleave(block, dim=0)
    w = w.to(compute_dtype).float()
    return torch.matmul(x.to(compute_dtype).float(), w).to(compute_dtype)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------
def _check_x(x: torch.Tensor, compute_dtype) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if compute_dtype not in _COMPUTE_DTYPES:
        raise TypeError(f"compute dtype {compute_dtype} not supported; "
                        f"expected one of {_COMPUTE_DTYPES}")
    if x.ndim != 2:
        raise ValueError(f"x must be 2-D, got {tuple(x.shape)}")


def _launch(name: str, *args) -> None:
    cuda_build.launch(SOURCES[name], LAUNCHES, *args)


def int8_matmul(x: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor,
                compute_dtype=torch.bfloat16) -> torch.Tensor:
    """x (M, K) @ dequant(codes int8 (K, N), scale f32 (N,)) -> (M, N)
    in the compute dtype."""
    if x.device.type == "cpu":
        return int8_matmul_plain(x, codes, scale, compute_dtype)
    _check_x(x, compute_dtype)
    M, K = x.shape
    N = codes.shape[-1]
    _check("x", x, compute_dtype, (M, K), x.device)
    _check("codes", codes, torch.int8, (K, N), x.device)
    _check("scale", scale, torch.float32, (N,), x.device)
    if N % 4 == 0 and codes.data_ptr() % 4:
        raise ValueError("codes must be 4-byte aligned")
    out = torch.empty((M, N), dtype=compute_dtype, device=x.device)
    if M and N:
        _launch("int8_matmul", x.data_ptr(), codes.data_ptr(),
                scale.data_ptr(), out.data_ptr(), M, N, K,
                int(compute_dtype == torch.bfloat16))
    return out


def nf4_matmul(x: torch.Tensor, packed: torch.Tensor, absmax: torch.Tensor,
               compute_dtype=torch.bfloat16) -> torch.Tensor:
    """x (M, K) @ dequant(packed uint8 (K/2, N), absmax f32 (K/block, N))
    -> (M, N) in the compute dtype."""
    if x.device.type == "cpu":
        return nf4_matmul_plain(x, packed, absmax, compute_dtype)
    _check_x(x, compute_dtype)
    M, K = x.shape
    N = packed.shape[-1]
    nb = absmax.shape[0]
    if K % 2 or nb == 0 or K % nb or (K // nb) % 2:
        raise ValueError(f"K={K} must be a multiple of an even block "
                         f"(absmax has {nb} rows)")
    _check("x", x, compute_dtype, (M, K), x.device)
    _check("packed", packed, torch.uint8, (K // 2, N), x.device)
    _check("absmax", absmax, torch.float32, (nb, N), x.device)
    out = torch.empty((M, N), dtype=compute_dtype, device=x.device)
    if M and N:
        _launch("nf4_matmul", x.data_ptr(), packed.data_ptr(),
                absmax.data_ptr(), out.data_ptr(), M, N, K, K // nb,
                int(compute_dtype == torch.bfloat16))
    return out
