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
:data:`LAUNCHES` and to the count of the loop it ran in
:data:`LOOP_LAUNCHES`. Nothing falls back from the kernel to the plain
version.

The loop is planned on the host from the shapes alone
(:func:`matmul_plan`, cached per shape and device): the decode loop for
M <= 8, the TMA + wgmma loop for bf16 prefill (M > 8), with its output
tile and a persistent grid of at most one block per SM, and the
CUDA-core tile loop for f32 and for shapes neither takes. The C entry
point runs the loop it is given, and refuses it (an error, which the
wrapper raises) if the shape does not allow it.
"""
from __future__ import annotations

import dataclasses
import functools
import shutil  # noqa: F401  (the build finds nvcc with shutil.which)
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.kernels import cuda_build
from repro_torch.kernels.cuda_build import I, P, check as _check
from repro_torch.quant.nf4 import codebook, unpack_codes

KERNELS = ("int8_matmul", "nf4_matmul")
CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = cuda_build.BUILD_DIR
HEADERS = ("quant_matmul.cuh", "qmm_wgmma.cuh", cuda_build.HOPPER_HEADER)
SOURCES = {
    # x, codes, scale, out, M, N, K, is_bf16, loop, bm, bn, grid
    "int8_matmul": cuda_build.Source("int8_matmul", CSRC,
                                     (P, P, P, P, I, I, I, I, I, I, I, I),
                                     HEADERS),
    # x, packed, absmax, out, M, N, K, block, is_bf16, loop, bm, bn, grid
    "nf4_matmul": cuda_build.Source("nf4_matmul", CSRC,
                                    (P, P, P, P, I, I, I, I, I, I, I, I, I),
                                    HEADERS),
}

#: the loops of the C entry points, by their number there (qmm::Loop)
LOOPS = ("decode", "wgmma", "tile")

#: launches of each CUDA kernel since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}
#: the same launches by the loop that ran
LOOP_LAUNCHES: Dict[str, Dict[str, int]] = {
    name: {loop: 0 for loop in LOOPS} for name in KERNELS}

_COMPUTE_DTYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0
        for loop in LOOPS:
            LOOP_LAUNCHES[name][loop] = 0


# ---------------------------------------------------------------------------
# launch plan
# ---------------------------------------------------------------------------
DEC_M, DEC_BN, DEC_BK = 8, 16, 512      # the decode loop's rows, tile
WG_BK = 64                              # K rows per stage of the wgmma loop
#: the wgmma loop's output tiles (BM rows of x, BN output columns) and
#: the time one K step (64 rows) of one tile takes, in us, per format:
#: the median over llama-3.1-8b's four projections at M = 352 and 512 of
#: ``tools/qmm_prefill_times.py --tile`` on an H100 SXM at 700 W (PERF.md,
#: section 6). A step costs 0.3 us however small the tile (waits and
#: latency), and nf4's dequantization (a codebook lookup and a multiply
#: per weight) costs more than int8's.
WG_STEP_US = {
    "int8": {(128, 128): 0.46, (256, 128): 0.69, (256, 64): 0.48,
             (128, 64): 0.34, (64, 128): 0.36, (64, 64): 0.31},
    "nf4": {(128, 128): 0.81, (256, 128): 1.03, (256, 64): 0.63,
            (128, 64): 0.52, (64, 128): 0.69, (64, 64): 0.49},
}
#: the tiles the plan may take, in order of preference on a tie
WG_TILES = tuple(WG_STEP_US["int8"])


@dataclasses.dataclass(frozen=True)
class Plan:
    """The loop a launch runs; for "wgmma" also its output tile (BM rows
    of x, BN output columns) and the persistent grid (blocks) that walks
    the tiles."""

    loop: str
    bm: int = 0
    bn: int = 0
    grid: int = 0


def wgmma_tiles(M: int, N: int, bm: int, bn: int) -> Tuple[int, int]:
    """(row tiles, all tiles) of the wgmma loop's output grid."""
    m_tiles = -(-M // bm)
    return m_tiles, m_tiles * -(-N // bn)


def tile_origin(t: int, m_tiles: int, bm: int, bn: int) -> Tuple[int, int]:
    """(row, column) of output tile ``t``'s first element, as the kernel
    computes it: tiles that share weight columns are neighbours."""
    return (t % m_tiles) * bm, (t // m_tiles) * bn


def matmul_plan(M: int, N: int, K: int, n_sm: int, *, bf16: bool = True,
                block: Optional[int] = None, aligned: bool = True) -> Plan:
    """The loop for x (M, K) @ W (K, N), from shapes alone (``block``: the
    nf4 block, None for int8; ``aligned``: every pointer 16-byte aligned).

    - "decode" for M <= 8 where its 16-byte copies fit (N % 16, K % 512,
      the nf4 block dividing 512);
    - "wgmma" for bf16, M > 8, N % 16 == 0, K % 64 == 0 and an nf4 block
      of 32 or a multiple of 64: of :data:`WG_TILES`, the tile whose
      waves over ``n_sm`` SMs (tiles / n_sm, rounded up) take the least
      time at the format's :data:`WG_STEP_US`, the earlier on a tie, and
      a grid of min(tiles, n_sm) blocks;
    - "tile" otherwise (f32, and unaligned shapes or small nf4 blocks)."""
    if (M <= DEC_M and N % DEC_BN == 0 and K % DEC_BK == 0 and aligned
            and (block is None or DEC_BK % block == 0)):
        return Plan("decode")
    if (bf16 and M > DEC_M and N % 16 == 0 and K % WG_BK == 0 and aligned
            and (block is None or block == 32 or block % WG_BK == 0)):
        step_us = WG_STEP_US["int8" if block is None else "nf4"]

        def cost(tile):
            tiles = wgmma_tiles(M, N, *tile)[1]
            return -(-tiles // n_sm) * step_us[tile]
        bm, bn = min(WG_TILES, key=cost)
        return Plan("wgmma", bm, bn, min(wgmma_tiles(M, N, bm, bn)[1], n_sm))
    return Plan("tile")


@functools.lru_cache(maxsize=None)
def _device_plan(M: int, N: int, K: int, bf16: bool, block: Optional[int],
                 aligned: bool, device: int) -> Plan:
    """:func:`matmul_plan` for CUDA device ``device``, once per shape:
    prefill repeats seven shapes in every layer, decode one per step."""
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    return matmul_plan(M, N, K, n_sm, bf16=bf16, block=block,
                       aligned=aligned)


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


def _launch(name: str, plan: Plan, *args) -> None:
    cuda_build.launch(SOURCES[name], LAUNCHES, *args,
                      LOOPS.index(plan.loop), plan.bm, plan.bn, plan.grid)
    LOOP_LAUNCHES[name][plan.loop] += 1


def _aligned(*ts: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


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
        bf16 = compute_dtype == torch.bfloat16
        plan = _device_plan(M, N, K, bf16, None, _aligned(x, codes),
                            x.get_device())
        _launch("int8_matmul", plan, x.data_ptr(), codes.data_ptr(),
                scale.data_ptr(), out.data_ptr(), M, N, K, int(bf16))
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
        bf16 = compute_dtype == torch.bfloat16
        plan = _device_plan(M, N, K, bf16, K // nb,
                            _aligned(x, packed, absmax), x.get_device())
        _launch("nf4_matmul", plan, x.data_ptr(), packed.data_ptr(),
                absmax.data_ptr(), out.data_ptr(), M, N, K, K // nb,
                int(bf16))
    return out
