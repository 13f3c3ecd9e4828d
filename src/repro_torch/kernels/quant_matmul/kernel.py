"""The dequant-matmul kernels: CUDA C++ for Hopper, bound with ctypes.

Counterpart of ``repro.kernels.quant_matmul.kernel`` (the Pallas
``int8_matmul_pallas`` / ``nf4_matmul_pallas``), with int8's LLM.int8
outlier product inside its kernel (the reference adds it at the XLA
level, ``repro.kernels.quant_matmul.ops``), and two kernels of 16-bit
weights for the reference's ``einsum(x.astype(cd), w.astype(cd))``
(``repro.quant.apply``), which no Pallas kernel computes:
``fp16_matmul``/``fp16_matmul_grouped``, the float16 format's product,
its weights converted to bf16 in registers, and ``bf16_matmul_grouped``,
an MoE's bf16 expert stack, whose grouped launch reads only the kept
experts. Sources are ``csrc/int8_matmul.cu``, ``csrc/nf4_matmul.cu``,
``csrc/fp16_matmul.cu`` and ``csrc/bf16_matmul.cu`` (the last two share
``csrc/f16_stage.cuh``); each is compiled at first use with ``nvcc
-gencode arch=compute_90a,code=sm_90a`` into a shared library with a
plain C interface under ``build/kernels/`` at the root of the checkout,
and loaded with ``ctypes``.

``int8_matmul`` and ``int8_matmul_grouped`` take the weight's outlier
rows and their bf16 weights (``outlier_idx``, ``outlier_w``: the
``Int8Weight`` fields) as optional arguments: the kernel then adds
``bf16(x[:, idx] @ ow)`` (an f32 sum) to its rounded output and rounds
once more, the rounding points of the product the reference adds, in
the same launch.

``int8_matmul``/``nf4_matmul`` take a 2-D problem; ``*_grouped`` take its
grouped form, E problems at once (x (E, C, K) against a weight with a
leading expert axis, the experts of an MoE layer), in one launch of the
same kernel: what the Pallas kernels compute under ``jax.vmap`` over the
experts. A grouped call may take each expert's kept-row count (``rows``,
int32 (E,) on the call's device: the capacity dispatch's, which never
sends a row past it to a token): its output rows at or past the count
are exactly zero, and the kernel reads only the weights of experts with
a kept row and computes only those rows, reading the counts on the
device in the same launch. The 16-bit grouped calls compute in bf16
only (f32 compute keeps ``torch.matmul``: no 16-bit stage takes it).
For a tensor on the CPU a wrapper returns the plain PyTorch version
(``*_plain``, which takes either form: the kernel's exact rounding
points, used by the CPU tests). For a CUDA tensor it checks
device, dtype, shape and contiguity, raises on anything the kernel does
not take, allocates the output with ``torch.empty``, launches on the
current stream, raises if the launch reports an error, and adds one to
its own count in :data:`LAUNCHES` and to the count of the loop it ran in
:data:`LOOP_LAUNCHES`. Nothing falls back from the kernel to the plain
version, and a grouped call is never a loop of 2-D calls. The kernels
have no backward (the reference cannot train quantized weights either):
on either device, an input that requires grad while grad mode is on
raises (:func:`~repro_torch.kernels.cuda_build.refuse_grad`).

On the ``meta`` device under a cost analysis (the dry run,
:mod:`repro_torch.launch.dryrun`; outside one a meta tensor has no
kernel and raises, as any device but the two) a wrapper returns an
empty output of the kernel's shape and dtype and reports the kernel's
bytes and FLOPs (:func:`repro_torch.kernels.cost.quant_matmul`) to the
active :class:`~repro_torch.core.op_analysis.OpCounter`; it never enters
the plain version. The counts are data, which the dry run cannot see: a
grouped call reports every expert, with ``rows`` or without (an upper
bound, as a paged call counts every slot). On DTensors it runs that
branch on each rank's shards (:func:`_on_meta`): a weight sharded on
its output columns gives an output sharded on its columns, one sharded
on its input rows (``wo``, ``w_down``) a partial sum on that mesh axis.

The loop is planned on the host from the shapes alone
(:func:`matmul_plan`, cached per shape and device). In bf16 both loops
are the TMA + wgmma kernel of ``csrc/qmm_wgmma.cuh``: "decode" for M <= 8
(8 rows of x, 128-column tiles, one block per SM, the column tiles' K
steps split evenly among the blocks and the split tiles merged in the
same launch through a workspace and per-tile counters), "wgmma" for
prefill (M > 8, an output tile and a persistent grid of at most one
block per SM). The CUDA-core tile loop takes f32 and the shapes neither
takes. A grouped call walks the experts inside those loops (the plan
takes the expert count): prefill the output tiles of the kept rows,
decode the K segments of the kept experts' column tiles
(:func:`decode_segments`), each tile cut into segments by the shapes
alone and its segments added in order, so that an expert's sums do not
depend on the other experts' rows. In bf16 it raises where the plan
gives it neither loop. The C entry point runs the loop it is given, and
refuses it (an error, which the wrapper raises) if the shape does not
allow it.
"""
from __future__ import annotations

import dataclasses
import functools
import shutil  # noqa: F401  (the build finds nvcc with shutil.which)
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.core.op_analysis import counting
from repro_torch.kernels import cuda_build
from repro_torch.kernels.cuda_build import I, P, check as _check
from repro_torch.core.sharded import (is_sharded, matmul_placements,
                                     on_shards)
from repro_torch.quant.nf4 import codebook, unpack_codes

KERNELS = ("int8_matmul", "nf4_matmul", "fp16_matmul", "bf16_matmul")
CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = cuda_build.BUILD_DIR
HEADERS = ("quant_matmul.cuh", "qmm_wgmma.cuh", cuda_build.HOPPER_HEADER)
#: the 16-bit weight stage's libraries add its header
HEADERS16 = HEADERS + ("f16_stage.cuh",)
SOURCES = {
    # x, codes, scale, outlier_idx, outlier_w, out, part, counter, rows, E,
    # M, N, K, n_out, is_bf16, loop, bm, bn, grid, seg
    "int8_matmul": cuda_build.Source(
        "int8_matmul", CSRC,
        (P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, I, I),
        HEADERS),
    # x, packed, absmax, out, part, counter, rows, E, M, N, K, block,
    # is_bf16, loop, bm, bn, grid, seg
    "nf4_matmul": cuda_build.Source(
        "nf4_matmul", CSRC,
        (P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, I, I), HEADERS),
    # x, w, out, part, counter, rows, E, M, N, K, is_bf16, loop, bm, bn,
    # grid, seg
    "fp16_matmul": cuda_build.Source(
        "fp16_matmul", CSRC,
        (P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, I), HEADERS16),
    # x, w, out, part, counter, rows, E, M, N, K, loop, bm, bn, grid, seg
    "bf16_matmul": cuda_build.Source(
        "bf16_matmul", CSRC,
        (P, P, P, P, P, P, I, I, I, I, I, I, I, I, I), HEADERS16),
}
#: the wrappers that launch the kernels, each with its own count: the
#: 2-D calls and the grouped calls (one launch over all experts)
ENTRY_POINTS = ("int8_matmul", "nf4_matmul", "int8_matmul_grouped",
                "nf4_matmul_grouped", "fp16_matmul", "bf16_matmul_grouped",
                "fp16_matmul_grouped")

#: the loops of the C entry points, by their number there (qmm::Loop)
LOOPS = ("decode", "wgmma", "tile")

#: launches of each wrapper since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {name: 0 for name in ENTRY_POINTS}
#: the same launches by the loop that ran
LOOP_LAUNCHES: Dict[str, Dict[str, int]] = {
    name: {loop: 0 for loop in LOOPS} for name in ENTRY_POINTS}
cuda_build.register_counts(LAUNCHES, *LOOP_LAUNCHES.values())

_COMPUTE_DTYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    for name in ENTRY_POINTS:
        LAUNCHES[name] = 0
        for loop in LOOPS:
            LOOP_LAUNCHES[name][loop] = 0


# ---------------------------------------------------------------------------
# launch plan
# ---------------------------------------------------------------------------
WG_BK = 64          # K rows per stage of the bf16 loops
DEC_M = 8           # rows of x of the decode loop: M <= 8
#: the decode loop's column tile: 128 codes (int8) or packed bytes (nf4)
#: a row, whole 128-byte lines
DEC_BN = 128
#: K steps a segment of the grouped decode walk: each column tile's nk
#: steps are cut into max(1, nk // DEC_SEG_STEPS) segments, or kept whole
#: where every expert's column tiles fit in one wave of blocks. Short
#: enough that the segments of a few experts' tiles still spread over the
#: SMs (qwen3's w_gate: 4 segments of 8 steps a tile, 24 an expert), long
#: enough that a segment's fixed cost (its sums start from zero and are
#: added to the tile's once its products drain) stays small: 4-step
#: segments read slower at both every row and the dispatch's few experts
#: (PERF.md, section 6; ``tools/qmm_loop_probe.py --grouped``).
DEC_SEG_STEPS = 8
#: experts a grouped call of the bf16 loops may have (the kernel scans
#: their counts with one thread each: qmm_wgmma.cuh, kMaxE)
MAX_EXPERTS = 256
#: the wgmma loop's output tiles (BM rows of x, BN output columns) and
#: the time one K step (64 rows) of one tile takes, in us, per format:
#: the median over llama-3.1-8b's four projections at M = 352 and 512 of
#: ``tools/qmm_prefill_times.py --tile`` on an H100 SXM at 700 W (PERF.md,
#: section 6). A step costs 0.3 us however small the tile (waits and
#: latency), and nf4's dequantization (a codebook lookup and a multiply
#: per weight) costs more than int8's. A refit from the same sweep at M =
#: 64-2064 moved near-ties to tiles that read slower in turns with this
#: table (PERF.md, section 6), so the table stays.
WG_STEP_US = {
    "int8": {(128, 128): 0.46, (256, 128): 0.69, (256, 64): 0.48,
             (128, 64): 0.34, (64, 128): 0.36, (64, 64): 0.31},
    "nf4": {(128, 128): 0.81, (256, 128): 1.03, (256, 64): 0.63,
            (128, 64): 0.52, (64, 128): 0.69, (64, 64): 0.49},
}
#: fp16 weights (a conversion a weight, as int8's) and bf16 weights (none):
#: not swept, int8's
WG_STEP_US["fp16"] = dict(WG_STEP_US["int8"])
WG_STEP_US["bf16"] = dict(WG_STEP_US["int8"])
#: the tiles the plan may take, in order of preference on a tie
WG_TILES = tuple(WG_STEP_US["int8"])


def ring_stages(fmt: str, bm: int, bn: int) -> int:
    """Stages of the bf16 loops' ring at tile (bm, bn) for a format's
    weights (qmm_wgmma.cuh, Layout): an x tile of bm rows and the raw
    weight tile of 64 K rows (int8: a byte a weight; nf4: half a byte and
    two absmax rows; fp16 and bf16: two bytes), each rounded up to 1024
    bytes, as many as fit beside 4 KB of static shared memory, at most 8.
    A tile whose ring holds fewer than 5 is never planned (the 16-bit
    formats' 256 x 128)."""
    raw = {"int8": WG_BK * bn, "nf4": WG_BK // 2 * bn + 2 * bn * 4,
           "fp16": WG_BK * bn * 2, "bf16": WG_BK * bn * 2}[fmt]
    raw = -(-raw // 1024) * 1024
    return min(8, (232448 - 4096) // (bm * WG_BK * 2 + raw))


@dataclasses.dataclass(frozen=True)
class Plan:
    """The loop a launch runs; for "wgmma" and "decode" also its output
    tile (BM rows of x, BN output columns) and its grid (blocks); the
    number of experts of a grouped call (1 for a 2-D call); for a grouped
    "decode", the K segments of each column tile (0: the 2-D walk)."""

    loop: str
    bm: int = 0
    bn: int = 0
    grid: int = 0
    experts: int = 1
    seg: int = 0


def wgmma_tiles(M: int, N: int, bm: int, bn: int) -> Tuple[int, int]:
    """(row tiles, all tiles) of the wgmma loop's output grid of one
    expert; a grouped call walks ``experts`` such grids, expert by
    expert (tile t is tile t % tiles of expert t // tiles)."""
    m_tiles = -(-M // bm)
    return m_tiles, m_tiles * -(-N // bn)


def tile_origin(t: int, m_tiles: int, bm: int, bn: int) -> Tuple[int, int]:
    """(row, column) of output tile ``t``'s first element, as the kernel
    computes it: tiles that share weight columns are neighbours."""
    return (t % m_tiles) * bm, (t // m_tiles) * bn


def decode_segments(plan: Plan, N: int, K: int, rows=None
                    ) -> List[Tuple[int, int, int, int]]:
    """(block, column tile, first K step, end K step) of every piece the
    decode loop walks, in the kernel's order (``qmm_wgmma.cuh``, walk; a
    K step is 64 rows). The column tiles of all experts are numbered
    expert by expert: tile t is column tile t % ceil(N / bn) of expert
    t // ceil(N / bn).

    The 2-D walk (``plan.seg`` 0): the tiles' K steps laid end to end,
    block b taking steps [b U / grid, (b + 1) U / grid) of the U, one
    piece a block and tile. The grouped walk: each tile's nk steps cut
    into ``plan.seg`` segments (segment s holds [s nk / seg, (s + 1) nk /
    seg)), the segments of the experts whose count in ``rows`` is above 0
    (every expert for None) laid end to end, block b taking segments
    [b U / G, (b + 1) U / G) of the U, G = min(grid, U), one piece a
    segment: every block from a split tile's first to its last holds part
    of it, which its merge counts on."""
    nk = K // WG_BK
    n_col = -(-N // plan.bn)
    segs = []
    if plan.seg == 0:
        u_all = plan.experts * n_col * nk
        for b in range(plan.grid):
            u, hi = u_all * b // plan.grid, u_all * (b + 1) // plan.grid
            while u < hi:
                t, k0 = divmod(u, nk)
                k1 = min(nk, hi - t * nk)
                segs.append((b, t, k0, k1))
                u = t * nk + k1
        return segs
    S = plan.seg
    kept = [e for e in range(plan.experts) if rows is None or rows[e] > 0]
    u_all = len(kept) * n_col * S
    G = min(plan.grid, u_all)
    for b in range(G):
        for u in range(u_all * b // G, u_all * (b + 1) // G):
            ta, s = divmod(u, S)
            a, col = divmod(ta, n_col)
            segs.append((b, kept[a] * n_col + col, s * nk // S,
                         (s + 1) * nk // S))
    return segs


def decode_scratch(plan: Plan, N: int) -> Tuple[int, int]:
    """(f32 elements of the workspace, int32 counters) a decode launch
    needs, for any rows. 2-D walk: the partial sums of block b for column
    tile t go to slot b + t of DEC_M x bn, and each column tile (of every
    expert) has a counter. Grouped walk: a split tile's first block b owns
    slots b seg .. b seg + seg - 1, one a segment, and counter b (a block
    is the first of at most one split tile)."""
    if plan.seg:
        return plan.grid * plan.seg * DEC_M * plan.bn, plan.grid
    tiles = plan.experts * -(-N // plan.bn)
    return (plan.grid + tiles - 1) * DEC_M * plan.bn, tiles


def matmul_plan(M: int, N: int, K: int, n_sm: int, *, bf16: bool = True,
                block: Optional[int] = None, aligned: bool = True,
                experts: int = 1, grouped: bool = False,
                fmt: Optional[str] = None) -> Plan:
    """The loop for x (M, K) @ W (K, N), from shapes alone (``block``: the
    nf4 block, None for int8; ``aligned``: every pointer 16-byte aligned),
    or for ``experts`` such products in one launch, M rows each
    (``grouped``: a grouped call, which may skip experts and rows);
    ``fmt`` names the weight format of :data:`WG_STEP_US` ("int8" for
    ``block`` None, else "nf4", by default; "fp16" and "bf16" for 16-bit
    weights).

    Where the bf16 loops take the shape (bf16, N % 16 == 0, K % 64 == 0,
    aligned, an nf4 block of 32 or a multiple of 64, at most
    :data:`MAX_EXPERTS` experts):

    - "decode" for M <= 8: :data:`DEC_BN` columns a tile. The 2-D walk
      shares out the K steps of every tile over a grid of min(``n_sm``,
      steps) blocks. Grouped, each tile's nk steps are cut into
      max(1, nk // :data:`DEC_SEG_STEPS`) segments (one where the column
      tiles of all experts fit in ``n_sm`` blocks: no tile is then split)
      and the grid is min(``n_sm``, segments of all tiles of all experts):
      sized for every expert kept, the kernel shares out those of the
      kept ones.
      Neither depends on M, so a row of x gets the same sums whatever the
      batch;
    - "wgmma" for M > 8: of :data:`WG_TILES` whose ring holds at least
      five of the format's stages (:func:`ring_stages`), the tile whose
      waves over ``n_sm`` SMs (tiles of all experts / n_sm, rounded up)
      take the least time at the format's :data:`WG_STEP_US`, the earlier
      on a tie, and a grid of min(tiles, n_sm) blocks. A block walks each
      of its tiles' whole K axis in order, so here too a row of x gets the
      same sums whatever the batch.

    "tile" otherwise (f32, and unaligned shapes or small nf4 blocks)."""
    if not (bf16 and N % 16 == 0 and K % WG_BK == 0 and aligned
            and (block is None or block == 32 or block % WG_BK == 0)
            and experts <= MAX_EXPERTS):
        return Plan("tile", experts=experts)
    if M <= DEC_M:
        nk, n_col = K // WG_BK, -(-N // DEC_BN)
        if grouped:
            seg = (1 if experts * n_col <= n_sm
                   else max(1, nk // DEC_SEG_STEPS))
            return Plan("decode", DEC_M, DEC_BN,
                        min(n_sm, experts * n_col * seg), experts, seg)
        return Plan("decode", DEC_M, DEC_BN, min(n_sm, experts * n_col * nk),
                    experts)
    fmt = fmt or ("int8" if block is None else "nf4")
    step_us = WG_STEP_US[fmt]

    def tiles(tile):
        return experts * wgmma_tiles(M, N, *tile)[1]

    def cost(tile):
        return -(-tiles(tile) // n_sm) * step_us[tile]
    bm, bn = min((t for t in WG_TILES if ring_stages(fmt, *t) >= 5),
                 key=cost)
    return Plan("wgmma", bm, bn, min(tiles((bm, bn)), n_sm), experts)


@functools.lru_cache(maxsize=None)
def _device_plan(M: int, N: int, K: int, bf16: bool, block: Optional[int],
                 aligned: bool, device: int, experts: int = 1,
                 grouped: bool = False, fmt: Optional[str] = None) -> Plan:
    """:func:`matmul_plan` for CUDA device ``device``, once per shape:
    prefill repeats seven shapes in every layer, decode one per step."""
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    return matmul_plan(M, N, K, n_sm, bf16=bf16, block=block,
                       aligned=aligned, experts=experts, grouped=grouped,
                       fmt=fmt)


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
def _zero_past(out: torch.Tensor, rows: Optional[torch.Tensor]
               ) -> torch.Tensor:
    """out (E, C, N) with each expert's rows at or past its count in
    ``rows`` (E,) exactly zero; out itself for None."""
    if rows is None:
        return out
    if out.ndim != 3:
        raise ValueError("rows is for a grouped call: x must be (E, C, K)")
    kept = torch.arange(out.shape[-2], device=out.device) < rows[:, None]
    return torch.where(kept[..., None], out,
                       torch.zeros((), dtype=out.dtype, device=out.device))


def int8_matmul_plain(x: torch.Tensor, codes: torch.Tensor,
                      scale: torch.Tensor, compute_dtype=torch.bfloat16,
                      rows: Optional[torch.Tensor] = None,
                      outlier_idx: Optional[torch.Tensor] = None,
                      outlier_w: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """x and the codes cast to the compute dtype, an f32 product (exact
    products of compute-dtype values, f32 sums), the per-column scale,
    one rounding to the compute dtype. With outliers (``outlier_idx``
    int32 ([E,] n_out), ``outlier_w`` ([E,] n_out, N)), LLM.int8's
    outlier product is added: x's outlier columns (``index_select``;
    grouped, ``gather``) in the compute dtype against the outlier weights
    in it, an f32 product rounded to the compute dtype, added to the
    rounded output in the compute dtype. 2-D, or grouped: x (E, C, K),
    codes (E, K, N), scale (E, N), expert by expert, and with ``rows``
    each expert's rows at or past its count zero."""
    xc = x.to(compute_dtype)
    acc = torch.matmul(xc.float(), codes.to(compute_dtype).float())
    out = (acc * scale[..., None, :]).to(compute_dtype)
    if outlier_idx is not None and outlier_idx.shape[-1]:
        idx = outlier_idx.long()
        if x.ndim == 2:
            x_out = torch.index_select(xc, -1, idx)
        else:
            x_out = torch.gather(xc, 2, idx[:, None, :].expand(
                *x.shape[:2], idx.shape[-1]))
        out = out + torch.matmul(
            x_out.float(), outlier_w.to(compute_dtype).float()
        ).to(compute_dtype)
    return _zero_past(out, rows)


def fp16_matmul_plain(x: torch.Tensor, w: torch.Tensor,
                      compute_dtype=torch.bfloat16,
                      rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x and the 16-bit weight cast to the compute dtype (fp16: round to
    nearest even; bf16: itself), their product in it (f32 sums, one
    rounding): ``torch.matmul(x.to(cd), w.to(cd))``, the product the
    16-bit kernels replace. x (..., K), w (K, N); or grouped: x (E, C, K),
    w (E, K, N), expert by expert, and with ``rows`` each expert's rows at
    or past its count zero."""
    return _zero_past(
        torch.matmul(x.to(compute_dtype), w.to(compute_dtype)), rows)


#: the bf16 grouped kernel's plain version: the same expression
bf16_matmul_plain = fp16_matmul_plain


def nf4_matmul_plain(x: torch.Tensor, packed: torch.Tensor,
                     absmax: torch.Tensor, compute_dtype=torch.bfloat16,
                     rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Each weight dequantized in f32 (codebook value times its block's
    absmax) and rounded to the compute dtype, then an f32 product and one
    rounding of the result. 2-D, or grouped: x (E, C, K), packed
    (E, K/2, N), absmax (E, K/block, N), expert by expert, and with
    ``rows`` each expert's rows at or past its count zero."""
    codes = unpack_codes(packed)
    block = codes.shape[-2] // absmax.shape[-2]
    w = codebook(codes.device)[codes] \
        * absmax.repeat_interleave(block, dim=-2)
    w = w.to(compute_dtype).float()
    return _zero_past(
        torch.matmul(x.to(compute_dtype).float(), w).to(compute_dtype), rows)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------
def _meta(entry: str, x: torch.Tensor, wargs, compute_dtype,
          n_out: int = 0) -> torch.Tensor:
    """The meta branch: an empty output, the kernel's cost reported
    (every field of the weight read: int8's outliers too, whose product,
    ``n_out`` rows, it counts). The weight's local shape gives N (its side
    fields stay replicated)."""
    from repro_torch.core import op_analysis
    from repro_torch.kernels import cost
    *lead, M, K = x.shape
    N = wargs[0].shape[-1]
    E = lead[0] if lead else 1
    es = torch.finfo(compute_dtype).bits // 8
    nbytes, flops = cost.quant_matmul(
        M, K, N, sum(op_analysis.tensor_bytes(w) for w in wargs), es, E,
        n_out)
    op_analysis.record(entry, flops, nbytes)
    return torch.empty((*lead, M, N), dtype=compute_dtype, device="meta")


def _on_meta(entry: str, call, x: torch.Tensor, wargs, compute_dtype,
             n_out: int = 0) -> torch.Tensor:
    """A wrapper's ``meta`` branch: on DTensors ``call(x, *wargs)`` (the
    wrapper) on each rank's shards, placed by the weight's main field
    (codes, packed, the fp16 weight) as
    :func:`~repro_torch.core.sharded.matmul_placements` says, its side
    fields (scale, absmax, outliers) as they are; else, under a cost
    analysis, :func:`_meta`. Outside one a meta tensor has no kernel. A
    grouped call's kept counts are not passed: a meta tensor holds no
    counts, so every expert and row is counted. On an x sharded on K
    (``wo``, ``w_down``) each rank counts every outlier row's product, as
    the product of the whole x's outlier columns counted on every rank
    before the outliers joined the kernel."""
    if is_sharded(x, *wargs):
        x_pl, out_pl, _, _ = matmul_placements(x, wargs[0])
        return on_shards(call, out_pl, x, *wargs,
                         in_placements=[x_pl] + [t.placements for t in wargs])
    if not counting():
        raise ValueError(f"no kernel for device {x.device}")
    return _meta(entry, x, wargs, compute_dtype, n_out)


def _check_x(x: torch.Tensor, compute_dtype, ndim: int = 2) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if compute_dtype not in _COMPUTE_DTYPES:
        raise TypeError(f"compute dtype {compute_dtype} not supported; "
                        f"expected one of {_COMPUTE_DTYPES}")
    if x.ndim != ndim:
        raise ValueError(f"x must be {ndim}-D, got {tuple(x.shape)}")


def _check_rows(rows: Optional[torch.Tensor], x: torch.Tensor) -> None:
    """Raise unless ``rows`` is None or an int32 (E,) tensor on x's
    device, E x's leading dim."""
    if rows is not None:
        _check("rows", rows, torch.int32, x.shape[:1], x.device)


def _scratch(plan: Plan, N: int, device: torch.device):
    """(workspace, counters) of a decode launch (:func:`decode_scratch`),
    both shared by the launches on ``device``: no allocation once warm,
    and the counters left at 0 by every launch."""
    n_part, n_count = decode_scratch(plan, N)
    return (cuda_build.workspace(device, n_part),
            cuda_build.counters(device, n_count))


def _launch(name: str, entry: str, plan: Plan, x: torch.Tensor, wargs,
            out: torch.Tensor, *shape,
            rows: Optional[torch.Tensor] = None) -> None:
    """Launch library ``name`` at ``plan`` and count it for the wrapper
    ``entry`` (``rows``: a grouped call's kept rows; None in ``wargs``: a
    null pointer)."""
    part = counter = None
    if plan.loop == "decode":
        part, counter = _scratch(plan, out.shape[-1], x.device)
    cuda_build.launch(SOURCES[name], LAUNCHES, x.data_ptr(),
                      *(cuda_build.ptr(w) for w in wargs), out.data_ptr(),
                      cuda_build.ptr(part), cuda_build.ptr(counter),
                      cuda_build.ptr(rows), plan.experts, *shape,
                      LOOPS.index(plan.loop), plan.bm, plan.bn, plan.grid,
                      plan.seg, key=entry)
    LOOP_LAUNCHES[entry][plan.loop] += 1


def _aligned(*ts: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def _outliers(idx: Optional[torch.Tensor], ow: Optional[torch.Tensor],
              E: int, N: int, device) -> Tuple[Optional[torch.Tensor],
                                               Optional[torch.Tensor], int]:
    """(idx, ow, n_out) of an int8 call on the card: both None, or idx
    int32 (E, n_out) and ow bf16 (E, n_out, N) on ``device`` (None for
    n_out = 0). The rows in idx must lie in 0..K-1: the kernel reads x
    there unchecked, as a gather would."""
    if (idx is None) != (ow is None):
        raise ValueError("outlier_idx and outlier_w go together")
    if idx is None or idx.shape[-1] == 0:
        return None, None, 0
    n_out = idx.shape[-1]
    _check("outlier_idx", idx, torch.int32, (E, n_out), device)
    _check("outlier_w", ow, torch.bfloat16, (E, n_out, N), device)
    return idx, ow, n_out


def _int8_launch(x: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor,
                 compute_dtype, entry: str, grouped: bool,
                 rows: Optional[torch.Tensor] = None,
                 outlier_idx: Optional[torch.Tensor] = None,
                 outlier_w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (E, C, K) @ dequant(codes (E, K, N), scale (E, N)) plus the
    outlier product of ``outlier_idx`` (E, n_out), ``outlier_w`` (E,
    n_out, N) on the card, counted for the wrapper ``entry``; E = 1 for a
    2-D call (``grouped`` false)."""
    E, C, K = x.shape
    N = codes.shape[-1]
    _check("x", x, compute_dtype, (E, C, K), x.device)
    _check("codes", codes, torch.int8, (E, K, N), x.device)
    _check("scale", scale, torch.float32, (E, N), x.device)
    _check_rows(rows, x)
    idx, ow, n_out = _outliers(outlier_idx, outlier_w, E, N, x.device)
    if N % 4 == 0 and codes.data_ptr() % 4:
        raise ValueError("codes must be 4-byte aligned")
    out = torch.empty((E, C, N), dtype=compute_dtype, device=x.device)
    if E and C and N:
        bf16 = compute_dtype == torch.bfloat16
        plan = _plan(entry, grouped, C, N, K, bf16, None,
                     _aligned(x, codes), x, E)
        _launch("int8_matmul", entry, plan, x, (codes, scale, idx, ow), out,
                C, N, K, n_out, int(bf16), rows=rows)
    return out


def _nf4_launch(x: torch.Tensor, packed: torch.Tensor, absmax: torch.Tensor,
                compute_dtype, entry: str, grouped: bool,
                rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (E, C, K) @ dequant(packed (E, K/2, N), absmax (E, K/block, N))
    on the card, counted for the wrapper ``entry``; E = 1 for a 2-D call
    (``grouped`` false)."""
    E, C, K = x.shape
    N = packed.shape[-1]
    nb = absmax.shape[-2]
    if K % 2 or nb == 0 or K % nb or (K // nb) % 2:
        raise ValueError(f"K={K} must be a multiple of an even block "
                         f"(absmax has {nb} rows)")
    _check("x", x, compute_dtype, (E, C, K), x.device)
    _check("packed", packed, torch.uint8, (E, K // 2, N), x.device)
    _check("absmax", absmax, torch.float32, (E, nb, N), x.device)
    _check_rows(rows, x)
    out = torch.empty((E, C, N), dtype=compute_dtype, device=x.device)
    if E and C and N:
        bf16 = compute_dtype == torch.bfloat16
        plan = _plan(entry, grouped, C, N, K, bf16, K // nb,
                     _aligned(x, packed, absmax), x, E)
        _launch("nf4_matmul", entry, plan, x, (packed, absmax), out, C, N,
                K, K // nb, int(bf16), rows=rows)
    return out


def _plan(entry: str, grouped: bool, C: int, N: int, K: int, bf16: bool,
          block: Optional[int], aligned: bool, x: torch.Tensor,
          E: int, fmt: Optional[str] = None) -> Plan:
    """The device plan of a call; a grouped call in bf16 raises where the
    plan gives it neither bf16 loop (``entry`` names it)."""
    plan = _device_plan(C, N, K, bf16, block, aligned, x.get_device(), E,
                        grouped, fmt)
    if grouped and bf16 and plan.loop == "tile":
        raise ValueError(
            f"{entry}: no grouped bf16 kernel for E={E} C={C} K={K} N={N}"
            + ("" if block is None else f" block={block}")
            + (" (the bf16 loops need N % 16 == 0, K % 64 == 0, 16-byte "
               f"aligned operands, an nf4 block of 32 or a multiple of 64 "
               f"and at most {MAX_EXPERTS} experts)"))
    return plan


def _outlier_args(idx, ow) -> tuple:
    """The outlier fields a call was given, as extra weight arguments."""
    return () if idx is None else (idx, ow)


def int8_matmul(x: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor,
                compute_dtype=torch.bfloat16,
                outlier_idx: Optional[torch.Tensor] = None,
                outlier_w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (M, K) @ dequant(codes int8 (K, N), scale f32 (N,)) -> (M, N)
    in the compute dtype, plus LLM.int8's outlier product of x's columns
    ``outlier_idx`` (int32 (n_out,)) and ``outlier_w`` (bf16 (n_out, N))
    where given, in the same launch."""
    cuda_build.refuse_grad("int8_matmul", x, codes, scale)
    if x.device.type == "cpu":
        return int8_matmul_plain(x, codes, scale, compute_dtype, None,
                                 outlier_idx, outlier_w)
    if x.is_meta:
        extra = _outlier_args(outlier_idx, outlier_w)
        return _on_meta(
            "int8_matmul",
            lambda x_, c_, s_, *o: int8_matmul(x_, c_, s_, compute_dtype,
                                               *o),
            x, (codes, scale, *extra), compute_dtype,
            extra[0].shape[-1] if extra else 0)
    _check_x(x, compute_dtype)
    return _int8_launch(
        x[None], codes[None], scale[None], compute_dtype, "int8_matmul",
        grouped=False,
        outlier_idx=None if outlier_idx is None else outlier_idx[None],
        outlier_w=None if outlier_w is None else outlier_w[None])[0]


def nf4_matmul(x: torch.Tensor, packed: torch.Tensor, absmax: torch.Tensor,
               compute_dtype=torch.bfloat16) -> torch.Tensor:
    """x (M, K) @ dequant(packed uint8 (K/2, N), absmax f32 (K/block, N))
    -> (M, N) in the compute dtype."""
    cuda_build.refuse_grad("nf4_matmul", x, packed, absmax)
    if x.device.type == "cpu":
        return nf4_matmul_plain(x, packed, absmax, compute_dtype)
    if x.is_meta:
        return _on_meta(
            "nf4_matmul",
            lambda x_, p_, a_: nf4_matmul(x_, p_, a_, compute_dtype),
            x, (packed, absmax), compute_dtype)
    _check_x(x, compute_dtype)
    return _nf4_launch(x[None], packed[None], absmax[None], compute_dtype,
                       "nf4_matmul", grouped=False)[0]


def int8_matmul_grouped(x: torch.Tensor, codes: torch.Tensor,
                        scale: torch.Tensor, compute_dtype=torch.bfloat16,
                        rows: Optional[torch.Tensor] = None,
                        outlier_idx: Optional[torch.Tensor] = None,
                        outlier_w: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """x (E, C, K) @ dequant(codes int8 (E, K, N), scale f32 (E, N)) ->
    (E, C, N) in the compute dtype: every expert in one launch, each with
    its outlier product where given (``outlier_idx`` int32 (E, n_out),
    ``outlier_w`` bf16 (E, n_out, N)). ``rows``: each expert's kept rows,
    int32 (E,) in 0..C on x's device, or None for all C; the rows at or
    past the count are zero."""
    cuda_build.refuse_grad("int8_matmul_grouped", x, codes, scale)
    if x.device.type == "cpu":
        _check_rows(rows, x)
        return int8_matmul_plain(x, codes, scale, compute_dtype, rows,
                                 outlier_idx, outlier_w)
    if x.is_meta:
        extra = _outlier_args(outlier_idx, outlier_w)
        return _on_meta(
            "int8_matmul_grouped",
            lambda x_, c_, s_, *o: int8_matmul_grouped(
                x_, c_, s_, compute_dtype, None, *o),
            x, (codes, scale, *extra), compute_dtype,
            extra[0].shape[-1] if extra else 0)
    _check_x(x, compute_dtype, ndim=3)
    return _int8_launch(x, codes, scale, compute_dtype,
                        "int8_matmul_grouped", grouped=True, rows=rows,
                        outlier_idx=outlier_idx, outlier_w=outlier_w)


def nf4_matmul_grouped(x: torch.Tensor, packed: torch.Tensor,
                       absmax: torch.Tensor, compute_dtype=torch.bfloat16,
                       rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (E, C, K) @ dequant(packed uint8 (E, K/2, N), absmax f32
    (E, K/block, N)) -> (E, C, N) in the compute dtype: every expert in
    one launch. ``rows`` as for :func:`int8_matmul_grouped`."""
    cuda_build.refuse_grad("nf4_matmul_grouped", x, packed, absmax)
    if x.device.type == "cpu":
        _check_rows(rows, x)
        return nf4_matmul_plain(x, packed, absmax, compute_dtype, rows)
    if x.is_meta:
        return _on_meta(
            "nf4_matmul_grouped",
            lambda x_, p_, a_: nf4_matmul_grouped(x_, p_, a_, compute_dtype),
            x, (packed, absmax), compute_dtype)
    _check_x(x, compute_dtype, ndim=3)
    return _nf4_launch(x, packed, absmax, compute_dtype,
                       "nf4_matmul_grouped", grouped=True, rows=rows)


def fp16_matmul(x: torch.Tensor, w: torch.Tensor,
                compute_dtype=torch.bfloat16) -> torch.Tensor:
    """x (M, K) @ w float16 (K, N) -> (M, N) in the compute dtype, each
    weight converted to it in registers (bf16: round to nearest even, as
    ``.to(torch.bfloat16)``), no converted copy of w written."""
    cuda_build.refuse_grad("fp16_matmul", x, w)
    if x.device.type == "cpu":
        return fp16_matmul_plain(x, w, compute_dtype)
    if x.is_meta:
        return _on_meta(
            "fp16_matmul", lambda x_, w_: fp16_matmul(x_, w_, compute_dtype),
            x, (w,), compute_dtype)
    _check_x(x, compute_dtype)
    M, K = x.shape
    N = w.shape[-1]
    _check("x", x, compute_dtype, (M, K), x.device)
    _check("w", w, torch.float16, (K, N), x.device)
    out = torch.empty((M, N), dtype=compute_dtype, device=x.device)
    if M and N:
        bf16 = compute_dtype == torch.bfloat16
        plan = _plan("fp16_matmul", False, M, N, K, bf16, None,
                     _aligned(x, w), x, 1, "fp16")
        _launch("fp16_matmul", "fp16_matmul", plan, x, (w,), out, M, N, K,
                int(bf16))
    return out


def _grouped16(fmt: str, x: torch.Tensor, w: torch.Tensor, compute_dtype,
               rows: Optional[torch.Tensor]) -> torch.Tensor:
    """The 16-bit grouped wrappers: x (E, C, K) @ w (E, K, N) of the
    format ``fmt`` ("bf16" or "fp16") in bf16, one launch of the format's
    kernel over all experts, counted for ``<fmt>_matmul_grouped``."""
    entry = f"{fmt}_matmul_grouped"
    cuda_build.refuse_grad(entry, x, w)
    if x.device.type == "cpu":
        _check_rows(rows, x)
        return fp16_matmul_plain(x, w, compute_dtype, rows)
    if x.is_meta:
        return _on_meta(
            entry, lambda x_, w_: _grouped16(fmt, x_, w_, compute_dtype,
                                             None),
            x, (w,), compute_dtype)
    _check_x(x, compute_dtype, ndim=3)
    if compute_dtype != torch.bfloat16:
        raise TypeError(f"{entry} computes in bf16, not {compute_dtype}")
    E, C, K = x.shape
    N = w.shape[-1]
    _check("x", x, torch.bfloat16, (E, C, K), x.device)
    _check("w", w, torch.float16 if fmt == "fp16" else torch.bfloat16,
           (E, K, N), x.device)
    _check_rows(rows, x)
    out = torch.empty((E, C, N), dtype=torch.bfloat16, device=x.device)
    if E and C and N:
        plan = _plan(entry, True, C, N, K, True, None, _aligned(x, w), x, E,
                     fmt)
        _launch(f"{fmt}_matmul", entry, plan, x, (w,), out, C, N, K,
                *((1,) if fmt == "fp16" else ()), rows=rows)
    return out


def bf16_matmul_grouped(x: torch.Tensor, w: torch.Tensor,
                        compute_dtype=torch.bfloat16,
                        rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (E, C, K) @ w bf16 (E, K, N) -> (E, C, N) in bf16: every expert
    in one launch, reading only the experts with a kept row. ``rows`` as
    for :func:`int8_matmul_grouped`."""
    return _grouped16("bf16", x, w, compute_dtype, rows)


def fp16_matmul_grouped(x: torch.Tensor, w: torch.Tensor,
                        compute_dtype=torch.bfloat16,
                        rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (E, C, K) @ w float16 (E, K, N) -> (E, C, N) in bf16, each weight
    converted to bf16 in registers: every expert in one launch, reading
    only the experts with a kept row. ``rows`` as for
    :func:`int8_matmul_grouped`."""
    return _grouped16("fp16", x, w, compute_dtype, rows)
