"""Paged decode attention: a CUDA C++ kernel for Hopper, bound with
ctypes, and its plain PyTorch version.

Counterpart of ``repro.kernels.paged_attention.kernel`` (the Pallas
``paged_attention_pallas``). The source is ``csrc/paged_attention.cu``,
built at first use by :mod:`repro_torch.kernels.cuda_build`: one launch
per call, TMA-staged pages, the products on the tensor cores in bf16.

:func:`paged_attention` takes one query token per sequence, q (B, H, d),
a K/V pool (n_pages, page, Kv, d) of any page size, a page table
(B, n_max) int32 with -1 for an unassigned page, and seq_lens (B,) int32.
Slots at or past a row's length and slots of unassigned pages are masked;
a row of length 0 returns 0. Two optional parts of a call:

- **int8 pages**: k_pages and v_pages int8 with ``k_scale`` and
  ``v_scale`` f32 (n_pages, page, Kv), each element dequantized as the
  reference's ``dequantize_kv`` does it, ``(code.float() * scale)
  .to(q.dtype)``, after which the arithmetic is that of pages in q's
  dtype (bf16 or f32).
- **a per-slot position test**: ``slot_pos`` int32 (n_pages, page), the
  absolute position each slot holds (-1 empty), ``pos`` (B,) int32 and
  an optional ``window``: a slot of row b is valid only if ``0 <=
  slot_pos <= pos[b]`` and, with a window, ``slot_pos > pos[b] -
  window`` (the reference's ``decode_attention_mask``), on top of the
  length and page tests. A row whose every slot fails returns 0.

For a tensor on the CPU it returns :func:`paged_attention_plain`. For
a CUDA tensor it checks device, dtypes, shapes, contiguity and alignment
(:func:`check_inputs`), raises on anything the kernel does not take
(head_dim outside ``HEAD_DIMS``, more than 8 query heads per KV head,
scales without int8 pages or the reverse, ``pos`` without
``slot_pos``), allocates the output, launches on the current stream,
raises if the launch reports an error, and adds one to
``LAUNCHES["paged_attention"]`` (and to ``CASES`` for int8 pages and for
the position test). One launch a call in every case. Head dims 96 and
120 run on the 128-column instance (:func:`instance_d`) with the columns
past d zero-filled. Nothing falls back from the kernel to the plain
version. The kernel has no backward: on either device, an input that
requires grad while grad mode is on raises
(:func:`~repro_torch.kernels.cuda_build.refuse_grad`).

On the ``meta`` device under a cost analysis (the dry run; outside one a
meta tensor has no kernel) it returns an empty output and
reports the kernel's bytes and FLOPs (:func:`repro_torch.kernels.cost.
paged_attention`, every slot of the table counted as valid: the lengths
are data; int8 codes at a byte, their scales and the slot positions
beside them) to the active :class:`~repro_torch.core.op_analysis.
OpCounter`. On DTensors it runs on each rank's shards (:func:`_on_shards`).
"""
from __future__ import annotations

import functools
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.core import op_analysis
from repro_torch.kernels import cuda_build
from repro_torch.kernels.cuda_build import F, I, P, check
from repro_torch.core.sharded import is_sharded, on_shards

NAME = "paged_attention"
CSRC = Path(__file__).resolve().parent / "csrc"
# q, k_pages, v_pages, page_table, seq_lens, out, part, counter, k_scale,
# v_scale, slot_pos, pos, B, H, Kv, D, n_pool, page, n_max, split,
# n_split, window, scale, is_bf16
SOURCES = {NAME: cuda_build.Source(
    NAME, CSRC, (P,) * 12 + (I,) * 10 + (F, I),
    (cuda_build.HOPPER_HEADER,))}

#: launches of the CUDA kernel since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {NAME: 0}
#: of those, the launches over int8 pages and with the position test
CASES: Dict[str, int] = {"int8_pages": 0, "slot_positions": 0}
cuda_build.register_counts(LAUNCHES, CASES)

NEG_INF = -1e30
HEAD_DIMS = (64, 96, 120, 128)
MAX_GROUP = 8           # query heads per KV head the kernel keeps
DTYPES = (torch.float32, torch.bfloat16)
CHUNK = 64              # slots a block stages at a time (a ring stage)
# The least split of a row's slots over several blocks, by dtype. A
# block's fixed cost (q, barriers, its merge) and the last split's merge
# (1-2.5 us) pay for themselves in bf16 only once a split streams 8
# chunks; the f32 products on the CUDA cores cost more a chunk than their
# loads, so f32 spreads a row down to single chunks (the split sweep of
# tools/paged_probe.py on an H100, PERF.md section 6).
MIN_SPLIT = 8 * CHUNK
MIN_SPLIT_F32 = CHUNK
BLOCKS_PER_SM = 1       # blocks the split aims for on every SM: one wave
BOX_ROWS = (64, 32, 16, 8, 4, 2, 1)   # the kernel's tensor-map boxes


def reset_launches() -> None:
    LAUNCHES[NAME] = 0
    for case in CASES:
        CASES[case] = 0


def split_slots(B: int, Kv: int, slots: int, n_sm: int,
                min_split: int = MIN_SPLIT) -> int:
    """Slots per block: each row's ``slots`` are cut into as many splits
    as the B * Kv * splits blocks can take without passing
    ``BLOCKS_PER_SM`` on each of ``n_sm`` SMs (a second wave of blocks
    would double a call's time), but no more than ``min_split`` slots
    each would need; a split is a multiple of ``CHUNK`` slots. Decided
    from shapes alone, never from the lengths on the device."""
    want = BLOCKS_PER_SM * n_sm // max(1, B * Kv)
    n_split = max(1, min(want, -(-slots // min_split)))
    per = -(-slots // n_split)
    return -(-per // CHUNK) * CHUNK


def chunk_boxes(c0: int, c1: int, page: int,
                table_row: List[int], n_pool: int
                ) -> List[Tuple[int, int, int]]:
    """The boxes the kernel's producer issues for the slots [c0, c1) of
    one row (a chunk, c1 - c0 <= CHUNK): (pool row, rows, shared row)
    with rows one of ``BOX_ROWS``, page by page, skipping pages whose id
    is < 0 or >= n_pool. Each box lies within one page."""
    boxes = []
    j = c0 // page
    while j * page < c1:
        pid = table_row[j]
        if 0 <= pid < n_pool:
            lo, hi = max(c0, j * page), min(c1, (j + 1) * page)
            n, row, r = hi - lo, pid * page + lo - j * page, lo - c0
            for rows in BOX_ROWS:
                if n & rows:
                    boxes.append((row, rows, r))
                    row += rows
                    r += rows
        j += 1
    return boxes


def instance_d(d: int) -> int:
    """The columns of the kernel instance that runs head_dim ``d``: 64 for
    64, and 128 for 96, 120 and 128."""
    return 64 if d <= 64 else 128


def scratch_sizes(B: int, Kv: int, d: int, n_split: int) -> Tuple[int, int]:
    """(f32 elements of ``part``, int32 elements of the counter) a launch
    with ``n_split`` splits needs; none with one split. A split's row
    keeps the instance's columns, not d's."""
    if n_split == 1:
        return 0, 0
    return B * Kv * n_split * MAX_GROUP * (instance_d(d) + 2), B * Kv


@functools.lru_cache(maxsize=None)
def _launch_plan(B: int, Kv: int, slots: int, device: int,
                 min_split: int = MIN_SPLIT) -> Tuple[int, int]:
    """(slots per block, splits per row) for a launch on CUDA device
    ``device``: decided once per shape, as decode repeats one shape for
    every layer and step."""
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    split = split_slots(B, Kv, slots, n_sm, min_split)
    return split, -(-slots // split)


def slot_mask(slot_pos: torch.Tensor, pos: torch.Tensor,
              window: Optional[int]) -> torch.Tensor:
    """The position test of a call: slot_pos (B, ...) against pos (B,),
    the reference's ``decode_attention_mask`` row for row."""
    p = pos.view(-1, *([1] * (slot_pos.ndim - 1)))
    ok = (slot_pos >= 0) & (slot_pos <= p)
    if window is not None:
        ok &= slot_pos > p - window
    return ok


def paged_attention_plain(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, page_table: torch.Tensor,
                          seq_lens: torch.Tensor, *,
                          k_scale: Optional[torch.Tensor] = None,
                          v_scale: Optional[torch.Tensor] = None,
                          slot_pos: Optional[torch.Tensor] = None,
                          pos: Optional[torch.Tensor] = None,
                          window: Optional[int] = None) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch, walking the pages in order as
    the TPU kernel does: int8 pages dequantized page by page to q's dtype
    as ``dequantize_kv`` does; f32 scores times 1/sqrt(d); masked slots
    -1e30 with p = 0; f32 running max and sum; the unnormalised p rounded
    to v's dtype (q's for int8 pages) before an f32 PV product; acc /
    max(l, 1e-20) cast once to q's dtype. An unassigned page is read as
    page 0 and masked."""
    B, H, d = q.shape
    page, Kv = k_pages.shape[1], k_pages.shape[2]
    G = H // Kv
    scale = 1.0 / d ** 0.5
    v_dtype = v_pages.dtype if k_scale is None else q.dtype
    qg = q.reshape(B, Kv, G, d).float()
    m = torch.full((B, Kv, G), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Kv, G, d), dtype=torch.float32, device=q.device)
    offs = torch.arange(page, device=q.device)
    for j in range(page_table.shape[1]):
        pid = page_table[:, j].long()
        at = pid.clamp(min=0)
        kp = k_pages[at]                                # (B, page, Kv, d)
        vp = v_pages[at]
        if k_scale is not None:
            kp = (kp.float() * k_scale[at][..., None]).to(q.dtype)
            vp = (vp.float() * v_scale[at][..., None]).to(q.dtype)
        s = torch.einsum("bkgd,btkd->bkgt", qg, kp.float()) * scale
        valid = (j * page + offs[None, :] < seq_lens[:, None]) \
            & (pid[:, None] >= 0)                        # (B, page)
        if slot_pos is not None:
            valid &= slot_mask(slot_pos[at], pos, window)
        valid = valid[:, None, None, :]
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(valid, torch.exp(s - m_new[..., None]),
                        torch.zeros_like(s))
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgt,btkd->bkgd", p.to(v_dtype).float(), vp.float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-20)[..., None]
    return out.reshape(B, H, d).to(q.dtype)


def check_inputs(q: torch.Tensor, k_pages: torch.Tensor,
                 v_pages: torch.Tensor, page_table: torch.Tensor,
                 seq_lens: torch.Tensor, *,
                 k_scale: Optional[torch.Tensor] = None,
                 v_scale: Optional[torch.Tensor] = None,
                 slot_pos: Optional[torch.Tensor] = None,
                 pos: Optional[torch.Tensor] = None,
                 window: Optional[int] = None) -> None:
    """Raise on anything the kernel does not take: the checks of the CUDA
    path, on any device (a test runs them on the meta device)."""
    if q.ndim != 3 or k_pages.ndim != 4 or page_table.ndim != 2:
        raise ValueError(f"expected q (B, H, d), pages (n, page, Kv, d) and "
                         f"page_table (B, n_max); got {tuple(q.shape)}, "
                         f"{tuple(k_pages.shape)}, {tuple(page_table.shape)}")
    B, H, d = q.shape
    n_pool, page, Kv = k_pages.shape[:3]
    n_max = page_table.shape[1]
    if q.dtype not in DTYPES:
        raise TypeError(f"no kernel for dtype {q.dtype}; expected one of "
                        f"{DTYPES}")
    if d not in HEAD_DIMS:
        raise ValueError(f"no kernel for head_dim {d}; expected {HEAD_DIMS}")
    if Kv == 0 or H % Kv or H // Kv > MAX_GROUP:
        raise ValueError(f"H={H} must be a multiple of Kv={Kv}, at most "
                         f"{MAX_GROUP} times it")
    if page == 0:
        raise ValueError("page size must be >= 1")
    quant = k_pages.dtype == torch.int8
    if (k_scale is None) != (v_scale is None) or \
            quant != (k_scale is not None):
        raise ValueError("int8 pages take both k_scale and v_scale, and "
                         "pages of q's dtype take neither")
    if (slot_pos is None) != (pos is None):
        raise ValueError("slot_pos and pos come together")
    if window is not None and (slot_pos is None or window < 1):
        raise ValueError(f"window {window} needs slot_pos and pos, and "
                         f"must be >= 1")
    if quant and Kv * d % 16:
        raise ValueError(f"int8 pages need Kv * head_dim = {Kv * d} a "
                         f"multiple of 16 (the kernel's row pitch)")
    kv_dtype = torch.int8 if quant else q.dtype
    check("q", q, q.dtype, (B, H, d), q.device)
    check("k_pages", k_pages, kv_dtype, (n_pool, page, Kv, d), q.device)
    check("v_pages", v_pages, kv_dtype, (n_pool, page, Kv, d), q.device)
    check("page_table", page_table, torch.int32, (B, n_max), q.device)
    check("seq_lens", seq_lens, torch.int32, (B,), q.device)
    if quant:
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            check(name, t, torch.float32, (n_pool, page, Kv), q.device)
    if slot_pos is not None:
        check("slot_pos", slot_pos, torch.int32, (n_pool, page), q.device)
        check("pos", pos, torch.int32, (B,), q.device)
    if any(t.data_ptr() % 16 for t in (q, k_pages, v_pages)):
        raise ValueError("q and the pages must be 16-byte aligned")


def _meta(q: torch.Tensor, k_pages: torch.Tensor, page_table: torch.Tensor,
          quant: bool, positions: bool) -> torch.Tensor:
    from repro_torch.kernels import cost
    B, H, d = q.shape
    page, Kv = k_pages.shape[1], k_pages.shape[2]
    n_max = page_table.shape[1]
    nbytes, flops = cost.paged_attention(
        B, H, Kv, d, B * n_max * page, page_table.numel(), q.element_size(),
        kv_es=k_pages.element_size(), scales=quant, positions=positions)
    op_analysis.record(NAME, flops, nbytes)
    return torch.empty_like(q)


#: the optional tensors of a call, in the kernel's order
EXTRAS = ("k_scale", "v_scale", "slot_pos", "pos")


def _on_shards(q, k_pages, v_pages, page_table, seq_lens, window, extra):
    """The kernel on each rank's shards. Where the pool's pages are split
    across a mesh axis that does not split the rows of q (the ring cut
    along its length, the reference's decode sharding), q is replicated
    on that axis and each rank attends over its part of every row: the
    output is a partial result there, placed ``Partial``, so that the
    combine the reference lowers to small all-reduces is counted as one
    all-reduce of the output. The scales and slot positions enter as
    they are placed (views aligned with the pool's pages)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    q_pl, out_pl = [], []
    for qp, kp in zip(q.placements, k_pages.placements):
        split = isinstance(kp, Shard) and kp.dim == 0
        if split and not (isinstance(qp, Shard) and qp.dim == 0):
            q_pl.append(Replicate())
            out_pl.append(Partial())
        else:
            q_pl.append(qp)
            out_pl.append(qp)
    names = [k for k in EXTRAS if extra[k] is not None]

    def local(q, k_pages, v_pages, page_table, seq_lens, *more):
        return paged_attention(q, k_pages, v_pages, page_table, seq_lens,
                               window=window, **dict(zip(names, more)))

    rest = (k_pages, v_pages, page_table, seq_lens,
            *(extra[k] for k in names))
    return on_shards(local, out_pl, q, *rest,
                     in_placements=[q_pl] + [getattr(t, "placements", None)
                                             for t in rest])


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, page_table: torch.Tensor,
                    seq_lens: torch.Tensor, *,
                    k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None,
                    slot_pos: Optional[torch.Tensor] = None,
                    pos: Optional[torch.Tensor] = None,
                    window: Optional[int] = None) -> torch.Tensor:
    """q (B, H, d) over the pool (n_pages, page, Kv, d) -> (B, H, d) in
    q's dtype."""
    extra = dict(k_scale=k_scale, v_scale=v_scale, slot_pos=slot_pos,
                 pos=pos)
    cuda_build.refuse_grad(NAME, q, k_pages, v_pages,
                           *(t for t in (k_scale, v_scale) if t is not None))
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pages, v_pages, page_table,
                                     seq_lens, window=window, **extra)
    if q.device.type != "cuda":
        if is_sharded(q, k_pages, v_pages, page_table, seq_lens):
            return _on_shards(q, k_pages, v_pages, page_table, seq_lens,
                              window, extra)
        if not (q.is_meta and op_analysis.counting()):
            raise ValueError(f"no kernel for device {q.device}")
        return _meta(q, k_pages, page_table, k_scale is not None,
                     slot_pos is not None)
    check_inputs(q, k_pages, v_pages, page_table, seq_lens, window=window,
                 **extra)
    B, H, d = q.shape
    n_pool, page, Kv = k_pages.shape[:3]
    n_max = page_table.shape[1]
    out = torch.empty_like(q)
    if B:
        split, n_split = _launch_plan(
            B, Kv, n_max * page, q.get_device(),
            MIN_SPLIT if q.dtype == torch.bfloat16 else MIN_SPLIT_F32)
        n_part, n_count = scratch_sizes(B, Kv, d, n_split)
        # f32 (acc, max, sum) of every split, merged in the same launch by
        # the last split to finish; from the caching allocator, so no
        # device allocation once warm
        part = (torch.empty(n_part, dtype=torch.float32, device=q.device)
                if n_part else None)
        counter = (cuda_build.counters(q.device, n_count) if n_count
                   else None)
        cuda_build.launch(
            SOURCES[NAME], LAUNCHES, q.data_ptr(), k_pages.data_ptr(),
            v_pages.data_ptr(), page_table.data_ptr(), seq_lens.data_ptr(),
            out.data_ptr(), cuda_build.ptr(part), cuda_build.ptr(counter),
            *(cuda_build.ptr(extra[k]) for k in EXTRAS),
            B, H, Kv, d, n_pool, page, n_max, split, n_split,
            0 if window is None else window, 1.0 / d ** 0.5,
            int(q.dtype == torch.bfloat16))
        CASES["int8_pages"] += k_scale is not None
        CASES["slot_positions"] += slot_pos is not None
    return out
