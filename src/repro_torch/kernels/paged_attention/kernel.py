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
a row of length 0 returns 0. For a tensor on the CPU it returns
:func:`paged_attention_plain`. For a CUDA tensor it checks device,
dtypes, shapes, contiguity and alignment, raises on anything the kernel
does not take (head_dim other than 64 or 128, more than 8 query heads per
KV head), allocates the output, launches on the current stream, raises if
the launch reports an error, and adds one to
``LAUNCHES["paged_attention"]``. Nothing falls back from the kernel to
the plain version.
"""
from __future__ import annotations

import functools
from pathlib import Path
from typing import Dict, List, Tuple

import torch

from repro_torch.kernels import cuda_build
from repro_torch.kernels.cuda_build import F, I, P, check

NAME = "paged_attention"
CSRC = Path(__file__).resolve().parent / "csrc"
# q, k_pages, v_pages, page_table, seq_lens, out, part, counter, B, H, Kv,
# D, n_pool, page, n_max, split, n_split, scale, is_bf16
SOURCES = {NAME: cuda_build.Source(
    NAME, CSRC, (P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, F, I),
    (cuda_build.HOPPER_HEADER,))}

#: launches of the CUDA kernel since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {NAME: 0}

NEG_INF = -1e30
HEAD_DIMS = (64, 128)
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


def scratch_sizes(B: int, Kv: int, d: int, n_split: int) -> Tuple[int, int]:
    """(f32 elements of ``part``, int32 elements of the counter) a launch
    with ``n_split`` splits needs; none with one split."""
    if n_split == 1:
        return 0, 0
    return B * Kv * n_split * MAX_GROUP * (d + 2), B * Kv


@functools.lru_cache(maxsize=None)
def _launch_plan(B: int, Kv: int, slots: int, device: int,
                 min_split: int = MIN_SPLIT) -> Tuple[int, int]:
    """(slots per block, splits per row) for a launch on CUDA device
    ``device``: decided once per shape, as decode repeats one shape for
    every layer and step."""
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    split = split_slots(B, Kv, slots, n_sm, min_split)
    return split, -(-slots // split)


def paged_attention_plain(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, page_table: torch.Tensor,
                          seq_lens: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch, walking the pages in order as
    the TPU kernel does: f32 scores times 1/sqrt(d); masked slots -1e30
    with p = 0; f32 running max and sum; the unnormalised p rounded to
    v's dtype before an f32 PV product; acc / max(l, 1e-20) cast once to
    q's dtype. An unassigned page is read as page 0 and masked."""
    B, H, d = q.shape
    page, Kv = k_pages.shape[1], k_pages.shape[2]
    G = H // Kv
    scale = 1.0 / d ** 0.5
    qg = q.reshape(B, Kv, G, d).float()
    m = torch.full((B, Kv, G), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Kv, G, d), dtype=torch.float32, device=q.device)
    offs = torch.arange(page, device=q.device)
    for j in range(page_table.shape[1]):
        pid = page_table[:, j].long()
        kp = k_pages[pid.clamp(min=0)]                  # (B, page, Kv, d)
        vp = v_pages[pid.clamp(min=0)]
        s = torch.einsum("bkgd,btkd->bkgt", qg, kp.float()) * scale
        valid = (j * page + offs[None, :] < seq_lens[:, None]) \
            & (pid[:, None] >= 0)                        # (B, page)
        valid = valid[:, None, None, :]
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(valid, torch.exp(s - m_new[..., None]),
                        torch.zeros_like(s))
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgt,btkd->bkgd", p.to(v_pages.dtype).float(), vp.float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-20)[..., None]
    return out.reshape(B, H, d).to(q.dtype)


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, page_table: torch.Tensor,
                    seq_lens: torch.Tensor) -> torch.Tensor:
    """q (B, H, d) over the pool (n_pages, page, Kv, d) -> (B, H, d) in
    q's dtype."""
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pages, v_pages, page_table,
                                     seq_lens)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
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
    check("q", q, q.dtype, (B, H, d), q.device)
    check("k_pages", k_pages, q.dtype, (n_pool, page, Kv, d), q.device)
    check("v_pages", v_pages, q.dtype, (n_pool, page, Kv, d), q.device)
    check("page_table", page_table, torch.int32, (B, n_max), q.device)
    check("seq_lens", seq_lens, torch.int32, (B,), q.device)
    if any(t.data_ptr() % 16 for t in (q, k_pages, v_pages)):
        raise ValueError("q and the pages must be 16-byte aligned")
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
            B, H, Kv, d, n_pool, page, n_max, split, n_split, 1.0 / d ** 0.5,
            int(q.dtype == torch.bfloat16))
    return out
