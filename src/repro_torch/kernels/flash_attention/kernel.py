"""Flash attention (prefill and training): CUDA C++ kernels for Hopper,
bound with ctypes, and their plain PyTorch versions.

Counterpart of ``repro.kernels.flash_attention.kernel`` (the Pallas
``flash_attention_pallas``). The forward's source is
``csrc/flash_attention.cu`` (bf16: the TMA + wgmma kernel of
``csrc/flash_wgmma.cuh``; f32: a CUDA-core kernel), built at first use by
:mod:`repro_torch.kernels.cuda_build`. The bf16 kernel's grid and tensor
map boxes are planned on the host from the shapes alone
(:func:`flash_plan`). The backward's source is
``csrc/flash_attention_bwd.cu``; the Pallas kernel has none (the
reference trains through XLA's attention). Its bf16 passes are TMA-fed
wgmma kernels (``csrc/flash_bwd_wgmma.cuh``): a dK/dV pass whose blocks
own 128 keys (64 at head_dim above 64) and walk the query tiles that may
see them, and a dQ pass
on the forward's blocks and key walk, both recomputing P from the
forward's logsumexp, so that no output needs atomics; their grids,
boxes and walks are planned on the host (:func:`flash_bwd_plan`). f32
runs both passes on the CUDA cores.

:func:`flash_attention` takes q (B, S, H, d) and k, v (B, T, Kv, d) with
H a multiple of Kv, a causal flag and an optional sliding window, at any
S, T >= 1. When grad mode is on and an input requires grad it runs as
one ``torch.autograd.Function`` (:class:`FlashAttention`): the forward
also keeps each row's logsumexp, and the backward computes dQ, dK and dV
from it. Otherwise it is the forward alone. For tensors on the CPU the
forward is :func:`flash_attention_plain` and the backward
:func:`flash_attention_backward_plain`. For CUDA tensors each checks
device, dtype (f32 or bf16, one for all), shape, contiguity and
alignment (:func:`check_inputs`), raises on anything the kernels do not
take (head_dim outside ``HEAD_DIMS``, more than 64 query heads per KV
head), allocates its outputs, launches on the current stream, raises if
the launch reports an error, and adds one to
``LAUNCHES["flash_attention"]`` or ``LAUNCHES["flash_attention_bwd"]``.
Head dims 96 and 120 run on the 128-column instances with the columns
past d zero-filled. Nothing falls back from a kernel to its plain
version.

On the ``meta`` device under a cost analysis (the dry run; outside one a
meta tensor has no kernel) the forward and the backward return
empty outputs of the kernels' shapes and dtypes and report the kernels'
bytes and FLOPs (:mod:`repro_torch.kernels.cost`) to the active
:class:`~repro_torch.core.op_analysis.OpCounter`; they never enter the
plain versions, whose tiled loops would run tens of thousands of
iterations at the dry run's lengths. On DTensors :func:`flash_attention`
runs on each rank's shards: the output is placed as q.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.core import op_analysis
from repro_torch.kernels import cuda_build
from repro_torch.kernels.cuda_build import F, I, P, check
from repro_torch.core.sharded import is_sharded, on_shards

NAME = "flash_attention"
BWD = "flash_attention_bwd"
CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {
    # q, k, v, out, lse, B, S, T, H, Kv, D, causal, window, scale, is_bf16,
    # bq
    NAME: cuda_build.Source(
        NAME, CSRC, (P, P, P, P, P, I, I, I, I, I, I, I, I, F, I, I),
        ("flash_wgmma.cuh", cuda_build.HOPPER_HEADER)),
    # q, k, v, out, dout, lse, delta, dq, dk, dv, B, S, T, H, Kv, D,
    # causal, window, scale, is_bf16, bq
    BWD: cuda_build.Source(
        BWD, CSRC, (P,) * 10 + (I,) * 8 + (F, I, I),
        ("flash_bwd_wgmma.cuh", "flash_wgmma.cuh",
         cuda_build.HOPPER_HEADER)),
}

#: launches of each CUDA kernel since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {NAME: 0, BWD: 0}
cuda_build.register_counts(LAUNCHES)

NEG_INF = -1e30
HEAD_DIMS = (64, 96, 120, 128)
MAX_GROUP = 64          # query heads per KV head: the f32 kernel's 64 rows
PLAIN_TILE = 128        # query and key tile of the plain version
WG_ROWS = 128           # (position, head) rows of a bf16 block
KEY_TILE = 64           # keys per tile of both kernels
BWD_Q_TILE = 64         # query positions of a bf16 dK/dV tile
BOX_COLS = 64           # head_dim columns of one tensor-map box (128 bytes)
DTYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@dataclasses.dataclass(frozen=True)
class FlashPlan:
    """The bf16 kernel's launch: ``bq`` query positions per block (all G
    heads of one KV head each, ``rows = bq * G <= 128`` rows), a grid of
    (B * Kv, q_tiles) blocks whose y index walks the q tiles from the last
    to the first, and the tensor-map boxes: q over (d, H, S, B) with box
    ``q_box``, k and v over (d, Kv, T, B) with box ``kv_box``, ``d_boxes``
    boxes of 64 columns to a row (the last one zero-filled past d when d
    is 96 or 120)."""

    bq: int
    rows: int
    q_tiles: int
    grid: Tuple[int, int]
    q_box: Tuple[int, int, int, int]
    kv_box: Tuple[int, int, int, int]
    d_boxes: int


def flash_plan(B: int, S: int, H: int, Kv: int, d: int) -> FlashPlan:
    """The bf16 kernel's plan from the shapes alone."""
    G = H // Kv
    bq = WG_ROWS // G
    q_tiles = -(-S // bq)
    return FlashPlan(bq=bq, rows=bq * G, q_tiles=q_tiles,
                     grid=(B * Kv, q_tiles), q_box=(BOX_COLS, G, bq, 1),
                     kv_box=(BOX_COLS, 1, KEY_TILE, 1),
                     d_boxes=-(-d // BOX_COLS))


def block_origin(plan: FlashPlan, bx: int, by: int,
                 Kv: int) -> Tuple[int, int, int]:
    """(batch, KV head, first query position) of block (bx, by), as the
    kernel computes them: the q tile index is reversed, so that the tiles
    with the most keys start first."""
    return bx // Kv, bx % Kv, (plan.q_tiles - 1 - by) * plan.bq


def block_rows(plan: FlashPlan, bx: int, by: int, S: int, H: int,
               Kv: int) -> List[Tuple[int, int, int]]:
    """The (batch, position, head) rows block (bx, by) stores: row r of
    its q box is position q0 + r // G and head kv * G + r % G; rows past
    S are the box's zero fill and are not stored."""
    G = H // Kv
    b, kv, q0 = block_origin(plan, bx, by, Kv)
    return [(b, q0 + r // G, kv * G + r % G) for r in range(plan.rows)
            if q0 + r // G < S]


def key_tiles(q0: int, bq: int, S: int, T: int, causal: bool,
              window: Optional[int]) -> int:
    """Key tiles a block of positions q0 .. q0 + bq - 1 walks (the
    kernel's key_range)."""
    if not causal:
        return -(-T // KEY_TILE)
    end = min(T, min(S, q0 + bq))
    begin = (max(0, q0 - window + 1) // KEY_TILE * KEY_TILE
             if window is not None else 0)
    return -(-(end - begin) // KEY_TILE) if end > begin else 0


def key_tile_starts(q0: int, bq: int, S: int, T: int, causal: bool,
                    window: Optional[int]) -> range:
    """First keys of the tiles a block of positions q0 .. q0 + bq - 1
    walks: the forward's and the dQ pass's key walk."""
    begin = (max(0, q0 - window + 1) // KEY_TILE * KEY_TILE
             if causal and window is not None else 0)
    n = key_tiles(q0, bq, S, T, causal, window)
    return range(begin, begin + n * KEY_TILE, KEY_TILE)


@dataclasses.dataclass(frozen=True)
class FlashBwdPlan:
    """The bf16 backward's two launches after the delta pass. dK/dV: a
    grid of (B * Kv, key blocks) blocks of ``keys`` keys each (d = 64: 128
    keys, 64 to a consumer warpgroup; d > 64, the 128-column instance: 64
    keys, the two warpgroups splitting dK's and dV's columns), block
    (bx, by) holding keys ``by * keys`` on of KV head ``bx % Kv`` of batch
    row ``bx // Kv`` (the key blocks that walk the most query tiles start
    first), q and dO over (d, H, S, B) with box ``q_box``, k and v over
    (d, Kv, T, B) with box ``kv_box``;
    each block walks, for each of the G heads of its KV head, the query
    tiles of :func:`dkdv_query_tiles`. dQ: the forward's plan ``dq``
    (its grid, rows and boxes, q and dO each read once a block) and its
    key walk (:func:`key_tile_starts`). ``d_boxes`` boxes of 64 columns
    to a row, the last one zero-filled past d when d is 96 or 120."""

    S: int
    T: int
    causal: bool
    window: Optional[int]
    keys: int
    dkdv_grid: Tuple[int, int]
    q_box: Tuple[int, int, int, int]
    kv_box: Tuple[int, int, int, int]
    dq: FlashPlan
    d_boxes: int


def flash_bwd_plan(B: int, S: int, T: int, H: int, Kv: int, d: int,
                   causal: bool, window: Optional[int]) -> FlashBwdPlan:
    """The bf16 backward's plan from the shapes alone."""
    keys = 128 if d == 64 else 64
    return FlashBwdPlan(
        S=S, T=T, causal=causal, window=window, keys=keys,
        dkdv_grid=(B * Kv, -(-T // keys)),
        q_box=(BOX_COLS, 1, BWD_Q_TILE, 1),
        kv_box=(BOX_COLS, 1, keys, 1),
        dq=flash_plan(B, S, H, Kv, d), d_boxes=-(-d // BOX_COLS))


def dkdv_query_tiles(plan: FlashBwdPlan, by: int) -> range:
    """First positions of the query tiles dK/dV block row ``by`` walks
    (the kernel's query_range): under the causal mask from the block's
    first key on, and with a window up to its last key + window - 1;
    unmasked, every tile. As the forward's key walk, the window narrows
    the walk only under the causal mask (an unmasked windowed call walks
    tiles it may not see, and masks them)."""
    k0 = by * plan.keys
    q_begin, q_end = 0, plan.S
    if plan.causal:
        q_begin = k0
        if plan.window is not None:
            last = min(plan.T, k0 + plan.keys) - 1
            q_end = min(plan.S, last + plan.window)
    return range(q_begin, max(q_begin, q_end), BWD_Q_TILE)


def _key_range(q0: int, q1: int, T: int, causal: bool,
               window: Optional[int]):
    """Keys [begin, end) that queries q0..q1-1 may see."""
    if not causal:
        return 0, T
    begin = max(0, q0 - window + 1) if window is not None else 0
    return begin, min(T, q1)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: Optional[int] = None,
                          tile: int = PLAIN_TILE,
                          return_lse: bool = False):
    """The kernel's arithmetic in PyTorch: an online softmax over
    (tile x tile) blocks, ragged tails included. f32 scores times
    1/sqrt(d); masked entries -1e30; f32 running max and sum; the
    unnormalised p rounded to v's dtype before an f32 PV product;
    acc / max(l, 1e-20) cast once to q's dtype. Key blocks that no query
    of the block may see are skipped, which changes nothing: every query
    sees its own position, and the first real score wipes what a wholly
    masked block added (corr = exp(-1e30 - m) = 0). With ``return_lse``,
    (out, lse): each row's logsumexp m + log(l) in f32, (B, H, S), as the
    kernel stores it for the backward."""
    B, S, H, d = q.shape
    T, Kv = k.shape[1], k.shape[2]
    G = H // Kv
    scale = 1.0 / d ** 0.5
    qg = q.reshape(B, S, Kv, G, d).permute(0, 2, 3, 1, 4).float()
    kt = k.permute(0, 2, 1, 3).float()[:, :, None]        # (B,Kv,1,T,d)
    vt = v.permute(0, 2, 1, 3)[:, :, None]
    out = torch.empty((B, Kv, G, S, d), dtype=torch.float32, device=q.device)
    lse = torch.empty((B, Kv, G, S), dtype=torch.float32, device=q.device)
    for q0 in range(0, S, tile):
        q1 = min(S, q0 + tile)
        qc = qg[:, :, :, q0:q1]
        qpos = torch.arange(q0, q1, device=q.device)[:, None]
        m = torch.full((B, Kv, G, q1 - q0), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, Kv, G, q1 - q0, d), dtype=torch.float32,
                          device=q.device)
        begin, end = _key_range(q0, q1, T, causal, window)
        for k0 in range(begin // tile * tile, end, tile):
            k1 = min(T, k0 + tile)
            s = torch.matmul(qc, kt[..., k0:k1, :].transpose(-1, -2)) * scale
            kpos = torch.arange(k0, k1, device=q.device)[None, :]
            allow = torch.ones((q1 - q0, k1 - k0), dtype=torch.bool,
                               device=q.device)
            if causal:
                allow &= kpos <= qpos
            if window is not None:
                allow &= kpos > qpos - window
            s = torch.where(allow, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.matmul(
                p.to(v.dtype).float(), vt[..., k0:k1, :].float())
            m = m_new
        out[:, :, :, q0:q1] = acc / torch.clamp(l, min=1e-20)[..., None]
        lse[:, :, :, q0:q1] = m + torch.log(l)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, S, H, d).to(q.dtype)
    return (out, lse.reshape(B, H, S)) if return_lse else out


def visible(S: int, T: int, causal: bool, window: Optional[int],
            device) -> torch.Tensor:
    """(S, T) boolean: key j visible to query i (both counted from 0)."""
    qpos = torch.arange(S, device=device)[:, None]
    kpos = torch.arange(T, device=device)[None, :]
    allow = torch.ones((S, T), dtype=torch.bool, device=device)
    if causal:
        allow &= kpos <= qpos
    if window is not None:
        allow &= kpos > qpos - window
    return allow


def flash_attention_backward_plain(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, o: torch.Tensor,
                                   lse: torch.Tensor, do: torch.Tensor, *,
                                   causal: bool = True,
                                   window: Optional[int] = None):
    """The backward kernel's arithmetic in PyTorch: (dq, dk, dv) of the
    forward's function from its output ``o`` and logsumexp ``lse``
    (B, H, S) f32, for the output gradient ``do``. Every operand widened
    to f32; D = rowsum(do * o); P = exp(q k^T / sqrt(d) - lse), 0 where
    masked; dV = P^T dO; dS = P * (dO v^T - D); dQ = dS k / sqrt(d);
    dK = dS^T q / sqrt(d), dK and dV summed over each KV head's G query
    heads; each cast once to its input's dtype. For bf16 inputs P is
    rounded to bf16 before the dV product and dS before the dK and dQ
    products (dS from the f32 P), as the kernel rounds them: its products
    run on the tensor cores with bf16 operands, as FlashAttention-2 and 3
    round them and as the forward rounds p before PV. f32 keeps P and dS
    in f32."""
    B, S, H, d = q.shape
    T, Kv = k.shape[1], k.shape[2]
    G = H // Kv
    scale = 1.0 / d ** 0.5

    def heads(t):                      # (B, S, H, d) -> (B, Kv, G, S, d)
        return t.reshape(B, S, Kv, G, d).permute(0, 2, 3, 1, 4).float()

    qg, og, dog = heads(q), heads(o), heads(do)
    kt = k.permute(0, 2, 1, 3).float()[:, :, None]        # (B,Kv,1,T,d)
    vt = v.permute(0, 2, 1, 3).float()[:, :, None]
    delta = (dog * og).sum(dim=-1)                        # (B,Kv,G,S)
    s = torch.matmul(qg, kt.transpose(-1, -2)) * scale
    allow = visible(S, T, causal, window, q.device)
    p = torch.where(allow, torch.exp(s - lse.reshape(B, Kv, G, S)[..., None]),
                    torch.zeros((), device=q.device))
    del s

    def operand(t):                    # a tensor-core operand: bf16 rounds
        return t.to(q.dtype).float() if q.dtype == torch.bfloat16 else t

    dv = torch.matmul(operand(p).transpose(-1, -2), dog).sum(dim=2)
    ds = operand(p * (torch.matmul(dog, vt.transpose(-1, -2))
                      - delta[..., None]))
    del p
    dq = torch.matmul(ds, kt) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qg).sum(dim=2) * scale
    return (dq.permute(0, 3, 1, 2, 4).reshape(B, S, H, d).to(q.dtype),
            dk.permute(0, 2, 1, 3).to(k.dtype).contiguous(),
            dv.permute(0, 2, 1, 3).to(v.dtype).contiguous())


def check_inputs(q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor) -> None:
    """Raise on anything the kernel does not take: the checks of the CUDA
    path, on any device (a test runs them on the meta device)."""
    if q.ndim != 4 or k.ndim != 4:
        raise ValueError(f"q and k must be 4-D, got {tuple(q.shape)} and "
                         f"{tuple(k.shape)}")
    B, S, H, d = q.shape
    T, Kv = k.shape[1], k.shape[2]
    if q.dtype not in DTYPES:
        raise TypeError(f"no kernel for dtype {q.dtype}; expected one of "
                        f"{DTYPES}")
    if d not in HEAD_DIMS:
        raise ValueError(f"no kernel for head_dim {d}; expected {HEAD_DIMS}")
    if Kv == 0 or H % Kv or H // Kv > MAX_GROUP:
        raise ValueError(f"H={H} must be a multiple of Kv={Kv}, at most "
                         f"{MAX_GROUP} times it")
    check("q", q, q.dtype, (B, S, H, d), q.device)
    check("k", k, q.dtype, (B, T, Kv, d), q.device)
    check("v", v, q.dtype, (B, T, Kv, d), q.device)
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must be 16-byte aligned")
    if T == 0 and S:
        raise ValueError("no keys to attend to (T = 0)")


def flash_attention_forward(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True,
                            window: Optional[int] = None,
                            with_lse: bool = False):
    """(out, each row's logsumexp (B, H, S) f32 with ``with_lse``, else
    None): the plain version on the CPU, the kernel on the card."""
    if q.device.type == "cpu":
        if with_lse:
            return flash_attention_plain(q, k, v, causal=causal,
                                         window=window, return_lse=True)
        return flash_attention_plain(q, k, v, causal=causal,
                                     window=window), None
    if q.is_meta and op_analysis.counting():
        return _meta_forward(q, k, causal, window, with_lse)
    check_inputs(q, k, v)
    B, S, H, d = q.shape
    T, Kv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if B and S:
        cuda_build.launch(
            SOURCES[NAME], LAUNCHES, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), cuda_build.ptr(lse), B, S, T, H,
            Kv, d, int(causal), window or 0, 1.0 / d ** 0.5,
            int(q.dtype == torch.bfloat16), flash_plan(B, S, H, Kv, d).bq)
    return out, lse


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             lse: torch.Tensor, do: torch.Tensor, *,
                             causal: bool = True,
                             window: Optional[int] = None):
    """(dq, dk, dv) of :func:`flash_attention` at (q, k, v), given its
    output ``o``, logsumexp ``lse`` (B, H, S) f32 and the output gradient
    ``do``: :func:`flash_attention_backward_plain` on the CPU, the
    backward kernel on the card (counted in ``LAUNCHES[BWD]``)."""
    if q.device.type == "cpu":
        return flash_attention_backward_plain(q, k, v, o, lse, do,
                                              causal=causal, window=window)
    if q.is_meta and op_analysis.counting():
        return _meta_backward(q, k, v, causal, window)
    check_inputs(q, k, v)
    B, S, H, d = q.shape
    T, Kv = k.shape[1], k.shape[2]
    check("o", o, q.dtype, (B, S, H, d), q.device)
    check("do", do, q.dtype, (B, S, H, d), q.device)
    check("lse", lse, torch.float32, (B, H, S), q.device)
    if o.data_ptr() % 16 or do.data_ptr() % 16:
        raise ValueError("o and do must be 16-byte aligned")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if B:
        delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
        cuda_build.launch(
            SOURCES[BWD], LAUNCHES, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, S, T, H, Kv, d,
            int(causal), window or 0, 1.0 / d ** 0.5,
            int(q.dtype == torch.bfloat16),
            flash_bwd_plan(B, S, T, H, Kv, d, causal, window).dq.bq)
    return dq, dk, dv


def _meta_cost(name: str, fn, q: torch.Tensor, k: torch.Tensor,
               causal: bool, window: Optional[int]) -> None:
    from repro_torch.kernels import cost
    B, S, H, d = q.shape
    T, Kv = k.shape[1], k.shape[2]
    pairs = cost.attention_pairs(S, T, causal, window)
    nbytes, flops = fn(B, S, T, H, Kv, d, pairs, q.element_size())
    op_analysis.record(name, flops, nbytes)


def _meta_forward(q, k, causal, window, with_lse):
    """The forward's meta branch: (empty out, empty lse or None)."""
    from repro_torch.kernels import cost
    _meta_cost(NAME, cost.flash_attention, q, k, causal, window)
    B, S, H, _ = q.shape
    lse = (torch.empty((B, H, S), dtype=torch.float32, device="meta")
           if with_lse else None)
    return torch.empty_like(q), lse


def _meta_backward(q, k, v, causal, window):
    """The backward's meta branch: empty (dq, dk, dv)."""
    from repro_torch.kernels import cost
    _meta_cost(BWD, cost.flash_attention_bwd, q, k, causal, window)
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


class FlashAttention(torch.autograd.Function):
    """Flash attention with its gradient: the forward keeps the output and
    each row's logsumexp, the backward recomputes the probabilities from
    them (:func:`flash_attention_backward`)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out, lse = flash_attention_forward(q, k, v, causal=causal,
                                           window=window, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(
            q, k, v, out, lse, do.to(q.dtype).contiguous(),
            causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q (B, S, H, d), k/v (B, T, Kv, d) -> (B, S, H, d) in q's dtype."""
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if q.device.type not in ("cpu", "cuda"):
        if is_sharded(q, k, v):
            return on_shards(flash_attention, list(q.placements), q, k, v,
                             causal=causal, window=window)
        if not (q.is_meta and op_analysis.counting()):
            raise ValueError(f"no kernel for device {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, window)
    return flash_attention_forward(q, k, v, causal=causal,
                                   window=window)[0]
