#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure ends the script with a
non-zero exit code:

1. card: the GPU's name and power limit (``nvidia-smi``); TF32 off.
2. build: the four kernels (``src/repro_torch/kernels/*/csrc``), one
   ``nvcc`` each, all started together, timed.
3. kernels: each kernel against its plain PyTorch version, with the
   kernel, plain and library times and the card's bound: the two
   dequant-matmul kernels at the llama-3.1-8b projection shapes (M in
   {1, 4, 8, 464, 512}, four (K, N)) in bf16, each row naming the loop
   that ran: "decode" for M <= 8 (the TMA + tensor-core loop of
   ``qmm_wgmma.cuh`` at 8 rows of x, its K steps split evenly over one
   block per SM and the split tiles merged in the same launch), "wgmma"
   for prefill; at the headline decode shape (M = 4, w_gate) one call of
   either, captured in a CUDA graph, must be one kernel node and nothing
   else; flash attention at llama-3.1-8b's
   heads (B, S) in {(1, 81), (2, 256), (1, 2048)} causal, one windowed
   cell and one at qwen2.5-0.5b's heads, and at head_dim 120
   (h2o-danube-3-4b: (2, 256) causal and a window of 4096 over S = 4608)
   and 96 (phi-3-vision-4.2b: (2, 256) causal); paged attention at
   llama-3.1-8b's heads for B in {1, 4, 8} and ring lengths W in {261,
   512, 4096}, and at h2o-danube's and phi-3-vision's heads for B = 4
   over W = 512, with ragged lengths and an unassigned page; the
   attention cells in bf16 and
   f32, each checked row by row and beside a control (the plain version
   with its mask edge moved by one key) that the check must see. At each
   cell one call of either attention kernel, captured in a CUDA graph,
   must be one kernel node and nothing else (paged attention merges its
   splits in the same launch).
4. serve: llama-3.1-8b at full width (random weights from
   ``torch.Generator(device="cuda").manual_seed(0)``) under each of the
   five formats: a continuous run of 8 requests through
   ``repro_torch.launch.serve.serve``, the launch counts of the kernels
   in that run (one flash launch per layer and prefill phase, one paged
   launch per layer and decode step; under int8 and nf4 one wgmma-loop
   launch per projection, layer and prefill phase, one decode-loop
   launch per projection, layer and decode step, and no tile-loop
   launch, in the sequential run too), and each request's prefill logits
   against its own sequential run. Per format it prints the host wall
   times of the run's phases (``PhaseResult.wall_s``), the analytic
   report of the H100 SXM energy model (J/token, total J, the analytic
   clock, mean batch) and, labelled measured, the card's power draw
   sampled by ``nvidia-smi`` every 100 ms over the continuous run, with
   the J/token it integrates to.

The line before the last holds the card's name and power limit, the one
before it the ``kernels`` summary, and the last line is
``{"ok": true, "device": {...}}``. Exits non-zero without a result when
no CUDA device is visible.
"""
from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM data sheet (dense): HBM3 bytes/s, bf16 tensor-core FLOP/s and
# f32 FLOP/s outside the tensor cores (TF32 is off)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12
L2_BYTES = 50 * 2**20

SHAPES_KN = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096)]
# 1: a sequential decode step; 4: the serve phase's decode batch
# (max_batch); 8: the widest decode tile; 464: the serve phase's first
# prefill (two prompts, the longer 228 tokens rounded up to 232); 512: a
# prefill of two 256-token prompts
SHAPES_M = [1, 4, 8, 464, 512]
HEADLINE = (4, 4096, 14336)     # the serve phase's decode, w_gate
# kernel vs plain, bf16 output: both round one f32 sum to bf16 (2^-8
# relative), after summing K products in different orders
KERNEL_REL_TOL = 1e-2
FORMATS = ("float32", "float16", "bfloat16", "int8", "nf4")
# quantized projections of a llama layer: wq, wk, wv, wo, w_gate, w_up,
# w_down (the LM head stays in bf16)
QUANT_PROJECTIONS = 7
# batched prefill vs the request's own prefill: the same arithmetic at
# other M and padding, so only the order of f32 sums differs; through 32
# layers that moves f32 logits by ~1e-6 of their range and 16-bit
# activations by a few bf16 ulps
PREFILL_LOGIT_TOL = {"float32": 1e-3, "float16": 5e-2, "bfloat16": 5e-2,
                     "int8": 5e-2, "nf4": 5e-2}
REPLACES = {
    "int8_matmul": "src/repro/kernels/quant_matmul/kernel.py:55",
    "nf4_matmul": "src/repro/kernels/quant_matmul/kernel.py:112",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:67",
    "paged_attention": "src/repro/kernels/paged_attention/kernel.py:71",
}
# attention kernel vs plain, row by row (one query token and head): the
# worst row's max |kernel - plain| over its max |plain|. f32 is the same
# arithmetic with sums in other orders. In bf16 p and the output are each
# rounded once to bf16: an output that lands across a rounding boundary
# is one ulp away, at most 2^-7 (0.0078) of its row's largest value, and
# p rounded against other running maxima moves a row by about 1e-3. Each
# cell also reads a control, the plain version with the mask edge moved
# by one key (the diagonal key of flash's second half of the rows, the
# last key of every paged row), which must read above the tolerance.
ATTN_REL_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
ATTN_DTYPES = ("bfloat16", "float32")
LLAMA_HEADS = (32, 8, 128)          # H, Kv, head_dim
QWEN_HEADS = (14, 2, 64)            # qwen2.5-0.5b
H2O_HEADS = (32, 8, 120)            # h2o-danube-3-4b: 3840 / 32
PHI3V_HEADS = (32, 32, 96)          # phi-3-vision-4.2b: 3072 / 32
# (B, S, heads, window)
FLASH_CELLS = [(1, 81, LLAMA_HEADS, None), (2, 256, LLAMA_HEADS, None),
               (1, 2048, LLAMA_HEADS, None), (1, 2048, LLAMA_HEADS, 512),
               (2, 256, QWEN_HEADS, None), (2, 256, H2O_HEADS, None),
               (1, 4608, H2O_HEADS, 4096), (2, 256, PHI3V_HEADS, None)]
# 261: the sequential path's ring for a 228-token prompt (one page);
# 512: the serve phase's buf_len; 4096: a long context. (B, W, heads)
PAGED_CELLS = [(B, W, LLAMA_HEADS) for B in (1, 4, 8)
               for W in (261, 512, 4096)] \
    + [(4, 512, H2O_HEADS), (4, 512, PHI3V_HEADS)]
# the card's power draw in W, one line every 100 ms, over the serve runs
POWER_SAMPLER = ["nvidia-smi", "--query-gpu=power.draw",
                 "--format=csv,noheader,nounits", "-lms", "100"]
# the cells the kernels line reports: the serve phase's prefill of two
# prompts and its decode batch over its 512-slot ring
# where the headline (bf16) kernel of each attention module lives
ATTN_SOURCES = {
    "flash_attention": "src/repro_torch/kernels/flash_attention/csrc/"
                       "flash_wgmma.cuh",
    "paged_attention": "src/repro_torch/kernels/paged_attention/csrc/"
                       "paged_attention.cu",
}
HEADLINE_ATTN = {
    "flash_attention": {"dtype": "bfloat16", "B": 2, "S": 256, "H": 32,
                        "d": 128, "window": None},
    "paged_attention": {"dtype": "bfloat16", "B": 4, "W": 512, "d": 128},
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def timed_ms(torch, fn, arg_sets, reps: int = 10,
             graph: bool = True) -> float:
    """Device time of ``fn`` per call, over 3 * ``reps`` calls cycling
    through ``arg_sets`` (so that consecutive calls read different
    weights), between CUDA events. With ``graph`` the calls are captured
    in a CUDA graph and replayed, which takes the host's launch cost out
    of the reading; the plain versions copy the codebook from the host,
    which a capture refuses, and are timed from eager launches."""
    fn(*arg_sets[0])
    torch.cuda.synchronize()
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for i in range(reps):
                fn(*arg_sets[i % len(arg_sets)])
        g.replay()
        torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for r in range(3):
        if graph:
            g.replay()
        else:
            for i in range(reps):
                fn(*arg_sets[(r * reps + i) % len(arg_sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (3 * reps)


def kernel_phase(torch, K):
    from repro_torch.quant.int8 import dequantize_int8, quantize_int8
    from repro_torch.quant.nf4 import dequantize_nf4, quantize_nf4
    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = {"int8_matmul": [], "nf4_matmul": []}
    for (Kd, N) in SHAPES_KN:
        w = torch.randn((Kd, N), generator=gen, device="cuda") * Kd ** -0.5
        q8 = quantize_int8(w, 0.01)
        q4 = quantize_nf4(w, 64)
        del w
        weights = {
            "int8_matmul": ((q8.codes, q8.scale), Kd * N + 4 * N,
                            dequantize_int8(q8, bf16)),
            "nf4_matmul": ((q4.packed, q4.absmax),
                           Kd * N // 2 + 4 * (Kd // 64) * N,
                           dequantize_nf4(q4, bf16)),
        }
        for name, (wargs, wbytes, wdeq) in weights.items():
            kern = getattr(K, name)
            plain = getattr(K, name + "_plain")
            copies = max(1, min(32, math.ceil(2 * L2_BYTES / wbytes)))
            wsets = [wargs] + [tuple(t.clone() for t in wargs)
                               for _ in range(copies - 1)]
            lcopies = max(1, min(32, math.ceil(2 * L2_BYTES / (2 * Kd * N))))
            lsets = [wdeq] + [wdeq.clone() for _ in range(lcopies - 1)]
            for M in SHAPES_M:
                x = torch.randn((M, Kd), generator=gen, device="cuda").to(bf16)
                before = dict(K.LOOP_LAUNCHES[name])
                got = kern(x, *wargs, bf16)
                loop = next(lp for lp, n in K.LOOP_LAUNCHES[name].items()
                            if n != before[lp])
                launched = (check_one_launch(
                    torch, name, lambda: kern(x, *wargs, bf16))
                    if (M, Kd, N) == HEADLINE else None)
                ref = plain(x, *wargs, bf16)
                torch.cuda.synchronize()
                diff = (got.float() - ref.float()).abs().max().item()
                rel = diff / max(ref.float().abs().max().item(), 1e-30)
                k_ms = timed_ms(torch, lambda *a: kern(x, *a, bf16),
                                wsets)
                p_ms = timed_ms(torch, lambda *a: plain(x, *a, bf16),
                                [wargs], reps=3, graph=False)
                l_ms = timed_ms(torch, lambda w_: torch.matmul(x, w_),
                                [(t,) for t in lsets])
                nbytes = 2 * M * Kd + wbytes + 2 * M * N
                flops = 2 * M * Kd * N
                t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                t_ops = flops / BF16_FLOP_PER_S * 1e3
                row = {"phase": "kernel", "name": name, "M": M, "K": Kd,
                       "N": N, "loop": loop, "max_abs_err": diff, "max_rel_err": rel,
                       "rel_tol": KERNEL_REL_TOL, "kernel_ms": k_ms,
                       "plain_ms": p_ms, "library_ms": l_ms,
                       "bytes": nbytes, "flops": flops,
                       "bound_ms": max(t_bytes, t_ops),
                       "bound_by": "bytes" if t_bytes >= t_ops
                       else "operations",
                       "cuda_launches_per_call": launched}
                emit(row)
                if not rel <= KERNEL_REL_TOL:
                    raise SystemExit(f"{name} disagrees with its plain "
                                     f"version at M={M} K={Kd} N={N}: "
                                     f"rel {rel} > {KERNEL_REL_TOL}")
                rows[name].append(row)
            del wsets, lsets
        del weights, q8, q4
        torch.cuda.empty_cache()
    return rows


def _bound(nbytes: int, flops: int, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    peak = BF16_FLOP_PER_S if dtype == "bfloat16" else F32_FLOP_PER_S
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _copies(nbytes: int) -> int:
    """Input sets to cycle through so that the timed calls read more than
    the L2 holds."""
    return max(1, min(32, math.ceil(2 * L2_BYTES / nbytes)))


def graph_nodes(torch, fn) -> list:
    """The node types (0: a kernel) of a CUDA graph that captures one call
    of ``fn`` after a warm-up call: every launch the call makes, read
    through the driver (``cuGraphGetNodes``, ``cuGraphNodeGetType``)."""
    import ctypes
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g):
        fn()
    cu = ctypes.CDLL("libcuda.so.1")
    graph = ctypes.c_void_p(g.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(graph, None, ctypes.byref(n)):
        raise SystemExit("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if n.value and cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n)):
        raise SystemExit("cuGraphGetNodes failed")
    types = []
    for node in nodes:
        t = ctypes.c_int(-1)
        if cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(t)):
            raise SystemExit("cuGraphNodeGetType failed")
        types.append(t.value)
    g.reset()
    return types


def check_one_launch(torch, name, fn) -> int:
    """Fail unless one call of ``fn`` is exactly one CUDA kernel launch
    (and nothing else: no copy or memset)."""
    types = graph_nodes(torch, fn)
    if types != [0]:
        raise SystemExit(f"{name}: one call captured the graph nodes "
                         f"{types}, expected one kernel [0]")
    return len(types)


def row_rel_err(got, ref) -> float:
    """Worst row, over the last axis: max |got - ref| / max |ref|."""
    diff = (got.float() - ref.float()).abs().amax(-1)
    return (diff / ref.float().abs().amax(-1).clamp_min(1e-30)).max().item()


def _attn_row(torch, name, dtype, got, ref, control, lib, times, nbytes,
              flops, launched, **shape):
    rel = row_rel_err(got, ref)
    bound, by = _bound(nbytes, flops, dtype)
    tol = ATTN_REL_TOL[dtype]
    row = {"phase": "kernel", "name": name, "dtype": dtype, **shape,
           "max_abs_err": (got.float() - ref.float()).abs().max().item(),
           "max_rel_err": rel, "rel_tol": tol, "control_rel_err": control,
           "library_max_abs_err": (lib.float() - ref.float()).abs().max()
           .item(),
           "kernel_ms": times[0], "plain_ms": times[1],
           "library_ms": times[2], "bytes": nbytes, "flops": flops,
           "bound_ms": bound, "bound_by": by,
           "cuda_launches_per_call": launched}
    emit(row)
    row["fault"] = (
        f"{name} disagrees with its plain version at {dtype} {shape}: "
        f"rel {rel} > {tol}" if not rel <= tol else
        f"{name} at {dtype} {shape}: the control reads {control} <= {tol}, "
        f"so the check cannot see a one-key error" if not control > tol
        else None)
    return row


def _raise_faults(rows) -> None:
    faults = [r.pop("fault") for r in rows]
    if any(faults):
        raise SystemExit("\n".join(f for f in faults if f))


def flash_phase(torch, FK):
    """Flash attention against its plain version; the library time is
    scaled_dot_product_attention on the same q, k, v laid out (B, H, S, d)
    beforehand, causal (and with the window as a boolean mask)."""
    from repro_torch.models.layers import attention
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for dtype in ATTN_DTYPES:
        td = getattr(torch, dtype)
        es = torch.finfo(td).bits // 8
        for B, S, (H, Kv, d), window in FLASH_CELLS:
            nbytes = es * (2 * B * S * H * d + 2 * B * S * Kv * d)
            sets = [tuple(torch.randn(shape, generator=gen,
                                      device="cuda").to(td)
                          for shape in ((B, S, H, d), (B, S, Kv, d),
                                        (B, S, Kv, d)))
                    for _ in range(_copies(nbytes))]
            q, k, v = sets[0]
            got = FK.flash_attention(q, k, v, causal=True, window=window)
            launched = check_one_launch(
                torch, "flash_attention", lambda: FK.flash_attention(
                    q, k, v, causal=True, window=window))
            ref = FK.flash_attention_plain(q, k, v, causal=True,
                                           window=window)
            qpos = torch.arange(S, device="cuda")
            allow = qpos[None, :] <= qpos[:, None]
            if window is not None:
                allow &= qpos[None, :] > qpos[:, None] - window
            pairs = int(allow.sum())
            # control: the plain attention without each row's diagonal key
            strict = qpos[None, :] < qpos[:, None]
            ctrl = attention(q, k, v, causal=True, window=window,
                             mask=strict[None])
            control = row_rel_err(ctrl[:, S // 2:], ref[:, S // 2:])
            del ctrl, strict
            lsets = [tuple(t.transpose(1, 2).contiguous() for t in st)
                     for st in sets]
            lkw = (dict(is_causal=True) if window is None
                   else dict(attn_mask=allow))

            def lib_fn(q_, k_, v_):
                return sdpa(q_, k_, v_, enable_gqa=True, **lkw)

            lib = lib_fn(*lsets[0]).transpose(1, 2)
            torch.cuda.synchronize()
            times = (
                timed_ms(torch, lambda *a: FK.flash_attention(
                    *a, causal=True, window=window), sets),
                timed_ms(torch, lambda *a: FK.flash_attention_plain(
                    *a, causal=True, window=window), sets[:1], reps=3,
                    graph=False),
                timed_ms(torch, lib_fn, lsets))
            rows.append(_attn_row(
                torch, "flash_attention", dtype, got, ref, control, lib,
                times, nbytes, 4 * B * H * d * pairs, launched, B=B, S=S,
                H=H, Kv=Kv, d=d, window=window))
            del sets, lsets, got, ref, lib
            torch.cuda.empty_cache()
    _raise_faults(rows)
    return rows


def paged_phase(torch, PK):
    """Paged attention against its plain version over a ring cache viewed
    as pages, as the decode step does, with ragged lengths and (where a
    row has more than one page) an unassigned page in the last row. The
    library time is scaled_dot_product_attention over the same cache laid
    out (B, Kv, W, d) beforehand, with the valid slots as a boolean
    mask."""
    import numpy as np
    from repro_torch.models.layers import ring_cache_pages
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device="cuda").manual_seed(3)
    rng = np.random.default_rng(3)
    rows = []
    for dtype in ATTN_DTYPES:
        td = getattr(torch, dtype)
        es = torch.finfo(td).bits // 8
        for B, W, (H, Kv, d) in PAGED_CELLS:
            lens = rng.integers(W // 2, W + 1, B)
            lens[0] = W
            cache_bytes = 2 * B * W * Kv * d * es
            caches = [tuple(torch.randn((B, W, Kv, d), generator=gen,
                                        device="cuda").to(td)
                            for _ in range(2))
                      for _ in range(_copies(cache_bytes))]
            q = torch.randn((B, H, d), generator=gen,
                            device="cuda").to(td)
            pos = torch.as_tensor(lens - 1, dtype=torch.int32,
                                  device="cuda")
            views = [ring_cache_pages(kc, vc, pos) for kc, vc in caches]
            _, _, table, sl = views[0]
            page, n = views[0][0].shape[1], table.shape[1]
            if n > 1:
                table[B - 1, n // 2] = -1
            sets = [(q, kp, vp, table, sl) for kp, vp, _, _ in views]
            slot = torch.arange(W, device="cuda")
            valid = (slot[None, :] < sl[:, None].long()) \
                & (table.repeat_interleave(page, dim=1) >= 0)
            n_valid = int(valid.sum())
            got = PK.paged_attention(*sets[0])
            ref = PK.paged_attention_plain(*sets[0])
            launched = check_one_launch(
                torch, "paged_attention",
                lambda: PK.paged_attention(*sets[0]))
            # control: the plain version without each row's last key
            control = row_rel_err(PK.paged_attention_plain(
                q, *sets[0][1:4], (sl - 1).clamp(min=0)), ref)
            lsets = [(q[:, :, None], kc.transpose(1, 2).contiguous(),
                      vc.transpose(1, 2).contiguous())
                     for kc, vc in caches]
            mask = valid[:, None, None, :]

            def lib_fn(q_, k_, v_):
                return sdpa(q_, k_, v_, attn_mask=mask, enable_gqa=True)

            lib = lib_fn(*lsets[0])[:, :, 0]
            torch.cuda.synchronize()
            times = (timed_ms(torch, PK.paged_attention, sets),
                     timed_ms(torch, PK.paged_attention_plain, sets[:1],
                              reps=3, graph=False),
                     timed_ms(torch, lib_fn, lsets))
            nbytes = es * (2 * B * H * d + 2 * n_valid * Kv * d) \
                + 4 * (table.numel() + B)
            rows.append(_attn_row(
                torch, "paged_attention", dtype, got, ref, control, lib,
                times, nbytes, 4 * H * d * n_valid, launched, B=B, W=W,
                H=H, Kv=Kv, d=d, page=page,
                seq_lens=[int(x) for x in lens],
                unassigned_page=n > 1))
            del caches, views, sets, lsets, got, ref, lib
        torch.cuda.empty_cache()
    _raise_faults(rows)
    return rows


def reset_launches(mods) -> None:
    for m in mods:
        m.reset_launches()


def read_launches(mods) -> dict:
    return {name: n for m in mods for name, n in m.LAUNCHES.items()}


def read_loops(K) -> dict:
    return {name: dict(c) for name, c in K.LOOP_LAUNCHES.items()}


def check_quant_loops(fmt, loops, prefills, decodes, layers, run) -> None:
    """Under int8 and nf4: every projection of each of the run's
    ``prefills`` prefills on the wgmma loop, of each of its ``decodes``
    decode steps on the decode loop, none on the tile loop."""
    per = QUANT_PROJECTIONS * layers
    name = {"int8": "int8_matmul", "nf4": "nf4_matmul"}.get(fmt)
    if name is None:
        return
    want = {"wgmma": per * prefills, "decode": per * decodes, "tile": 0}
    if loops[name] != want:
        raise SystemExit(f"{fmt} {run} run: {name} loops {loops[name]}, "
                         f"expected {want} ({per} per prefill phase and "
                         f"decode step)")


def sampled_power(fn):
    """Run ``fn()`` while ``nvidia-smi`` samples the card's power draw
    every 100 ms, from the sampler's start to the end of the run; return
    (fn's result, the samples in W). Fails if the sampler gave no
    reading."""
    import os
    ids = os.environ.get("CUDA_VISIBLE_DEVICES", "").split(",")[0].strip()
    proc = subprocess.Popen(POWER_SAMPLER + ["-i", ids or "0"],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        out = fn()              # serve() ends with a device synchronise
    finally:
        proc.terminate()
        stdout, stderr = proc.communicate(timeout=60)
    watts = [float(x) for x in stdout.split()]
    if not watts:
        raise SystemExit(f"the power sampler gave no reading: {stderr!r}")
    return out, watts


def serve_phase(torch, mods, cfg):
    from repro_torch.launch.serve import build_params, serve
    from repro_torch.models.api import build_model
    kw = dict(n=8, max_batch=4, max_prefill_batch=2, buf_len=512,
              prompt_len=(64, 256), new_tokens=(32, 32), seed=0,
              record_logits=True)
    launches = {}
    for fmt in FORMATS:
        t0 = time.perf_counter()
        model = build_model(cfg, fmt=fmt, device="cuda")
        params = build_params(model, seed=0)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        reset_launches(mods)
        con, watts = sampled_power(lambda: serve(
            model=model, params=params, mode="continuous", **kw))
        counts = read_launches(mods)
        loops = read_loops(mods[0])
        phases = [p.phase for p in con.engine.phases]
        check_quant_loops(fmt, loops, phases.count("prefill"),
                          phases.count("decode"), cfg.num_layers,
                          "continuous")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        launches[fmt] = counts
        for r in con.requests:
            if len(r.generated) != r.max_new_tokens:
                raise SystemExit(f"{fmt}: request {r.req_id} got "
                                 f"{len(r.generated)} tokens")
            if not all(0 <= t < cfg.vocab_size for t in r.generated):
                raise SystemExit(f"{fmt}: token out of the vocabulary")
        for name, fmt_of in (("int8_matmul", "int8"),
                             ("nf4_matmul", "nf4")):
            if (counts[name] > 0) != (fmt == fmt_of):
                raise SystemExit(f"{fmt}: {name} launched "
                                 f"{counts[name]} times")
        for name, phase in (("flash_attention", "prefill"),
                            ("paged_attention", "decode")):
            want = cfg.num_layers * phases.count(phase)
            if counts[name] != want:
                raise SystemExit(f"{fmt}: {name} launched {counts[name]} "
                                 f"times, not {cfg.num_layers} per {phase} "
                                 f"({want})")
        reset_launches(mods)
        seq = serve(model=model, params=params, mode="sequential", **kw)
        seq_loops = read_loops(mods[0])
        # each request alone: one B=1 prefill, then a decode step for
        # every token after the first
        check_quant_loops(fmt, seq_loops, len(seq.requests),
                          sum(r.max_new_tokens - 1 for r in seq.requests),
                          cfg.num_layers, "sequential")
        worst = 0.0
        for rc, rs in zip(con.requests, seq.requests):
            a = con.engine.backend.first_logits[rc.req_id]
            b = seq.engine.backend.first_logits[rs.req_id]
            if not torch.isfinite(a).all():
                raise SystemExit(f"{fmt}: non-finite prefill logits")
            worst = max(worst, ((a - b).abs().max()
                                / b.abs().max()).item())
        if not worst <= PREFILL_LOGIT_TOL[fmt]:
            raise SystemExit(f"{fmt}: batched prefill logits differ from "
                             f"the sequential run by {worst} > "
                             f"{PREFILL_LOGIT_TOL[fmt]}")
        same = sum(rc.generated == rs.generated
                   for rc, rs in zip(con.requests, seq.requests))
        tok_same = sum(x == y for rc, rs in zip(con.requests, seq.requests)
                       for x, y in zip(rc.generated, rs.generated))
        n_tok = sum(len(r.generated) for r in con.requests)
        # host wall times of the executed phases (latency_s is the
        # analytic clock)
        pre = [p.wall_s for p in con.engine.phases if p.phase == "prefill"]
        dec = [p.wall_s for p in con.engine.phases if p.phase == "decode"]
        rep = con.report
        analytic = {"j_per_token": 3600.0 * rep.mean_energy_per_token_wh,
                    "total_energy_j": rep.total_energy_j,
                    "wall_time_s": rep.wall_time_s,
                    "mean_batch": rep.mean_batch}
        if not (all(math.isfinite(v) and v > 0 for v in analytic.values())
                and rep.n_decode_steps == len(dec)):
            raise SystemExit(f"{fmt}: analytic report {analytic}, "
                             f"{rep.n_decode_steps} decode steps")
        mean_w = sum(watts) / len(watts)
        emit({"phase": "serve", "fmt": fmt, "model": cfg.name,
              "layers": cfg.num_layers, "d_model": cfg.d_model,
              "requests": len(con.requests),
              "prompt_lens": [r.prompt_len for r in con.requests],
              "generated_tokens": n_tok, "init_s": init_s,
              "wall_s": con.wall_s, "tokens_per_s": n_tok / con.wall_s,
              "prefill_phases": len(pre),
              "prefill_ms_mean": 1e3 * sum(pre) / len(pre),
              "decode_steps": len(dec),
              "decode_ms_per_step": 1e3 * sum(dec) / len(dec),
              "analytic": analytic,
              "measured": {"power_w_mean": mean_w, "samples": len(watts),
                           "power_w": watts, "interval_s": 0.1,
                           "j_per_token": mean_w * con.wall_s / n_tok},
              "peak_mem_gb": peak_gb, "launches": counts,
              "quant_loops": {"continuous": loops, "sequential": seq_loops},
              "prefill_logit_rel_err": worst,
              "prefill_logit_tol": PREFILL_LOGIT_TOL[fmt],
              "requests_same_tokens_as_sequential": same / len(con.requests),
              "tokens_same_as_sequential": tok_same / n_tok})
        del model, params, con, seq
        gc.collect()
        torch.cuda.empty_cache()
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.paged_attention import kernel as PK
    from repro_torch.kernels.quant_matmul import kernel as K
    mods = (K, FK, PK)

    card = card_line()
    emit({"phase": "card", "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    libs = cuda_build.build(src for m in mods for src in m.SOURCES.values())
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": [p.name for p in libs]})

    rows = kernel_phase(torch, K)
    rows["flash_attention"] = flash_phase(torch, FK)
    rows["paged_attention"] = paged_phase(torch, PK)
    from repro_torch.configs.paper_zoo import PAPER_MODELS
    launches = serve_phase(torch, mods, PAPER_MODELS["llama-3.1-8b"])

    kernels = []
    for name in K.KERNELS:
        head = next(r for r in rows[name]
                    if (r["M"], r["K"], r["N"]) == HEADLINE)
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/quant_matmul/csrc/"
                      f"{name}.cu",
            "replaces": REPLACES[name],
            "launches": max(c[name] for c in launches.values()),
            "max_abs_err": max(r["max_abs_err"] for r in rows[name]),
            "max_rel_err": max(r["max_rel_err"] for r in rows[name]),
            "shape": list(HEADLINE),
            "ms": head["kernel_ms"], "kernel_ms": head["kernel_ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "bytes": head["bytes"],
            "cuda_launches_per_call": head["cuda_launches_per_call"],
            "library_ms": head["library_ms"],
            "library_is": "torch.matmul on the weight already "
                          "dequantized to bf16 (does less work)",
        })
    for name, shape in HEADLINE_ATTN.items():
        head = next(r for r in rows[name]
                    if all(r[k] == v for k, v in shape.items()))
        kernels.append({
            "name": name, "route": "cuda",
            "source": ATTN_SOURCES[name],
            "replaces": REPLACES[name],
            "launches": max(c[name] for c in launches.values()),
            "max_abs_err": max(r["max_abs_err"] for r in rows[name]),
            "max_rel_err": max(r["max_rel_err"] for r in rows[name]),
            "shape": shape,
            "ms": head["kernel_ms"], "kernel_ms": head["kernel_ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "bytes": head["bytes"],
            "library_ms": head["library_ms"],
            "library_is": "torch.nn.functional.scaled_dot_product_attention"
                          " (enable_gqa) on the same inputs",
        })
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
