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
   {1, 4, 8, 464, 512}, four (K, N)) and at every other 2-D projection
   that a serve cell runs in int8 or nf4 (qwen3-moe-30b-a3b's and
   granite-moe-1b-a400m's attention, command-r-35b's seven), at the rows
   the serve gives it (1 and 4 at decode, 512 at prefill), in bf16, each
   row naming the loop
   that ran: "decode" for M <= 8 (the TMA + tensor-core loop of
   ``qmm_wgmma.cuh`` at 8 rows of x, its K steps split evenly over one
   block per SM and the split tiles merged in the same launch), "wgmma"
   for prefill; at the headline decode shape (M = 4, w_gate) one call of
   either, captured in a CUDA graph, must be one kernel node and nothing
   else; flash attention at llama-3.1-8b's
   heads (B, S) in {(1, 81), (2, 256), (1, 2048)} causal, one windowed
   cell and one at qwen2.5-0.5b's heads, and at head_dim 120
   (h2o-danube-3-4b: (2, 256) causal and a window of 4096 over S = 4608)
   and 96 (phi-3-vision-4.2b: (2, 256) causal), and (2, 256) at the
   heads of qwen3-moe-30b-a3b (32/4/64), stablelm-1.6b (32/32/64),
   command-r-35b (64/8/128) and granite-moe-1b-a400m (16/8/64); paged
   attention at
   llama-3.1-8b's heads for B in {1, 4, 8} and ring lengths W in {261,
   512, 4096}, and at the other six heads for B = 4
   over W = 512, with ragged lengths and an unassigned page; the
   attention cells in bf16 and
   f32, each checked row by row and beside a control (the plain version
   with its mask edge moved by one key) that the check must see. At each
   cell one call of either attention kernel, captured in a CUDA graph,
   must be one kernel node and nothing else (paged attention merges its
   splits in the same launch). The grouped launch of both quant kernels
   (every expert of an MoE projection in one launch) at
   qwen3-moe-30b-a3b's expert shapes (E = 128; (K, N) = (2048, 768) and
   (768, 2048); C = 8 rows an expert at decode, 40 at prefill) in both
   formats, and at every (E, C, K, N) that a serve cell's grouped
   products run (qwen3's and granite-moe-1b-a400m's, E = 32 over (1024,
   512) and (512, 1024), under the configs' capacity factor and the
   no-drop one of the logit pair, at decode, a request's own prefill and
   a batched prefill: C up to 512) in the formats the cell serves,
   against its plain version, each call one kernel node, beside
   ``torch.bmm`` on the weights already dequantized to bf16 and a Python
   loop of the 2-D kernel over the experts. Every attention geometry a
   serve cell runs must be among the flash and paged cells.
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
5. moe: qwen3-moe-30b-a3b at full width and depth (48 layers, 128
   experts, top 8) in bfloat16, int8 and nf4, and granite-moe-1b-a400m
   (24 layers, 32 experts) in int8, with llama's traffic and checks: the
   timed continuous run keeps the config's capacity factor (1.25) and
   prints the layer-mean dropped fraction of each prefill; the prefill
   logit check runs a continuous and a sequential run under a capacity
   that drops nothing (E / top_k), since capacity drops depend on the
   number of tokens routed together. Under int8 and nf4 each layer makes
   4 attention projections and 3 grouped expert products a phase, each
   on the loop its rows choose (decode for at most 8, wgmma above).
6. dense: stablelm-1.6b, minitron-8b and h2o-danube-3-4b in bfloat16
   and command-r-35b in int8, at full width and depth, 4 requests of 8
   new tokens, the same checks (h2o-danube's windowed decode takes the
   masked path: no paged launch).

The line before the last holds the card's name and power limit, the one
before it the ``kernels`` summary, and the last line is
``{"ok": true, "device": {...}}``. Exits non-zero without a result when
no CUDA device is visible.

Cuts: qwen3-moe-30b-a3b runs no float32 (120 GB of weights, more than
the card's 80 GB) and no float16 (it stores the same 16-bit bytes as
bfloat16 and casts them per product); the dense ARCH_IDS configs run one
format each, 4 requests of 8 new tokens. Weights are random.
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
    "int8_matmul_grouped": "src/repro/kernels/quant_matmul/kernel.py:55",
    "nf4_matmul_grouped": "src/repro/kernels/quant_matmul/kernel.py:112",
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
# the serve cells' grouped expert products under the reference's capacity
# dispatch (moe.py, _expert_dense), in both formats: (arch, E, C, K, N)
# of qwen3-moe-30b-a3b's w_gate/w_up and w_down at decode (C = 8 rows an
# expert: 4 tokens, top 8 of 128 experts, capacity factor 1.25, at least
# 8) and at prefill (C = 40: 512 tokens), and granite-moe-1b-a400m's (32
# experts: C = 8 and 160, two row tiles). quant_cells adds every other
# capacity the serve cells run.
GROUPED_SHAPES = [("qwen3-moe-30b-a3b", 128, C, Kd, N)
                  for C in (8, 40) for Kd, N in ((2048, 768), (768, 2048))] \
    + [("granite-moe-1b-a400m", 32, C, Kd, N)
       for C in (8, 160) for Kd, N in ((1024, 512), (512, 1024))]
HEADLINE_GROUPED = (128, 8, 2048, 768)
LLAMA_HEADS = (32, 8, 128)          # H, Kv, head_dim
QWEN_HEADS = (14, 2, 64)            # qwen2.5-0.5b
H2O_HEADS = (32, 8, 120)            # h2o-danube-3-4b: 3840 / 32
PHI3V_HEADS = (32, 32, 96)          # phi-3-vision-4.2b: 3072 / 32
QWEN3_HEADS = (32, 4, 64)           # qwen3-moe-30b-a3b
STABLELM_HEADS = (32, 32, 64)       # stablelm-1.6b (MHA)
COMMAND_R_HEADS = (64, 8, 128)      # command-r-35b
GRANITE_HEADS = (16, 8, 64)         # granite-moe-1b-a400m
# (B, S, heads, window)
FLASH_CELLS = [(1, 81, LLAMA_HEADS, None), (2, 256, LLAMA_HEADS, None),
               (1, 2048, LLAMA_HEADS, None), (1, 2048, LLAMA_HEADS, 512),
               (2, 256, QWEN_HEADS, None), (2, 256, H2O_HEADS, None),
               (1, 4608, H2O_HEADS, 4096), (2, 256, PHI3V_HEADS, None),
               (2, 256, QWEN3_HEADS, None), (2, 256, STABLELM_HEADS, None),
               (2, 256, COMMAND_R_HEADS, None),
               (2, 256, GRANITE_HEADS, None)]
# 261: the sequential path's ring for a 228-token prompt (one page);
# 512: the serve phase's buf_len; 4096: a long context. (B, W, heads)
PAGED_CELLS = [(B, W, LLAMA_HEADS) for B in (1, 4, 8)
               for W in (261, 512, 4096)] \
    + [(4, 512, h) for h in (H2O_HEADS, PHI3V_HEADS, QWEN3_HEADS,
                             STABLELM_HEADS, COMMAND_R_HEADS,
                             GRANITE_HEADS)]
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


def serve_projections(cfg) -> list:
    """(K, N) of each 2-D projection a layer of ``cfg`` quantizes: wq,
    wk and wv, wo, and for a dense layer w_gate and w_up, w_down (an MoE
    layer's experts take the grouped launch)."""
    D = cfg.d_model
    q, kv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    kn = [(D, q), (D, kv), (q, D)]
    if not cfg.is_moe:
        kn += [(D, cfg.d_ff), (cfg.d_ff, D)]
    return kn


def quant_cells(configs) -> tuple:
    """The quant kernel calls of the kernel phase: llama-3.1-8b's
    SHAPES_KN x SHAPES_M and GROUPED_SHAPES in both formats, and the calls
    every SERVE_CELLS
    config makes in each quantized format it serves: its 2-D projections
    at 1 row (a sequential decode step), max_batch rows (a continuous
    one) and max_prefill_batch times the longest prompt (a batched
    prefill), and for MoE its grouped expert products (E, C, K, N) at the
    capacity C of a decode step, a request's own prefill and a batched
    prefill, under the config's capacity factor and the no-drop one (E /
    top_k) of the logit pair. ``configs`` maps an arch to its config.
    Returns ({(name, K, N): {M: [arch, ...]}}, {(name, E, K, N): {C:
    [arch, ...]}})."""
    from repro_torch.models.moe import expert_capacity
    two_d, grouped = {}, {}

    def add(table, key, rows, arch):
        for r in rows:
            table.setdefault(key, {}).setdefault(r, [])
            if arch not in table[key][r]:
                table[key][r].append(arch)

    for Kd, N in SHAPES_KN:
        for name in ("int8_matmul", "nf4_matmul"):
            add(two_d, (name, Kd, N), SHAPES_M, "llama-3.1-8b")
    for arch, E, C, Kd, N in GROUPED_SHAPES:
        for name in ("int8_matmul", "nf4_matmul"):
            add(grouped, (name + "_grouped", E, Kd, N), [C], arch)
    for arch, formats, kw in SERVE_CELLS:
        cfg = configs[arch]
        batched = kw["max_prefill_batch"] * kw["prompt_len"][1]
        for fmt in formats:
            name = {"int8": "int8_matmul", "nf4": "nf4_matmul"}.get(fmt)
            if name is None:
                continue
            for Kd, N in serve_projections(cfg):
                add(two_d, (name, Kd, N), [1, kw["max_batch"], batched],
                    arch)
            if not cfg.is_moe:
                continue
            E, k = cfg.num_experts, cfg.experts_per_token
            cs = sorted({expert_capacity(T, E, k, cf)
                         for T in (kw["max_batch"], kw["prompt_len"][1],
                                   batched)
                         for cf in (cfg.moe_capacity_factor, E / k)})
            for Kd, N in ((cfg.d_model, cfg.d_ff), (cfg.d_ff, cfg.d_model)):
                add(grouped, (name + "_grouped", E, Kd, N), cs, arch)
    return two_d, grouped


def _quantized(torch, name, w, bf16):
    """(kernel weight args, bytes, the weight dequantized to bf16) of a
    float weight (K, N) or (E, K, N) in the format of the entry point
    ``name``."""
    from repro_torch.quant.int8 import dequantize_int8, quantize_int8
    from repro_torch.quant.nf4 import dequantize_nf4, quantize_nf4
    *E, Kd, N = w.shape
    n = math.prod(E)
    if name.startswith("int8"):
        q = quantize_int8(w, 0.01)
        return ((q.codes, q.scale), n * (Kd * N + 4 * N),
                dequantize_int8(q, bf16))
    q = quantize_nf4(w, 64)
    return ((q.packed, q.absmax), n * (Kd * N // 2 + 4 * (Kd // 64) * N),
            dequantize_nf4(q, bf16))


def kernel_phase(torch, K, cells):
    """Both quant kernels' 2-D calls at ``cells`` (:func:`quant_cells`)
    against their plain versions, bf16, each row naming the loop that ran
    and the serve cells that make the call."""
    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = {"int8_matmul": [], "nf4_matmul": []}
    for (name, Kd, N), ms in cells.items():
        w = torch.randn((Kd, N), generator=gen, device="cuda") * Kd ** -0.5
        wargs, wbytes, wdeq = _quantized(torch, name, w, bf16)
        del w
        kern = getattr(K, name)
        plain = getattr(K, name + "_plain")
        wsets = [wargs] + [tuple(t.clone() for t in wargs)
                           for _ in range(_copies(wbytes) - 1)]
        lsets = [wdeq] + [wdeq.clone()
                          for _ in range(_copies(2 * Kd * N) - 1)]
        for M in sorted(ms):
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
            k_ms = timed_ms(torch, lambda *a: kern(x, *a, bf16), wsets)
            p_ms = timed_ms(torch, lambda *a: plain(x, *a, bf16), [wargs],
                            reps=3, graph=False)
            l_ms = timed_ms(torch, lambda w_: torch.matmul(x, w_),
                            [(t,) for t in lsets])
            nbytes = 2 * M * Kd + wbytes + 2 * M * N
            flops = 2 * M * Kd * N
            bound, by = _bound(nbytes, flops, "bfloat16")
            row = {"phase": "kernel", "name": name, "M": M, "K": Kd,
                   "N": N, "serves": ms[M], "loop": loop,
                   "max_abs_err": diff, "max_rel_err": rel,
                   "rel_tol": KERNEL_REL_TOL, "kernel_ms": k_ms,
                   "plain_ms": p_ms, "library_ms": l_ms,
                   "bytes": nbytes, "flops": flops, "bound_ms": bound,
                   "bound_by": by, "cuda_launches_per_call": launched}
            emit(row)
            if not rel <= KERNEL_REL_TOL:
                raise SystemExit(f"{name} disagrees with its plain "
                                 f"version at M={M} K={Kd} N={N}: "
                                 f"rel {rel} > {KERNEL_REL_TOL}")
            rows[name].append(row)
            del x, got, ref
        del wargs, wdeq, wsets, lsets
        torch.cuda.empty_cache()
    return rows


def grouped_phase(torch, K, cells):
    """The grouped launch of both quant kernels (all E experts of an MoE
    projection in one launch) against its plain grouped version at
    ``cells`` (:func:`quant_cells`), bf16; each call one kernel node. Two
    yardsticks: ``torch.bmm`` on the weights already dequantized to bf16
    (less work: no dequantization), and a Python loop of the 2-D kernel
    over the experts, timed from eager launches (what E launches cost the
    host)."""
    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(4)
    rows = {"int8_matmul_grouped": [], "nf4_matmul_grouped": []}
    for (entry, E, Kd, N), cs in cells.items():
        name = entry.replace("_grouped", "")
        w = torch.randn((E, Kd, N), generator=gen, device="cuda") * Kd ** -0.5
        wargs, wbytes, wdeq = _quantized(torch, name, w, bf16)
        del w
        kern, two_d = getattr(K, entry), getattr(K, name)
        plain = getattr(K, name + "_plain")
        wsets = [wargs] + [tuple(t.clone() for t in wargs)
                           for _ in range(_copies(wbytes) - 1)]
        lsets = [(wdeq,)] + [(wdeq.clone(),)
                             for _ in range(_copies(2 * E * Kd * N) - 1)]
        for C in sorted(cs):
            x = torch.randn((E, C, Kd), generator=gen,
                            device="cuda").to(bf16)
            before = dict(K.LOOP_LAUNCHES[entry])
            got = kern(x, *wargs, bf16)
            loop = next(lp for lp, n in K.LOOP_LAUNCHES[entry].items()
                        if n != before[lp])
            launched = check_one_launch(torch, entry,
                                        lambda: kern(x, *wargs, bf16))
            ref = plain(x, *wargs, bf16)
            torch.cuda.synchronize()
            diff = (got.float() - ref.float()).abs().max().item()
            rel = diff / max(ref.float().abs().max().item(), 1e-30)
            del got, ref

            def loop_2d(*a):
                for e in range(E):
                    two_d(x[e], *(t[e] for t in a), bf16)

            k_ms = timed_ms(torch, lambda *a: kern(x, *a, bf16), wsets)
            p_ms = timed_ms(torch, lambda *a: plain(x, *a, bf16), [wargs],
                            reps=3, graph=False)
            l_ms = timed_ms(torch, lambda w_: torch.bmm(x, w_), lsets)
            loop_ms = timed_ms(torch, loop_2d, wsets, reps=3, graph=False)
            nbytes = 2 * E * C * Kd + wbytes + 2 * E * C * N
            flops = 2 * E * C * Kd * N
            bound, by = _bound(nbytes, flops, "bfloat16")
            row = {"phase": "kernel", "name": entry, "E": E, "C": C,
                   "K": Kd, "N": N, "serves": cs[C], "loop": loop,
                   "max_abs_err": diff, "max_rel_err": rel,
                   "rel_tol": KERNEL_REL_TOL, "kernel_ms": k_ms,
                   "plain_ms": p_ms, "library_ms": l_ms,
                   "loop_of_2d_calls_ms": loop_ms, "bytes": nbytes,
                   "flops": flops, "bound_ms": bound, "bound_by": by,
                   "cuda_launches_per_call": launched}
            emit(row)
            if not rel <= KERNEL_REL_TOL:
                raise SystemExit(f"{entry} disagrees with its plain version "
                                 f"at E={E} C={C} K={Kd} N={N}: rel {rel} "
                                 f"> {KERNEL_REL_TOL}")
            rows[entry].append(row)
            del x
        del wargs, wdeq, wsets, lsets
        torch.cuda.empty_cache()
    return rows


def check_attention_cells(configs) -> None:
    """Fail unless the heads (H, Kv, head_dim) of every SERVE_CELLS
    config are among FLASH_CELLS' and, unless it is windowed (its decode
    takes the masked path), among PAGED_CELLS'."""
    flash = {h for _, _, h, _ in FLASH_CELLS}
    paged = {h for _, _, h in PAGED_CELLS}
    for arch, _, _ in SERVE_CELLS:
        cfg = configs[arch]
        heads = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
        if heads not in flash or (not cfg.sliding_window
                                  and heads not in paged):
            raise SystemExit(f"{arch}: its heads {heads} are missing from "
                             f"the attention cells")


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


def expected_quant_loops(cfg, fmt, tokens) -> dict:
    """Under int8 and nf4, the launches of each quant entry point by loop
    over phases that route ``tokens`` tokens each (a prefill: its rows
    times its padded length; a decode step: its lanes): per layer and
    phase, the 2-D projections (7 of a dense layer, the 4 attention ones
    of an MoE layer) on the decode loop for at most 8 rows and the wgmma
    loop above, and the 3 grouped expert products on the loop their
    capacity (rows an expert) chooses the same way; none on the tile
    loop. Empty for the other formats."""
    from repro_torch.models.moe import expert_capacity
    name = {"int8": "int8_matmul", "nf4": "nf4_matmul"}.get(fmt)
    if name is None:
        return {}
    L = cfg.num_layers
    zero = {"decode": 0, "wgmma": 0, "tile": 0}
    want = {name: dict(zero)}
    if cfg.is_moe:
        want[name + "_grouped"] = dict(zero)
    two_d = QUANT_PROJECTIONS - (3 if cfg.is_moe else 0)
    for T in tokens:
        want[name]["decode" if T <= 8 else "wgmma"] += two_d * L
        if cfg.is_moe:
            C = expert_capacity(T, cfg.num_experts, cfg.experts_per_token,
                                cfg.moe_capacity_factor)
            want[name + "_grouped"]["decode" if C <= 8 else "wgmma"] \
                += 3 * L
    return want


def check_quant_loops(cfg, fmt, loops, tokens, run) -> dict:
    """Fail unless the run's quant launches by loop are
    :func:`expected_quant_loops`; return them."""
    want = expected_quant_loops(cfg, fmt, tokens)
    got = {name: loops[name] for name in want}
    if got != want:
        raise SystemExit(f"{cfg.name} {fmt} {run} run: quant loops {got}, "
                         f"expected {want}")
    return got


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


# llama-3.1-8b's serve phase and the MoE cells: 8 requests, prompts of
# 64-256 tokens, 32 new tokens each, all arriving at t = 0
TRAFFIC = dict(n=8, max_batch=4, max_prefill_batch=2, buf_len=512,
               prompt_len=(64, 256), new_tokens=(32, 32), seed=0,
               record_logits=True)
# the dense ARCH_IDS cells: 4 requests of 8 new tokens
DENSE_TRAFFIC = dict(TRAFFIC, n=4, new_tokens=(8, 8))
# (arch, formats, traffic), at full width and depth
SERVE_CELLS = [
    ("llama-3.1-8b", FORMATS, TRAFFIC),
    ("qwen3-moe-30b-a3b", ("bfloat16", "int8", "nf4"), TRAFFIC),
    ("granite-moe-1b-a400m", ("int8",), TRAFFIC),
    ("stablelm-1.6b", ("bfloat16",), DENSE_TRAFFIC),
    ("minitron-8b", ("bfloat16",), DENSE_TRAFFIC),
    ("h2o-danube-3-4b", ("bfloat16",), DENSE_TRAFFIC),
    ("command-r-35b", ("int8",), DENSE_TRAFFIC),
]


def _run_tokens(res, mode, max_batch) -> list:
    """The tokens each phase of a served run routed: continuous, each
    batched prefill's rows times its padded length and max_batch lanes a
    decode step; sequential, each prompt, then one token a step."""
    if mode == "continuous":
        steps = [p.phase for p in res.engine.phases].count("decode")
        return ([b * s for b, s in res.engine.backend.prefill_shapes]
                + [max_batch] * steps)
    return ([r.prompt_len for r in res.requests]
            + [1] * sum(r.max_new_tokens - 1 for r in res.requests))


def _check_run(torch, mods, cfg, fmt, res, mode, max_batch):
    """The launch checks of one served run (the counts set to 0 before
    it): every token in the vocabulary and every request complete; the
    quant kernels in their formats only (the grouped ones only for MoE),
    each launch on the loop its rows choose; one flash launch per layer
    and prefill, one paged launch per layer and decode step (none for a
    windowed model, whose decode takes the masked path). Returns (launch
    counts, quant loops)."""
    counts = read_launches(mods)
    for r in res.requests:
        if len(r.generated) != r.max_new_tokens:
            raise SystemExit(f"{cfg.name} {fmt}: request {r.req_id} got "
                             f"{len(r.generated)} tokens")
        if not all(0 <= t < cfg.vocab_size for t in r.generated):
            raise SystemExit(f"{cfg.name} {fmt}: token out of the "
                             f"vocabulary")
    for name, fmt_of in (("int8_matmul", "int8"), ("nf4_matmul", "nf4")):
        for entry, want in ((name, fmt == fmt_of),
                            (name + "_grouped", fmt == fmt_of
                             and cfg.is_moe)):
            if (counts[entry] > 0) != want:
                raise SystemExit(f"{cfg.name} {fmt} {mode}: {entry} "
                                 f"launched {counts[entry]} times")
    loops = check_quant_loops(cfg, fmt, read_loops(mods[0]),
                              _run_tokens(res, mode, max_batch), mode)
    if mode == "continuous":
        phases = [p.phase for p in res.engine.phases]
        for name, phase, per in (
                ("flash_attention", "prefill", cfg.num_layers),
                ("paged_attention", "decode",
                 0 if cfg.sliding_window else cfg.num_layers)):
            want = per * phases.count(phase)
            if counts[name] != want:
                raise SystemExit(f"{cfg.name} {fmt}: {name} launched "
                                 f"{counts[name]} times, not {per} per "
                                 f"{phase} ({want})")
    return counts, loops


def _logit_check(torch, cfg, fmt, con, seq) -> float:
    """Each request's batched prefill logits against its own sequential
    prefill: the worst max |diff| over max |logit|, within
    PREFILL_LOGIT_TOL."""
    worst = 0.0
    for rc, rs in zip(con.requests, seq.requests):
        a = con.engine.backend.first_logits[rc.req_id]
        b = seq.engine.backend.first_logits[rs.req_id]
        if not torch.isfinite(a).all():
            raise SystemExit(f"{cfg.name} {fmt}: non-finite prefill logits")
        worst = max(worst, ((a - b).abs().max() / b.abs().max()).item())
    if not worst <= PREFILL_LOGIT_TOL[fmt]:
        raise SystemExit(f"{cfg.name} {fmt}: batched prefill logits differ "
                         f"from the sequential run by {worst} > "
                         f"{PREFILL_LOGIT_TOL[fmt]}")
    return worst


def serve_cell(torch, mods, cfg, fmt, kw) -> dict:
    """One format of one config at full width: weights from seed 0 (each
    layer quantized as it is drawn), a timed continuous run under the
    power sampler with its launch checks, and the prefill-logit check of
    a continuous and a sequential run. For MoE that pair runs under a
    capacity that drops nothing (E / top_k: an expert's buffer holds
    every token routed with it), on the same weights: capacity drops
    depend on how many tokens are routed together, so a batched prefill
    and a request's own prefill may rightly drop different assignments
    under the config's capacity. Prints the serve line; returns the
    timed run's launch counts."""
    import dataclasses
    from repro_torch.launch.serve import build_params, serve
    from repro_torch.models.api import build_model
    t0 = time.perf_counter()
    model = build_model(cfg, fmt=fmt, device="cuda")
    params = build_params(model, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_launches(mods)
    con, watts = sampled_power(lambda: serve(
        model=model, params=params, mode="continuous", **kw))
    counts, loops = _check_run(torch, mods, cfg, fmt, con, "continuous",
                               kw["max_batch"])
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    line = {"phase": "serve", "fmt": fmt, "model": cfg.name,
            "family": cfg.family, "layers": cfg.num_layers,
            "d_model": cfg.d_model}
    pair_model, pair_con = model, con
    if cfg.is_moe:
        line["capacity_factor"] = cfg.moe_capacity_factor
        line["dropped_fraction_per_prefill"] = [
            a["dropped_fraction"] for a in con.engine.backend.prefill_aux]
        nodrop = dataclasses.replace(
            cfg, moe_capacity_factor=cfg.num_experts / cfg.experts_per_token)
        pair_model = build_model(nodrop, fmt=fmt, device="cuda")
        reset_launches(mods)
        pair_con = serve(model=pair_model, params=params, mode="continuous",
                         **kw)
        _, pair_loops = _check_run(torch, mods, nodrop, fmt, pair_con,
                                   "continuous", kw["max_batch"])
        dropped = [a["dropped_fraction"]
                   for a in pair_con.engine.backend.prefill_aux]
        if any(d != 0.0 for d in dropped):
            raise SystemExit(f"{cfg.name} {fmt}: the no-drop capacity "
                             f"dropped {dropped}")
        line["logit_pair_capacity_factor"] = nodrop.moe_capacity_factor
        loops = {"continuous": loops, "no_drop_continuous": pair_loops}
    else:
        loops = {"continuous": loops}
    reset_launches(mods)
    seq = serve(model=pair_model, params=params, mode="sequential", **kw)
    _, loops["sequential"] = _check_run(torch, mods, pair_model.cfg, fmt,
                                        seq, "sequential", kw["max_batch"])
    worst = _logit_check(torch, cfg, fmt, pair_con, seq)
    same = sum(rc.generated == rs.generated
               for rc, rs in zip(pair_con.requests, seq.requests))
    tok_same = sum(x == y for rc, rs in zip(pair_con.requests, seq.requests)
                   for x, y in zip(rc.generated, rs.generated))
    n_tok = sum(len(r.generated) for r in con.requests)
    # host wall times of the executed phases (latency_s is the analytic
    # clock)
    pre = [p.wall_s for p in con.engine.phases if p.phase == "prefill"]
    dec = [p.wall_s for p in con.engine.phases if p.phase == "decode"]
    rep = con.report
    analytic = {"j_per_token": 3600.0 * rep.mean_energy_per_token_wh,
                "total_energy_j": rep.total_energy_j,
                "wall_time_s": rep.wall_time_s,
                "mean_batch": rep.mean_batch}
    if not (all(math.isfinite(v) and v > 0 for v in analytic.values())
            and rep.n_decode_steps == len(dec)):
        raise SystemExit(f"{cfg.name} {fmt}: analytic report {analytic}, "
                         f"{rep.n_decode_steps} decode steps")
    mean_w = sum(watts) / len(watts)
    line.update({
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
        "peak_mem_gb": peak_gb, "launches": counts, "quant_loops": loops,
        "prefill_logit_rel_err": worst,
        "prefill_logit_tol": PREFILL_LOGIT_TOL[fmt],
        "requests_same_tokens_as_sequential": same / len(con.requests),
        "tokens_same_as_sequential": tok_same / n_tok})
    emit(line)
    del model, params, con, seq, pair_model, pair_con
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def serve_phase(torch, mods) -> dict:
    """Every SERVE_CELLS config in each of its formats; the timed runs'
    launch counts by (arch, format)."""
    from repro_torch.launch.serve import arch_config
    return {(arch, fmt): serve_cell(torch, mods, arch_config(arch), fmt, kw)
            for arch, formats, kw in SERVE_CELLS for fmt in formats}


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

    from repro_torch.launch.serve import arch_config
    configs = {arch: arch_config(arch) for arch, _, _ in SERVE_CELLS}
    check_attention_cells(configs)
    two_d, grouped = quant_cells(configs)
    rows = kernel_phase(torch, K, two_d)
    rows.update(grouped_phase(torch, K, grouped))
    rows["flash_attention"] = flash_phase(torch, FK)
    rows["paged_attention"] = paged_phase(torch, PK)
    launches = serve_phase(torch, mods)

    kernels = []
    for name in K.ENTRY_POINTS:
        grouped = name.endswith("_grouped")
        shape = HEADLINE_GROUPED if grouped else HEADLINE
        head = next(r for r in rows[name] if tuple(
            r[k] for k in (("E", "C", "K", "N") if grouped
                           else ("M", "K", "N"))) == shape)
        library = ("torch.bmm" if grouped else "torch.matmul") \
            + " on the weight already dequantized to bf16 (does less work)"
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/quant_matmul/csrc/"
                      f"{name.replace('_grouped', '')}.cu",
            "replaces": REPLACES[name],
            **({"replaces_as": "that kernel under jax.vmap over the "
                               "experts, src/repro/models/moe.py:147 "
                               "_expert_dense"} if grouped else {}),
            "launches": max(c[name] for c in launches.values()),
            "max_abs_err": max(r["max_abs_err"] for r in rows[name]),
            "max_rel_err": max(r["max_rel_err"] for r in rows[name]),
            "shape": list(shape),
            "ms": head["kernel_ms"], "kernel_ms": head["kernel_ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "bytes": head["bytes"],
            "cuda_launches_per_call": head["cuda_launches_per_call"],
            "library_ms": head["library_ms"], "library_is": library,
            **({"loop_of_2d_calls_ms": head["loop_of_2d_calls_ms"]}
               if grouped else {}),
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
