#!/usr/bin/env python3
"""Time the two dequant-matmul kernels of a tree of the PyTorch/CUDA port
at llama-3.1-8b's projection shapes, prefill or decode, on one NVIDIA GPU.

    python3 tools/qmm_prefill_times.py [--src DIR] [--m 464 512]
        [--tile 128x128] [--dec-bn 64] [--dtype bfloat16]
        [--cells llama|smoke|big] [--names int8_matmul nf4_matmul]

``--src`` is the ``src`` directory of the tree whose ``repro_torch`` is
timed (default: this checkout's), so that one call can time two commits
in turns, each from its own ``git archive``. For int8 and nf4 (block 64)
at the four (K, N) of the projections and each M (``--m 1 4 8`` for the
decode loop), it prints one JSON line: the kernel's and
``torch.matmul``'s times (the latter on the weight already dequantized
to the compute dtype, a yardstick the port never calls), the bound (the
larger of the bytes over 3.35 TB/s and 2 M K N over 989 TFLOP/s in bf16
or 67 in f32, H100 SXM data sheet), the largest relative error against
the plain version, and the loop that ran where the tree counts loops.
``--tile BMxBN`` makes the wgmma loop's plan take that output tile at
every shape (in a tree that plans its tiles); ``--dec-bn`` sets the
decode loop's column tile (in a tree whose decode loop has one);
``--dtype float32`` times the f32 compute dtype. ``--cells smoke`` times
every prefill call (M > 8) of ``chip_smoke.py``'s kernel phase instead
(``quant_cells``: 156 (name, K, N, M), row 1o's w_down at M = 2064 and
seamless-m4t's (8192, 1024) at M = 64-496 among them), ``--cells big``
the llama projections at ``--m`` plus those two shapes; ``--names``
keeps some entry points. In a tree with the split walk (the
``split_walk`` copy of ``tools/qmm_loop_probe.py``), ``--walk whole``
keeps the prefill plan to whole tiles, ``--seg S`` cuts every shape into
S K segments (with ``--walk whole``, whole tiles summed segment by
segment: the folds' sweep; with ``--walk split``, tiles shared out
wherever the tile leaves some past its full waves: the split's sweep);
other trees ignore both. Each line names the plan (``plan``: tile,
grid, the K segments of every tile, ``seg``, and the tiles shared out,
``split``) and the K steps of its busiest block (``steps``), where the
tree plans them. Each line also holds the host's time to enqueue one
call of the kernel's wrapper (``host_us_per_call``, 200 eager calls back
to back). ``--outliers`` gives int8 its LLM.int8 outlier rows (1% of K,
the policy's) and times the call with their product: in a tree whose
``int8_matmul`` takes them, inside the kernel; in an older tree, the
kernel and the separate product its ops ran after it (a gather, an f32
``torch.matmul``, a rounding and an add), as one line (``outliers``:
"kernel" or "separate"). The first line holds the card's name and power
limit. Exits
non-zero when no CUDA device is visible or a kernel disagrees with its
plain version by more than 1e-2 relative (1e-5 in f32).
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

SHAPES_KN = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096)]
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12
L2_BYTES = 50 * 2**20
REL_TOL = {"bfloat16": 1e-2, "float32": 1e-5}


def timed_ms(torch, fn, arg_sets, reps: int = 10) -> float:
    """Device time per call of ``fn``: ``reps`` calls cycling through
    ``arg_sets`` captured in a CUDA graph, replayed 3 times between CUDA
    events."""
    fn(*arg_sets[0])
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(reps):
            fn(*arg_sets[i % len(arg_sets)])
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        g.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (3 * reps)


def host_us(torch, fn, calls: int = 200) -> float:
    """Host time per call of ``fn``, in us: ``calls`` eager calls
    enqueued back to back (fewer than the launch queue holds, so the
    host never waits for the device), then one synchronize outside the
    reading."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def cells(args, K) -> list:
    """[(K, N, {entry point: [M, ...]})] of the shapes to time, in order:
    llama-3.1-8b's four projections at ``--m`` (``--cells llama``), with
    row 1o's and seamless-m4t's w_down (``big``), or every prefill call of
    chip_smoke's kernel phase (``smoke``). Imports chip_smoke after the
    tree's ``repro_torch``, so that its configs come from that tree."""
    names = args.names
    if args.cells != "smoke":
        shapes = [(Kd, N, args.m) for Kd, N in SHAPES_KN]
        if args.cells == "big":
            shapes += [(14336, 4096, [1264, 2064]),
                       (8192, 1024, [64, 216, 496])]
        return [(Kd, N, {n: ms for n in names}) for Kd, N, ms in shapes]
    sys.path.insert(1, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    from repro_torch.launch.serve import arch_config
    configs = {a: arch_config(a) for a, *_ in
               chip_smoke.SERVE_CELLS + chip_smoke.MODEL_CELLS}
    by_kn = {}
    for (name, Kd, N), ms in sorted(chip_smoke.quant_cells(configs)[0]
                                    .items()):
        pre = sorted(m for m in ms if m > 8)
        if name in names and pre:
            by_kn.setdefault((Kd, N), {})[name] = pre
    return [(Kd, N, by) for (Kd, N), by in sorted(by_kn.items())]


def force_walk(K, walk: str, seg) -> None:
    """Hold the tree's prefill plan to a walk (in a tree with the split
    walk, ``K.prefill_segments``; others are left as they are): ``seg``
    segments for every shape (None: the shape's own; ``walk`` "whole"
    alone: one), and with ``walk`` "whole" or "split" only the segmented
    plans that keep every tile whole or share tiles out (the fastest by
    the tree's model)."""
    if not hasattr(K, "prefill_segments"):
        return
    if seg is None and walk == "whole":
        K.prefill_segments = lambda *a: 1
        return
    if seg is not None:
        K.prefill_segments = lambda *a: seg
    if walk == "plan":
        return

    def plan(M, N, Kd, n_sm, block, s):
        cands = []
        for bm, bn in K.WG_TILES:
            tiles = K.wgmma_tiles(M, N, bm, bn)[1]
            if walk == "whole":
                cands.append(K.Plan("wgmma", bm, bn, min(tiles, n_sm),
                                    seg=s))
                continue
            for waves in (tiles // n_sm, tiles // n_sm - 1):
                shared = tiles - waves * n_sm
                if waves >= 0 and shared > 0:
                    grid = n_sm if waves else min(n_sm, shared * s)
                    cands.append(K.Plan("wgmma", bm, bn, grid, seg=s,
                                        split=shared))
        return min(cands, key=lambda p: K.plan_us(p, M, N, Kd, block))
    K.segmented_plan = plan


def plan_fields(K, M: int, N: int, Kd: int, name: str, dtype: str) -> dict:
    """The plan of the call (tile, grid, ``split``: the tiles whose K
    steps the grid shares out, 0 for whole tiles) and the K steps of its
    busiest block, where the tree's plan has them; {} otherwise."""
    plan = K._device_plan(M, N, Kd, dtype == "bfloat16",
                          None if name.startswith("int8") else 64, True, 0)
    if plan.loop != "wgmma":
        return {}
    split = getattr(plan, "split", 0)
    if hasattr(K, "prefill_pieces"):
        steps = [0] * plan.grid
        for b, _, k0, k1 in K.prefill_pieces(plan, M, N, Kd):
            steps[b] += k1 - k0
        busiest = max(steps)
    else:
        tiles = K.wgmma_tiles(M, N, plan.bm, plan.bn)[1]
        busiest = -(-tiles // plan.grid) * (Kd // K.WG_BK)
    return {"plan": {"bm": plan.bm, "bn": plan.bn, "grid": plan.grid,
                     "split": split, "seg": plan.seg},
            "steps": busiest}


def outlier_calls(torch, K, cd) -> tuple:
    """(call, plain version, "kernel" or "separate") of int8 with outlier
    rows, each f(x, codes, scale, idx, ow, cd): the kernel's own outlier
    product where the tree's wrapper takes it, else the kernel and the
    separate product; the plain version the separate product after the
    plain kernel (the rounding points of both)."""
    import inspect

    def separate(fn):
        def call(x, codes, scale, idx, ow, cd_):
            out = fn(x, codes, scale, cd_)
            x_out = torch.index_select(x, -1, idx.long())
            return out + torch.matmul(x_out.float(),
                                      ow.to(cd_).float()).to(cd_)
        return call
    plain = separate(K.int8_matmul_plain)
    if "outlier_idx" in inspect.signature(K.int8_matmul).parameters:
        return (lambda x, c, s, i, w, cd_: K.int8_matmul(x, c, s, cd_, i, w),
                plain, "kernel")
    return separate(K.int8_matmul), plain, "separate"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--m", type=int, nargs="+", default=[464, 512])
    ap.add_argument("--tile", default=None,
                    help="force the wgmma loop's output tile, e.g. 128x128")
    ap.add_argument("--dec-bn", type=int, default=None,
                    help="the decode loop's column tile (64 or 128)")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"))
    ap.add_argument("--cells", default="llama",
                    choices=("llama", "smoke", "big"))
    ap.add_argument("--names", nargs="+",
                    default=["int8_matmul", "nf4_matmul"])
    ap.add_argument("--walk", default="plan",
                    choices=("plan", "whole", "split"),
                    help="whole: whole tiles only; split: share tiles out "
                         "wherever the shape has tiles to share")
    ap.add_argument("--seg", type=int, default=None,
                    help="cut every shape into this many K segments")
    ap.add_argument("--outliers", action="store_true",
                    help="int8 with its outlier rows and their product")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("qmm_prefill_times: no CUDA device visible", file=sys.stderr)
        return 2
    from repro_torch.kernels.quant_matmul import kernel as K
    if args.tile:
        K.WG_TILES = (tuple(int(v) for v in args.tile.split("x")),)
    if args.dec_bn:
        K.DEC_BN = args.dec_bn
    force_walk(K, args.walk, args.seg)
    from repro_torch.quant.int8 import dequantize_int8, quantize_int8
    from repro_torch.quant.nf4 import dequantize_nf4, quantize_nf4
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "src": args.src, "tile": args.tile,
                      "dec_bn": args.dec_bn, "dtype": args.dtype,
                      "torch": torch.__version__}), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    K.build()
    cd = getattr(torch, args.dtype)
    es = torch.finfo(cd).bits // 8
    peak = BF16_FLOP_PER_S if args.dtype == "bfloat16" else F32_FLOP_PER_S
    gen = torch.Generator(device="cuda").manual_seed(1)
    worst = 0.0
    for Kd, N, by_name in cells(args, K):
        w = torch.randn((Kd, N), generator=gen, device="cuda") * Kd ** -0.5
        q8, q4 = quantize_int8(w, 0.01), quantize_nf4(w, 64)
        del w
        n_out = q8.outlier_idx.shape[0] if args.outliers else 0
        weights = {
            "int8_matmul": (tuple(q8)[:4 if n_out else 2],
                            Kd * N + 4 * N + n_out * (4 + 2 * N),
                            dequantize_int8(q8, cd)),
            "nf4_matmul": ((q4.packed, q4.absmax),
                           Kd * N // 2 + 4 * (Kd // 64) * N,
                           dequantize_nf4(q4, cd)),
        }
        for name, (wargs, wbytes, wdeq) in weights.items():
            if name not in by_name:
                continue
            kern = getattr(K, name)
            plain = getattr(K, name + "_plain")
            how = None
            if name == "int8_matmul" and n_out:
                kern, plain, how = outlier_calls(torch, K, cd)
            copies = max(1, min(32, math.ceil(2 * L2_BYTES / wbytes)))
            wsets = [wargs] + [tuple(t.clone() for t in wargs)
                               for _ in range(copies - 1)]
            lcopies = max(1, min(32, math.ceil(2 * L2_BYTES
                                               / (es * Kd * N))))
            lsets = [(wdeq,)] + [(wdeq.clone(),) for _ in range(lcopies - 1)]
            for M in by_name[name]:
                x = torch.randn((M, Kd), generator=gen,
                                device="cuda").to(cd)
                counts = getattr(K, "LOOP_LAUNCHES", {}).get(name)
                before = dict(counts) if counts is not None else None
                got = kern(x, *wargs, cd)
                ref = plain(x, *wargs, cd)
                torch.cuda.synchronize()
                loop = (next(lp for lp, n in counts.items()
                             if n != before[lp])
                        if counts is not None else None)
                rel = ((got.float() - ref.float()).abs().max()
                       / ref.float().abs().max()).item()
                worst = max(worst, rel)
                nbytes = es * M * Kd + wbytes + es * M * N
                flops = 2 * M * (Kd + (n_out if name == "int8_matmul"
                                       else 0)) * N
                t_b = nbytes / HBM_BYTES_PER_S * 1e3
                t_o = flops / peak * 1e3
                print(json.dumps({
                    "name": name, "dtype": args.dtype, "M": M, "K": Kd,
                    "N": N, "loop": loop,
                    **({"outliers": how, "n_out": n_out} if how else {}),
                    **plan_fields(K, M, N, Kd, name, args.dtype),
                    "max_rel_err": rel,
                    "kernel_ms": timed_ms(
                        torch, lambda *a: kern(x, *a, cd), wsets),
                    "library_ms": timed_ms(
                        torch, lambda w_: torch.matmul(x, w_), lsets),
                    "host_us_per_call": host_us(
                        torch, lambda: kern(x, *wargs, cd)),
                    "bytes": nbytes, "flops": flops,
                    "bound_ms": max(t_b, t_o),
                    "bound_by": "bytes" if t_b >= t_o else "operations"}),
                    flush=True)
            del wsets, lsets
        del weights, q8, q4
        torch.cuda.empty_cache()
    if not worst <= REL_TOL[args.dtype]:
        print(f"qmm_prefill_times: a kernel disagrees with its plain "
              f"version by {worst} > {REL_TOL[args.dtype]}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
