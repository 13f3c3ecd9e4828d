#!/usr/bin/env python3
"""Time the two dequant-matmul kernels of a tree of the PyTorch/CUDA port
at llama-3.1-8b's projection shapes, prefill or decode, on one NVIDIA GPU.

    python3 tools/qmm_prefill_times.py [--src DIR] [--m 464 512]
        [--tile 128x128] [--dec-bn 64] [--dtype bfloat16]

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
``--dtype float32`` times the f32 compute dtype. Each line also holds
the host's time to enqueue one call of the kernel's wrapper
(``host_us_per_call``, 200 eager calls back to back). The first line holds
the card's name and power limit. Exits non-zero when no CUDA device is
visible or a kernel disagrees with its plain version by more than 1e-2
relative (1e-5 in f32).
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
    for Kd, N in SHAPES_KN:
        w = torch.randn((Kd, N), generator=gen, device="cuda") * Kd ** -0.5
        q8, q4 = quantize_int8(w, 0.01), quantize_nf4(w, 64)
        del w
        weights = {
            "int8_matmul": ((q8.codes, q8.scale), Kd * N + 4 * N,
                            dequantize_int8(q8, cd)),
            "nf4_matmul": ((q4.packed, q4.absmax),
                           Kd * N // 2 + 4 * (Kd // 64) * N,
                           dequantize_nf4(q4, cd)),
        }
        for name, (wargs, wbytes, wdeq) in weights.items():
            kern = getattr(K, name)
            copies = max(1, min(32, math.ceil(2 * L2_BYTES / wbytes)))
            wsets = [wargs] + [tuple(t.clone() for t in wargs)
                               for _ in range(copies - 1)]
            lcopies = max(1, min(32, math.ceil(2 * L2_BYTES
                                               / (es * Kd * N))))
            lsets = [(wdeq,)] + [(wdeq.clone(),) for _ in range(lcopies - 1)]
            for M in args.m:
                x = torch.randn((M, Kd), generator=gen,
                                device="cuda").to(cd)
                counts = getattr(K, "LOOP_LAUNCHES", {}).get(name)
                before = dict(counts) if counts is not None else None
                got = kern(x, *wargs, cd)
                ref = getattr(K, name + "_plain")(x, *wargs, cd)
                torch.cuda.synchronize()
                loop = (next(lp for lp, n in counts.items()
                             if n != before[lp])
                        if counts is not None else None)
                rel = ((got.float() - ref.float()).abs().max()
                       / ref.float().abs().max()).item()
                worst = max(worst, rel)
                nbytes = es * M * Kd + wbytes + es * M * N
                flops = 2 * M * Kd * N
                t_b = nbytes / HBM_BYTES_PER_S * 1e3
                t_o = flops / peak * 1e3
                print(json.dumps({
                    "name": name, "dtype": args.dtype, "M": M, "K": Kd,
                    "N": N, "loop": loop,
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
