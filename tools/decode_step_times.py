#!/usr/bin/env python3
"""Host wall time of one decode step of the PyTorch/CUDA port, for one
tree, on one NVIDIA GPU.

    python3 tools/decode_step_times.py [--src DIR] [--fmt bfloat16 int8]
        [--steps 300] [--arch ID] [--kv-quant] [--by-name]

``--src`` is the ``src`` directory of the tree whose ``repro_torch`` is
timed (default: this checkout's), so that one call can time two commits
in turns, each from its own ``git archive``. For each format it builds
``--arch`` (llama-3.1-8b by default; any id ``repro_torch.launch.serve.
arch_config`` takes) at full width with random weights from seed 0 (with
``--kv-quant``, with an int8 KV cache) and an empty cache of 4 lanes over
a ring of 512 (chip_smoke's serve cells), then
runs ``Model.decode_step`` ``--warmup`` times and ``--steps`` times
more, each step timed on the host from its call to its logits' argmax on
the host (the serving loop's reading). It prints one JSON line a format:
the steps' median, quartiles, min and mean in ms, and the device time
of an eager step: the sum of its kernels' times in a ``torch.profiler``
trace of PROFILED_STEPS steps, a step's floor once the host no longer
holds the device back. Where the tree serves the decode step as a CUDA graph
(``repro_torch.serving.backend.DecodeGraph``), the line adds the same
step through it on a new cache (its first call eager, the second
captured and replayed, then replays): ``graph_*`` host ms over as many
steps, and ``graph_device_ms``, the median span of a replay between two
CUDA events. With ``--by-name`` it adds, for the eager step and for a
replay, a line of the step's device time by kernel name from a
``torch.profiler`` trace of PROFILED_STEPS steps (us and launches a
step, largest first). The first line holds the card's name and power
limit. Exits non-zero when no CUDA device is visible.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PROFILED_STEPS = 5


def quartiles(prefix: str, times) -> dict:
    """The median, quartiles, min and mean of ``times`` (ms)."""
    q1, med, q3 = statistics.quantiles(times, n=4)
    return {f"{prefix}steps": len(times), f"{prefix}median_ms": med,
            f"{prefix}q1_ms": q1, f"{prefix}q3_ms": q3,
            f"{prefix}min_ms": min(times),
            f"{prefix}mean_ms": statistics.mean(times)}


def device_by_name(torch, step, n: int) -> dict:
    """The device time of one ``step`` by kernel name, from the kernels of
    ``n`` steps in a ``torch.profiler`` trace: {"kernels": [[name, us a
    step, launches a step], ...] largest first, "us_per_step",
    "launches_per_step"}; the list is empty if the trace holds no device
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    rows = sorted(([e.key, e.self_device_time_total / n, e.count / n]
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0),
                  key=lambda r: -r[1])
    return {"kernels": rows, "us_per_step": sum(r[1] for r in rows),
            "launches_per_step": sum(r[2] for r in rows)}


def graph_times(torch, graph_cls, model, params, toks, cache, n: int,
                warmup: int) -> dict:
    """``n`` steps through ``graph_cls`` (a ``DecodeGraph``) on ``cache``,
    fed their own greedy tokens: host ms a step to the argmax on the host,
    and the median span of a replay on the device between two CUDA
    events, over the steps after ``warmup``; and the graph."""
    feed = toks.clone()

    def step():
        logits, _ = model.decode_step(params, feed, cache)
        feed.copy_(logits.argmax(-1)[:, None])
        return logits

    g = graph_cls(step)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    host, device = [], []
    for i in range(n):
        t0 = time.perf_counter()
        ev[0].record()
        g()
        ev[1].record()
        feed.cpu()
        if i >= warmup:
            host.append(1e3 * (time.perf_counter() - t0))
            device.append(ev[0].elapsed_time(ev[1]))
    return {**quartiles("graph_", host),
            "graph_device_ms": statistics.median(device),
            "graph_replays": g.replays}, g


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--fmt", nargs="+", default=["bfloat16", "int8"])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--arch", default="llama-3.1-8b")
    ap.add_argument("--kv-quant", action="store_true")
    ap.add_argument("--by-name", action="store_true",
                    help="print the eager step's and a replay's device "
                         "time by kernel name")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("decode_step_times: no CUDA device visible", file=sys.stderr)
        return 2
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.paged_attention import kernel as PK
    from repro_torch.kernels.quant_matmul import kernel as K
    from repro_torch.launch.serve import arch_config, build_params
    from repro_torch.models.api import build_model
    from repro_torch.serving import backend as backend_mod
    if not Path(FK.__file__).resolve().is_relative_to(
            Path(args.src).resolve()):
        raise SystemExit(f"decode_step_times: imported {FK.__file__}, not "
                         f"the tree under {args.src}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "src": args.src}), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mods = [K, FK, PK]
    try:                         # a tree from before the fused kernels
        from repro_torch.kernels.fused import kernel as FU
        mods.append(FU)
    except ImportError:
        pass
    cuda_build.build(src for m in mods for src in m.SOURCES.values())
    batch, ring = 4, 512
    for fmt in args.fmt:
        cfg = arch_config(args.arch)
        model = build_model(cfg, fmt=fmt, kv_quant=args.kv_quant,
                            device="cuda")
        params = build_params(model, seed=0)
        cache = model.init_cache(batch, ring)
        gen = torch.Generator(device="cuda").manual_seed(1)
        toks = torch.randint(0, cfg.vocab_size, (batch, 1), generator=gen,
                             device="cuda", dtype=torch.int32)
        times = []
        with torch.no_grad():
            for i in range(args.warmup + args.steps):
                t0 = time.perf_counter()
                logits, cache = model.decode_step(params, toks, cache)
                nxt = logits.argmax(-1).cpu()
                if i >= args.warmup:
                    times.append(1e3 * (time.perf_counter() - t0))
                toks = nxt.to(device="cuda", dtype=torch.int32)[:, None]
            eager = device_by_name(
                torch, lambda: model.decode_step(params, toks, cache),
                PROFILED_STEPS)
            line = {"arch": args.arch, "fmt": fmt, "kv_quant": args.kv_quant,
                    **quartiles("", times),
                    "eager_device_ms": (eager["us_per_step"] / 1e3
                                        if eager["kernels"] else None)}
            graph = getattr(backend_mod, "DecodeGraph", None)
            if graph is not None:
                fields, replay = graph_times(
                    torch, graph, model, params, toks,
                    model.init_cache(batch, ring), args.warmup + args.steps,
                    args.warmup)
                line.update(fields)
            by_name = []
            if args.by_name:
                by_name.append(("eager", eager))
                if graph is not None:
                    by_name.append(("graph", device_by_name(
                        torch, replay, PROFILED_STEPS)))
        print(json.dumps(line), flush=True)
        for step_kind, table in by_name:
            print(json.dumps({"arch": args.arch, "fmt": fmt,
                              "by_name": step_kind, **table}), flush=True)
        del model, params, cache
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
