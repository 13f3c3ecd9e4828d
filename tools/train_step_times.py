#!/usr/bin/env python3
"""Time of one train step of the PyTorch/CUDA port, for one tree, on one
NVIDIA GPU.

    python3 tools/train_step_times.py [--src DIR] [--arch stablelm-1.6b]
        [--fmt bfloat16] [--batch 4] [--seq 1024] [--steps 10]
        [--warmup 2] [--remat] [--by-name]

``--src`` is the ``src`` directory of the tree whose ``repro_torch`` is
timed (default: this checkout's), so that one call can time two commits
in turns, each from its own ``git archive``. It builds ``--arch`` at full
width and depth with weights from seed 0, takes the first batch of
``SyntheticLM`` (``--batch`` x ``--seq`` tokens), and runs
``make_train_step`` (``lm_loss``, its gradient, AdamW) ``--warmup``
times and ``--steps`` times more on the same batch, each step timed on
the host from its call to a synchronize, and on the device between two
CUDA events. It prints one JSON line: the steps' median, quartiles, min
and mean host ms, the median device ms, the peak memory, and the launches
a step of every counted kernel. With ``--by-name`` it adds a line of the
step's device time by kernel name from a ``torch.profiler`` trace of
``PROFILED_STEPS`` steps (``tools/decode_step_times.py``'s
``device_by_name``). The first line holds the card's name and power
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
PROFILED_STEPS = 2


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--fmt", default="bfloat16")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--by-name", action="store_true",
                    help="print the step's device time by kernel name")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("train_step_times: no CUDA device visible", file=sys.stderr)
        return 2
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.paged_attention import kernel as PK
    from repro_torch.kernels.quant_matmul import kernel as K
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.training import AdamWConfig, adamw_init, make_train_step
    from repro_torch.training.data import DataConfig, SyntheticLM
    if not Path(FK.__file__).resolve().is_relative_to(
            Path(args.src).resolve()):
        raise SystemExit(f"train_step_times: imported {FK.__file__}, not "
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
    cfg = get_config(args.arch)
    model = build_model(cfg, fmt=args.fmt, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    opt = adamw_init(params)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=args.seq, batch_size=args.batch))
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in next(data.batches()).items()}
    step_fn = make_train_step(model, AdamWConfig(), remat=args.remat)
    state = {"params": params, "opt": opt}

    def step():
        state["params"], state["opt"], _ = step_fn(state["params"],
                                                   state["opt"], batch)

    for _ in range(args.warmup):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for m in mods:
        m.reset_launches()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    host, device = [], []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        ev[0].record()
        step()
        ev[1].record()
        torch.cuda.synchronize()
        host.append(1e3 * (time.perf_counter() - t0))
        device.append(ev[0].elapsed_time(ev[1]))
    launches = {name: n // args.steps for m in mods
                for name, n in m.LAUNCHES.items() if n}
    q1, med, q3 = statistics.quantiles(host, n=4)
    print(json.dumps({
        "arch": cfg.name, "fmt": args.fmt, "batch": args.batch,
        "seq": args.seq, "remat": args.remat, "steps": args.steps,
        "median_ms": med, "q1_ms": q1, "q3_ms": q3, "min_ms": min(host),
        "mean_ms": statistics.mean(host),
        "device_median_ms": statistics.median(device),
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches_per_step": launches}), flush=True)
    if args.by_name:
        sys.path.insert(0, str(ROOT / "tools"))
        from decode_step_times import device_by_name
        print(json.dumps({"by_name": "train_step",
                          **device_by_name(torch, step, PROFILED_STEPS)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
