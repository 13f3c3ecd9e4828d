#!/usr/bin/env python3
"""Host wall times of the PyTorch/CUDA port's continuous serve, for one
tree, on one NVIDIA GPU.

    python3 tools/serve_times.py [--src DIR] [--arch ID]
        [--fmt float32 bfloat16] [--reps 3] [--kv-quant] [--dense]

``--src`` is the ``src`` directory of the tree whose ``repro_torch`` is
timed (default: this checkout's), so that one call can time two commits
in turns, each from its own ``git archive``. For each format it builds
``--arch`` (llama-3.1-8b by default; any id ``repro_torch.launch.serve.
arch_config`` takes, such as qwen3-moe-30b-a3b) at full width with
random weights from seed 0, serves chip_smoke's continuous workload (8
requests, prompts of 64-256 tokens, 32 new tokens each, ``max_batch=4``,
``max_prefill_batch=2``, ``buf_len=512``; with ``--dense``, its dense
cells' 4 requests of 8 new tokens) ``--reps`` times on the same
weights (with ``--kv-quant``, with an int8 KV cache), and prints one
JSON line a run: the run's host wall time and tokens/s, the host wall
time of its decode steps (mean, median, min) and prefill phases (mean),
and the card's mean power draw over the run (``nvidia-smi`` every 100
ms, chip_smoke's ``sampled_power``) with the J/token it integrates to
(measured, as chip_smoke's serve lines).
A phase's host wall time is ``PhaseResult.wall_s`` where the tree has it
and ``latency_s`` before (the same reading: the phase's execution up to
its argmax on the host). The first line holds the card's name and power
limit. Exits non-zero when no CUDA device is visible.
"""
from __future__ import annotations

import argparse
import gc
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--arch", default="llama-3.1-8b")
    ap.add_argument("--fmt", nargs="+", default=["float32", "bfloat16"])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--kv-quant", action="store_true")
    ap.add_argument("--dense", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    from chip_smoke import DENSE_TRAFFIC, TRAFFIC, sampled_power
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("serve_times: no CUDA device visible", file=sys.stderr)
        return 2
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.paged_attention import kernel as PK
    from repro_torch.kernels.quant_matmul import kernel as K
    from repro_torch.launch.serve import arch_config, build_params, serve
    from repro_torch.models.api import build_model
    if not Path(FK.__file__).resolve().is_relative_to(
            Path(args.src).resolve()):
        raise SystemExit(f"serve_times: imported {FK.__file__}, not the "
                         f"tree under {args.src}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "src": args.src, "arch": args.arch}),
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda_build.build(src for m in (K, FK, PK) for src in m.SOURCES.values())
    kw = dict(DENSE_TRAFFIC if args.dense else TRAFFIC,
              record_logits=False)
    for fmt in args.fmt:
        model = build_model(arch_config(args.arch), fmt=fmt,
                            kv_quant=args.kv_quant, device="cuda")
        params = build_params(model, seed=0)
        for rep in range(args.reps):
            res, watts = sampled_power(lambda: serve(
                model=model, params=params, mode="continuous", **kw))
            # the phase log is the backend's (an engine's before the
            # serving simulator stack was ported)
            phases = (getattr(res.engine.backend, "phases", None)
                      or res.engine.phases)
            wall = {ph: [getattr(p, "wall_s", None) or p.latency_s
                         for p in phases if p.phase == ph]
                    for ph in ("prefill", "decode")}
            n_tok = sum(len(r.generated) for r in res.requests)
            dec = wall["decode"]
            print(json.dumps({
                "arch": args.arch, "fmt": fmt, "kv_quant": args.kv_quant,
                "dense": args.dense, "rep": rep,
                "wall_s": res.wall_s,
                "tokens_per_s": n_tok / res.wall_s,
                "decode_steps": len(dec),
                "decode_ms_mean": 1e3 * statistics.mean(dec),
                "decode_ms_median": 1e3 * statistics.median(dec),
                "decode_ms_min": 1e3 * min(dec),
                "prefill_ms_mean": 1e3 * statistics.mean(wall["prefill"]),
                "measured_mean_w": statistics.mean(watts),
                "measured_j_per_token":
                    statistics.mean(watts) * res.wall_s / n_tok}),
                flush=True)
        del model, params, res
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
