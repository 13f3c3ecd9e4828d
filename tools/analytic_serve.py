#!/usr/bin/env python3
"""The analytic report (the paper's H100 SXM energy model) of
chip_smoke's serve cells, on the CPU, without the card.

    PYTHONPATH=src python3 tools/analytic_serve.py \
        [--arch qwen3-moe-30b-a3b] [--fmt bfloat16 int8 nf4]

The analytic clock and energy of a served run depend on the full-width
config, the format and the phases the scheduler forms, and the phases
depend only on the requests (every request runs to its
``max_new_tokens``). So the tool serves chip_smoke's requests through a
``ServeEngine`` on the analytic backend of the full-width config, which
needs no weights. It prints one JSON line per format: J/token, total J,
the analytic clock in s, the mean batch, and the phase counts, the
numbers chip_smoke's ``analytic`` field reads on the card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-moe-30b-a3b")
    ap.add_argument("--fmt", nargs="+", default=["bfloat16", "int8", "nf4"])
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke
    from repro_torch.batching.policy import SlotCountPolicy
    from repro_torch.launch.serve import arch_config, make_requests
    from repro_torch.serving.engine import ServeEngine
    kw = next(kw for arch, _, kw in chip_smoke.SERVE_CELLS
              if arch == args.arch)
    cfg = arch_config(args.arch)
    for fmt in args.fmt:
        eng = ServeEngine(cfg, fmt=fmt, batch_policy=SlotCountPolicy(
            max_batch=kw["max_batch"],
            max_prefill_batch=kw["max_prefill_batch"]))
        rep = eng.run(make_requests(cfg.vocab_size, kw["n"], kw["seed"],
                                    kw["prompt_len"], kw["new_tokens"]))
        print(json.dumps({
            "model": cfg.name, "fmt": fmt,
            "j_per_token": 3600.0 * rep.mean_energy_per_token_wh,
            "total_energy_j": rep.total_energy_j,
            "wall_time_s": rep.wall_time_s, "mean_batch": rep.mean_batch,
            "prefill_phases": rep.n_prefill_batches,
            "decode_steps": rep.n_decode_steps}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
