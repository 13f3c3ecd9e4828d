"""End-to-end serving demo (the paper's kind of system): serve a small
model with real batched requests through the continuous-batching engine
— genuine PyTorch prefill/decode steps, token-level scheduling,
paged-KV admission, and phase-aware energy accounting per request —
driven entirely by a declarative spec with ``execute=True``.

    PYTHONPATH=src python examples/torch/serve_batched.py [--device cpu]

The model runs on ``--device`` (``cuda`` by default), named to the spec
at run time (``torch_device=``).
"""
import argparse
import time

import repro_torch

BASE = repro_torch.ExperimentSpec(
    model="stablelm-1.6b", reduced=True, execute=True, buf_len=64,
    fmt="float32", mode="continuous", max_batch=8, max_prefill_batch=4,
    n_requests=24, prompt_range=(8, 24), output_range=(4, 12),
    arrival="uniform", arrival_params={"low_s": 0.0, "high_s": 0.02})


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device the model runs on (default cuda)")
    args = ap.parse_args(argv)
    cfg = BASE.model_config()
    print(f"serving {cfg.name} ({cfg.param_count()/1e6:.1f}M params) "
          f"with REAL execution through the continuous batcher on "
          f"{args.device}")

    t0 = time.perf_counter()
    rep = BASE.run(torch_device=args.device)
    wall = time.perf_counter() - t0
    eng_rep = rep.report          # the underlying ServeReport
    print(f"completed {rep.n_requests} requests in {wall:.1f}s wall "
          f"({eng_rep.n_prefill_batches} prefill batches, "
          f"{eng_rep.n_decode_steps} decode steps, "
          f"mean live batch {rep.mean_batch:.2f})")
    for r in eng_rep.requests[:3]:
        print(f"  req {r.req_id}: prompt={r.prompt_len} -> "
              f"{r.generated}")
    print("modeled serving metrics (H100 constants): "
          f"{rep.mean_energy_wh*1e3:.3f} mWh/request, "
          f"ttft={rep.mean_ttft_s*1e3:.1f} ms(model-time)")

    # same workload, sequential mode — the paper's Fig 3a contrast
    rep2 = BASE.derive(mode="sequential").run(torch_device=args.device)
    print(f"sequential baseline: "
          f"{rep2.mean_energy_wh*1e3:.3f} mWh/request -> "
          f"continuous batching is "
          f"{rep2.mean_energy_wh/rep.mean_energy_wh:.1f}x "
          f"more energy-efficient on this workload")


if __name__ == "__main__":
    main()
