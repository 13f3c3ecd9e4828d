"""Quickstart: build a model, generate with a KV cache, and get the
paper's phase-aware energy profile for the same workload.

    PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]

The model runs on ``--device`` (``cuda`` by default).
"""
import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.core import PhaseProfiler, make_policy
from repro_torch.core.hardware import H100_SXM
from repro_torch.launch.serve import build_params
from repro_torch.models import build_model


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device the model runs on (default cuda)")
    args = ap.parse_args(argv)

    # 1. a reduced h2o-danube (dense + sliding window)
    cfg = get_config("h2o-danube-3-4b").reduced()
    model = build_model(cfg, fmt="float32", device=args.device)
    params = build_params(model, seed=0)
    print(f"model: {cfg.name}  params={cfg.param_count()/1e6:.1f}M "
          f"(full config: "
          f"{get_config('h2o-danube-3-4b').param_count()/1e9:.2f}B) "
          f"on {model.device}")

    # 2. prefill + greedy decode
    gen = torch.Generator(device=model.device).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (1, 16), generator=gen,
                           device=model.device)
    logits, cache = model.prefill(params, {"tokens": prompt}, buf_len=64)
    tok = torch.argmax(logits, -1)[:, None]
    out = [int(tok[0, 0])]
    for _ in range(7):
        logits, cache = model.decode_step(params, tok, cache)
        tok = torch.argmax(logits, -1)[:, None]
        out.append(int(tok[0, 0]))
    print("generated token ids:", out)

    # 3. phase-aware energy profile of the FULL config on the paper's
    #    H100 platform (the paper's central methodology)
    full = get_config("h2o-danube-3-4b")
    for fmt in ("float32", "bfloat16", "int8"):
        prof = PhaseProfiler(full, H100_SXM, make_policy(fmt))
        g = prof.profile_generate(batch=1, prompt_len=1200, new_tokens=80)
        print(f"  {fmt:9s} prefill={g.prefill.energy_j:7.2f} J "
              f"({g.prefill.bound:7s})  "
              f"decode/tok={g.energy_per_output_token_j('decode'):5.2f} J "
              f"({g.decode.bound})  "
              f"request={g.energy_per_request_wh()*1e3:6.2f} mWh")
    print("note the paper's asymmetry: quantization helps the compute-"
          "bound prefill, not the memory/idle-bound decode.")


if __name__ == "__main__":
    main()
