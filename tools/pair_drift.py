#!/usr/bin/env python3
"""Where a batched prefill's logits drift from a request's own prefill, in
the PyTorch/CUDA port on one NVIDIA GPU.

    python3 tools/pair_drift.py [--arch zamba2-1.2b]

Builds ``--arch`` in bfloat16 at full width with random weights from
seed 0 and takes chip_smoke's dense traffic (4 prompts of 64-256
tokens, seed 0).
It prefills the prompts two at a time, right-padded to a multiple of 8
with ``lengths`` and a ring of 512 slots, as the serving backend's
continuous run does, and each prompt on its own, unpadded, as its
sequential run does; and prints the worst max |diff| over max |logit|
of a request's two first-token logits, the reading chip_smoke holds
within ``PREFILL_LOGIT_TOL``:

* ``as_served``: the port as it is;
* ``fixed_rows``: every product of a 16-bit weight (the ``torch.matmul``
  of ``quant.apply.linear_apply``) run on its x padded with zero rows to
  a fixed count (8 for at most 8 rows, else the next multiple of 512),
  so that cuBLAS sees the same shape in the batched and the own prefill;
  the kernels and the rest of the model run as served.

Then, for each 16-bit weight of the first layers (layer 0, and for
hybrid the shared block; the LM head), whether the rows of a product
depend on how many rows it has: the first m rows of ``x @ w`` at the
batched prefill's row count against ``x[:m] @ w`` at a request's own,
bit for bit (max |diff| and the count of rows that differ). The first
line holds the card's name and power limit. Exits non-zero when no CUDA
device is visible.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

PAIR = 2
TRAFFIC = dict(n=4, seed=0, prompt_len=(64, 256), new_tokens=(8, 8))
BUF_LEN = 512
FMT = "bfloat16"


def _fixed_rows(torch, linear_apply):
    """linear_apply with a 16-bit weight's x padded to a fixed row
    count."""
    def apply(w, x, policy):
        if not torch.is_tensor(w):
            return linear_apply(w, x, policy)
        lead, K = x.shape[:-1], x.shape[-1]
        x2 = x.reshape(-1, K)
        M = x2.shape[0]
        fixed = 8 if M <= 8 else -(-M // 512) * 512
        xp = torch.nn.functional.pad(x2, (0, 0, 0, fixed - M))
        y = linear_apply(w, xp, policy)[:M]
        return y.reshape(*lead, y.shape[-1])
    return apply


def _projections(torch, layer, prefix) -> dict:
    """The 2-D projection weights (keys w*) of a layer dict, one level of
    sub-blocks (attn, mlp) included, by dotted name."""
    out = {}
    for k, v in layer.items():
        if isinstance(v, dict):
            out.update(_projections(torch, v, f"{prefix}.{k}"))
        elif torch.is_tensor(v) and v.ndim == 2 and k.startswith("w"):
            out[f"{prefix}.{k}"] = v
    return out


def _drift(torch, model, params, reqs) -> float:
    worst = 0.0
    for i in range(0, len(reqs), PAIR):
        pair = reqs[i:i + PAIR]
        pad = -(-max(r.prompt_len for r in pair) // 8) * 8
        toks = torch.zeros((len(pair), pad), dtype=torch.long,
                           device="cuda")
        for j, r in enumerate(pair):
            toks[j, :r.prompt_len] = torch.as_tensor(r.prompt,
                                                     device="cuda")
        lens = torch.as_tensor([r.prompt_len for r in pair],
                               dtype=torch.int32, device="cuda")
        batched, _ = model.prefill(params, {"tokens": toks},
                                   buf_len=BUF_LEN, lengths=lens)
        for j, r in enumerate(pair):
            own, _ = model.prefill(
                params, {"tokens": toks[j:j + 1, :r.prompt_len]},
                buf_len=r.prompt_len + r.max_new_tokens + 1)
            a, b = batched[j].float(), own[0].float()
            worst = max(worst, ((a - b).abs().max() / b.abs().max()).item())
    return worst


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="zamba2-1.2b")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("pair_drift: no CUDA device visible", file=sys.stderr)
        return 2
    import importlib
    from repro_torch.launch.serve import (arch_config, build_params,
                                          make_requests)
    from repro_torch.models.api import build_model
    from repro_torch.quant.apply import linear_apply
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "arch": args.arch, "fmt": FMT}),
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = arch_config(args.arch)
    model = build_model(cfg, fmt=FMT, device="cuda")
    params = build_params(model, seed=0)
    reqs = make_requests(cfg.vocab_size, TRAFFIC["n"], TRAFFIC["seed"],
                         TRAFFIC["prompt_len"], TRAFFIC["new_tokens"])
    with torch.no_grad():
        print(json.dumps({"run": "as_served",
                          "drift": _drift(torch, model, params, reqs)}),
              flush=True)
        users = [importlib.import_module(f"repro_torch.models.{m}")
                 for m in ("layers", "moe", "ssm", "hybrid", "transformer",
                           "api")]
        for m in users:
            m.linear_apply = _fixed_rows(torch, linear_apply)
        try:
            drift = _drift(torch, model, params, reqs)
        finally:
            for m in users:
                m.linear_apply = linear_apply
        print(json.dumps({"run": "fixed_rows", "drift": drift}), flush=True)

        weights = _projections(torch, params["layers"][0], "layers.0")
        if "shared" in params:
            weights.update(_projections(torch, params["shared"], "shared"))
        weights["lm_head"] = params["lm_head"]
        gen = torch.Generator(device="cuda").manual_seed(7)
        cd = model.policy.compute_dtype
        for name, w in weights.items():
            if w.dtype.itemsize != 2:
                continue
            for i in range(0, len(reqs), PAIR):
                pair = reqs[i:i + PAIR]
                pad = -(-max(r.prompt_len for r in pair) // 8) * 8
                rows = [(PAIR, 1)] if name == "lm_head" else \
                    [(PAIR * pad, r.prompt_len) for r in pair]
                for M, m in rows:
                    x = torch.randn((M, w.shape[0]), generator=gen,
                                    device="cuda").to(cd)
                    big = torch.matmul(x, w.to(cd))[:m].float()
                    small = torch.matmul(x[:m], w.to(cd)).float()
                    diff = (big - small).abs()
                    print(json.dumps({
                        "weight": name, "K": w.shape[0], "N": w.shape[1],
                        "rows_batched": M, "rows_own": m,
                        "max_abs_diff": diff.max().item(),
                        "rows_differ": int((diff.amax(-1) > 0).sum())}),
                        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
