#!/usr/bin/env python3
"""How the paged decode attention kernel's time depends on its split of a
row over blocks, on one NVIDIA GPU.

    python3 tools/paged_probe.py [--splits 1 2 4 8 16]

Over a ring cache viewed as pages (as the decode step and
``chip_smoke.py`` view it, every row full), for every ``PAGED_CELLS``
cell of ``chip_smoke.py`` (batch, ring length and heads) in bf16 and
f32, it times the
kernel with the split its plan (``kernel.py::split_slots``) takes and
with each forced number of splits, and prints one JSON line per cell and
split: the device time per call (CUDA-graph replays between CUDA
events) and the worst row's error against the plain version.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--splits", type=int, nargs="+", default=[1, 2, 4, 8, 16])
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    import torch
    if not torch.cuda.is_available():
        print("paged_probe: no CUDA device visible", file=sys.stderr)
        return 2
    from repro_torch.kernels.paged_attention import kernel as PK
    from repro_torch.models.layers import ring_cache_pages
    print(json.dumps({"card": chip_smoke.card_line()}), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(3)
    plan = PK._launch_plan
    for dtype in chip_smoke.ATTN_DTYPES:
        td = getattr(torch, dtype)
        min_split = (PK.MIN_SPLIT if dtype == "bfloat16"
                     else PK.MIN_SPLIT_F32)
        for B, W, (H, Kv, d) in chip_smoke.PAGED_CELLS:
            k, v = (torch.randn((B, W, Kv, d), generator=gen,
                                device="cuda").to(td) for _ in range(2))
            q = torch.randn((B, H, d), generator=gen, device="cuda").to(td)
            pos = torch.full((B,), W - 1, dtype=torch.int32,
                             device="cuda")
            kp, vp, pt, sl = ring_cache_pages(k, v, pos)
            ref = PK.paged_attention_plain(q, kp, vp, pt, sl)
            slots = pt.shape[1] * kp.shape[1]
            for n in [None, *args.splits]:
                if n is None:
                    PK._launch_plan = plan
                    split = plan(B, Kv, slots, 0, min_split)[0]
                else:
                    split = -(-(-(-slots // n)) // PK.CHUNK) * PK.CHUNK
                    PK._launch_plan = (lambda *_, s=split:
                                       (s, -(-slots // s)))
                got = PK.paged_attention(q, kp, vp, pt, sl)
                ms = chip_smoke.timed_ms(
                    torch, PK.paged_attention, [(q, kp, vp, pt, sl)])
                print(json.dumps({
                    "dtype": dtype, "B": B, "W": W, "H": H, "Kv": Kv,
                    "d": d, "forced": n,
                    "split": split, "n_split": -(-slots // split),
                    "ms": ms,
                    "max_rel_err": chip_smoke.row_rel_err(got, ref)}),
                    flush=True)
            PK._launch_plan = plan
    return 0


if __name__ == "__main__":
    sys.exit(main())
