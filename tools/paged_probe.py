#!/usr/bin/env python3
"""How the paged decode attention kernel's time depends on its split of a
row over blocks, or on its optional parts, on one NVIDIA GPU.

    python3 tools/paged_probe.py [--splits 1 2 4 8 16]
    python3 tools/paged_probe.py --cases [--src DIR]

``--cases`` times, at llama-3.1-8b's heads in bf16 over full rows of
(B, W) in {(4, 512), (1, 4096), (8, 4096)}, the same call four ways: as
it is ("base"), with a position test that keeps every slot ("pos":
slot_pos 0..W-1, pos W - 1), over the cache as int8 pages and scales
("int8") and both ("int8+pos"), twice each in turns, over as many
seeded copies as the L2 asks (chip_smoke's ``_copies``), one JSON line a
cell. ``--src`` is the ``src`` directory of the tree whose
``repro_torch`` runs (default: this checkout's; ``--cases`` needs a tree
whose kernel takes int8 pages and the position test).

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
import functools
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--splits", type=int, nargs="+", default=[1, 2, 4, 8, 16])
    ap.add_argument("--cases", action="store_true")
    ap.add_argument("--src", default=str(ROOT / "src"))
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("paged_probe: no CUDA device visible", file=sys.stderr)
        return 2
    from repro_torch.kernels.paged_attention import kernel as PK
    from repro_torch.models.layers import ring_cache_pages
    print(json.dumps({"card": chip_smoke.card_line()}), flush=True)
    if args.cases:
        return cases(chip_smoke, torch, PK)
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


def cases(chip_smoke, torch, PK) -> int:
    """The ``--cases`` timings (module docstring)."""
    from repro_torch.kernels import cuda_build
    from repro_torch.models.layers import ring_cache_pages, ring_pages
    from repro_torch.models.transformer import quantize_kv
    cuda_build.build(PK.SOURCES.values())
    gen = torch.Generator(device="cuda").manual_seed(0)
    H, Kv, d = chip_smoke.LLAMA_HEADS
    for B, W in ((4, 512), (1, 4096), (8, 4096)):
        sets = {k: [] for k in ("base", "pos", "int8", "int8+pos")}
        for _ in range(chip_smoke._copies(2 * B * W * Kv * d * 2)):
            k, v = (torch.randn((B, W, Kv, d), generator=gen,
                                device="cuda").to(torch.bfloat16)
                    for _ in range(2))
            q = torch.randn((B, H, d), generator=gen,
                            device="cuda").to(torch.bfloat16)
            pos = torch.full((B,), W - 1, dtype=torch.int32, device="cuda")
            sp = ring_pages(torch.arange(W, dtype=torch.int32, device="cuda")
                            .expand(B, W).contiguous(), 0)
            kp, vp, pt, sl = ring_cache_pages(k, v, pos)
            (kc, ks), (vc, vs) = quantize_kv(k), quantize_kv(v)
            kq, vq, _, _ = ring_cache_pages(kc, vc, pos)
            scales = dict(k_scale=ring_pages(ks, 0), v_scale=ring_pages(vs, 0))
            test = dict(slot_pos=sp, pos=pos)
            for name, pages, kw in (("base", (kp, vp), {}),
                                    ("pos", (kp, vp), test),
                                    ("int8", (kq, vq), scales),
                                    ("int8+pos", (kq, vq),
                                     dict(scales, **test))):
                sets[name].append(functools.partial(
                    PK.paged_attention, q, *pages, pt, sl, **kw))
        ms = {}
        for _ in range(2):
            for name, calls in sets.items():
                ms.setdefault(name, []).append(chip_smoke.timed_ms(
                    torch, lambda f: f(), [(f,) for f in calls], reps=20))
        print(json.dumps({"dtype": "bfloat16", "B": B, "W": W, "H": H,
                          "Kv": Kv, "d": d, "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
