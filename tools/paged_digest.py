#!/usr/bin/env python3
"""Digest the paged attention kernel's outputs of a tree of the
PyTorch/CUDA port at ``chip_smoke.py``'s paged cells, so that two trees
can be shown to give the same bits for calls without int8 pages and
without the position test.

    python3 tools/paged_digest.py [--src DIR]

``--src`` is the ``src`` directory of the tree whose ``repro_torch`` runs
(default: this checkout's). At every ``chip_smoke.PAGED_CELLS`` cell (batch,
ring length, heads), in bf16 and f32, the K/V cache and q come from
``torch.Generator(device="cuda").manual_seed(5)`` in a fixed order, the
cache is viewed as pages as the decode step views it
(``ring_cache_pages``), the lengths are ragged (row 0 full) and the last
row has an unassigned page where it has more than one; the call is
``paged_attention(q, k_pages, v_pages, page_table, seq_lens)``. It prints
one JSON line per cell with the sha256 of the output's bytes, and a last
line with the sha256 over all of them. Exits non-zero when no CUDA device
is visible.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke   # the cells; puts ROOT/src on the path
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("paged_digest: no CUDA device visible", file=sys.stderr)
        return 2
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels.paged_attention import kernel as PK
    from repro_torch.models.layers import ring_cache_pages
    if not Path(PK.__file__).resolve().is_relative_to(
            Path(args.src).resolve()):
        raise SystemExit(f"paged_digest: imported {PK.__file__}, not the "
                         f"tree under {args.src}")
    print(json.dumps({"card": chip_smoke.card_line(), "src": args.src}),
          flush=True)
    cuda_build.build(PK.SOURCES.values())
    gen = torch.Generator(device="cuda").manual_seed(5)
    total = hashlib.sha256()
    for dtype in chip_smoke.ATTN_DTYPES:
        td = getattr(torch, dtype)
        for B, W, (H, Kv, d) in chip_smoke.PAGED_CELLS:
            k, v = (torch.randn((B, W, Kv, d), generator=gen,
                                device="cuda").to(td) for _ in range(2))
            q = torch.randn((B, H, d), generator=gen, device="cuda").to(td)
            lens = torch.randint(W // 2, W + 1, (B,), generator=gen,
                                 device="cuda")
            lens[0] = W
            kp, vp, table, sl = ring_cache_pages(k, v, (lens - 1).int())
            if table.shape[1] > 1:
                table[B - 1, table.shape[1] // 2] = -1
            out = PK.paged_attention(q, kp, vp, table, sl)
            raw = out.float().cpu().numpy().tobytes()
            digest = hashlib.sha256(raw).hexdigest()
            total.update(digest.encode())
            print(json.dumps({"dtype": dtype, "B": B, "W": W, "H": H,
                              "Kv": Kv, "d": d, "sha256": digest}),
                  flush=True)
            del k, v, kp, vp
            torch.cuda.empty_cache()
    print(json.dumps({"all_sha256": total.hexdigest()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
