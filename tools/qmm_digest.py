#!/usr/bin/env python3
"""Digest the two dequant-matmul kernels' outputs of a tree of the
PyTorch/CUDA port at ``chip_smoke.py``'s kernel-phase shapes, so that two
trees can be shown to give the same bits.

    python3 tools/qmm_digest.py [--src DIR]

``--src`` is the ``src`` directory of the tree whose ``repro_torch`` runs
(default: this checkout's). The weights and activations come from
``torch.Generator(device="cuda").manual_seed(1)`` in a fixed order, int8
with outlier threshold 0.01 and nf4 with block 64, at every (K, N) of
``chip_smoke.SHAPES_KN`` and M of ``SHAPES_M``, in bf16, then the grouped
calls at every ``chip_smoke.GROUPED_SHAPES`` cell, with every row and with
the kept rows of a seeded top-8 dispatch (``chip_smoke.dispatch_rows``).
It prints one JSON line per kernel and shape with the sha256 of the
output's bytes, a line with the sha256 over each kind of call (``decode``:
the 2-D calls at M <= 8, ``prefill``: at M > 8, ``grouped``), and a last
line with the sha256 over all of them. Exits non-zero when no CUDA
device is visible.
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
    import chip_smoke   # the shapes; puts ROOT/src on the path
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("qmm_digest: no CUDA device visible", file=sys.stderr)
        return 2
    from repro_torch.kernels.quant_matmul import kernel as K
    from repro_torch.quant.int8 import quantize_int8
    from repro_torch.quant.nf4 import quantize_nf4
    print(json.dumps({"card": chip_smoke.card_line(), "src": args.src}),
          flush=True)
    K.build()
    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(1)
    total = hashlib.sha256()
    kinds = {k: hashlib.sha256() for k in ("decode", "prefill", "grouped")}

    def digest(out, kind: str) -> str:
        raw = out.view(torch.int16).cpu().numpy().tobytes()
        d = hashlib.sha256(raw).hexdigest()
        total.update(d.encode())
        kinds[kind].update(d.encode())
        return d

    for Kd, N in chip_smoke.SHAPES_KN:
        w = torch.randn((Kd, N), generator=gen, device="cuda") * Kd ** -0.5
        q8, q4 = quantize_int8(w, 0.01), quantize_nf4(w, 64)
        del w
        for M in chip_smoke.SHAPES_M:
            x = torch.randn((M, Kd), generator=gen, device="cuda").to(bf16)
            for name, wargs in (("int8_matmul", (q8.codes, q8.scale)),
                                ("nf4_matmul", (q4.packed, q4.absmax))):
                out = getattr(K, name)(x, *wargs, bf16)
                kind = "decode" if M <= 8 else "prefill"
                print(json.dumps({"name": name, "M": M, "K": Kd, "N": N,
                                  "sha256": digest(out, kind)}), flush=True)
        del q8, q4
        torch.cuda.empty_cache()
    for arch, E, C, T, Kd, N in chip_smoke.GROUPED_SHAPES:
        w = torch.randn((E, Kd, N), generator=gen, device="cuda") \
            * Kd ** -0.5
        x = torch.randn((E, C, Kd), generator=gen, device="cuda").to(bf16)
        rows = chip_smoke.dispatch_rows(torch, E, C, T, seed=E + C)
        for name in ("int8_matmul_grouped", "nf4_matmul_grouped"):
            wargs = chip_smoke._quantized(torch, name, w, bf16)[0]
            for case, r in (("every_row", None), ("dispatch", rows)):
                out = getattr(K, name)(x, *wargs, bf16, rows=r)
                print(json.dumps({"name": name, "arch": arch, "E": E,
                                  "C": C, "K": Kd, "N": N, "case": case,
                                  "sha256": digest(out, "grouped")}),
                      flush=True)
        del w, x
        torch.cuda.empty_cache()
    print(json.dumps({f"{k}_sha256": h.hexdigest()
                      for k, h in kinds.items()}), flush=True)
    print(json.dumps({"all_sha256": total.hexdigest()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
