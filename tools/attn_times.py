#!/usr/bin/env python3
"""Time the two attention kernels of a tree of the PyTorch/CUDA port on
one NVIDIA GPU, at the cells of ``chip_smoke.py``.

    python3 tools/attn_times.py [--src DIR] [--only flash|paged]

``--src`` is the ``src`` directory of the tree whose ``repro_torch`` is
timed (default: this checkout's), so that one call can time two commits
in turns, each from its own ``git archive``. For flash attention at
every ``FLASH_CELLS`` cell and paged attention at every ``PAGED_CELLS``
cell, and both at the Model runs' shapes (``attention_cells``), in bf16
and f32, it prints one JSON line through
``chip_smoke.py``'s own attention phases: the kernel's, the plain
version's and ``scaled_dot_product_attention``'s times (the last a
yardstick the port never calls), the bound (the larger of the bytes
over 3.35 TB/s and the operations over the bf16 or f32 peak, H100 SXM
data sheet), and the kernel's worst row against the plain version
beside the one-key control. The first line holds the card's name and
power limit. Exits non-zero when no CUDA device is visible or a kernel
disagrees with its plain version.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--only", choices=("flash", "paged"), default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke   # the cells and phases; puts ROOT/src on the path
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("attn_times: no CUDA device visible", file=sys.stderr)
        return 2
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.paged_attention import kernel as PK
    if not Path(FK.__file__).resolve().is_relative_to(
            Path(args.src).resolve()):
        raise SystemExit(f"attn_times: imported {FK.__file__}, not the "
                         f"tree under {args.src}")
    print(json.dumps({"card": chip_smoke.card_line(), "src": args.src,
                      "torch": torch.__version__}), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import cuda_build
    cuda_build.build([*FK.SOURCES.values(), *PK.SOURCES.values()])
    # count the CUDA launches of a call without holding an older tree to
    # one (its paged call merged the splits in a second kernel)
    chip_smoke.check_one_launch = (
        lambda torch_, name, fn: len(chip_smoke.graph_nodes(torch_, fn)))
    from repro_torch.launch.serve import arch_config
    causal, full, paged = chip_smoke.attention_cells(
        {arch: arch_config(arch) for arch, _ in chip_smoke.MODEL_CELLS})
    if args.only != "paged":
        chip_smoke.flash_phase(torch, FK, causal, full)
    if args.only != "flash":
        chip_smoke.paged_phase(torch, PK, paged)
    return 0


if __name__ == "__main__":
    sys.exit(main())
