#!/usr/bin/env python3
"""Time the two attention kernels of a tree of the PyTorch/CUDA port on
one NVIDIA GPU, at the cells of ``chip_smoke.py``.

    python3 tools/attn_times.py [--src DIR] [--only flash|paged|bwd] [--split]

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
beside the one-key control (paged: each cell also over int8 pages and
with the position test, so a tree whose kernel takes neither fails
there: time it with its own ``chip_smoke.py``). ``--only bwd`` times the flash backward
kernel instead, at ``BWD_CELLS`` through ``chip_smoke.bwd_phase``
(kernel, forward + backward, plain, SDPA forward + backward and SDPA's
backward alone, and the kernel against its plain version); with
``--split`` also each of its CUDA kernels' device time a call (delta,
dK/dV, dQ) at the same cells, from ``torch.profiler`` over 10 calls.
The first line holds the card's name and power limit. Exits non-zero when no CUDA device is visible or a kernel
disagrees with its plain version.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def bwd_split(torch, FK, chip_smoke) -> None:
    """One JSON line a cell of ``BWD_CELLS`` and dtype: the device ms a
    call of each CUDA kernel the backward launches, from
    ``torch.profiler`` over 10 calls after 3 warm-up calls."""
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator(device="cuda").manual_seed(3)
    for dtype in chip_smoke.ATTN_DTYPES:
        td = getattr(torch, dtype)
        for B, S, T, (H, Kv, d), causal, window in chip_smoke.BWD_CELLS:
            q, do = (torch.randn((B, S, H, d), generator=gen,
                                 device="cuda").to(td) for _ in range(2))
            k, v = (torch.randn((B, T, Kv, d), generator=gen,
                                device="cuda").to(td) for _ in range(2))
            kw = dict(causal=causal, window=window)
            out, lse = FK.flash_attention_forward(q, k, v, with_lse=True,
                                                  **kw)
            for _ in range(3):
                FK.flash_attention_backward(q, k, v, out, lse, do, **kw)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    FK.flash_attention_backward(q, k, v, out, lse, do, **kw)
                torch.cuda.synchronize()
            split = {e.key.replace("(anonymous namespace)::", "")
                     .split("(")[0].replace("void ", ""):
                     e.device_time_total / 10 / 1e3
                     for e in prof.key_averages() if e.device_time_total}
            print(json.dumps({"split": FK.BWD, "dtype": dtype, "B": B,
                              "S": S, "T": T, "H": H, "Kv": Kv, "d": d,
                              "causal": causal, "window": window,
                              "kernel_ms": split,
                              "sum_ms": sum(split.values())}), flush=True)
            del q, k, v, do, out, lse


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--only", choices=("flash", "paged", "bwd"),
                    default=None)
    ap.add_argument("--split", action="store_true",
                    help="with --only bwd: device ms of each CUDA kernel")
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
    if args.only == "bwd":
        chip_smoke.bwd_phase(torch, FK)
        if args.split:
            bwd_split(torch, FK, chip_smoke)
        return 0
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
