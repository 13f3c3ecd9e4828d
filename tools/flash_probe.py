#!/usr/bin/env python3
"""Where the bf16 flash attention kernel (TMA + wgmma) spends its time,
on one NVIDIA GPU.

    python3 tools/flash_probe.py

Copies this checkout's ``src`` into ``build/probe/<variant>/src`` once per
variant, with one edit of ``flash_wgmma.cuh`` each, and times every copy
in its own process at llama-3.1-8b's heads: the serve phase's prefill
(B=2, S=256, causal), a long causal prompt (1, 2048) and a non-causal
row of 8192 keys for 256 queries (64 blocks of 128 key tiles, which
reads a key tile's steady cost):

- ``as_is``: the kernel unchanged;
- ``no_softmax``: the softmax of every tile after the first skipped (p is
  the raw score): the products, loads and barriers alone;
- ``no_wgmma``: no product issued after the first tile: the softmax,
  loads and barriers alone;
- ``ping_pong``: FlashAttention-3's warpgroup ping-pong (named barriers
  give the two consumer warpgroups turns to issue their products);
- ``warp_arrive``: one arrival per consumer warp, not per thread, on a
  stage's empty barrier.

``no_softmax`` and ``no_wgmma`` compute wrong outputs by design; only
their times mean anything. ``as_is`` runs first and
last, to show the spread. Prints one JSON line per variant and cell with
the device time per call (CUDA-graph replays between CUDA events).
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HEADER = "repro_torch/kernels/flash_attention/csrc/flash_wgmma.cuh"
SOFTMAX = "      softmax_at(k_begin + i * kBK, corr);"
PRODUCTS = "      issue_qk(s);\n      issue_pv(prev);"
# FlashAttention-3's ping-pong: named barrier 1 + w is warpgroup w's turn
# to issue products; each has n + 1 turns, warpgroup 1 opens warpgroup
# 0's first and leaves out its own last hand-over
TURNS = """    auto my_turn = [&]() {
      asm volatile("bar.sync %0, 256;\\n" ::"r"(1 + wgi) : "memory");
    };
    auto your_turn = [&]() {
      asm volatile("bar.arrive %0, 256;\\n" ::"r"(2 - wgi) : "memory");
    };
    float corr[2];
    if (wgi == 1) your_turn();
    mbar_wait(&full[0], 0);
    my_turn();
    wgmma_fence();
    issue_qk(0);
    your_turn();"""
VARIANTS = {
    "as_is": [],
    "no_softmax": [(SOFTMAX, "      corr[0] = corr[1] = 1.f;")],
    "no_wgmma": [(PRODUCTS, "      wgmma_commit();\n      wgmma_commit();")],
    "ping_pong": [
        ("    float corr[2];\n    mbar_wait(&full[0], 0);\n    wgmma_fence();\n"
         "    issue_qk(0);", TURNS),
        (PRODUCTS, "      my_turn();\n" + PRODUCTS + "\n      your_turn();"),
        ("    wgmma_fence();\n    issue_pv((n - 1) % kStages);",
         "    my_turn();\n    wgmma_fence();\n    issue_pv((n - 1) % kStages);\n"
         "    if (wgi == 0) your_turn();"),
    ],
    "warp_arrive": [
        ("mbar_init(&empty[s], 256);", "mbar_init(&empty[s], 8);"),
        ("      mbar_arrive(&empty[prev]);",
         "      __syncwarp();\n      if (lane == 0) mbar_arrive(&empty[prev]);"),
        ("    mbar_arrive(&empty[(n - 1) % kStages]);",
         "    __syncwarp();\n"
         "    if (lane == 0) mbar_arrive(&empty[(n - 1) % kStages]);"),
    ],
}
# (B, S, T, causal)
CELLS = [(2, 256, 256, True), (1, 2048, 2048, True), (1, 256, 8192, False)]
H, KV, D = 32, 8, 128


def make_copy(name: str) -> Path:
    dst = ROOT / "build" / "probe" / name
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(ROOT / "src", dst / "src",
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = dst / "src" / HEADER
    text = path.read_text()
    for old, new in VARIANTS[name]:
        if old not in text:
            raise SystemExit(f"{name}: anchor not found in {HEADER}")
        text = text.replace(old, new)
    path.write_text(text)
    return dst / "src"


def worker(src: str, name: str) -> int:
    sys.path.insert(0, src)
    import torch
    from repro_torch.kernels.flash_attention import kernel as FK
    gen = torch.Generator(device="cuda").manual_seed(0)
    for B, S, T, causal in CELLS:
        q = torch.randn((B, S, H, D), generator=gen, device="cuda").bfloat16()
        k, v = (torch.randn((B, T, KV, D), generator=gen, device="cuda")
                .bfloat16() for _ in range(2))
        FK.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(10):
                FK.flash_attention(q, k, v, causal=causal)
        g.replay()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            g.replay()
        end.record()
        end.synchronize()
        print(json.dumps({"variant": name, "B": B, "S": S, "T": T,
                          "causal": causal,
                          "ms": start.elapsed_time(end) / 30}), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--worker", nargs=2, metavar=("SRC", "NAME"))
    args = ap.parse_args()
    if args.worker:
        return worker(*args.worker)
    srcs = {name: make_copy(name) for name in VARIANTS}
    rc = 0
    for name in ("as_is", "no_softmax", "no_wgmma", "ping_pong",
                 "warp_arrive", "as_is"):
        out = subprocess.run([sys.executable, __file__, "--worker",
                              str(srcs[name]), name], timeout=600)
        if name == "as_is" and out.returncode:
            rc = out.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
