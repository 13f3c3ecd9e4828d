#!/usr/bin/env python3
"""Where the bf16 prefill loop of the dequant-matmul kernels spends its
time, on one NVIDIA GPU.

    python3 tools/qmm_loop_probe.py [--m 512] [--tile 128x128]

Copies this checkout's ``src`` into ``build/probe/<variant>/src`` once per
variant, with one edit of ``qmm_wgmma.cuh`` each, and times every copy
with ``tools/qmm_prefill_times.py`` (int8 and nf4 at llama-3.1-8b's four
projections), one process a copy:

- ``as_is``: the loop unchanged;
- ``no_dequant``: the consumers build no fragment from the raw tile (each
  is a constant pair of bf16 ones): the loop's time without reading and
  dequantizing the weights on chip;
- ``no_wgmma``: the consumers issue no product: the time of the TMA ring,
  the fragments and the barriers alone.

The two edited copies compute wrong outputs by design, so their lines
read a large error; only their times mean anything. ``as_is`` runs first
and last, to show the spread. Exits non-zero if a copy cannot be edited
(its anchor text is gone) or ``as_is`` fails.
"""
from __future__ import annotations

import argparse
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HEADER = "repro_torch/kernels/quant_matmul/csrc/qmm_wgmma.cuh"
DEQUANT = """        a.st.template fragments<BN>(smem + L::raw_off + s * L::raw_bytes,
                                    lut, nb, lane, cur);"""
WGMMA = """          wgmma_rs<BM>(acc, cur[kk], desc(xa + kk * 32, 16, 1024));"""
VARIANTS = {
    "as_is": None,
    # every fragment a pair of bf16 ones, with no read of the raw tile
    "no_dequant": (DEQUANT, """        for (auto& r : cur) for (auto& v : r) v = 0x3F803F80u;"""),
    # the fragments kept alive through a use that costs one operation
    "no_wgmma": (WGMMA, """          acc[kk] += __uint_as_float((cur[kk][0] ^ cur[kk][1] ^
                                      cur[kk][2] ^ cur[kk][3] ^ xa) &
                                     0x3F800000u);"""),
}


def make_copy(name: str) -> Path:
    dst = ROOT / "build" / "probe" / name
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(ROOT / "src", dst / "src",
                    ignore=shutil.ignore_patterns("__pycache__"))
    edit = VARIANTS[name]
    if edit is not None:
        path = dst / "src" / HEADER
        text = path.read_text()
        if edit[0] not in text:
            raise SystemExit(f"{name}: anchor not found in {HEADER}")
        path.write_text(text.replace(edit[0], edit[1]))
    return dst / "src"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--m", type=int, nargs="+", default=[512])
    ap.add_argument("--tile", default=None)
    args = ap.parse_args()
    srcs = {name: make_copy(name) for name in VARIANTS}
    rc = 0
    for name in ("as_is", "no_dequant", "no_wgmma", "as_is"):
        print(f'{{"variant": "{name}"}}', flush=True)
        cmd = [sys.executable, str(ROOT / "tools" / "qmm_prefill_times.py"),
               "--src", str(srcs[name]), "--m", *map(str, args.m)]
        if args.tile:
            cmd += ["--tile", args.tile]
        out = subprocess.run(cmd, timeout=600)
        if name == "as_is" and out.returncode:
            rc = out.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
