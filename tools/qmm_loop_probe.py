#!/usr/bin/env python3
"""Where the bf16 loops of the dequant-matmul kernels (prefill, and decode
at M <= 8) spend their time, on one NVIDIA GPU.

    python3 tools/qmm_loop_probe.py [--m 512] [--tile 128x128]
    python3 tools/qmm_loop_probe.py --m 1 4 8        # the decode loop

Copies this checkout's ``src`` into ``build/probe/<variant>/src`` once per
variant, with edits of ``qmm_wgmma.cuh`` (the one kernel both loops run),
and times every copy with ``tools/qmm_prefill_times.py`` (int8 and nf4 at
llama-3.1-8b's four projections), one process a copy:

- ``as_is``: the loops unchanged;
- ``no_dequant``: the consumers build no fragment from the raw tile (each
  is a constant pair of bf16 ones): the loop's time without reading and
  dequantizing the weights on chip;
- ``no_mma``: the consumers issue no product (neither wgmma nor the
  decode loop's mma.sync): the time of the TMA ring, the fragments and
  the barriers alone;
- ``no_tma``: the producer issues no copy (each stage is released
  empty at once): the loop's time without device-memory traffic;
- ``skeleton``: no copies, no fragments, no products: the fixed cost of
  a launch (barriers, the walk, the epilogue and the decode loop's
  merge);
- ``single``, ``group4``: a decode warp takes one or four stages at a
  time, not two;
- ``no_merge``: the decode loop's split tiles each stored, not merged
  (wrong output): the merge's cost;
- ``ring16``: rings 16 stages deep where they fit, not 8.

The ``no_*`` copies compute wrong outputs by design, so their lines read
a large error; only their times mean anything. ``as_is`` runs first and
last, to show the spread. Exits non-zero if a copy cannot be edited (its
anchor text is gone) or ``as_is`` fails.
"""
from __future__ import annotations

import argparse
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HEADER = "repro_torch/kernels/quant_matmul/csrc/qmm_wgmma.cuh"
DEQUANT = """          a.st.template fragments<BN>(smem + L::raw_off + s * L::raw_bytes,
                                      lut, nb, lane, cur);"""
DEC_DEQUANT = """              a.st.template fragments<BN>(
                  smem + L::raw_off + s * L::raw_bytes, lut, nb, lane, f[i]);"""
ONES = "for (auto& r : {f}) for (auto& v : r) v = 0x3F803F80u;"
WGMMA = """            wgmma_rs<BM>(acc, cur[kk], desc(xa + kk * 32, 16, 1024));"""
MMA = """                mma_bf16(acc, f[i][kk], xb[i][kk][0], xb[i][kk][1]);"""
LOADS = """          mbar_expect_tx(&full[s], L::x_bytes + a.st.template tx_bytes<BN>());
          tma_load_3d(smem + s * L::x_bytes, &a.x, &full[s], kt * kBK, m0,
                      e);
          a.st.template load<BN>(smem + L::raw_off + s * L::raw_bytes,
                                 &full[s], e * a.K + kt * kBK, n0);"""
# the fragments (and x's) kept alive through a use that costs one operation
KEEP = """acc[{i}] += __uint_as_float(({r}[0] ^ {r}[1] ^ {r}[2] ^ {r}[3] ^
                                      {x}) & 0x3F800000u);"""
# (anchor, replacement) pairs, each anchor found once
VARIANTS = {
    "as_is": [],
    # every fragment a pair of bf16 ones, with no read of the raw tile
    "no_dequant": [(DEQUANT, "          " + ONES.format(f="cur")),
                   (DEC_DEQUANT, "              " + ONES.format(f="f[i]"))],
    "no_mma": [
        (WGMMA, "              " + KEEP.format(i="kk", r="cur[kk]", x="xa")),
        (MMA, "                " + KEEP.format(i="kk", r="f[i][kk]",
                                               x="xb[i][kk][0]")),
    ],
    # a decode warp takes one stage at a time, not two
    "single": [("constexpr int kDecGroup = 2;",
                "constexpr int kDecGroup = 1;")],
    # a decode warp takes four stages at a time
    "group4": [("constexpr int kDecGroup = 2;",
                "constexpr int kDecGroup = 4;")],
    # the decode loop's split tiles stored, not merged: the merge's cost
    "no_merge": [("        if (k0 > 0 || k1 < nk) {", "        if (false) {")],
    # rings 16 stages deep where they fit, not 8
    "ring16": [("constexpr int kMaxStages = 8;",
                "constexpr int kMaxStages = 16;")],
    # the producer copies nothing and releases each stage at once
    "no_tma": [(LOADS, "          mbar_arrive(&full[s]);")],
}
# no copies, no fragments, no products: the ring's barriers, the walk and
# the epilogue (with the decode loop's merge) alone
VARIANTS["skeleton"] = (VARIANTS["no_tma"] + VARIANTS["no_dequant"]
                        + VARIANTS["no_mma"])


def make_copy(name: str) -> Path:
    dst = ROOT / "build" / "probe" / name
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(ROOT / "src", dst / "src",
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = dst / "src" / HEADER
    text = path.read_text()
    for a, b in VARIANTS[name]:
        if text.count(a) != 1:
            raise SystemExit(f"{name}: anchor not found once in {HEADER}")
        text = text.replace(a, b)
    path.write_text(text)
    return dst / "src"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--m", type=int, nargs="+", default=[512])
    ap.add_argument("--tile", default=None)
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS),
                    help="the variants to time, in order")
    args = ap.parse_args()
    names = ["as_is"] + [v for v in args.variants if v != "as_is"]
    srcs = {name: make_copy(name) for name in names}
    rc = 0
    for name in names + ["as_is"]:
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
