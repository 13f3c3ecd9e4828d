#!/usr/bin/env python3
"""Where the bf16 loops of the dequant-matmul kernels (prefill, and decode
at M <= 8) spend their time, on one NVIDIA GPU.

    python3 tools/qmm_loop_probe.py [--m 512] [--tile 128x128]
    python3 tools/qmm_loop_probe.py --m 1 4 8        # the decode loop
    python3 tools/qmm_loop_probe.py --grouped --variants dec_table

Copies this checkout's ``src`` into ``build/probe/<variant>/src`` once per
variant, with edits of ``qmm_wgmma.cuh`` (the one kernel both loops run)
or of a format's source,
and times every copy with ``tools/qmm_prefill_times.py`` (int8 and nf4 at
llama-3.1-8b's four projections), or with ``--grouped`` with
``tools/grouped_times.py`` (the MoE cells' grouped calls, every row and
the dispatch's kept rows), one process a copy:

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
- ``steps_walk``: a grouped decode call takes the 2-D walk (every
  expert's K steps shared out evenly, no segments);
- ``seg4``, ``seg_whole``: grouped decode segments of 4 K steps, or whole
  column tiles (``kernel.py``, ``DEC_SEG_STEPS``);
- ``dec_table``: nf4's decode loop looks each weight up in a per-warp
  table of the 16 values its code can give in its column, built once a
  stage (``NF4_TABLE`` below, patched into ``nf4_matmul.cu``), not a
  product a weight;
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
INT8_SOURCE = "repro_torch/kernels/quant_matmul/csrc/int8_matmul.cu"
NF4_SOURCE = "repro_torch/kernels/quant_matmul/csrc/nf4_matmul.cu"
PLAN = "repro_torch/kernels/quant_matmul/kernel.py"
DEQUANT = """          a.st.template fragments<BN>(smem + L::raw_off + s * L::raw_bytes,
                                      lut, nb, lane, cur);"""
DEC_DEQUANT = """                a.st.template fragments<BN>(
                    smem + L::raw_off + s * L::raw_bytes, lut, nb, lane,
                    f[i]);"""
# nf4's decode tables (dec_table): every weight of a stage in column n is
# one of the 16 values bf16(codebook[i] * absmax[n]) of its absmax row,
# the rounding points of NF4Stage::fragments, so a warp builds them once a
# stage for its 16 columns (lane (g, t): values t, t + 4, t + 8, t + 12 of
# columns nb + 2g and + 1; word 128 h + 8 i + g holds value i of absmax
# row h, the low half for column nb + 2g) and looks each weight up: two
# lookups and a byte permute a pair of weights
NF4_TABLE = """  static constexpr bool kDecTable = true;
  template <int BN>
  __device__ __forceinline__ void table(const uint8_t* raw, const float* lut,
                                        uint32_t* tab, int nb,
                                        int lane) const {
    const int g = lane / 4, t = lane % 4;
    const float* am =
        reinterpret_cast<const float*>(raw + qmm::wg::kBK / 2 * BN) + nb +
        2 * g;
    for (int h = 0; h < rows; ++h) {
      const float2 s = *reinterpret_cast<const float2*>(am + h * BN);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = t + 4 * j;
        tab[128 * h + 8 * i + g] =
            qmm::wg::pack_bf16(lut[i] * s.x, lut[i] * s.y);
      }
    }
  }
  template <int BN>
  __device__ __forceinline__ void dec_fragments(const uint8_t* raw,
                                                const uint32_t* tab, int nb,
                                                int lane,
                                                uint32_t (&f)[4][4]) const {
    const int i = lane % 8;
    uint32_t r[4];
    qmm::wg::ldmatrix_x4_trans(
        r, raw + qmm::wg::raw_at<BN>(8 * (lane / 8) + i / 2 + 4 * (i % 2),
                                     nb));
    const uint32_t* tg = tab + lane / 4;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t* tk = tg + (kk >= 2 ? 128 * (rows - 1) : 0);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t v = r[kk] >> (16 * h);
        f[kk][2 * h] = __byte_perm(tk[8 * (v & 15)], tk[8 * ((v >> 4) & 15)],
                                   0x5410);
        f[kk][2 * h + 1] = __byte_perm(tk[8 * ((v >> 8) & 15)],
                                       tk[8 * ((v >> 12) & 15)], 0x7632);
      }
    }
  }
"""
NF4_EPILOGUE = """  __device__ __forceinline__ float epilogue(float acc, size_t) const {"""
INT8_PREPARE = """  __device__ __forceinline__ void prepare(float*, int) const {}"""
DEC_TABLE_CALL = """                if constexpr (Stage::kDecTable) {
                  __shared__ uint32_t dec_tab[BN / 16][kDecGroup][256];
                  __syncwarp();
                  a.st.template table<BN>(
                      smem + L::raw_off + s * L::raw_bytes, lut,
                      dec_tab[warp][i], nb, lane);
                  __syncwarp();
                  a.st.template dec_fragments<BN>(
                      smem + L::raw_off + s * L::raw_bytes, dec_tab[warp][i],
                      nb, lane, f[i]);
                } else {
""" + DEC_DEQUANT + """
                }"""
ONES = "for (auto& r : {f}) for (auto& v : r) v = 0x3F803F80u;"
WGMMA = """            wgmma_rs<BM>(acc, cur[kk], desc(xa + kk * 32, 16, 1024));"""
MMA = """                  mma_bf16(acc, f[i][kk], xb[i][kk][0], xb[i][kk][1]);"""
LOADS = """          mbar_expect_tx(&full[s], L::x_bytes + a.st.template tx_bytes<BN>());
          tma_load_3d(smem + s * L::x_bytes, &a.x, &full[s], kt * kBK, g.m0,
                      g.e);
          a.st.template load<BN>(smem + L::raw_off + s * L::raw_bytes,
                                 &full[s], g.e * a.K + kt * kBK, g.n0);"""
# the fragments (and x's) kept alive through a use that costs one operation
KEEP = """acc[{i}] += __uint_as_float(({r}[0] ^ {r}[1] ^ {r}[2] ^ {r}[3] ^
                                      {x}) & 0x3F800000u);"""
# (anchor, replacement) pairs, each anchor found once
VARIANTS = {
    "as_is": [],
    # every fragment a pair of bf16 ones, with no read of the raw tile
    "no_dequant": [(DEQUANT, "          " + ONES.format(f="cur")),
                   (DEC_DEQUANT, "                " + ONES.format(f="f[i]"))],
    # a grouped decode call takes the 2-D walk: every expert's K steps
    # shared out, no segments (rows still zero the output past the counts)
    "steps_walk": [("        if grouped:\n            seg =",
                    "        if False:\n            seg =", PLAN)],
    # grouped decode segments of 4 K steps, or whole column tiles
    "seg4": [("DEC_SEG_STEPS = 8\n", "DEC_SEG_STEPS = 4\n", PLAN)],
    "seg_whole": [("DEC_SEG_STEPS = 8\n", "DEC_SEG_STEPS = 1 << 20\n",
                   PLAN)],
    # nf4's decode loop looks each weight up in a per-warp table of the 16
    # values its code can give in its column (NF4_TABLE), not a product a
    # weight
    "dec_table": [(NF4_EPILOGUE, NF4_TABLE + NF4_EPILOGUE, NF4_SOURCE),
                  (INT8_PREPARE, INT8_PREPARE
                   + "\n  static constexpr bool kDecTable = false;",
                   INT8_SOURCE),
                  (DEC_DEQUANT, DEC_TABLE_CALL)],
    "no_mma": [
        (WGMMA, "              " + KEEP.format(i="kk", r="cur[kk]", x="xa")),
        (MMA, "                  " + KEEP.format(i="kk", r="f[i][kk]",
                                                 x="xb[i][kk][0]")),
    ],
    # a decode warp takes one stage at a time, not two
    "single": [("constexpr int kDecGroup = 2;",
                "constexpr int kDecGroup = 1;")],
    # a decode warp takes four stages at a time
    "group4": [("constexpr int kDecGroup = 2;",
                "constexpr int kDecGroup = 4;")],
    # the decode loop's split tiles stored, not merged: the merge's cost
    "no_merge": [("""          if (g.b0 == g.b1) {
#pragma unroll""", """          if (true) {
#pragma unroll"""),
                 ("""        if (g.b0 == g.b1) {
          if (g.k1 == nk) store(tot""", """        if (true) {
          if (true) store(tot""")],
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
    for a, b, *where in VARIANTS[name]:
        rel = where[0] if where else HEADER
        path = dst / "src" / rel
        text = path.read_text()
        if text.count(a) != 1:
            raise SystemExit(f"{name}: anchor not found once in {rel}")
        path.write_text(text.replace(a, b))
    return dst / "src"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--m", type=int, nargs="+", default=[512])
    ap.add_argument("--tile", default=None)
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS),
                    help="the variants to time, in order")
    ap.add_argument("--grouped", action="store_true",
                    help="time the grouped calls (tools/grouped_times.py)")
    args = ap.parse_args()
    names = ["as_is"] + [v for v in args.variants if v != "as_is"]
    srcs = {name: make_copy(name) for name in names}
    rc = 0
    for name in names + ["as_is"]:
        print(f'{{"variant": "{name}"}}', flush=True)
        if args.grouped:
            cmd = [sys.executable, str(ROOT / "tools" / "grouped_times.py"),
                   "--src", str(srcs[name])]
        else:
            cmd = [sys.executable,
                   str(ROOT / "tools" / "qmm_prefill_times.py"),
                   "--src", str(srcs[name]), "--m", *map(str, args.m)]
            if args.tile:
                cmd += ["--tile", args.tile]
        out = subprocess.run(cmd, timeout=600)
        if name == "as_is" and out.returncode:
            rc = out.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
