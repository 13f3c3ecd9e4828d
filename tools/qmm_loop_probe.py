#!/usr/bin/env python3
"""Where the bf16 loops of the dequant-matmul kernels (prefill, and decode
at M <= 8) spend their time, on one NVIDIA GPU.

    python3 tools/qmm_loop_probe.py [--m 512] [--tile 128x128]
        [--cells big]
    python3 tools/qmm_loop_probe.py --cells big --walk split --seg 2 \
        --variants split_walk split_walk+no_split_merge
    python3 tools/qmm_loop_probe.py --m 1 4 8        # the decode loop
    python3 tools/qmm_loop_probe.py --grouped --variants dec_table

Copies this checkout's ``src`` into ``build/probe/<variant>/src`` once per
variant, with edits of ``qmm_wgmma.cuh`` (the one kernel both loops run)
or of a format's source (a variant may be several joined by ``+``,
applied in order), and times every copy with ``tools/qmm_prefill_times.py`` (int8 and nf4 at
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
- ``split_walk``: the prefill loop of ``qmm_split_walk.patch`` (beside
  this file): every tile of a shape summed in K segments and the tiles
  past the full waves shared out segment by segment over every SM, each
  shared tile merged by its last block; its plan walks whole tiles unless
  ``--walk split --seg S`` forces the cut (``qmm_prefill_times.py``);
- ``no_split_merge``: on ``split_walk``, its shared tiles' units stored
  to their slots and not merged (wrong output): the merge's cost, the
  counters included;
- ``steps_walk``: a grouped decode call takes the 2-D walk (every
  expert's K steps shared out evenly, no segments);
- ``seg4``, ``seg_whole``: grouped decode segments of 4 K steps, or whole
  column tiles (``kernel.py``, ``DEC_SEG_STEPS``);
- ``dec_table``: nf4's decode loop looks each weight up in a per-warp
  table of the 16 values its code can give in its column, built once a
  stage (``NF4_TABLE`` below, patched into ``nf4_matmul.cu``), not a
  product a weight;
- ``nf4_table``: nf4's prefill loop looks each weight up in a per-warp
  table of the 16 values its code can give in its column,
  bf16(codebook[i] * absmax), built once a stage and laid out with one
  copy per lane of a column pair so that every lookup of a warp falls in
  its own bank (``NF4_PREFILL_TABLE`` below); the same bits as the
  per-weight product, one lookup and half a byte permute a weight in
  place of a lookup, a multiply and half a conversion; its 32 KB of
  tables come out of the ring;
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
# nf4's prefill tables (nf4_table): word (i * 8 + g) * 4 + t of absmax
# row h holds bf16(codebook[i] * absmax) of columns nb + 2g (low half)
# and nb + 2g + 1, one copy for each lane t of the pair (so that lane
# (g, t) reads bank 4 g + t whatever the code); built once a stage by the
# warp, each lane writing values t, t + 4, t + 8, t + 12 to the four
# copies in turn (conflict-free), then two lookups and a byte permute a
# pair of weights
NF4_PREFILL_TABLE = """  static constexpr bool kTable = true;
  template <int BN>
  __host__ __device__ static constexpr int table_bytes() {
    return BN / 16 * 1024 * 4;
  }
  template <int BN>
  __device__ __forceinline__ void table_fragments(const uint8_t* raw,
                                                  const float* lut,
                                                  uint32_t* tab, int nb,
                                                  int lane,
                                                  uint32_t (&f)[4][4]) const {
    const int g = lane / 4, t = lane % 4, i8 = lane % 8;
    const float* am =
        reinterpret_cast<const float*>(raw + qmm::wg::kBK / 2 * BN) + nb +
        2 * g;
    __syncwarp();
    for (int h = 0; h < rows; ++h) {
      const float2 sc = *reinterpret_cast<const float2*>(am + h * BN);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = t + 4 * j;
        const uint32_t w = qmm::wg::pack_bf16(lut[i] * sc.x, lut[i] * sc.y);
#pragma unroll
        for (int r = 0; r < 4; ++r)
          tab[h * 512 + (i * 8 + g) * 4 + ((t + r) & 3)] = w;
      }
    }
    __syncwarp();
    uint32_t r4[4];
    qmm::wg::ldmatrix_x4_trans(
        r4, raw + qmm::wg::raw_at<BN>(8 * (lane / 8) + i8 / 2 + 4 * (i8 % 2),
                                      nb));
    const uint32_t* tl = tab + g * 4 + t;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t* th = tl + (kk >= 2 ? (rows - 1) * 512 : 0);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const uint32_t v = r4[kk] >> (16 * hh);
        f[kk][2 * hh] = __byte_perm(th[(v & 15) * 32],
                                    th[((v >> 4) & 15) * 32], 0x5410);
        f[kk][2 * hh + 1] = __byte_perm(th[((v >> 8) & 15) * 32],
                                        th[((v >> 12) & 15) * 32], 0x7632);
      }
    }
  }
"""
PREFILL_TABLE_CALL = """          if constexpr (Stage::kTable) {
            __shared__ uint32_t nf4_tab[BN / 16][1024];
            a.st.template table_fragments<BN>(
                smem + L::raw_off + s * L::raw_bytes, lut, nf4_tab[warp], nb,
                lane, cur);
          } else {
""" + """          a.st.template fragments<BN>(smem + L::raw_off + s * L::raw_bytes,
                                      lut, nb, lane, cur);""" + """
          }"""
LAYOUT_FIT = """  static constexpr int fit = (kSmemMax - kSmemStatic) / (x_bytes + raw_bytes);"""
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
SPLIT_KEY = """            const int key = g.slot % a.split;   // the tile's counter"""
SPLIT_PATCH = Path(__file__).resolve().with_name("qmm_split_walk.patch")


def patch_edits(path: Path) -> list:
    """The hunks of a unified diff of files under ``src`` as edits
    (old text, new text, path under ``src``): each hunk's context and
    removed lines, and its context and added lines."""
    edits, rel, old, new = [], None, [], []

    def flush():
        if old or new:
            edits.append(("".join(old), "".join(new), rel))
        old.clear()
        new.clear()
    for line in path.read_text().splitlines(keepends=True):
        if line.startswith("+++ "):
            flush()
            rel = line[4:].strip().split("/src/", 1)[1]
        elif line.startswith("@@"):
            flush()
        elif rel is None or line.startswith("--- "):
            continue
        elif line.startswith("\\"):
            continue
        else:
            tag, body = line[:1], line[1:]
            if tag in " -":
                old.append(body)
            if tag in " +":
                new.append(body)
    flush()
    return edits


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
    # the split walk's shared tiles stored, not merged (on split_walk)
    "no_split_merge": [(SPLIT_KEY, "            return;\n" + SPLIT_KEY)],
    # the prefill loop's split walk (SPLIT_PATCH)
    "split_walk": patch_edits(SPLIT_PATCH),
    # nf4's prefill loop looks each weight up in a per-warp table
    # (NF4_PREFILL_TABLE), its 32 KB taken from the ring
    "nf4_table": [(NF4_EPILOGUE, NF4_PREFILL_TABLE + NF4_EPILOGUE,
                   NF4_SOURCE),
                  (INT8_PREPARE, INT8_PREPARE
                   + "\n  static constexpr bool kTable = false;"
                   + "\n  template <int BN>\n  __host__ __device__ static "
                   "constexpr int table_bytes() { return 0; }",
                   INT8_SOURCE),
                  (DEQUANT, PREFILL_TABLE_CALL),
                  (LAYOUT_FIT, "  static constexpr int fit = (kSmemMax - "
                   "kSmemStatic - Stage::template table_bytes<BN>()) / "
                   "(x_bytes + raw_bytes);")],
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
# the variants timed by default: those that apply to this checkout
DEFAULT = [v for v in VARIANTS if v not in ("split_walk", "no_split_merge")]


def make_copy(name: str, into: Path = ROOT / "build" / "probe") -> Path:
    """A copy of this checkout's ``src`` at ``into/<name>/src`` with the
    edits of variant ``name`` (its parts joined by ``+``, in order);
    exits if an anchor is not found exactly once."""
    dst = into / name
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(ROOT / "src", dst / "src",
                    ignore=shutil.ignore_patterns("__pycache__"))
    edits = [e for part in name.split("+") for e in VARIANTS[part]]
    for a, b, *where in edits:
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
    ap.add_argument("--variants", nargs="+", default=DEFAULT,
                    help="the variants to time, in order")
    ap.add_argument("--grouped", action="store_true",
                    help="time the grouped calls (tools/grouped_times.py)")
    ap.add_argument("--cells", default=None,
                    help="passed to tools/qmm_prefill_times.py")
    ap.add_argument("--walk", default=None,
                    help="passed to tools/qmm_prefill_times.py")
    ap.add_argument("--seg", default=None,
                    help="passed to tools/qmm_prefill_times.py")
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
            for flag in ("tile", "cells", "walk", "seg"):
                if getattr(args, flag):
                    cmd += [f"--{flag}", getattr(args, flag)]
        out = subprocess.run(cmd, timeout=600)
        if name == "as_is" and out.returncode:
            rc = out.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
