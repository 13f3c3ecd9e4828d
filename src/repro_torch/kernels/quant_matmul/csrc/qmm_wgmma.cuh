// The bf16 Hopper (sm_90a) loops of the two dequant-matmul kernels,
// prefill (M > 8) and decode (M <= 8): out (M, N) = x (M, K) @ dequant(W)
// (K, N), bf16 in and out, f32 sums. One kernel, qmm_wgmma_kernel, with
// BM = 8 rows of x for decode. The same launch runs the grouped form, E
// such problems at once (the experts of an MoE layer: x (E, M, K) @
// dequant(W[e]) (K, N) -> out (E, M, N)), with the expert as the outer
// index of every walk below; E = 1 is the 2-D call.
//
// Bound: at llama-3.1-8b's prefill shapes (M = 81-512) the 2*M*K*N
// operations on the tensor cores; at decode (M = 1-8) the weight bytes
// (w_gate: 58.7 MB of int8 codes, 17.6 us at 3.35 TB/s). What the design
// does about it (the mixed-input design of CUTLASS, written out by hand):
//
// - The operands are swapped: each warpgroup computes out^T for 64
//   output columns, D (64 n x BM m) += W^T (64 n x 16 k) @ x^T (16 k x BM
//   m), with wgmma.mma_async m64nBMk16 (prefill) or, per warp, mma.sync
//   m16n8k16 (decode, 16 n x 8 m), which takes the same register A
//   fragments (wgmma m64n8k16 read 3-11% slower there, PERF.md). The
//   dequantized weight is the A operand, built in registers straight from
//   the raw codes in shared memory; x is the B operand, read by wgmma
//   from shared memory (by ldmatrix for mma.sync). So the
//   weight never makes a bf16 round trip through shared memory, the
//   consumer warpgroups never wait for each other, and at decode the
//   products cost the same whatever M (x's rows past M are zeros that
//   TMA fills in, not reads).
// - A persistent grid: the host plans the output tile (prefill: BM = 64,
//   128 or 256 rows of x; BN = 64 or 128 output columns, one consumer
//   warpgroup per 64) and a grid of at most one block per SM from the
//   shapes alone (quant_matmul/kernel.py, matmul_plan). Prefill: each
//   block walks whole output tiles t = blockIdx.x, blockIdx.x + gridDim.x,
//   ..., row tile fastest, so blocks that run together read the same
//   weight columns; every tile walks the whole K axis in one block.
//   Decode: one block per SM, and the column tiles' K steps laid end to
//   end and cut into equal ranges, one a block, so that every SM streams
//   the same bytes even where there are fewer column tiles than SMs
//   (wk/wv: 8 tiles of 128 columns). A tile cut between blocks is split:
//   each writes its f32 partial sums to a workspace, and the last to
//   finish (an atomic counter per split tile, which it resets) adds them
//   in a fixed order and writes the output, in the same launch. Every sum
//   is taken in one fixed order that does not depend on M: the output is
//   the same bits run to run, and a row of x gets the same sums alone or
//   in a batch.
// - Grouped (the experts of an MoE layer), the launch takes each expert's
//   kept-row count from the dispatch, on the device (a.rows; the rows past
//   it are zeros and never reach a token). Every block reads the E counts
//   and scans them in shared memory (plan_work), so the walks cover only
//   the kept rows' work: prefill, the row tiles that hold a kept row of
//   the experts that have one; decode, the column tiles of those experts,
//   each tile's K steps cut into a fixed number of segments (by the shapes
//   alone), the segments of all of them shared out evenly over the
//   blocks. A tile's segments are added in segment order, so an expert's
//   sums do not depend on the other experts' rows. Idle producer threads
//   write the zero rows. Only the kept experts' weights are read, in one
//   launch with no host sync.
// - Warp specialisation: one producer thread (in the last warpgroup,
//   which gives its registers to the consumers) keeps a ring of as many
//   stages as fit in shared memory (5-8) full with TMA copies. A stage
//   holds the x tile (BM rows x 64 K, bf16, 128-byte swizzle; x is a
//   rank-3 tensor map (K, M, E) with boxes of one expert, so TMA fills
//   rows past M of each expert with zeros and never reads the next
//   expert's rows) and the format's raw weight tile for the same
//   64 K rows (int8: 64 x BN codes; nf4: 32 x BN packed bytes, then the
//   absmax rows those K rows use; the experts' weights as one 2-D map of
//   E K rows, whose boxes never cross an expert since K is a multiple of
//   64), swizzled so that the reads below meet
//   no bank conflicts. Each stage has a full and an empty mbarrier. At
//   decode with BN = 128 a stage is 128-byte lines of codes, and the ring
//   keeps up to 45 (nf4) or 72 (int8) KB in flight per SM.
// - A consumer thread gathers its fragment of W^T for a whole stage (32
//   weights of two adjacent columns: A row g of a warp's 16 rows is
//   column 2g of its 16, row g + 8 column 2g + 1) and dequantizes it in
//   registers, then issues four wgmma, one per 16 K. The A fragments are
//   double-buffered: a stage's products run while the next stage's
//   fragments are built, and a consumer waits for the group before last
//   (wgmma.wait_group 1) before it releases that group's stage. At decode
//   a warp takes two stages at a time instead (their shared-memory reads
//   in flight together, the products in stage order), since a stage's
//   handshake and read latency, not its arithmetic, set a warp's pace
//   there. What stays on the CUDA cores is the dequantization alone.
// - The epilogue (the format's per-column scale, one rounding to bf16)
//   runs from the registers (or the merged partial sums) straight to
//   device memory, two adjacent columns per store.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <unordered_map>

#include "../../csrc/hopper.cuh"

namespace qmm {
namespace wg {

constexpr int kBK = 64;        // K rows per stage: one 128-byte row of x

// mbarriers, TMA, wgmma descriptors and fences, tensor-map encoding:
// the shared Hopper helpers
using namespace ::hopper;

// -- the raw weight tile ------------------------------------------------------
// Byte c of row r of a stage's raw tile with BN-byte rows, as TMA lays it
// out: its 16-byte chunks swizzled by the 128-byte pattern (BN = 128:
// chunk ^ r % 8) or the 64-byte one (BN = 64: chunk ^ (r / 2) % 4). The
// tile starts on 1024 bytes.
template <int BN>
__device__ __forceinline__ int raw_at(int r, int c) {
  static_assert(BN == 64 || BN == 128, "64 or 128 columns");
  const int x = BN == 128 ? (r & 7) : ((r >> 1) & 3);
  return r * BN + ((((c >> 4) ^ x) << 4) | (c & 15));
}

// -- wgmma -----------------------------------------------------------------
// d (64 x N, f32) += A (64 x 16, bf16, registers) @ B (16 x N, bf16,
// K-major in shared memory, 128-byte swizzle)
__device__ __forceinline__ void wgmma_rs_m64n64(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_m64n128(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_m64n256(float (&d)[128],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (N == 64) wgmma_rs_m64n64(d, a, db);
  else if constexpr (N == 128) wgmma_rs_m64n128(d, a, db);
  else wgmma_rs_m64n256(d, a, db);
}

// -- the loop --------------------------------------------------------------
// BM rows of x (8 for decode; 64, 128 or 256 for prefill) by BN output
// columns (64 or 128, one consumer warpgroup per 64). Shared memory, in
// bytes from a 1024-aligned base: the x tiles of the stages, then their
// raw weight tiles (each rounded up to 1024 bytes), as many stages as fit
// (at most 8; a deeper decode ring, 16, read slower at int8's w_gate).
constexpr int kSmemMax = 232448;   // a block's shared memory, H100
constexpr int kSmemStatic = 4096;  // kept for the static shared memory
constexpr int kDecM = 8;           // rows of x of the decode loop (M <= 8)
constexpr int kMaxStages = 8;
// stages a decode warp takes at a time, all their shared-memory reads in
// flight together
constexpr int kDecGroup = 2;
// experts a grouped call of these loops may have (one a thread of the
// work plan below)
constexpr int kMaxE = 256;
// the producer warpgroup's threads past its first warp, which write the
// zero rows of a grouped call while the first issues the copies
constexpr int kFillThreads = 96;

template <class Stage, int BM, int BN>
struct Layout {
  static constexpr int x_bytes = BM * kBK * 2;
  static constexpr int raw_bytes =
      (Stage::template raw_bytes<BN>() + 1023) / 1024 * 1024;
  static constexpr int fit = (kSmemMax - kSmemStatic) / (x_bytes + raw_bytes);
  static constexpr int stages = fit < kMaxStages ? fit : kMaxStages;
  static constexpr int raw_off = stages * x_bytes;
  static constexpr int total = raw_off + stages * raw_bytes + 1024;
  static_assert(stages >= 5, "a ring of at least five stages");
};

template <class Stage>
struct Args {
  // (E, M, K) bf16 as a rank-3 map (K, M, E), box (64, BM rows, 1
  // expert), 128-byte swizzle
  CUtensorMap x;
  Stage st;        // the format's tensor maps and epilogue data
  __nv_bfloat16* out;   // (E, M, N)
  // decode only: the f32 partial sums of split tiles and one counter per
  // split tile, at 0 between launches (kernel.py, decode_scratch)
  float* part;
  int* counter;
  // each expert's kept rows (E,) int32, or null: all M. The rows at or
  // past an expert's count (every row of an expert with none) are
  // written as zeros, and only the kept rows' tiles are computed.
  const int* rows;
  int E, M, N, K;
  // decode: the K segments of each column tile of the grouped walk
  // (walk_segments), or 0 for the 2-D call's even split (walk_steps)
  int seg;
};

// What the blocks share out: each expert's kept rows (clamped to 0..M)
// and the prefix over the experts of their work items, the output tiles
// of the rows they keep (prefill: row tiles holding a kept row times the
// column tiles) or, in the grouped decode walk, K segments (`seg` of
// each column tile of an expert with a kept row); pre[kMaxE] is all of
// them. Every block computes it from a.rows in the same launch.
struct Work {
  int rows[kMaxE];
  int pre[kMaxE + 1];
  int wsum[kMaxE / 32];
};

// Fill w: threads 0..kMaxE-1 one expert each, a scan within each warp,
// then the warps' sums. Every thread of the block calls it (it holds the
// block's first two barriers).
template <int BM, int BN, class A>
__device__ __forceinline__ void plan_work(const A& a, Work& w, int tid) {
  const int n_col = (a.N + BN - 1) / BN;
  int items = 0, incl = 0;
  if (tid < kMaxE) {
    if (tid < a.E) {
      const int r = a.rows ? min(max(a.rows[tid], 0), a.M) : a.M;
      items = BM == kDecM ? (r > 0 ? n_col * max(a.seg, 1) : 0)
                          : (r + BM - 1) / BM * n_col;
      w.rows[tid] = r;
    }
    incl = items;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, d);
      if ((tid & 31) >= d) incl += y;
    }
    if ((tid & 31) == 31) w.wsum[tid >> 5] = incl;
  }
  __syncthreads();
  if (tid < kMaxE) {
    int off = 0;
    for (int i = 0; i < (tid >> 5); ++i) off += w.wsum[i];
    w.pre[tid] = off + incl - items;
    if (tid == kMaxE - 1) w.pre[kMaxE] = off + incl;
  }
  __syncthreads();
}

// The expert whose work items hold item u < w.pre[kMaxE]: the last e with
// pre[e] <= u, which has items (an expert without shares its pre with the
// next).
__device__ __forceinline__ int expert_of(const Work& w, int E, int u) {
  int lo = 0, hi = E - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (w.pre[mid] <= u)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

// One run of a block's walk: K steps [k0, k1) of the output tile of
// expert e whose first element is (m0, n0), all this block holds of it.
// Decode only: b0 .. b1, the blocks that share the tile (b0 == b1: this
// block's alone); s0 .. s1 - 1, the run's K segments in the grouped walk
// (s0 = -1: the 2-D walk, whose run is summed as one); slot, the
// workspace slot of a 2-D run's partial sums (a grouped run's segment s
// takes slot first + s); key, the tile's counter; first .. first + n -
// 1, the slots the merge adds, in order.
struct Seg {
  int e, m0, n0, k0, k1;
  int b0, b1, s0, s1, slot, key, first, n;
};

// The block of a decode grid of G blocks over U items whose range holds
// item x: block b walks items [b U / G, (b + 1) U / G).
__device__ __forceinline__ int split_block(long long x, long long U, int G) {
  return (int)(((x + 1) * G - 1) / U);
}

// Prefill (BM > kDecM): the output tiles of the kept rows (Work), whole,
// t = blockIdx.x, blockIdx.x + gridDim.x, ..., numbered expert by expert
// and within an expert row tile fastest, so that blocks that run
// together read the same weight columns. A 2-D call (E = 1, no rows)
// walks every tile, as a grouped call with rows = null walks every
// expert's.
template <int BM, int BN, class A, class F>
__device__ __forceinline__ void walk_tiles(const A& a, const Work& w, int nk,
                                           F&& f) {
  for (int t = blockIdx.x; t < w.pre[kMaxE]; t += gridDim.x) {
    Seg g;
    g.e = expert_of(w, a.E, t);
    const int l = t - w.pre[g.e];
    const int mt = (w.rows[g.e] + BM - 1) / BM;
    g.m0 = (l % mt) * BM;
    g.n0 = (l / mt) * BN;
    g.k0 = 0;
    g.k1 = nk;
    g.s0 = -1;
    f(g);
  }
}

// The 2-D decode walk (seg = 0): the column tiles' K steps laid end to
// end, tile by tile (expert by expert), and cut into gridDim.x ranges
// whose lengths differ by at most one step. A tile whose steps fall to
// several blocks is split: block b's partial sums go to slot b + t, the
// tile's counter is t, and the merge adds slots b0 + t .. b1 + t, in
// block (that is K) order.
template <int BN, class A, class F>
__device__ __forceinline__ void walk_steps(const A& a, int nk, F&& f) {
  const int n_col = (a.N + BN - 1) / BN;
  const long long U = (long long)a.E * n_col * nk;
  int u = (int)(U * blockIdx.x / gridDim.x);
  const int hi = (int)(U * (blockIdx.x + 1) / gridDim.x);
  while (u < hi) {
    const int t = u / nk;
    Seg g;
    g.e = t / n_col;
    g.m0 = 0;
    g.n0 = (t - g.e * n_col) * BN;
    g.k0 = u - t * nk;
    g.k1 = min(nk, hi - t * nk);
    g.b0 = split_block((long long)t * nk, U, gridDim.x);
    g.b1 = split_block((long long)(t + 1) * nk - 1, U, gridDim.x);
    g.s0 = -1;
    g.slot = blockIdx.x + t;
    g.key = t;
    g.first = g.b0 + t;
    g.n = g.b1 - g.b0 + 1;
    f(g);
    u = t * nk + g.k1;
  }
}

// The grouped decode walk (seg > 0). Each column tile's K steps are cut
// into a.seg segments, by the shapes alone (segment s holds steps
// [s nk / seg, (s + 1) nk / seg)); the segments of the column tiles of
// the experts with a kept row (Work) are laid end to end, expert by
// expert, and cut into G = min(gridDim.x, U) ranges of the U whose
// lengths differ by at most one segment (so every block from a tile's
// first to its last holds part of it; the blocks past G have none). So
// only those experts' weights are read, and the blocks share them out
// evenly however few they are. A block gets one run a tile it touches.
// Each segment's sums start from zero, and a tile's segments are added
// in segment order, in registers where the tile is one block's alone,
// else by the merge: a split tile's first block b0 owns slots b0 seg ..
// b0 seg + seg - 1 (one a segment) and counter b0, since a block is the
// first of at most one split tile, the last it touches. An expert's sums,
// and their order, therefore do not depend on the other experts' rows.
template <int BN, class A, class F>
__device__ __forceinline__ void walk_segments(const A& a, const Work& w,
                                              int nk, F&& f) {
  const int S = a.seg, n_col = (a.N + BN - 1) / BN;
  const int U = w.pre[kMaxE];
  const int G = min((int)gridDim.x, U);
  const int b = blockIdx.x;
  if (b >= G) return;
  const int lo = (int)((long long)U * b / G);
  const int hi = (int)((long long)U * (b + 1) / G);
  // the first piece's expert, column tile and segment; then each tile's
  // successor: the next column tile, or the next expert with kept rows
  int e = expert_of(w, a.E, lo);
  const int l = lo - w.pre[e];
  int ct = l / S, s = l - ct * S;
  for (int u = lo; u < hi;) {
    const int ut = u - s;   // the tile's first segment
    const int s1 = min(S, hi - ut);
    Seg g;
    g.e = e;
    g.m0 = 0;
    g.n0 = ct * BN;
    // b0 == b1 unless the tile starts before this block's range or ends
    // past it, the only tiles whose blocks need a division
    g.b0 = ut >= lo ? b : split_block(ut, U, G);
    g.b1 = ut + S <= hi ? b : split_block((long long)ut + S - 1, U, G);
    g.key = g.b0;
    g.first = g.b0 * S;
    g.n = S;
    g.s0 = s;
    g.s1 = s1;
    g.k0 = s * nk / S;
    g.k1 = s1 * nk / S;
    f(g);
    u = ut + s1;
    s = 0;
    if (++ct == n_col) {
      ct = 0;
      do ++e;
      while (e < a.E && w.pre[e + 1] == w.pre[e]);
    }
  }
}

// The runs block blockIdx.x walks, in order, each passed to f.
template <int BM, int BN, class A, class F>
__device__ __forceinline__ void walk(const A& a, const Work& w, int nk,
                                     F&& f) {
  if constexpr (BM == kDecM) {
    if (a.seg > 0)
      walk_segments<BN>(a, w, nk, f);
    else
      walk_steps<BN>(a, nk, f);
  } else {
    walk_tiles<BM, BN>(a, w, nk, f);
  }
}

// Zeros in every output row at or past its expert's kept count, 16 bytes
// a store, shared out over the fill threads of all blocks (N is a
// multiple of 16, so each expert's zero rows are whole 16-byte chunks).
template <class A>
__device__ __forceinline__ void zero_fill(const A& a, const Work& w, int i) {
  const int stride = gridDim.x * kFillThreads;
  const int j0 = blockIdx.x * kFillThreads + i;
  for (int e = 0; e < a.E; ++e) {
    const int r = w.rows[e];
    uint4* z = reinterpret_cast<uint4*>(a.out + ((size_t)e * a.M + r) * a.N);
    const int n = (a.M - r) * a.N / 8;
    for (int j = j0; j < n; j += stride) z[j] = make_uint4(0u, 0u, 0u, 0u);
  }
}

// atomicAdd at GPU scope with acquire-release order: the writes that
// happened before it are seen by whoever acquires the new value, and the
// writes released by earlier adds are seen after it
__device__ __forceinline__ int atomic_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], %2;\n"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}

// the consumer warpgroups alone (the producer runs ahead)
template <int NT>
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(NT) : "memory");
}

template <class Stage, int BM, int BN>
__global__ void __launch_bounds__(128 * (BN / 64 + 1), 1)
    qmm_wgmma_kernel(const __grid_constant__ Args<Stage> a) {
  using L = Layout<Stage, BM, BN>;
  constexpr int S = L::stages;
  constexpr int NWG = BN / 64;    // consumer warpgroups
  constexpr int NT = 128 * NWG;   // consumer threads
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[S], empty[S];
  __shared__ float lut[16];
  __shared__ int last_split;
  __shared__ Work work;
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x;
  const int nk = a.K / kBK;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NT);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  a.st.prepare(lut, tid);
  plan_work<BM, BN>(a, work, tid);

  if (tid >= NT) {
    // producer warpgroup: gives its registers to the consumers; one
    // thread issues every copy, S stages ahead, and its last three warps
    // write the zero rows
    if constexpr (NWG == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == NT) {
      int it = 0;
      walk<BM, BN>(a, work, nk, [&](const Seg& g) {
        for (int kt = g.k0; kt < g.k1; ++kt, ++it) {
          const int s = it % S;
          mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
          mbar_expect_tx(&full[s], L::x_bytes + a.st.template tx_bytes<BN>());
          tma_load_3d(smem + s * L::x_bytes, &a.x, &full[s], kt * kBK, g.m0,
                      g.e);
          a.st.template load<BN>(smem + L::raw_off + s * L::raw_bytes,
                                 &full[s], g.e * a.K + kt * kBK, g.n0);
        }
      });
    } else if (a.rows && tid >= NT + 32) {
      zero_fill(a, work, tid - NT - 32);
    }
  } else {
    if constexpr (NWG == 2)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int warp = tid / 32, lane = tid % 32;
    // this warp's 16 columns of the tile: A rows g and g + 8 of the warp
    // are columns 2g and 2g + 1 of them
    const int nb = warp * 16;
    // acc[j * 4 + h * 2 + e]: D row 16 * (warp % 4) + lane / 4 + 8 h, that
    // is column c + h of the tile; D column j * 8 + 2 (lane % 4) + e, that
    // is row j * 8 + 2 (lane % 4) + e of the tile
    const int c = nb + 2 * (lane / 4);
    // rows m0 .. of expert ex below lim, its kept rows (the others are
    // the zero fill's)
    auto store = [&](const float* acc, int ex, int m0, int n0, int lim) {
      const int n = n0 + c;
      if (n >= a.N) return;   // N is even, so n + 1 < N too
      const size_t col = (size_t)ex * a.N + n;
#pragma unroll
      for (int j = 0; j < BM / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = m0 + j * 8 + 2 * (lane % 4) + e;
          if (m < lim)
            *reinterpret_cast<uint32_t*>(
                a.out + ((size_t)ex * a.M + m) * a.N + n) =
                pack_bf16(a.st.epilogue(acc[j * 4 + e], col),
                          a.st.epilogue(acc[j * 4 + 2 + e], col + 1));
        }
    };
    int it = 0;
    walk<BM, BN>(a, work, nk, [&](const Seg& g) {
      const int lim = work.rows[g.e];
      if constexpr (BM == kDecM) {
        // decode: the products of K steps [k0, k1) into acc, on mma.sync
        // m16n8k16 per warp (the A fragments as for wgmma, x rows 0..7 as
        // the B fragments by ldmatrix over the 128-byte swizzled rows,
        // chunk q of a row holding K 8q .. 8q+7). A warp takes kDecGroup
        // stages at a time: it waits for all, reads all (their
        // shared-memory reads in flight together), runs the products in
        // stage order and releases the stages.
        auto run = [&](float (&acc)[4], int k0, int k1) {
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i] = 0.f;
          for (int kt = k0; kt < k1; kt += kDecGroup) {
            const int n = min(kDecGroup, k1 - kt);
            uint32_t f[kDecGroup][kBK / 16][4], xb[kDecGroup][kBK / 16][2];
#pragma unroll
            for (int i = 0; i < kDecGroup; ++i)
              if (i < n) mbar_wait(&full[(it + i) % S], ((it + i) / S) & 1);
#pragma unroll
            for (int i = 0; i < kDecGroup; ++i)
              if (i < n) {
                const int s = (it + i) % S;
                a.st.template fragments<BN>(
                    smem + L::raw_off + s * L::raw_bytes, lut, nb, lane,
                    f[i]);
                const uint32_t xa = smem_u32(smem + s * L::x_bytes);
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                  uint32_t b[4];
                  ldmatrix_x4(b, swz(xa, lane & 7, 4 * h + (lane >> 3)));
                  xb[i][2 * h][0] = b[0];
                  xb[i][2 * h][1] = b[1];
                  xb[i][2 * h + 1][0] = b[2];
                  xb[i][2 * h + 1][1] = b[3];
                }
              }
#pragma unroll
            for (int i = 0; i < kDecGroup; ++i)
              if (i < n)
#pragma unroll
                for (int kk = 0; kk < kBK / 16; ++kk)
                  mma_bf16(acc, f[i][kk], xb[i][kk][0], xb[i][kk][1]);
#pragma unroll
            for (int i = 0; i < kDecGroup; ++i)
              if (i < n) mbar_arrive(&empty[(it + i) % S]);
            it += n;
          }
        };
        const int r0 = 2 * (lane % 4);
        // the sums of segment s (-1: a 2-D run): added to the tile's in
        // segment order where the tile is this block's alone (a 2-D run
        // is the whole K axis), else written to the segment's slot
        float tot[4];
        auto finish = [&](const float (&acc)[4], int s) {
          if (g.b0 == g.b1) {
#pragma unroll
            for (int i = 0; i < 4; ++i)
              tot[i] = s < 0 ? acc[i] : (s > 0 ? tot[i] : 0.f) + acc[i];
            return;
          }
          float* slot = a.part +
                        (size_t)(s < 0 ? g.slot : g.first + s) * kDecM * BN +
                        c;
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (r0 + e < lim)
              *reinterpret_cast<float2*>(slot + (r0 + e) * BN) =
                  make_float2(acc[e], acc[2 + e]);
        };
        float acc[4];
        if (g.s0 < 0) {
          run(acc, g.k0, g.k1);
          finish(acc, -1);
        }
        for (int s = g.s0; s >= 0 && s < g.s1; ++s) {
          run(acc, s * nk / a.seg, (s + 1) * nk / a.seg);
          finish(acc, s);
        }

        if (g.b0 == g.b1) {
          if (g.k1 == nk) store(tot, g.e, 0, g.n0, lim);
          return;
        }
        // a split tile: after the block's run of it, the last of the
        // tile's blocks to finish adds the slots in order, in the same
        // launch, and resets the tile's counter for the next launch or
        // graph replay
        // the barrier orders every consumer's writes before thread 0's
        // release, and thread 0's acquire (when last) before every
        // consumer's reads: one fence a block, not one a thread
        consumer_sync<NT>();
        if (tid == 0) {
          const int done = atomic_add_acq_rel(a.counter + g.key, 1);
          last_split = done == g.b1 - g.b0;
          if (last_split) a.counter[g.key] = 0;
        }
        consumer_sync<NT>();
        if (!last_split) return;
        // four slots' loads in flight at a time (8 or 16, for the 17
        // slots of a wk/wv tile, read no faster), added in slot order
        constexpr int kAhead = 4;
        float sum[4] = {0.f, 0.f, 0.f, 0.f};
        for (int b = 0; b < g.n; b += kAhead) {
          float2 v[kAhead][2];
#pragma unroll
          for (int i = 0; i < kAhead; ++i)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (b + i < g.n && r0 + e < lim)
                v[i][e] = __ldcg(reinterpret_cast<const float2*>(
                    a.part + (size_t)(g.first + b + i) * kDecM * BN +
                    (r0 + e) * BN + c));
#pragma unroll
          for (int i = 0; i < kAhead; ++i)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (b + i < g.n && r0 + e < lim) {
                sum[e] += v[i][e].x;
                sum[2 + e] += v[i][e].y;
              }
        }
        store(sum, g.e, 0, g.n0, lim);
      } else {
        float acc[BM / 2];
#pragma unroll
        for (int i = 0; i < BM / 2; ++i) acc[i] = 0.f;
        uint32_t f0[kBK / 16][4], f1[kBK / 16][4];
        // one stage: its fragments into `cur`, four wgmma, and the release
        // of the stage before it (none for the segment's `first`), once
        // its products are done (they read `prev`)
        auto step = [&](uint32_t (&cur)[kBK / 16][4],
                        uint32_t (&prev)[kBK / 16][4], bool first) {
          const int s = it % S;
          mbar_wait(&full[s], (it / S) & 1);
          a.st.template fragments<BN>(smem + L::raw_off + s * L::raw_bytes,
                                      lut, nb, lane, cur);
          const uint32_t xa = smem_u32(smem + s * L::x_bytes);
          fence_acc(acc);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kBK / 16; ++kk)
            wgmma_rs<BM>(acc, cur[kk], desc(xa + kk * 32, 16, 1024));
          wgmma_commit();
          fence_acc(acc);
          wgmma_wait<1>();
          fence_acc(acc);
#pragma unroll
          for (int kk = 0; kk < kBK / 16; ++kk) fence_regs(prev[kk]);
          if (!first) mbar_arrive(&empty[(it - 1) % S]);
          ++it;
        };
        int kt = g.k0;
        for (; kt + 1 < g.k1; kt += 2) {
          step(f0, f1, kt == g.k0);
          step(f1, f0, false);
        }
        if (kt < g.k1) step(f0, f1, kt == g.k0);
        wgmma_wait<0>();
        fence_acc(acc);
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          fence_regs(f0[kk]);
          fence_regs(f1[kk]);
        }
        mbar_arrive(&empty[(it - 1) % S]);
        store(acc, g.e, g.m0, g.n0, lim);
      }
    });
  }
}

// -- host --------------------------------------------------------------------
// make_map for a weight matrix, encoded once per (address, type, shape,
// box, swizzle) and then served from a cache: every decode step launches
// on the same weights, and a map is a function of that key alone, so a
// cached map stays right even where the memory was freed and reused.
inline bool make_map_cached(CUtensorMap* map, const void* base,
                            CUtensorMapDataType type, int esize,
                            uint64_t rows, uint64_t cols, uint32_t box_rows,
                            uint32_t box_cols, CUtensorMapSwizzle swizzle) {
  struct Key {
    const void* base;
    uint64_t rows, cols;
    uint32_t box_rows, box_cols;
    int type, esize, swizzle;
    bool operator==(const Key& o) const {
      return base == o.base && rows == o.rows && cols == o.cols &&
             box_rows == o.box_rows && box_cols == o.box_cols &&
             type == o.type && esize == o.esize && swizzle == o.swizzle;
    }
  };
  struct Hash {
    size_t operator()(const Key& k) const {
      size_t h = reinterpret_cast<uintptr_t>(k.base);
      for (uint64_t v : {k.rows, k.cols, (uint64_t)k.box_rows,
                         (uint64_t)k.box_cols, (uint64_t)k.type,
                         (uint64_t)k.swizzle})
        h = h * 1000003u ^ v;
      return h;
    }
  };
  static std::mutex mu;
  static std::unordered_map<Key, CUtensorMap, Hash> cache;
  const Key key{base, rows, cols, box_rows, box_cols, (int)type, esize,
                (int)swizzle};
  std::lock_guard<std::mutex> lock(mu);
  const auto it = cache.find(key);
  if (it != cache.end()) {
    *map = it->second;
    return true;
  }
  if (!make_map(map, base, type, esize, rows, cols, box_rows, box_cols,
                swizzle))
    return false;
  if (cache.size() >= 4096) cache.clear();
  cache.emplace(key, *map);
  return true;
}

// the swizzle of a raw weight tile with BN-byte rows (raw_at)
inline CUtensorMapSwizzle raw_swizzle(int bn) {
  return bn == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
}

template <class Stage, int BM, int BN>
cudaError_t launch_tiles(Args<Stage>& a, const __nv_bfloat16* x, int grid,
                         cudaStream_t stream) {
  using L = Layout<Stage, BM, BN>;
  const uint64_t dims[3] = {(uint64_t)a.K, (uint64_t)a.M, (uint64_t)a.E};
  const uint64_t strides[2] = {(uint64_t)a.K * 2, (uint64_t)a.M * a.K * 2};
  const uint32_t box[3] = {(uint32_t)kBK, (uint32_t)BM, 1};
  if (!make_map_nd(&a.x, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, dims,
                   strides, box, CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  auto kernel = qmm_wgmma_kernel<Stage, BM, BN>;
  // raised once per instance, so that later launches, inside a CUDA graph
  // capture too, make no attribute call
  static bool raised = false;
  if (!raised) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::total);
    if (err != cudaSuccess) return err;
    raised = true;
  }
  kernel<<<grid, 128 * (BN / 64 + 1), L::total, stream>>>(a);
  return cudaGetLastError();
}

// The prefill loop at the host's plan: BM in {256, 128, 64} rows of x by
// BN in {128, 64} columns, `grid` blocks, over a.E experts (the tiles of
// their kept rows, a.rows). The caller has filled a.st with the format's
// tensor maps for BN. Refuses (cudaErrorInvalidValue) what the plan never
// gives it: K not a multiple of 64, N not a multiple of 16, no expert or
// more than kMaxE, another tile.
template <class Stage>
cudaError_t launch(Args<Stage>& a, const __nv_bfloat16* x, int bm, int bn,
                   int grid, cudaStream_t stream) {
  if (a.K % kBK || a.N % 16 || grid < 1 || a.E < 1 || a.E > kMaxE)
    return cudaErrorInvalidValue;
  if (bn == 128) {
    if (bm == 256) return launch_tiles<Stage, 256, 128>(a, x, grid, stream);
    if (bm == 128) return launch_tiles<Stage, 128, 128>(a, x, grid, stream);
    if (bm == 64) return launch_tiles<Stage, 64, 128>(a, x, grid, stream);
  }
  if (bn == 64) {
    if (bm == 256) return launch_tiles<Stage, 256, 64>(a, x, grid, stream);
    if (bm == 128) return launch_tiles<Stage, 128, 64>(a, x, grid, stream);
    if (bm == 64) return launch_tiles<Stage, 64, 64>(a, x, grid, stream);
  }
  return cudaErrorInvalidValue;
}

// The decode loop at the host's plan: M <= 8 rows of x by BN in {128, 64}
// columns, `grid` blocks sharing out the K steps of the a.E experts'
// column tiles (a.seg = 0: walk_steps) or the K segments of the experts
// with kept rows (a.seg > 0: walk_segments), with a.part and a.counter
// for the split tiles. Refuses (cudaErrorInvalidValue) M > 8, K not a
// multiple of 64, N not a multiple of 16, no expert or more than kMaxE,
// more segments than K steps, more blocks than pieces, missing scratch,
// another tile.
template <class Stage>
cudaError_t launch_decode(Args<Stage>& a, const __nv_bfloat16* x, int bn,
                          int grid, cudaStream_t stream) {
  const int nk = a.K / kBK;
  if (a.M < 1 || a.M > kDecM || a.K % kBK || a.N % 16 || grid < 1 ||
      a.E < 1 || a.E > kMaxE || a.seg < 0 || a.seg > nk ||
      (bn != 128 && bn != 64) || !a.part || !a.counter ||
      (long long)grid > (long long)a.E * ((a.N + bn - 1) / bn) *
                            (a.seg > 0 ? a.seg : nk))
    return cudaErrorInvalidValue;
  if (bn == 128) return launch_tiles<Stage, kDecM, 128>(a, x, grid, stream);
  return launch_tiles<Stage, kDecM, 64>(a, x, grid, stream);
}

}  // namespace wg
}  // namespace qmm
