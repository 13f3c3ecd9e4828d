// The bf16 flash attention backward for Hopper (sm_90a): dK/dV and dQ
// passes on TMA-fed wgmma, warp-specialised as the forward
// (flash_wgmma.cuh), whose product helpers, mask and key walk they share.
//
// What it computes, from the forward's per-row logsumexp lse (f32,
// (B, H, S)) and D = rowsum(dO * O) (bwd_delta_kernel):
//   P  = exp(q k^T / sqrt(d) - lse), 0 where masked         (f32)
//   dS = P * (dO v^T - D)                                   (f32)
//   dV = bf16(P)^T dO,  dK = bf16(dS)^T q / sqrt(d),  dQ = bf16(dS) k / sqrt(d)
// P is rounded to bf16 before the dV product and dS before the dK and dQ
// products (FlashAttention-2/3; the forward rounds p before PV too);
// every product sums in f32 and each output is rounded once to bf16.
// flash_attention_backward_plain (kernel.py) rounds at the same points.
//
// Bound: by operations (the recompute makes seven products of 2 * d FLOP
// per visible (query, key) pair and head against the bound's five). What
// the design does about it:
//
// - Two passes, no atomics. dkdv_kernel owns keys and walks queries;
//   dq_kernel owns queries and walks keys. Each recomputes S and dP, so a
//   call does seven products, but every output element is summed by one
//   thread in an order fixed by the shapes alone: two calls agree bit for
//   bit, whatever the grid's schedule.
// - dkdv_kernel: a block owns a run of keys of one KV head (grid (B * Kv,
//   key blocks), the key blocks with the most query tiles first), two
//   consumer warpgroups and a producer warpgroup that gives its registers
//   to them (setmaxnreg) and one of whose warps feeds them. At D = 64 the
//   block owns 128 keys, 64 to a warpgroup; at D = 128 it owns 64 keys and
//   the warpgroups split dK's and dV's 128 columns, each computing the
//   block's S^T and dP^T (a third more products, against spilling: ptxas
//   gives each thread of a 384-thread block 168 registers, setmaxnreg or
//   not, and dK and dV of 64 keys x 128 columns take 128 of them beside
//   S^T's and dP^T's 64). K and V arrive once per block by TMA (box
//   {64, 1, keys, 1} of (d, Kv, T, B)).
//   For each of the G query heads of the KV head, the block walks the
//   64-position query tiles that may see its keys (query_range): Q and dO
//   (box {64, 1, 64, 1} of (d, H, S, B)) come through a ring of kStages
//   stages with full and empty mbarriers, and the producer warp stages
//   each tile's 64 (lse * log2 e, D) pairs beside them with plain loads.
//   Per tile a warpgroup computes S^T = K Q^T and dP^T = V dO^T (wgmma
//   m64n64k16, both operands K-major), then P^T and dS^T on the
//   accumulator fragments, rounds both to bf16 straight into register A
//   fragments, and issues dV += P^T dO and dK += dS^T Q with dO and Q
//   read MN-major (the transpose bit), as the forward reads V. A
//   warpgroup skips the products of a tile none of its keys may see (the
//   first tile on the causal diagonal, for the upper half). dK and dV sum
//   the G heads and every tile in f32 registers, then are scaled, rounded
//   once and stored. A consumer thread holds 64 keys x 64 columns of dK
//   and dV (32 registers each) beside S^T and dP^T (32 each); P^T and dS^T
//   are packed only after both are computed, and the first step of each
//   S^T and dP^T product writes its accumulator without reading it, so no
//   tile's fragments stay alive across the next tile's products.
// - dq_kernel: the forward's shape (flash_plan): 128 (position, head) rows
//   a block, bq = 128 / G positions times the G heads of one KV head, Q
//   and dO read once (box {64, G, bq, 1}), K and V through the ring over
//   the forward's key walk (key_range). Per 64-key tile: S = Q K^T and
//   dP = dO V^T, P with lse known (no online softmax), dS rounded to bf16
//   into A, dQ += dS K with K read MN-major.
// - Masks. Edge tiles (keys past T, queries past S, across the causal
//   diagonal or the window's start) mask each entry to P = 0 explicitly;
//   TMA fills keys past T with zeros, whose scores are 0 and would
//   otherwise count. A tile every pair sees takes one fused multiply-add
//   and ex2.approx per entry.
// - Head dims 96 and 120 run on a D = 128 instance (kExact false) with
//   the true d as the maps' inner extent: TMA fills the columns past d with
//   zeros, which add nothing to S and dP, and the output columns past d
//   are never stored.
#pragma once

#include "flash_wgmma.cuh"

namespace flash {
namespace bwd {

using namespace ::hopper;
using wg::allowed;
using wg::exp2_approx;
using wg::kLog2e;
using wg::wgmma_pv;
using wg::wgmma_ss_m64n64;

constexpr int kBQ = 64;          // query positions of a dK/dV tile
constexpr int kRows = 128;       // (position, head) rows of a dQ block
constexpr int kBK = 64;          // keys of a dQ tile
constexpr int kStages = 4;
constexpr int kThreads = 384;    // two consumer warpgroups + the producer
constexpr int kBoxBytes = 128;   // one row of a 64-column bf16 box

// A dK/dV block: at D = 64, 128 keys, 64 to a warpgroup; at D = 128, 64
// keys, whose 128 output columns the two warpgroups split (each computes
// S^T and dP^T of the block's keys). Either way a warpgroup accumulates
// 64 keys x 64 columns of dK and of dV: 168 registers a thread (the cap
// of 384 threads; setmaxnreg does not raise what ptxas allocates) cannot
// hold 64 x 128 of each beside S^T and dP^T.
template <int D>
struct DkvLayout {
  static constexpr int NB = D / 64;                       // column boxes
  static constexpr int keys = D == 64 ? 128 : 64;
  static constexpr bool split_keys = D == 64;
  static constexpr int kv_bytes = NB * keys * kBoxBytes;  // K or V
  static constexpr int tile_bytes = NB * kBQ * kBoxBytes;   // Q or dO tile
  static constexpr int stage_bytes = 2 * tile_bytes;
  static constexpr int total = 2 * kv_bytes + kStages * stage_bytes + 1024;
};

template <int D>
struct DqLayout {
  static constexpr int NB = D / 64;
  static constexpr int q_bytes = NB * kRows * kBoxBytes;  // Q or dO rows
  static constexpr int tile_bytes = NB * kBK * kBoxBytes;  // K or V tile
  static constexpr int stage_bytes = 2 * tile_bytes;
  static constexpr int total = 2 * q_bytes + kStages * stage_bytes + 1024;
};

struct Args {
  // q and dout over (d, H, S, B): dK/dV box {64, 1, 64, 1}, dQ box
  // {64, G, bq, 1}; k and v over (d, Kv, T, B): dK/dV box {64, 1, keys,
  // 1}, dQ box {64, 1, 64, 1}
  CUtensorMap q;
  CUtensorMap dout;
  CUtensorMap k;
  CUtensorMap v;
  const float* lse;    // (B, H, S) f32
  const float* delta;  // (B, H, S) f32
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int d, S, T, H, Kv, G, bq, n_qt, causal, window;
  float scale;
};

// d (64 x 64, f32) = A (64 x 16) @ B (16 x 64), both from shared memory,
// K-major: the first step of a product, d written and not read (scale-d
// 0). wg::wgmma_ss_m64n64 reads d ("+f") whatever its flag, which would
// keep the previous tile's S^T and dP^T alive across the dK and dV
// products and spill at D = 128
__device__ __forceinline__ void wgmma_ss_m64n64_first(float (&d)[32],
                                                      uint64_t da,
                                                      uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "l"(da), "l"(db), "r"(0));
}

// d (64 x 64) = A B^T over D columns: KS steps of 16, the first writing d;
// A and B K-major, 64-column boxes of a_rows and b_rows rows
template <int KS>
__device__ __forceinline__ void product_ss(float (&d)[32], uint32_t a,
                                           int a_rows, uint32_t b,
                                           int b_rows) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint32_t off = (kk % 4) * 32;   // 16 columns into a box
    const uint64_t da =
        desc(a + (kk / 4) * a_rows * kBoxBytes + off, 16, 1024);
    const uint64_t db =
        desc(b + (kk / 4) * b_rows * kBoxBytes + off, 16, 1024);
    if (kk == 0)
      wgmma_ss_m64n64_first(d, da, db);
    else
      wgmma_ss_m64n64(d, da, db, 1);
  }
}

// D = rowsum(dO * O) of every (batch, position, head) row, stored
// (B, H, S) as lse is: 16 lanes a row, 16 bytes (8 values) a lane and
// load, two rows a warp (a row of d = 64 .. 128 is 8 .. 16 such chunks)
constexpr int kDeltaThreads = 256;
__global__ void __launch_bounds__(kDeltaThreads)
    delta_kernel(const __nv_bfloat16* __restrict__ o,
                 const __nv_bfloat16* __restrict__ dout,
                 float* __restrict__ delta, long rows, int S, int H, int d) {
  const long row = ((long)blockIdx.x * kDeltaThreads + threadIdx.x) / 16;
  const int lane = threadIdx.x % 16;
  float s = 0.f;
  if (row < rows) {
    const uint4* po = reinterpret_cast<const uint4*>(o + (size_t)row * d);
    const uint4* pd = reinterpret_cast<const uint4*>(dout + (size_t)row * d);
    for (int c = lane; c < d / 8; c += 16) {
      const uint4 x = po[c], y = pd[c];
      const __nv_bfloat162* hx = reinterpret_cast<const __nv_bfloat162*>(&x);
      const __nv_bfloat162* hy = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 fx = __bfloat1622float2(hx[k]);
        const float2 fy = __bfloat1622float2(hy[k]);
        s = fmaf(fx.x, fy.x, s);
        s = fmaf(fx.y, fy.y, s);
      }
    }
  }
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (row < rows && lane == 0) {
    const int h = (int)(row % H);
    const long bs = row / H;
    delta[((size_t)(bs / S) * H + h) * S + bs % S] = s;
  }
}

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// the query positions [q_begin, q_end) that may see keys k0 .. k0 + nk - 1
// (kernel.py dkdv_query_tiles); the window narrows the walk only under
// the causal mask, as the forward's key walk
__device__ __forceinline__ void query_range(int k0, int nk, int S, int causal,
                                            int window, int& q_begin,
                                            int& q_end) {
  q_begin = 0;
  q_end = S;
  if (causal) {
    q_begin = k0;
    if (window > 0) q_end = min(S, k0 + nk - 1 + window);
  }
}

// an accumulator's fragments rounded to bf16 as the A fragments of a
// k = 64 product: 16 columns a step, fragments 2 kk and 2 kk + 1
__device__ __forceinline__ void pack_a(uint32_t (&pa)[4][4],
                                       const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    pa[kk][0] = pack_bf16(x[8 * kk + 0], x[8 * kk + 1]);
    pa[kk][1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
    pa[kk][2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
    pa[kk][3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

// acc[4 j + 2 h + e] is (row g + 8 h of the warp's 16, column 8 j +
// 2 quad + e): scaled, rounded and stored to dst[h] + column for the
// rows `live`, columns below d (even, so a pair lies wholly on one side)
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2],
                                           __nv_bfloat16* const (&dst)[2],
                                           const bool (&live)[2], int d,
                                           float scale, int quad) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!live[h]) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      if (8 * j + 2 * quad < d)
        *reinterpret_cast<__nv_bfloat162*>(dst[h] + 8 * j + 2 * quad) =
            __floats2bfloat162_rn(acc[4 * j + 2 * h] * scale,
                                  acc[4 * j + 2 * h + 1] * scale);
  }
}

template <int D, bool kExact>
__global__ void __launch_bounds__(kThreads, 1)
    dkdv_kernel(const __grid_constant__ Args a) {
  using L = DkvLayout<D>;
  constexpr int NB = L::NB;
  constexpr int KS = D / 16;      // 16-deep steps of S^T = K Q^T
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages], kvbar;
  // per stage and query: (lse * log2 e, D), 0 past S
  __shared__ __align__(16) float2 rows_s[kStages][kBQ];
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* sk = smem;                      // NB boxes of L::keys keys
  uint8_t* sv = smem + L::kv_bytes;
  uint8_t* sqd = smem + 2 * L::kv_bytes;   // stage s: Q boxes, then dO
  const int tid = threadIdx.x;
  const int b = blockIdx.x / a.Kv, kv = blockIdx.x % a.Kv;
  const int k0 = blockIdx.y * L::keys;
  const int nk = min(L::keys, a.T - k0);
  int q_begin, q_end;
  query_range(k0, nk, a.S, a.causal, a.window, q_begin, q_end);
  const int n_q = q_end > q_begin ? (q_end - q_begin + kBQ - 1) / kBQ : 0;
  const int n = a.G * n_q;        // tiles: query tile i % n_q of head i / n_q

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1 + 32);   // the copies' arrival + the warp's
      mbar_init(&empty[s], 256);
    }
    mbar_init(&kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid < 288 && n > 0) {
      const int lane = tid - 256;
      if (lane == 0) {
        mbar_expect_tx(&kvbar, 2 * L::kv_bytes);
        for (int c = 0; c < NB; ++c) {
          tma_load_4d(sk + c * L::keys * kBoxBytes, &a.k, &kvbar, c * 64, kv,
                      k0, b);
          tma_load_4d(sv + c * L::keys * kBoxBytes, &a.v, &kvbar, c * 64, kv,
                      k0, b);
        }
      }
      for (int i = 0; i < n; ++i) {
        const int s = i % kStages;
        const int h = kv * a.G + i / n_q;
        const int q0 = q_begin + (i % n_q) * kBQ;
        mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(&full[s], L::stage_bytes);
          uint8_t* st = sqd + s * L::stage_bytes;
          for (int c = 0; c < NB; ++c) {
            tma_load_4d(st + c * kBQ * kBoxBytes, &a.q, &full[s], c * 64, h,
                        q0, b);
            tma_load_4d(st + L::tile_bytes + c * kBQ * kBoxBytes, &a.dout,
                        &full[s], c * 64, h, q0, b);
          }
        }
        const size_t row = ((size_t)b * a.H + h) * a.S;
        for (int r = lane; r < kBQ; r += 32) {
          const int qp = q0 + r;
          rows_s[s][r] = qp < a.S ? make_float2(a.lse[row + qp] * kLog2e,
                                                a.delta[row + qp])
                                  : make_float2(0.f, 0.f);
        }
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wgi = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int quad = lane % 4;
  // this warpgroup's first key and first output column
  const int kw0 = k0 + (L::split_keys ? 64 * wgi : 0);
  const int c0 = L::split_keys ? 0 : 64 * wgi;
  const int kw_last = min(a.T, kw0 + 64) - 1;
  // this thread's two keys (h = 0, 1): row g + 8 h of its warp's 16
  int kp[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) kp[h] = kw0 + 16 * warp + lane / 4 + 8 * h;

  float dk[32], dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;

  if (n > 0) {
    mbar_wait(&kvbar, 0);
    const uint32_t ka = smem_u32(sk) + (kw0 - k0) * kBoxBytes;
    const uint32_t va = smem_u32(sv) + (kw0 - k0) * kBoxBytes;
    const uint32_t cb = (c0 / 64) * kBQ * kBoxBytes;   // its column box
    const float sl2 = a.scale * kLog2e;
    float st[32], dpt[32];
    uint32_t pa[4][4], sa[4][4];

    // P^T and dS^T of the stage's tile at q0 on the fragments: element
    // (key row g + 8 h, query 8 j + 2 quad + e) is st[4 j + 2 h + e];
    // P^T is left in st, dS^T in dpt
    auto grads = [&](auto edge_tag, int q0, int s) {
      constexpr bool kEdge = decltype(edge_tag)::value;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        // queries 8 j + 2 quad and + 1: (lse2, D) of each
        const float4 r =
            *reinterpret_cast<const float4*>(&rows_s[s][8 * j + 2 * quad]);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float l2 = e ? r.z : r.x, dd = e ? r.w : r.y;
          const int qp = q0 + 8 * j + 2 * quad + e;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float& x = st[4 * j + 2 * h + e];
            float& y = dpt[4 * j + 2 * h + e];
            float p = exp2_approx(fmaf(x, sl2, -l2));
            if constexpr (kEdge)
              p = qp < a.S && kp[h] < a.T &&
                          allowed(qp, kp[h], a.causal, a.window)
                      ? p
                      : 0.f;
            x = p;
            y = p * (y - dd);
          }
        }
      }
    };

    for (int i = 0; i < n; ++i) {
      const int s = i % kStages;
      const int q0 = q_begin + (i % n_q) * kBQ;
      const int q_last = min(a.S, q0 + kBQ) - 1;
      mbar_wait(&full[s], (i / kStages) & 1);
      // none of this warpgroup's keys visible to the tile's queries
      const bool skip = kw0 >= a.T || (a.causal && kw0 > q_last) ||
                        (a.window > 0 && kw_last <= q0 - a.window);
      if (!skip) {
        const uint32_t qa = smem_u32(sqd) + s * L::stage_bytes;
        const uint32_t da = qa + L::tile_bytes;
        wgmma_fence();
        product_ss<KS>(st, ka, L::keys, qa, kBQ);      // S^T = K Q^T
        product_ss<KS>(dpt, va, L::keys, da, kBQ);     // dP^T = V dO^T
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(st);
        fence_acc(dpt);
        const bool edge = kw0 + 64 > a.T || q0 + kBQ > a.S ||
                          (a.causal && kw0 + 63 > q0) ||
                          (a.window > 0 && kw0 <= q_last - a.window);
        if (edge)
          grads(std::true_type{}, q0, s);
        else
          grads(std::false_type{}, q0, s);
        pack_a(pa, st);
        pack_a(sa, dpt);
        wgmma_fence();
        // dV += P^T dO and dK += dS^T Q over the warpgroup's 64 columns
#pragma unroll
        for (int kk = 0; kk < kBQ / 16; ++kk)
          wgmma_pv<64>(dv, pa[kk], desc(da + cb + kk * 16 * kBoxBytes,
                                        kBQ * kBoxBytes, 1024));
#pragma unroll
        for (int kk = 0; kk < kBQ / 16; ++kk)
          wgmma_pv<64>(dk, sa[kk], desc(qa + cb + kk * 16 * kBoxBytes,
                                        kBQ * kBoxBytes, 1024));
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(dv);
        fence_acc(dk);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          fence_regs(pa[kk]);
          fence_regs(sa[kk]);
        }
      }
      mbar_arrive(&empty[s]);
    }
  }

  const int d = kExact ? D : a.d;
  bool live[2];
  __nv_bfloat16* dst_k[2];
  __nv_bfloat16* dst_v[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    live[h] = kp[h] < a.T;
    const size_t off = ((size_t)(b * a.T + kp[h]) * a.Kv + kv) * d + c0;
    dst_k[h] = a.dk + off;
    dst_v[h] = a.dv + off;
  }
  store_rows<64>(dk, dst_k, live, d - c0, a.scale, quad);
  store_rows<64>(dv, dst_v, live, d - c0, 1.f, quad);
}

template <int D, bool kExact>
__global__ void __launch_bounds__(kThreads, 1)
    dq_kernel(const __grid_constant__ Args a) {
  using L = DqLayout<D>;
  constexpr int NB = L::NB;
  constexpr int KS = D / 16;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages], qbar;
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* sq = smem;                       // NB boxes of 128 rows
  uint8_t* sdo = smem + L::q_bytes;
  uint8_t* skv = smem + 2 * L::q_bytes;     // stage s: K boxes, then V
  const int tid = threadIdx.x;
  const int b = blockIdx.x / a.Kv, kv = blockIdx.x % a.Kv;
  const int q0 = (a.n_qt - 1 - (int)blockIdx.y) * a.bq;
  int k_begin, k_end;
  wg::key_range(q0, a.bq, a.S, a.T, a.causal, a.window, k_begin, k_end);
  const int n = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    mbar_init(&qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 256 && n > 0) {
      mbar_expect_tx(&qbar, 2 * NB * a.G * a.bq * kBoxBytes);
      for (int c = 0; c < NB; ++c) {
        tma_load_4d(sq + c * kRows * kBoxBytes, &a.q, &qbar, c * 64,
                    kv * a.G, q0, b);
        tma_load_4d(sdo + c * kRows * kBoxBytes, &a.dout, &qbar, c * 64,
                    kv * a.G, q0, b);
      }
      for (int i = 0; i < n; ++i) {
        const int s = i % kStages;
        mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], L::stage_bytes);
        uint8_t* st = skv + s * L::stage_bytes;
        const int kt = k_begin + i * kBK;
        for (int c = 0; c < NB; ++c) {
          tma_load_4d(st + c * kBK * kBoxBytes, &a.k, &full[s], c * 64, kv,
                      kt, b);
          tma_load_4d(st + L::tile_bytes + c * kBK * kBoxBytes, &a.v,
                      &full[s], c * 64, kv, kt, b);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wgi = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int quad = lane % 4;
  // this thread's two rows (h = 0, 1): row g + 8 h of its warp's 16, with
  // its lse * log2 e and D (0 for a row past S or past the block's rows)
  int qp[2], head[2];
  bool live[2];
  float l2[2], dd[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 64 * wgi + 16 * warp + lane / 4 + 8 * h;
    qp[h] = q0 + r / a.G;
    head[h] = kv * a.G + r % a.G;
    live[h] = r < a.G * a.bq && qp[h] < a.S;
    const size_t at = ((size_t)b * a.H + head[h]) * a.S + qp[h];
    l2[h] = live[h] ? a.lse[at] * kLog2e : 0.f;
    dd[h] = live[h] ? a.delta[at] : 0.f;
  }

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

  if (n > 0) {
    mbar_wait(&qbar, 0);
    const uint32_t qa = smem_u32(sq) + wgi * 64 * kBoxBytes;
    const uint32_t doa = smem_u32(sdo) + wgi * 64 * kBoxBytes;
    const int q_last = min(a.S, q0 + a.bq) - 1;
    const float sl2 = a.scale * kLog2e;
    float sc[32], dp[32];
    uint32_t sa[4][4];

    // dS of the tile at kt on the fragments: element (row g + 8 h, key
    // kt + 8 j + 2 quad + e) is dp[4 j + 2 h + e]
    auto grads = [&](auto edge_tag, int kt) {
      constexpr bool kEdge = decltype(edge_tag)::value;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kp = kt + 8 * j + 2 * quad + e;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int at = 4 * j + 2 * h + e;
            float p = exp2_approx(fmaf(sc[at], sl2, -l2[h]));
            if constexpr (kEdge)
              p = kp < a.T && allowed(qp[h], kp, a.causal, a.window) ? p
                                                                     : 0.f;
            dp[at] = p * (dp[at] - dd[h]);
          }
        }
    };

    for (int i = 0; i < n; ++i) {
      const int s = i % kStages;
      const int kt = k_begin + i * kBK;
      const uint32_t ka = smem_u32(skv) + s * L::stage_bytes;
      const uint32_t va = ka + L::tile_bytes;
      mbar_wait(&full[s], (i / kStages) & 1);
      wgmma_fence();
      product_ss<KS>(sc, qa, kRows, ka, kBK);     // S = Q K^T
      product_ss<KS>(dp, doa, kRows, va, kBK);    // dP = dO V^T
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(sc);
      fence_acc(dp);
      const bool edge = kt + kBK > a.T || (a.causal && kt + kBK - 1 > q0) ||
                        (a.window > 0 && kt <= q_last - a.window);
      if (edge)
        grads(std::true_type{}, kt);
      else
        grads(std::false_type{}, kt);
      pack_a(sa, dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_pv<D>(dq, sa[kk],
                    desc(ka + kk * 16 * kBoxBytes, kBK * kBoxBytes, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(dq);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fence_regs(sa[kk]);
      mbar_arrive(&empty[s]);
    }
  }

  const int d = kExact ? D : a.d;
  __nv_bfloat16* dst[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    dst[h] = a.dq + ((size_t)(b * a.S + qp[h]) * a.H + head[h]) * d;
  store_rows<D>(dq, dst, live, d, a.scale, quad);
}

// The delta, dK/dV and dQ launches, on `stream`, at the host's plan
// (kernel.py flash_bwd_plan): bq query positions per dQ block (G * bq <=
// 128), head_dim d <= D (a multiple of 8; d == D when kExact). Tensor maps
// are encoded here, per launch, with no device call (a dimension of S = 0
// is encoded as 1: no block of such a call loads a query); the
// shared-memory limits are raised once per instance, so that later
// launches, inside a CUDA graph capture too, make no attribute call.
template <int D, bool kExact>
cudaError_t launch(const __nv_bfloat16* q, const __nv_bfloat16* k,
                   const __nv_bfloat16* v, const __nv_bfloat16* o,
                   const __nv_bfloat16* dout, const float* lse, float* delta,
                   __nv_bfloat16* dq,
                   __nv_bfloat16* dk, __nv_bfloat16* dv, int B, int S, int T_,
                   int H, int Kv, int d, int causal, int window, float scale,
                   int bq, cudaStream_t stream) {
  const int G = H / Kv;
  if (bq < 1 || G * bq > kRows || d < 1 || d > D || d % 8 ||
      (kExact && d != D))
    return cudaErrorInvalidValue;
  const uint64_t e = sizeof(__nv_bfloat16);
  const uint64_t s1 = S > 0 ? S : 1;
  const uint64_t qd[4] = {(uint64_t)d, (uint64_t)H, s1, (uint64_t)B};
  const uint64_t qs[3] = {d * e, (uint64_t)H * d * e, s1 * H * d * e};
  const uint64_t kd[4] = {(uint64_t)d, (uint64_t)Kv, (uint64_t)T_,
                          (uint64_t)B};
  const uint64_t ks[3] = {d * e, (uint64_t)Kv * d * e,
                          (uint64_t)T_ * Kv * d * e};
  auto maps = [&](Args& a, const uint32_t (&qb)[4], const uint32_t (&kb)[4]) {
    return make_map_nd(&a.q, q, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, qd, qs,
                       qb, CU_TENSOR_MAP_SWIZZLE_128B) &&
           make_map_nd(&a.dout, dout, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, qd,
                       qs, qb, CU_TENSOR_MAP_SWIZZLE_128B) &&
           make_map_nd(&a.k, k, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, kd, ks,
                       kb, CU_TENSOR_MAP_SWIZZLE_128B) &&
           make_map_nd(&a.v, v, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, kd, ks,
                       kb, CU_TENSOR_MAP_SWIZZLE_128B);
  };
  Args a;
  a.lse = lse;
  a.delta = delta;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.d = d;
  a.S = S;
  a.T = T_;
  a.H = H;
  a.Kv = Kv;
  a.G = G;
  a.bq = bq;
  a.n_qt = (S + bq - 1) / bq;
  a.causal = causal;
  a.window = window;
  a.scale = scale;
  const int keys = DkvLayout<D>::keys;
  const int n_kb = (T_ + keys - 1) / keys;
  if (a.n_qt > 65535 || n_kb > 65535) return cudaErrorInvalidValue;
  Args a_dq = a;
  if (!maps(a, {64, 1, (uint32_t)kBQ, 1}, {64, 1, (uint32_t)keys, 1}) ||
      !maps(a_dq, {64, (uint32_t)G, (uint32_t)bq, 1},
            {64, 1, (uint32_t)kBK, 1}))
    return cudaErrorInvalidValue;
  auto kdkdv = dkdv_kernel<D, kExact>;
  auto kdq = dq_kernel<D, kExact>;
  static bool raised = false;
  if (!raised) {
    cudaError_t err = cudaFuncSetAttribute(
        kdkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
        DkvLayout<D>::total);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kdq,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 DqLayout<D>::total);
    if (err != cudaSuccess) return err;
    raised = true;
  }
  const long rows = (long)B * S * H;
  if (rows > 0) {
    delta_kernel<<<(unsigned)((rows * 16 + kDeltaThreads - 1) /
                              kDeltaThreads),
                   kDeltaThreads, 0, stream>>>(o, dout, delta, rows, S, H, d);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (n_kb > 0) {
    kdkdv<<<dim3(B * Kv, n_kb), kThreads, DkvLayout<D>::total, stream>>>(a);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (a.n_qt > 0)
    kdq<<<dim3(B * Kv, a.n_qt), kThreads, DqLayout<D>::total, stream>>>(a_dq);
  return cudaGetLastError();
}

}  // namespace bwd
}  // namespace flash
