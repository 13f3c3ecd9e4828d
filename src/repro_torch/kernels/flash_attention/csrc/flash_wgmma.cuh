// The bf16 flash attention kernel for Hopper (sm_90a): TMA ring and
// warp-specialised wgmma, after FlashAttention-3.
//
// What it computes is flash_kernel's function (flash_attention.cu): f32
// scores times 1/sqrt(d), masked entries at the finite -1e30, an online
// softmax over 64-key tiles with f32 running max and sum, the
// unnormalised p rounded to bf16 before the PV product, f32 sums, and
// acc / max(l, 1e-20) rounded once to bf16; with a non-null lse, each
// row's logsumexp m + log(l) in f32, for the backward.
//
// Bound: by operations (4 * d FLOP per visible (query, key) pair and head,
// on the tensor cores). What the design does about it:
//
// - Rows. A block owns 128 (position, head) rows: bq = 128 / G query
//   positions times all G query heads of one KV head, row r being
//   position q0 + r / G and head kv * G + r % G. Each K/V tile is read
//   once per KV head and 128 rows. Two consumer warpgroups own 64 rows
//   each; a producer warpgroup gives its registers to them (setmaxnreg),
//   and one of its threads issues every copy.
// - Loads. TMA over 4-D tensor maps on the natural layouts, so that a box
//   past S or T is filled with zeros within its batch row and never reads
//   the next sequence: q (d, H, S, B) with box {64, G, bq, 1}, read once
//   per block; k and v (d, Kv, T, B) with box {64, 1, 64, 1} into a ring of
//   kStages stages, each with a full and an empty mbarrier. d = 128 is two
//   64-column boxes (the 128-byte swizzle caps a box row at 128 bytes).
// - Head dims 96 and 120 run on a D = 128 instance (kExact false; 64 and
//   128 have d == D at compile time) with the true d as the maps' inner
//   extent (row pitches of 192 and 240 bytes, multiples
//   of 16 as TMA asks): the second box runs past d and TMA fills its
//   columns past d with zeros. Those columns add exact zeros to Q K^T,
//   and the output columns past d that P V yields are never stored. The
//   expect-tx counts stay whole boxes, since TMA counts a box's zero fill.
// - Products. S = Q K^T is wgmma m64n64k16 with Q and K both read from
//   shared memory (K-major, 128-byte swizzle). The softmax runs on the
//   accumulator fragments in registers, the row max and sum over the 4
//   lanes of a quad. p is rounded to bf16 straight into the register A
//   operand of O += P V, wgmma m64n{d}k16 with V read from shared memory
//   MN-major (the transpose bit). While the PV product of tile i - 1 runs,
//   the QK product of tile i has been issued and its softmax runs: one
//   product group is always in flight beside the softmax.
// - Grid. (B * Kv, q tiles) with the q tile index reversed, so that the
//   blocks with the most key tiles start first. A block walks the key
//   tiles its rows may see (key_range in flash_attention.cu); tiles start
//   at key 0 whatever the batch, so a request's sums do not depend on the
//   batch it came in.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "../../csrc/hopper.cuh"

namespace flash {
namespace wg {

using namespace ::hopper;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kRows = 128;       // (position, head) rows a block owns
constexpr int kBK = 64;          // keys per tile
constexpr int kStages = 4;       // K/V ring
constexpr int kThreads = 384;    // two consumer warpgroups + the producer
constexpr int kBoxBytes = 128;   // one row of a 64-column bf16 box

template <int D>
struct Layout {
  static constexpr int NB = D / 64;                    // column boxes
  static constexpr int q_bytes = NB * kRows * kBoxBytes;
  static constexpr int tile_bytes = NB * kBK * kBoxBytes;  // K or V tile
  static constexpr int stage_bytes = 2 * tile_bytes;
  static constexpr int total = q_bytes + kStages * stage_bytes + 1024;
};

struct Args {
  CUtensorMap q;    // (d, H, S, B), box {64, G, bq, 1}
  CUtensorMap k;    // (d, Kv, T, B), box {64, 1, 64, 1}
  CUtensorMap v;
  __nv_bfloat16* out;
  float* lse;       // (B, H, S) f32, or null
  int d;            // head_dim: D, or (not kExact) less than D with the
                    // columns past d zero-filled by TMA
  int S, T, H, Kv, G, bq, n_qt, causal, window;
  float scale;
};

// the key tiles [k_begin, k_end) that positions q0 .. q0 + BQ - 1 may see
__device__ __forceinline__ void key_range(int q0, int BQ, int S, int T_,
                                          int causal, int window,
                                          int& k_begin, int& k_end) {
  const int q_last = min(S, q0 + BQ) - 1;
  k_begin = 0;
  k_end = T_;
  if (causal) {
    k_end = min(T_, q_last + 1);
    if (window > 0) k_begin = max(0, q0 - window + 1) / kBK * kBK;
  }
}

// 2^x on the special function unit (ex2.approx, relative error about
// 2^-22; results below 2^-126 flush to 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ bool allowed(int qp, int kp, int causal,
                                        int window) {
  return (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
}

// d (64 x 64, f32) (+)= A (64 x 16) @ B (16 x 64), both from shared memory,
// K-major; accumulate when `acc`, else overwrite
__device__ __forceinline__ void wgmma_ss_m64n64(float (&d)[32], uint64_t da,
                                                uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// d (64 x 64, f32) += A (64 x 16, registers) @ B (16 x 64, shared memory,
// MN-major: the transpose bit set)
__device__ __forceinline__ void wgmma_rs_m64n64_t(float (&d)[32],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
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

// d (64 x 128, f32) += A (64 x 16, registers) @ B (16 x 128, shared
// memory, MN-major)
__device__ __forceinline__ void wgmma_rs_m64n128_t(float (&d)[64],
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
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&d)[D / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (D == 64) wgmma_rs_m64n64_t(d, a, db);
  else wgmma_rs_m64n128_t(d, a, db);
}

template <int D, bool kExact>
__global__ void __launch_bounds__(kThreads, 1)
    flash_wgmma_kernel(const __grid_constant__ Args a) {
  using L = Layout<D>;
  constexpr int NB = L::NB;
  constexpr int KS = D / 16;      // 16-deep steps of S = Q K^T
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages], qbar;
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sq = smem;                 // NB boxes of 128 rows x 128 bytes
  uint8_t* skv = smem + L::q_bytes;   // stage s: K boxes, then V boxes
  const int tid = threadIdx.x;
  const int b = blockIdx.x / a.Kv, kv = blockIdx.x % a.Kv;
  const int q0 = (a.n_qt - 1 - (int)blockIdx.y) * a.bq;
  int k_begin, k_end;
  key_range(q0, a.bq, a.S, a.T, a.causal, a.window, k_begin, k_end);
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
      mbar_expect_tx(&qbar, NB * a.G * a.bq * kBoxBytes);
      for (int c = 0; c < NB; ++c)
        tma_load_4d(sq + c * kRows * kBoxBytes, &a.q, &qbar, c * 64,
                    kv * a.G, q0, b);
      for (int i = 0; i < n; ++i) {
        const int s = i % kStages;
        mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], L::stage_bytes);
        uint8_t* st = skv + s * L::stage_bytes;
        const int k0 = k_begin + i * kBK;
        for (int c = 0; c < NB; ++c) {
          tma_load_4d(st + c * kBK * kBoxBytes, &a.k, &full[s], c * 64, kv,
                      k0, b);
          tma_load_4d(st + L::tile_bytes + c * kBK * kBoxBytes, &a.v,
                      &full[s], c * 64, kv, k0, b);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wgi = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int quad = lane % 4;
  // this thread's two rows (h = 0, 1): row g + 8 h of its warp's 16
  int qp[2], head[2];
  bool live[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 64 * wgi + 16 * warp + lane / 4 + 8 * h;
    qp[h] = q0 + r / a.G;
    head[h] = kv * a.G + r % a.G;
    live[h] = r < a.G * a.bq && qp[h] < a.S;
  }

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  if (n > 0) {
    mbar_wait(&qbar, 0);
    const uint32_t qa = smem_u32(sq) + wgi * 64 * kBoxBytes;
    const uint32_t kva = smem_u32(skv);
    const int q_last = min(a.S, q0 + a.bq) - 1;
    float sc[32];
    uint32_t pa[kBK / 16][4];

    // S = Q K^T of the stage's tile, issued, not waited for
    auto issue_qk = [&](int s) {
      const uint32_t ka = kva + s * L::stage_bytes;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const uint32_t off = (kk % 4) * 32;   // 16 columns into a box
        wgmma_ss_m64n64(
            sc, desc(qa + (kk / 4) * kRows * kBoxBytes + off, 16, 1024),
            desc(ka + (kk / 4) * kBK * kBoxBytes + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
    };
    // O += P V of the stage's tile, issued, not waited for
    auto issue_pv = [&](int s) {
      const uint32_t va = kva + s * L::stage_bytes + L::tile_bytes;
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_pv<D>(o, pa[kk],
                    desc(va + kk * 16 * kBoxBytes, kBK * kBoxBytes, 1024));
      wgmma_commit();
    };
    // the online softmax of the tile at k0 on the S fragments: element
    // (row g + 8 h, key k0 + 8 j + 2 quad + e) is sc[4 j + 2 h + e]; p is
    // left in sc, and corr[h] rescales what O held before this tile. Edge
    // tiles (past T, across the diagonal or the window's start) mask each
    // entry to -1e30 (p = 0 past T); a tile every row sees whole takes the
    // row max on the raw scores (scaling by 1/sqrt(d) > 0 keeps the order)
    // and one fused multiply-add per exponent. exp(x) is 2^(x log2 e) on
    // the special function unit.
    const float sl2 = a.scale * kLog2e;
    auto softmax = [&](auto edge_tag, int k0, float (&corr)[2]) {
      constexpr bool kEdge = decltype(edge_tag)::value;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mp[4] = {kNegInf, kNegInf, kNegInf, kNegInf};
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = sc[4 * j + 2 * h + e];
            if constexpr (kEdge) {
              const int kp = k0 + 8 * j + 2 * quad + e;
              x = kp < a.T && allowed(qp[h], kp, a.causal, a.window)
                      ? x * a.scale
                      : kNegInf;
            }
            mp[j % 4] = fmaxf(mp[j % 4], x);
          }
        float mt = fmaxf(fmaxf(mp[0], mp[1]), fmaxf(mp[2], mp[3]));
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
        if constexpr (!kEdge) mt *= a.scale;
        const float m_new = fmaxf(m[h], mt);
        const float ml2 = m_new * kLog2e;
        float sp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = sc[4 * j + 2 * h + e];
            if constexpr (kEdge) {
              const int kp = k0 + 8 * j + 2 * quad + e;
              x = kp < a.T ? exp2_approx((x - m_new) * kLog2e) : 0.f;
            } else {
              x = exp2_approx(fmaf(x, sl2, -ml2));
            }
            sp[j % 4] += x;
          }
        float sum = (sp[0] + sp[1]) + (sp[2] + sp[3]);
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        corr[h] = exp2_approx((m[h] - m_new) * kLog2e);
        l[h] = l[h] * corr[h] + sum;
        m[h] = m_new;
      }
    };
    // the tile at k0 through the softmax its position asks for
    auto softmax_at = [&](int k0, float (&corr)[2]) {
      const bool edge = k0 + kBK > a.T ||
                        (a.causal && k0 + kBK - 1 > q0) ||
                        (a.window > 0 && k0 <= q_last - a.window);
      if (edge)
        softmax(std::true_type{}, k0, corr);
      else
        softmax(std::false_type{}, k0, corr);
    };
    // p rounded to bf16 as the A fragments of the PV product: 16 keys a
    // step, fragments 2 kk and 2 kk + 1 of S
    auto pack_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
        pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
    };

    float corr[2];
    mbar_wait(&full[0], 0);
    wgmma_fence();
    issue_qk(0);
    wgmma_wait<0>();
    fence_acc(sc);
    softmax_at(k_begin, corr);   // O is still 0: nothing to rescale
    pack_p();
    for (int i = 1; i < n; ++i) {
      const int s = i % kStages, prev = (i - 1) % kStages;
      mbar_wait(&full[s], (i / kStages) & 1);
      wgmma_fence();
      issue_qk(s);
      issue_pv(prev);
      wgmma_wait<1>();          // S of tile i is done, PV of i - 1 runs
      fence_acc(sc);
      softmax_at(k_begin + i * kBK, corr);
      wgmma_wait<0>();
      fence_acc(o);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) fence_regs(pa[kk]);
      mbar_arrive(&empty[prev]);
      // rows whose max did not move keep O as it is (corr = 1)
      if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          o[4 * j + 0] *= corr[0];
          o[4 * j + 1] *= corr[0];
          o[4 * j + 2] *= corr[1];
          o[4 * j + 3] *= corr[1];
        }
      }
      pack_p();
    }
    wgmma_fence();
    issue_pv((n - 1) % kStages);
    wgmma_wait<0>();
    fence_acc(o);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) fence_regs(pa[kk]);
    mbar_arrive(&empty[(n - 1) % kStages]);
  }

  // o[4 j + 2 h + e]: row g + 8 h, column 8 j + 2 quad + e; columns at or
  // past d (even, so a pair lies wholly on one side) are not stored
  const int d = kExact ? D : a.d;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!live[h]) continue;
    if (a.lse != nullptr && quad == 0)
      a.lse[((size_t)b * a.H + head[h]) * a.S + qp[h]] = m[h] + logf(l[h]);
    const float denom = fmaxf(l[h], 1e-20f);
    __nv_bfloat16* dst =
        a.out + ((size_t)(b * a.S + qp[h]) * a.H + head[h]) * d + 2 * quad;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      if (8 * j + 2 * quad < d)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
            __floats2bfloat162_rn(o[4 * j + 2 * h] / denom,
                                  o[4 * j + 2 * h + 1] / denom);
  }
}

// Launch at the host's plan: bq query positions per block (G * bq <=
// 128), head_dim d <= D (a multiple of 8; d == D when kExact). Tensor
// maps are encoded here, per launch, with no device call; the
// shared-memory limit is raised once per instance, so that later
// launches, inside a CUDA graph capture too, make no attribute call.
template <int D, bool kExact>
cudaError_t launch(const __nv_bfloat16* q, const __nv_bfloat16* k,
                   const __nv_bfloat16* v, __nv_bfloat16* out, float* lse,
                   int B, int S, int T_, int H, int Kv, int d, int causal,
                   int window, float scale, int bq, cudaStream_t stream) {
  using L = Layout<D>;
  const int G = H / Kv;
  if (bq < 1 || G * bq > kRows || d < 1 || d > D || d % 8 ||
      (kExact && d != D))
    return cudaErrorInvalidValue;
  Args a;
  const uint64_t e = sizeof(__nv_bfloat16);
  const uint64_t qd[4] = {(uint64_t)d, (uint64_t)H, (uint64_t)S,
                          (uint64_t)B};
  const uint64_t qs[3] = {d * e, (uint64_t)H * d * e,
                          (uint64_t)S * H * d * e};
  const uint32_t qb[4] = {64, (uint32_t)G, (uint32_t)bq, 1};
  const uint64_t kd[4] = {(uint64_t)d, (uint64_t)Kv, (uint64_t)T_,
                          (uint64_t)B};
  const uint64_t ks[3] = {d * e, (uint64_t)Kv * d * e,
                          (uint64_t)T_ * Kv * d * e};
  const uint32_t kb[4] = {64, 1, (uint32_t)kBK, 1};
  if (!make_map_nd(&a.q, q, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, qd, qs, qb,
                   CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map_nd(&a.k, k, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, kd, ks, kb,
                   CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map_nd(&a.v, v, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, kd, ks, kb,
                   CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  a.out = out;
  a.lse = lse;
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
  if (a.n_qt > 65535) return cudaErrorInvalidValue;
  auto kernel = flash_wgmma_kernel<D, kExact>;
  static bool raised = false;
  if (!raised) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::total);
    if (err != cudaSuccess) return err;
    raised = true;
  }
  kernel<<<dim3(B * Kv, a.n_qt), kThreads, L::total, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace wg
}  // namespace flash
