// Paged decode attention for Hopper (sm_90a): one query token per
// sequence over a pool of K/V pages reached through a page table,
//   out[b, h] = softmax(q[b, h] . K_b^T / sqrt(d)) V_b
// where K_b, V_b are the slots t < seq_lens[b] of the pages
// page_table[b, 0..n_max) (ids < 0 are unassigned and masked).
//
// Replaces: src/repro/kernels/paged_attention/kernel.py,
// paged_attention_pallas (body _paged_kernel). Same arithmetic: f32
// scores times 1/sqrt(d), an online softmax with f32 running max and sum,
// masked slots (t >= seq_len, or an unassigned page) contributing p = 0,
// the unnormalised p rounded to v's dtype before the PV product, f32
// sums, and acc / max(l, 1e-20) cast once to q's dtype, so a row with
// seq_len 0 returns 0. Unlike the TPU kernel, which loads page 0 in place
// of an unassigned page and masks it, this kernel never reads a masked
// slot (nor a page id at or past the pool's end). Any page size works.
//
// Bound on an H100 SXM: by bytes. Each valid slot's K and V rows are read
// once, 2 * Kv * d * 2 bytes (bf16) per slot and sequence, for 4 * H * d
// FLOP: llama-3.1-8b at batch 4 over 512 slots reads 8.4 MB, 2.5 us at
// 3.35 TB/s.
//
// What the design does about it:
// - One block per (KV head, sequence, split) handles all G = H / Kv query
//   heads of that KV head, so each K and V row is read from device memory
//   once for the whole group. A row's slots are cut into splits planned on
//   the host from the shapes alone (kernel.py, split_slots), so that the
//   blocks fill every SM.
// - Loads. A producer warp stages the block's slots in chunks of 64 with
//   TMA, into a ring of 2 to 6 stages (up to 128 KB), each with a full and
//   an empty mbarrier: all of a block's bytes are in flight together when
//   its split fits the ring. The tensor maps run
//   over the pool as (d, Kv, n_pool * page) with boxes of 128 bytes of a
//   row (64 bf16 or 32 f32 columns, 128-byte swizzle) by 64, 32, ..., 1
//   rows; a box's coordinates come from the page table on the device. The
//   valid slots of a chunk that lie in one page are cut into boxes of
//   those sizes, so a page longer than 64 slots (the ring of a long
//   prompt, 261) takes several and no box reads a slot past seq_len, an
//   unassigned page or a page id at or past n_pool. Slots never loaded
//   are masked in registers, so whatever their shared memory holds never
//   reaches a sum.
// - Products. Two sets of 4 consumer warps take alternate chunks, each
//   warp 16 slots of its set's chunks. bf16: both products on the tensor
//   cores with mma.sync m16n8k16; the A rows are the G
//   query heads padded to 16 (decode is bound by bytes, and wgmma's 64-row
//   minimum would waste 60 of 64 rows); K fragments by ldmatrix, V by
//   ldmatrix.trans, both conflict-free through the swizzle. f32: on the
//   CUDA cores, a lane per slot and half of d for the scores, then a lane
//   per d / 32 output columns, reading K and V from shared memory.
// - Head dims. 64 and 128 each have their instance (kExact: d is the
//   compile-time D); 96 and 120 run on a D = 128 instance. The tensor maps
//   keep the true d as their inner extent (row pitches of 192 and 240
//   bytes in bf16, 384 and 480 in f32, multiples of 16 as TMA asks), so
//   the boxes past d are zero-filled and still count whole towards a
//   stage's expect-tx bytes. q's columns past d are zero, so those columns
//   add exact zeros to the scores; the output columns past d are never
//   stored, and the merge scratch keeps D.
// - One launch. Each block merges its 8 warps' online softmaxes; with one
//   split that is the output, otherwise the block writes its (acc, max,
//   sum) to `part`, and the last block of a (sequence, KV head) to finish
//   (an atomic counter in `counter`, which it resets to 0 for the next
//   launch and CUDA-graph replay) merges the splits in split order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "../../csrc/hopper.cuh"

namespace {

using namespace ::hopper;

constexpr float kNegInf = -1e30f;
constexpr int kMaxG = 8;            // query heads per KV head
constexpr int kCh = 64;             // slots per chunk (a ring stage)
constexpr int kSets = 2;            // chunks in the consumers' hands at once
constexpr int kSetWarps = 4;        // warps of a set, 16 slots of a chunk each
constexpr int kWarps = kSets * kSetWarps;      // consumer warps
constexpr int kThreads = 32 * (kWarps + 1);    // + the producer warp
constexpr int kBoxSizes = 7;        // box rows 64, 32, ..., 1
constexpr int kRingBytes = 131072;

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int D>
struct Cfg {
  static constexpr int NB = D * (int)sizeof(T) / 128;  // boxes to a row
  static constexpr int EB = 128 / (int)sizeof(T);      // columns to a box
  static constexpr int region = kCh * 128;             // a box of a chunk
  static constexpr int stage_bytes = 2 * NB * region;  // K boxes, V boxes
  // a multiple of kSets, so that a stage always goes to the same set and
  // a set's parity waits on it never alias another set's phase
  static constexpr int fit = kRingBytes / stage_bytes / kSets * kSets;
  static constexpr int stages = fit < kSets ? kSets : (fit > 6 ? 6 : fit);
  static constexpr int total = stages * stage_bytes + 1024;
  // the warps' online softmaxes, merged after the loop in the ring's place
  static_assert(kWarps * kMaxG * (D + 2) * 4 <= stages * stage_bytes,
                "merge scratch fits the ring");
};

struct Args {
  CUtensorMap k[kBoxSizes];   // box rows 64 >> i
  CUtensorMap v[kBoxSizes];
  const void* q;
  void* out;
  float* part;
  int* counter;
  const int* page_table;
  const int* seq_lens;
  int d;      // head_dim <= D (== D when kExact): the row pitch of q,
              // out and the pages
  int H, Kv, n_pool, page, n_max, split, n_split;
  float scale;
};

__device__ __forceinline__ void ldmatrix_x4_t(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// The producer: for each chunk of the block's slots [s0, s1), the boxes
// of its valid slots, page by page, then one arrival on the stage's full
// barrier, with the chunk's valid slots as a bit mask in valid[stage].
template <typename T, int D>
__device__ void produce(const Args& a, uint8_t* ring, uint64_t* full,
                        uint64_t* empty, uint64_t* valid, int b, int kv,
                        int s0, int s1, int nch) {
  using C = Cfg<T, D>;
  for (int i = 0; i < nch; ++i) {
    const int st = i % C::stages;
    mbar_wait(&empty[st], ((i / C::stages) & 1) ^ 1);
    uint8_t* base = ring + st * C::stage_bytes;
    const int c0 = s0 + i * kCh, c1 = min(c0 + kCh, s1);
    uint64_t vm = 0;
    for (int j = c0 / a.page; j * a.page < c1; ++j) {
      const int pid = a.page_table[(size_t)b * a.n_max + j];
      if (pid < 0 || pid >= a.n_pool) continue;
      const int lo = max(c0, j * a.page), hi = min(c1, (j + 1) * a.page);
      int n = hi - lo, row = pid * a.page + (lo - j * a.page), r = lo - c0;
      vm |= (n == 64 ? ~0ull : ((1ull << n) - 1)) << r;
#pragma unroll
      for (int z = 0; z < kBoxSizes; ++z) {
        const int rows = kCh >> z;
        if (!(n & rows)) continue;
        mbar_add_tx(&full[st], 2 * C::NB * rows * 128);
        for (int c = 0; c < C::NB; ++c) {
          tma_load_3d(base + c * C::region + r * 128, &a.k[z], &full[st],
                      c * C::EB, kv, row);
          tma_load_3d(base + (C::NB + c) * C::region + r * 128, &a.v[z],
                      &full[st], c * C::EB, kv, row);
        }
        row += rows;
        r += rows;
      }
    }
    valid[st] = vm;
    mbar_arrive(&full[st]);
  }
}

// bf16 consumer warp: 16 slots of every chunk of its set (chunks i with
// i % kSets == set) on the tensor cores. The warp's online softmax (rows
// g = lane / 4 of the 16; rows g + 8 and rows >= G are padding) ends in m,
// l and o (o[j][e]: row g, column 8 j + 2 (lane % 4) + e).
template <int D>
__device__ void consume_bf16(const Args& a, const uint8_t* ring,
                             uint64_t* full, uint64_t* empty,
                             const uint64_t* valid, int nch, int G, int d,
                             const __nv_bfloat16* q, float& m, float& l,
                             float (&o)[D / 8][4]) {
  using C = Cfg<__nv_bfloat16, D>;
  constexpr int KS = D / 16, DT = D / 8;
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32 % kSetWarps;
  const int set = threadIdx.x / 32 / kSetWarps;
  const int g = lane / 4, c = lane % 4;
  // the A fragments of q: row g (zero past G and at columns past d),
  // rows g + 8 zero
  uint32_t qa[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    qa[ks][1] = qa[ks][3] = 0u;
    qa[ks][0] = qa[ks][2] = 0u;
    if (g < G) {
      const uint32_t* qr = reinterpret_cast<const uint32_t*>(q + g * d);
      if (16 * ks + 2 * c < d) qa[ks][0] = qr[ks * 8 + c];
      if (16 * ks + 8 + 2 * c < d) qa[ks][2] = qr[ks * 8 + c + 4];
    }
  }
  const uint32_t ring_a = smem_u32(ring);
  for (int i = set; i < nch; i += kSets) {
    const int st = i % C::stages;
    mbar_wait(&full[st], (i / C::stages) & 1);
    const uint32_t vm = (uint32_t)(valid[st] >> (16 * w)) & 0xFFFFu;
    if (vm) {
      const uint32_t kb = ring_a + st * C::stage_bytes;
      const uint32_t vb = kb + C::NB * C::region;
      // S (16 x 16 slots): sc[nt][e] is row g, slot 8 nt + 2 c + e
      float sc[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t kf[4];
        const int r = 16 * w + lane % 8 + (lane / 16) * 8;
        ldmatrix_x4(kf, swz(kb + (ks / 4) * C::region, r,
                            (ks % 4) * 2 + (lane / 8) % 2));
        mma_bf16(sc[0], qa[ks], kf[0], kf[1]);
        mma_bf16(sc[1], qa[ks], kf[2], kf[3]);
      }
      bool ok[2][2];
      float mt = kNegInf;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          ok[nt][e] = (vm >> (8 * nt + 2 * c + e)) & 1u;
          sc[nt][e] = ok[nt][e] ? sc[nt][e] * a.scale : kNegInf;
          mt = fmaxf(mt, sc[nt][e]);
        }
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float m_new = fmaxf(m, mt);
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sc[nt][e] = ok[nt][e] ? expf(sc[nt][e] - m_new) : 0.f;
          sum += sc[nt][e];
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float corr = expf(m - m_new);
      l = l * corr + sum;
      m = m_new;
      uint32_t pa[4];
      pa[0] = pack_bf16(sc[0][0], sc[0][1]);
      pa[1] = 0u;
      pa[2] = pack_bf16(sc[1][0], sc[1][1]);
      pa[3] = 0u;
      // slots 2c, 2c + 1 (keep0) and 8 + 2c, 9 + 2c (keep1) of the warp's
      // 16 in the V fragments: a masked slot's shared row was never loaded
      const uint32_t keep0 = (ok[0][0] ? 0xFFFFu : 0u) |
                             (ok[0][1] ? 0xFFFF0000u : 0u);
      const uint32_t keep1 = (ok[1][0] ? 0xFFFFu : 0u) |
                             (ok[1][1] ? 0xFFFF0000u : 0u);
      const int r = 16 * w + lane % 16;
#pragma unroll
      for (int j = 0; j < DT; j += 2) {
        o[j][0] *= corr;
        o[j][1] *= corr;
        o[j + 1][0] *= corr;
        o[j + 1][1] *= corr;
        const int chunk = j + lane / 16;    // 8-column chunk of d
        uint32_t vf[4];
        ldmatrix_x4_t(vf, swz(vb + (chunk / 8) * C::region, r, chunk % 8));
        mma_bf16(o[j], pa, vf[0] & keep0, vf[1] & keep1);
        mma_bf16(o[j + 1], pa, vf[2] & keep0, vf[3] & keep1);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }
}

// f32 consumer warp on the CUDA cores, over the chunks of its set: lane
// l scores slot l % 16 of the warp's 16 over half l / 16 of d, then keeps the output sums of columns
// l * D / 32 .. + D / 32 - 1 (acc[g][cc]) for the G heads.
template <int D>
__device__ void consume_f32(const Args& a, const uint8_t* ring,
                            uint64_t* full, uint64_t* empty,
                            const uint64_t* valid, int nch, int G,
                            const float (*qs)[D], float (&m)[kMaxG],
                            float (&l)[kMaxG], float (&acc)[kMaxG][D / 32]) {
  using C = Cfg<float, D>;
  constexpr int DPL = D / 32;
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32 % kSetWarps;
  const int set = threadIdx.x / 32 / kSetWarps;
  const int jj = lane % 16, half = lane / 16;
  for (int i = set; i < nch; i += kSets) {
    const int st = i % C::stages;
    mbar_wait(&full[st], (i / C::stages) & 1);
    const uint32_t vm = (uint32_t)(valid[st] >> (16 * w)) & 0xFFFFu;
    if (vm) {
      const uint8_t* kb = ring + st * C::stage_bytes;
      const uint8_t* vb = kb + C::NB * C::region;
      const int r = 16 * w + jj;
      const bool mine = (vm >> jj) & 1u;
      float s[kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) s[g] = 0.f;
      if (mine) {
#pragma unroll 4
        for (int e = half * D / 2; e < (half + 1) * D / 2; e += 4) {
          const float4 kk = *reinterpret_cast<const float4*>(
              kb + (e / 32) * C::region + r * 128 +
              ((((e % 32) / 4) ^ (r & 7)) << 4));
#pragma unroll
          for (int g = 0; g < kMaxG; ++g) {
            if (g < G) {
              const float4 qv = *reinterpret_cast<const float4*>(&qs[g][e]);
              s[g] = fmaf(qv.x, kk.x, s[g]);
              s[g] = fmaf(qv.y, kk.y, s[g]);
              s[g] = fmaf(qv.z, kk.z, s[g]);
              s[g] = fmaf(qv.w, kk.w, s[g]);
            }
          }
        }
      }
      float p[kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        p[g] = 0.f;
        if (g >= G) continue;
        s[g] += __shfl_xor_sync(0xffffffffu, s[g], 16);
        const float sg = mine ? s[g] * a.scale : kNegInf;
        float mt = sg;
#pragma unroll
        for (int o = 8; o > 0; o >>= 1)
          mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
        const float m_new = fmaxf(m[g], mt);
        const float pg = mine ? expf(sg - m_new) : 0.f;
        float sum = pg;
#pragma unroll
        for (int o = 8; o > 0; o >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
        const float corr = expf(m[g] - m_new);
        l[g] = l[g] * corr + sum;
        m[g] = m_new;
#pragma unroll
        for (int cc = 0; cc < DPL; ++cc) acc[g][cc] *= corr;
        p[g] = pg;
      }
      const int col = lane * DPL;
      const uint8_t* vcol = vb + (col / 32) * C::region;
      const int vch = (col % 32) / 4, vin = (col % 4) * 4;
      for (int u = 0; u < 16; ++u) {
        if (!((vm >> u) & 1u)) continue;
        const int ru = 16 * w + u;
        const float* vr = reinterpret_cast<const float*>(
            vcol + ru * 128 + ((vch ^ (ru & 7)) << 4) + vin);
        float vv[DPL];
#pragma unroll
        for (int cc = 0; cc < DPL; ++cc) vv[cc] = vr[cc];
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) {
          if (g < G) {
            const float pj = __shfl_sync(0xffffffffu, p[g], u);
#pragma unroll
            for (int cc = 0; cc < DPL; ++cc)
              acc[g][cc] = fmaf(pj, vv[cc], acc[g][cc]);
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }
}

template <typename T, int D, bool kExact>
__global__ void __launch_bounds__(kThreads)
    paged_kernel(const __grid_constant__ Args a) {
  using C = Cfg<T, D>;
  const int d = kExact ? D : a.d;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[C::stages], empty[C::stages];
  __shared__ uint64_t valid[C::stages];
  __shared__ __align__(16) float qs[std::is_same<T, float>::value ? kMaxG
                                                                   : 1][D];
  __shared__ int is_last;
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int G = a.H / a.Kv;
  const int kv = blockIdx.x, b = blockIdx.y, z = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const T* q = static_cast<const T*>(a.q) + ((size_t)b * a.H + kv * G) * d;

  // this block's slots [s0, s1) of the row, in chunks of 64
  const int L = max(0, min(a.seq_lens[b], a.n_max * a.page));
  const int s0 = z * a.split, s1 = min(L, s0 + a.split);
  const int nch = s1 > s0 ? (s1 - s0 + kCh - 1) / kCh : 0;

  if (tid == 0) {
    for (int s = 0; s < C::stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kSetWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (std::is_same<T, float>::value)
    for (int i = tid; i < G * D; i += kThreads)
      qs[i / D][i % D] = i % D < d ? q[i / D * d + i % D] : 0.f;
  __syncthreads();

  // the warps' online softmaxes: rows g < G, columns as each path keeps them
  float m[kMaxG], l[kMaxG];
  float o[D / 8][4];                 // bf16: row g = lane / 4
  float acc[kMaxG][D / 32];          // f32
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int cc = 0; cc < D / 32; ++cc) acc[g][cc] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  if (warp == kWarps) {
    if (lane == 0)
      produce<T, D>(a, ring, full, empty, valid, b, kv, s0, s1, nch);
  } else if constexpr (std::is_same<T, float>::value) {
    consume_f32<D>(a, ring, full, empty, valid, nch, G, qs, m, l, acc);
  } else {
    consume_bf16<D>(a, ring, full, empty, valid, nch, G, d, q, m[0], l[0],
                    o);
  }
  __syncthreads();   // every stage consumed: the ring is scratch now

  // merge the consumer warps' online softmaxes, warp by warp
  float* mw = reinterpret_cast<float*>(ring);          // [kWarps][kMaxG]
  float* lw = mw + kWarps * kMaxG;                     // [kWarps][kMaxG]
  float* aw = lw + kWarps * kMaxG;                     // [kWarps][kMaxG][D]
  if (warp < kWarps) {
    if constexpr (std::is_same<T, float>::value) {
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g >= G) break;
        if (lane == 0) {
          mw[warp * kMaxG + g] = m[g];
          lw[warp * kMaxG + g] = l[g];
        }
#pragma unroll
        for (int cc = 0; cc < D / 32; ++cc)
          aw[(warp * kMaxG + g) * D + lane * (D / 32) + cc] = acc[g][cc];
      }
    } else {
      const int g = lane / 4;
      if (g < G) {
        if (lane % 4 == 0) {
          mw[warp * kMaxG + g] = m[0];
          lw[warp * kMaxG + g] = l[0];
        }
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            aw[(warp * kMaxG + g) * D + 8 * j + 2 * (lane % 4) + e] = o[j][e];
      }
    }
  }
  __syncthreads();
  T* out = static_cast<T*>(a.out) + ((size_t)b * a.H + kv * G) * d;
  float* pp = a.n_split > 1
                  ? a.part + (((size_t)b * a.Kv + kv) * a.n_split + z) *
                                 kMaxG * (D + 2)
                  : nullptr;
  for (int i = tid; i < G * d; i += kThreads) {
    const int g = i / d, e = i % d;
    float mx = kNegInf;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, mw[w * kMaxG + g]);
    float num = 0.f, den = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(mw[w * kMaxG + g] - mx);
      num = fmaf(aw[(w * kMaxG + g) * D + e], f, num);
      den = fmaf(lw[w * kMaxG + g], f, den);
    }
    if (pp) {
      pp[g * (D + 2) + e] = num;
      if (e == 0) {
        pp[g * (D + 2) + D] = mx;
        pp[g * (D + 2) + D + 1] = den;
      }
    } else {
      out[i] = from_f<T>(num / fmaxf(den, 1e-20f));
    }
  }
  if (!pp) return;

  // the last split of (b, kv) to finish merges all of them, in order
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* cnt = a.counter + (size_t)b * a.Kv + kv;
    const int done = atomicAdd(cnt, 1);
    is_last = done == a.n_split - 1;
    if (is_last) *cnt = 0;   // ready for the next launch or graph replay
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const float* p0 =
      a.part + ((size_t)b * a.Kv + kv) * a.n_split * kMaxG * (D + 2);
  constexpr int kStride = kMaxG * (D + 2);
  for (int i = tid; i < G * d; i += kThreads) {
    const int g = i / d, e = i % d;
    float mx = kNegInf;
    for (int s = 0; s < a.n_split; ++s)
      mx = fmaxf(mx, __ldcg(p0 + s * kStride + g * (D + 2) + D));
    float num = 0.f, den = 0.f;
    for (int s = 0; s < a.n_split; ++s) {
      const float* ps = p0 + s * kStride + g * (D + 2);
      const float f = expf(__ldcg(ps + D) - mx);
      num = fmaf(__ldcg(ps + e), f, num);
      den = fmaf(__ldcg(ps + D + 1), f, den);
    }
    out[i] = from_f<T>(num / fmaxf(den, 1e-20f));
  }
}

template <typename T, int D, bool kExact>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const int* pt, const int* lens, void* out, float* part,
                   int* counter, int B, int H, int Kv, int d, int n_pool,
                   int page, int n_max, int split, int n_split, float scale,
                   cudaStream_t stream) {
  using C = Cfg<T, D>;
  if (split % kCh || (n_split > 1 && (!part || !counter)) ||
      (uint64_t)n_pool * page >= (1ull << 31) || d < 1 || d > D || d % 8 ||
      (kExact && d != D))
    return cudaErrorInvalidValue;
  Args a = {};
  if (n_pool > 0) {
    const CUtensorMapDataType type = sizeof(T) == 4
                                         ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                         : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    const uint64_t dims[3] = {(uint64_t)d, (uint64_t)Kv,
                              (uint64_t)n_pool * page};
    const uint64_t strides[2] = {d * sizeof(T), (uint64_t)Kv * d * sizeof(T)};
    for (int z = 0; z < kBoxSizes; ++z) {
      const uint32_t box[3] = {(uint32_t)C::EB, 1, (uint32_t)(kCh >> z)};
      if (!make_map_nd(&a.k[z], kp, type, 3, dims, strides, box,
                       CU_TENSOR_MAP_SWIZZLE_128B) ||
          !make_map_nd(&a.v[z], vp, type, 3, dims, strides, box,
                       CU_TENSOR_MAP_SWIZZLE_128B))
        return cudaErrorInvalidValue;
    }
  }
  a.q = q;
  a.out = out;
  a.part = part;
  a.counter = counter;
  a.page_table = pt;
  a.seq_lens = lens;
  a.d = d;
  a.H = H;
  a.Kv = Kv;
  a.n_pool = n_pool;
  a.page = page;
  a.n_max = n_max;
  a.split = split;
  a.n_split = n_split;
  a.scale = scale;
  auto kernel = paged_kernel<T, D, kExact>;
  // raised once per instance, so that later launches, inside a CUDA graph
  // capture too, make no attribute call
  static bool raised = false;
  if (!raised) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::total);
    if (err != cudaSuccess) return err;
    raised = true;
  }
  kernel<<<dim3(Kv, B, n_split), kThreads, C::total, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* kp, const void* vp,
                     const int* pt, const int* lens, void* out, float* part,
                     int* counter, int B, int H, int Kv, int D, int n_pool,
                     int page, int n_max, int split, int n_split, float scale,
                     cudaStream_t s) {
  if (D == 64)
    return launch<T, 64, true>(q, kp, vp, pt, lens, out, part, counter, B, H,
                               Kv, D, n_pool, page, n_max, split, n_split,
                               scale, s);
  if (D == 128)
    return launch<T, 128, true>(q, kp, vp, pt, lens, out, part, counter, B,
                                H, Kv, D, n_pool, page, n_max, split,
                                n_split, scale, s);
  if (D == 96 || D == 120)
    return launch<T, 128, false>(q, kp, vp, pt, lens, out, part, counter, B,
                                 H, Kv, D, n_pool, page, n_max, split,
                                 n_split, scale, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// q and out (B, H, D); k_pages and v_pages (n_pool, page, Kv, D);
// page_table (B, n_max) int32, -1 for an unassigned page; seq_lens (B,)
// int32. All contiguous and 16-byte aligned; bf16 when is_bf16 else f32.
// D is 64, 96, 120 or 128; G = H / Kv is at most 8. Each row's n_max *
// page slots are cut into n_split splits of `split` slots (a multiple of
// 64), one block per (KV head, row, split). With more than one split,
// `part` is f32 scratch of B * Kv * n_split * 8 * (D' + 2) floats, D' the
// instance's width (64 for D = 64, else 128), and `counter` B *
// Kv int32 that are 0 before the launch (and are left 0 after it). One
// launch; does not synchronise; returns cudaGetLastError() of the launch.
extern "C" int paged_attention_launch(const void* q, const void* k_pages,
                                      const void* v_pages,
                                      const void* page_table,
                                      const void* seq_lens, void* out,
                                      void* part, void* counter, int B, int H,
                                      int Kv, int D, int n_pool, int page,
                                      int n_max, int split, int n_split,
                                      float scale, int is_bf16, void* stream) {
  if (Kv <= 0 || H % Kv || H / Kv > kMaxG || split <= 0 || n_split <= 0 ||
      page <= 0)
    return (int)cudaErrorInvalidValue;
  const int* pt = static_cast<const int*>(page_table);
  const int* lens = static_cast<const int*>(seq_lens);
  float* pf = static_cast<float*>(part);
  int* cnt = static_cast<int*>(counter);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)launch_d<__nv_bfloat16>(q, k_pages, v_pages, pt, lens, out,
                                        pf, cnt, B, H, Kv, D, n_pool, page,
                                        n_max, split, n_split, scale, s);
  return (int)launch_d<float>(q, k_pages, v_pages, pt, lens, out, pf, cnt, B,
                              H, Kv, D, n_pool, page, n_max, split, n_split,
                              scale, s);
}
