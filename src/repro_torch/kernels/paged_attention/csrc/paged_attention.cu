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
// What the design does about it: one block per (sequence, KV head, split)
// handles all G = H / Kv query heads of that KV head, so each K and V row
// is read from device memory once for the whole group. A row's slots are
// cut into splits (chosen on the host from the shapes, so that the blocks
// fill every SM twice over), and a second small kernel merges the splits'
// online softmaxes; batch 1 over 4096 slots runs 128 blocks rather than 8.
// In a block, 8 warps take turns over chunks of 32 slots. In a chunk a
// lane issues all the 16-byte loads of one slot's K row before it uses
// any, and computes its G scores against q in shared memory; the chunk's
// max and sum are warp shuffles; then the warp walks the chunk's slots 16
// at a time, each lane loading d / 32 columns of the 16 V rows before it
// multiplies and keeping the output sums for its columns. The 8 warps'
// online softmaxes are merged in shared memory. The products run on the
// CUDA cores in f32. K and V go through registers with plain loads:
// staging them in shared memory with cp.async or TMA is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;            // query heads per KV head
constexpr int kBatch = 16;          // V rows a warp loads before using them

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
}
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// N consecutive elements of T at src (N * sizeof(T) bytes, aligned to
// that), widened to floats
template <typename T, int N>
__device__ __forceinline__ void load_cols(float (&dst)[N], const T* src) {
  if constexpr (sizeof(T) == 4) {
    static_assert(N == 2 || N == 4, "columns per lane");
    if constexpr (N == 4) {
      const float4 t = *reinterpret_cast<const float4*>(src);
      dst[0] = t.x; dst[1] = t.y; dst[2] = t.z; dst[3] = t.w;
    } else {
      const float2 t = *reinterpret_cast<const float2*>(src);
      dst[0] = t.x; dst[1] = t.y;
    }
  } else {
    static_assert(N == 2 || N == 4, "columns per lane");
    if constexpr (N == 4) {
      const uint2 raw = *reinterpret_cast<const uint2*>(src);
      const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
      for (int i = 0; i < 4; ++i) dst[i] = to_f(h[i]);
    } else {
      const unsigned raw = *reinterpret_cast<const unsigned*>(src);
      const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
      dst[0] = to_f(h[0]);
      dst[1] = to_f(h[1]);
    }
  }
}

// the 16 / sizeof(T) values of T in a 16-byte word, widened to floats
template <typename T>
__device__ __forceinline__ void widen16(float (&dst)[16 / sizeof(T)],
                                        const uint4& raw) {
  if constexpr (sizeof(T) == 4) {
    dst[0] = __uint_as_float(raw.x); dst[1] = __uint_as_float(raw.y);
    dst[2] = __uint_as_float(raw.z); dst[3] = __uint_as_float(raw.w);
  } else {
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[i] = to_f(h[i]);
  }
}

template <int D>
struct Smem {
  float q[kMaxG][D];
  float m[kWarps][kMaxG];
  float l[kWarps][kMaxG];
  float acc[kWarps][kMaxG][D];
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    paged_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                 const T* __restrict__ v_pages,
                 const int* __restrict__ page_table,
                 const int* __restrict__ seq_lens, T* __restrict__ out,
                 float* __restrict__ part, int H, int Kv, int n_pool,
                 int page, int n_max, int split, float scale) {
  __shared__ __align__(16) Smem<D> sm;
  constexpr int E = 16 / (int)sizeof(T);    // elements per 16-byte load
  constexpr int DPL = D / 32;               // V columns per lane
  const int G = H / Kv;
  const int kv = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  for (int i = tid; i < G * D; i += kThreads)
    sm.q[i / D][i % D] = to_f(q[((size_t)b * H + kv * G) * D + i]);
  __syncthreads();

  // this block's slots [s0, s1) of the row
  const int L = max(0, min(seq_lens[b], n_max * page));
  const int s0 = blockIdx.z * split, s1 = min(L, s0 + split);
  float m[kMaxG], l[kMaxG], acc[kMaxG][DPL];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[g][c] = 0.f;
  }

  for (int c0 = s0 + warp * 32; c0 < s1; c0 += kWarps * 32) {
    // this lane's slot, and the element offset of its K/V row (-1: masked)
    const int t = c0 + lane;
    long long row = -1;
    if (t < s1) {
      const int pid = page_table[(size_t)b * n_max + t / page];
      if (pid >= 0 && pid < n_pool)
        row = (((long long)pid * page + t % page) * Kv + kv) * D;
    }
    float s[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) s[g] = 0.f;
    if (row >= 0) {
      // the lane's K row in batches of up to 16 16-byte loads, all issued
      // before the first is used
      constexpr int NB = D / E < 16 ? D / E : 16;
      const T* kr = k_pages + row;
#pragma unroll
      for (int e0 = 0; e0 < D; e0 += NB * E) {
        uint4 raw[NB];
#pragma unroll
        for (int i = 0; i < NB; ++i)
          raw[i] = *reinterpret_cast<const uint4*>(kr + e0 + i * E);
#pragma unroll
        for (int i = 0; i < NB; ++i) {
          float kk[E];
          widen16<T>(kk, raw[i]);
          const int e = e0 + i * E;
#pragma unroll
          for (int g = 0; g < kMaxG; ++g) {
            if (g < G) {
#pragma unroll
              for (int j = 0; j < E; j += 4) {
                const float4 qv =
                    *reinterpret_cast<const float4*>(&sm.q[g][e + j]);
                s[g] = fmaf(qv.x, kk[j], s[g]);
                s[g] = fmaf(qv.y, kk[j + 1], s[g]);
                s[g] = fmaf(qv.z, kk[j + 2], s[g]);
                s[g] = fmaf(qv.w, kk[j + 3], s[g]);
              }
            }
          }
        }
      }
    }

    float p[kMaxG] = {};
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g >= G) break;
      const float sg = row >= 0 ? s[g] * scale : kNegInf;
      float mt = sg;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      const float m_new = fmaxf(m[g], mt);
      const float pg = row >= 0 ? expf(sg - m_new) : 0.f;
      float sum = pg;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float corr = expf(m[g] - m_new);
      l[g] = l[g] * corr + sum;
      m[g] = m_new;
#pragma unroll
      for (int c = 0; c < DPL; ++c) acc[g][c] *= corr;
      p[g] = round_to<T>(pg);
    }

    // acc += p @ v over the chunk's slots, f32 sums. The V rows of kBatch
    // slots are loaded before any is used, so that many loads are in
    // flight; a masked slot loads nothing and adds p = 0 times 0.
    const int n = min(32, s1 - c0);
    for (int j0 = 0; j0 < n; j0 += kBatch) {
      float vv[kBatch][DPL];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const long long rj = __shfl_sync(0xffffffffu, row, j0 + u);
        if (rj >= 0) {
          load_cols<T, DPL>(vv[u], v_pages + rj + lane * DPL);
        } else {
#pragma unroll
          for (int c = 0; c < DPL; ++c) vv[u][c] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) {
          if (g < G) {
            const float pj = __shfl_sync(0xffffffffu, p[g], j0 + u);
#pragma unroll
            for (int c = 0; c < DPL; ++c)
              acc[g][c] = fmaf(pj, vv[u][c], acc[g][c]);
          }
        }
      }
    }
  }

  // merge the warps' online softmaxes
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g >= G) break;
    if (lane == 0) {
      sm.m[warp][g] = m[g];
      sm.l[warp][g] = l[g];
    }
#pragma unroll
    for (int c = 0; c < DPL; ++c) sm.acc[warp][g][lane * DPL + c] = acc[g][c];
  }
  __syncthreads();
  // with one split the block's result is the output; otherwise its
  // (acc, max, sum) go to part[b][kv][split] for paged_merge
  float* pp = part ? part + (((size_t)b * Kv + kv) * gridDim.z + blockIdx.z) *
                                kMaxG * (D + 2)
                   : nullptr;
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, e = i % D;
    float mx = kNegInf;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm.m[w][g]);
    float num = 0.f, den = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(sm.m[w][g] - mx);
      num = fmaf(sm.acc[w][g][e], f, num);
      den = fmaf(sm.l[w][g], f, den);
    }
    if (pp) {
      pp[g * (D + 2) + e] = num;
      if (e == 0) {
        pp[g * (D + 2) + D] = mx;
        pp[g * (D + 2) + D + 1] = den;
      }
    } else {
      out[((size_t)b * H + kv * G) * D + i] =
          from_f<T>(num / fmaxf(den, 1e-20f));
    }
  }
}

// Merge the splits of one (sequence, KV head): the same online-softmax
// merge as the warps' above, over part[b][kv][0..n_split).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    paged_merge(const float* __restrict__ part, T* __restrict__ out, int H,
                int Kv, int n_split) {
  const int G = H / Kv;
  const int kv = blockIdx.x, b = blockIdx.y;
  const float* pp = part + ((size_t)b * Kv + kv) * n_split * kMaxG * (D + 2);
  constexpr int kStride = kMaxG * (D + 2);
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int g = i / D, e = i % D;
    float mx = kNegInf;
    for (int z = 0; z < n_split; ++z)
      mx = fmaxf(mx, pp[z * kStride + g * (D + 2) + D]);
    float num = 0.f, den = 0.f;
    for (int z = 0; z < n_split; ++z) {
      const float* pz = pp + z * kStride + g * (D + 2);
      const float f = expf(pz[D] - mx);
      num = fmaf(pz[e], f, num);
      den = fmaf(pz[D + 1], f, den);
    }
    out[((size_t)b * H + kv * G) * D + i] =
        from_f<T>(num / fmaxf(den, 1e-20f));
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const int* pt, const int* lens, void* out, float* part,
                   int B, int H, int Kv, int n_pool, int page, int n_max,
                   int split, float scale, cudaStream_t stream) {
  const int n_split = (n_max * page + split - 1) / split;
  dim3 grid(Kv, B, n_split);
  paged_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), pt, lens, static_cast<T*>(out),
      n_split > 1 ? part : nullptr, H, Kv, n_pool, page, n_max, split,
      scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  paged_merge<T, D><<<dim3(Kv, B), kThreads, 0, stream>>>(
      part, static_cast<T*>(out), H, Kv, n_split);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* kp, const void* vp,
                     const int* pt, const int* lens, void* out, float* part,
                     int B, int H, int Kv, int D, int n_pool, int page,
                     int n_max, int split, float scale, cudaStream_t s) {
  if (D == 64)
    return launch<T, 64>(q, kp, vp, pt, lens, out, part, B, H, Kv, n_pool,
                         page, n_max, split, scale, s);
  if (D == 128)
    return launch<T, 128>(q, kp, vp, pt, lens, out, part, B, H, Kv, n_pool,
                          page, n_max, split, scale, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// q and out (B, H, D); k_pages and v_pages (n_pool, page, Kv, D);
// page_table (B, n_max) int32, -1 for an unassigned page; seq_lens (B,)
// int32. All contiguous and 16-byte aligned; bf16 when is_bf16 else f32.
// D is 64 or 128; G = H / Kv is at most 8. Each row's n_max * page slots
// are cut into splits of `split` slots (a multiple of 32), one block per
// (KV head, row, split); with more than one split, `part` is f32 scratch
// of B * Kv * n_split * 8 * (D + 2) floats and a second kernel merges the
// splits. Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() of the launches.
extern "C" int paged_attention_launch(const void* q, const void* k_pages,
                                      const void* v_pages,
                                      const void* page_table,
                                      const void* seq_lens, void* out,
                                      void* part, int B, int H, int Kv,
                                      int D, int n_pool, int page, int n_max,
                                      int split, float scale, int is_bf16,
                                      void* stream) {
  if (Kv <= 0 || H % Kv || H / Kv > kMaxG || split <= 0 || split % 32)
    return (int)cudaErrorInvalidValue;
  const int* pt = static_cast<const int*>(page_table);
  const int* lens = static_cast<const int*>(seq_lens);
  float* pf = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)launch_d<__nv_bfloat16>(q, k_pages, v_pages, pt, lens, out,
                                        pf, B, H, Kv, D, n_pool, page, n_max,
                                        split, scale, s);
  return (int)launch_d<float>(q, k_pages, v_pages, pt, lens, out, pf, B, H,
                              Kv, D, n_pool, page, n_max, split, scale, s);
}
