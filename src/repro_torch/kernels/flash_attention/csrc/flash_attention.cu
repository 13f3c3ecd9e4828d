// Flash attention (prefill) for Hopper (sm_90a):
//   out (B, S, H, d) = softmax(q k^T / sqrt(d) + mask) v
// with q (B, S, H, d), k and v (B, T, Kv, d), query head h reading KV head
// h / G (G = H / Kv), a causal mask (key <= query, both counted from 0) and
// an optional sliding window (key > query - window).
//
// Replaces: src/repro/kernels/flash_attention/kernel.py,
// flash_attention_pallas (body _flash_kernel). Same arithmetic: f32
// scores times 1/sqrt(d), masked entries set to the finite -1e30 (never
// -inf, so a row whose first tiles are wholly masked adds exp(0) terms
// that the next real score wipes with corr = exp(-1e30 - m) = 0, as on
// the TPU), an online softmax over key tiles with f32 running max and
// sum, the unnormalised p rounded to v's dtype before the PV product, f32
// sums, and acc / max(l, 1e-20) cast once to q's dtype. Unlike the Pallas
// kernel it takes any S, T >= 1: keys past T get p = 0 and rows past S
// are not stored. Given an lse pointer (training), each row also stores
// its logsumexp m + log(l) in f32, (B, H, S), which the backward
// (flash_attention_bwd.cu) recomputes P from; with a null pointer nothing
// else changes.
//
// Bound on an H100 SXM: by operations. A causal llama-3.1-8b prefill of
// S = 2048 tokens does 2 * 2 * H * d * S(S+1)/2 = 34 GFLOP per layer over
// 42 MB of bf16 q, k, v and out: 0.035 ms at the bf16 tensor-core peak
// against 0.013 ms for the bytes. In f32 (no TF32) the 67 TFLOP/s of the
// CUDA cores make it 0.51 ms.
//
// What the design does about it: a block owns all G query heads of one
// KV head for a run of query positions, so each K/V tile is read from
// device memory once for the whole group and never repeated per query
// head, and walks only the key tiles of 64 keys that its rows may see
// (causal tiles past the diagonal, and tiles wholly before the window, are
// skipped). bf16 runs flash_wgmma.cuh: 128 rows a block, a TMA ring and
// both products on wgmma, warp-specialised. f32 (flash_kernel below) runs
// on the CUDA cores, since TF32 would round the inputs: 64 rows a block, 8
// warps of 8 rows, K, V and Q staged as f32, a lane computing the scores
// of 2 keys, p through shared memory, and a lane keeping the output sums
// of D / 32 columns.
//
// Head dims: 64 and 128 each have their instance (kExact: d is the
// compile-time D, so their strides and masks fold away); 96 and 120 run on
// a D = 128 instance with the true d in the row strides. bf16 loads them
// with tensor maps whose boxes TMA zero-fills past d (flash_wgmma.cuh);
// f32 loads columns below d and zeroes the rest. The zero columns add
// exact zeros to the scores, and output columns at or past d are not
// stored.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "flash_wgmma.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 64;                   // (position, head) rows a block owns
constexpr int kRowsPerWarp = kRows / kWarps;
constexpr int kBK = 64;                     // keys per tile

// 4 floats (16 bytes) from src to dst, both 16-byte aligned
__device__ __forceinline__ void load16(float* dst, const float* src) {
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
}

__device__ __forceinline__ void zero16(float* dst) {
  *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
}

// a lane's N consecutive columns of a shared f32 row, as one vector load
template <int N>
__device__ __forceinline__ void load_cols(float (&dst)[N], const float* src) {
  static_assert(N == 2 || N == 4, "columns per lane");
  if constexpr (N == 4) {
    const float4 t = *reinterpret_cast<const float4*>(src);
    dst[0] = t.x; dst[1] = t.y; dst[2] = t.z; dst[3] = t.w;
  } else {
    const float2 t = *reinterpret_cast<const float2*>(src);
    dst[0] = t.x; dst[1] = t.y;
  }
}

// the same key tiles and mask as the bf16 kernel
using flash::wg::allowed;
using flash::wg::key_range;

template <int D>
struct Smem {
  static constexpr int kStride = D + 4;     // K rows: conflict-free float4
  float q[kRows][D];
  float k[kBK][kStride];
  float v[kBK][D];
  float p[kRows][kBK];
};

// D: the instance's columns; d <= D (a multiple of 4) the head_dim, the
// row pitch of q, k, v and out; kExact: d == D
template <int D, bool kExact>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, int S,
                 int T_, int H, int Kv, int d_arg, int causal, int window,
                 float scale) {
  const int d = kExact ? D : d_arg;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(smem_raw);
  constexpr int E = 4;                      // floats per 16-byte piece
  constexpr int CPR = D / E;                // pieces per row
  constexpr int DPL = D / 32;               // output columns per lane

  const int G = H / Kv;
  const int BQ = kRows / G;                 // query positions per block
  const int rows = BQ * G;
  const int b = blockIdx.y / Kv, kv = blockIdx.y % Kv;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int r0 = warp * kRowsPerWarp;

  // query tile: row r is position q0 + r / G, head kv * G + r % G
  for (int c = tid; c < kRows * CPR; c += kThreads) {
    const int r = c / CPR, e = (c % CPR) * E;
    const int qi = q0 + r / G;
    if (r < rows && qi < S && e < d)
      load16(&sm.q[r][e],
                q + ((size_t)(b * S + qi) * H + kv * G + r % G) * d + e);
    else
      zero16(&sm.q[r][e]);
  }

  int qpos[kRowsPerWarp];
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DPL];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    qpos[i] = q0 + (r0 + i) / G;
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[i][c] = 0.f;
  }

  int k_begin, k_end;
  key_range(q0, BQ, S, T_, causal, window, k_begin, k_end);
  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();   // the previous tile's K and V are no longer read
    const int nk = min(kBK, T_ - k0);
    for (int c = tid; c < kBK * CPR; c += kThreads) {
      const int j = c / CPR, e = (c % CPR) * E;
      if (j < nk && e < d) {
        const size_t off = ((size_t)(b * T_ + k0 + j) * Kv + kv) * d + e;
        load16(&sm.k[j][e], k + off);
        load16(&sm.v[j][e], v + off);
      } else {
        zero16(&sm.k[j][e]);
        zero16(&sm.v[j][e]);
      }
    }
    __syncthreads();

    // scores of keys k0 + lane and k0 + lane + 32 for the warp's 8 rows
    float s[kRowsPerWarp][2];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 4
    for (int e = 0; e < D; e += 4) {
      const float4 ka = *reinterpret_cast<const float4*>(&sm.k[lane][e]);
      const float4 kb =
          *reinterpret_cast<const float4*>(&sm.k[lane + 32][e]);
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(&sm.q[r0 + i][e]);
        s[i][0] = fmaf(qv.x, ka.x, s[i][0]);
        s[i][0] = fmaf(qv.y, ka.y, s[i][0]);
        s[i][0] = fmaf(qv.z, ka.z, s[i][0]);
        s[i][0] = fmaf(qv.w, ka.w, s[i][0]);
        s[i][1] = fmaf(qv.x, kb.x, s[i][1]);
        s[i][1] = fmaf(qv.y, kb.y, s[i][1]);
        s[i][1] = fmaf(qv.z, kb.z, s[i][1]);
        s[i][1] = fmaf(qv.w, kb.w, s[i][1]);
      }
    }

    float corr[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      float mt = kNegInf;
      bool exists[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kp = k0 + lane + 32 * h;
        exists[h] = kp < T_;
        const bool allow = exists[h] && allowed(qpos[i], kp, causal, window);
        s[i][h] = allow ? s[i][h] * scale : kNegInf;
        mt = fmaxf(mt, s[i][h]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      const float m_new = fmaxf(m[i], mt);
      float sum = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float p = exists[h] ? expf(s[i][h] - m_new) : 0.f;
        sum += p;
        sm.p[r0 + i][lane + 32 * h] = p;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      corr[i] = expf(m[i] - m_new);
      l[i] = l[i] * corr[i] + sum;
      m[i] = m_new;
    }
    __syncwarp();

    // acc = acc * corr + p @ v over the tile's keys, f32 sums
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
      for (int c = 0; c < DPL; ++c) acc[i][c] *= corr[i];
    for (int j = 0; j < kBK; j += 4) {
      float4 pv[kRowsPerWarp];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i)
        pv[i] = *reinterpret_cast<const float4*>(&sm.p[r0 + i][j]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float vv[DPL];
        load_cols<DPL>(vv, &sm.v[j + jj][lane * DPL]);
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          const float pj = jj == 0 ? pv[i].x
                         : jj == 1 ? pv[i].y
                         : jj == 2 ? pv[i].z
                                   : pv[i].w;
#pragma unroll
          for (int c = 0; c < DPL; ++c) acc[i][c] = fmaf(pj, vv[c], acc[i][c]);
        }
      }
    }
    __syncwarp();      // the warp's p rows are read before the next tile
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = r0 + i;
    const int qi = q0 + r / G;
    if (r >= rows || qi >= S) continue;
    if (lse != nullptr && lane == 0)
      lse[((size_t)b * H + kv * G + r % G) * S + qi] = m[i] + logf(l[i]);
    if (lane * DPL >= d) continue;
    const float denom = fmaxf(l[i], 1e-20f);
    float* o =
        out + ((size_t)(b * S + qi) * H + kv * G + r % G) * d + lane * DPL;
#pragma unroll
    for (int c = 0; c < DPL; ++c) o[c] = acc[i][c] / denom;
  }
}

// Launch `kernel` with `smem` bytes of dynamic shared memory. The limit
// is raised once per kernel (`ready`), so that later launches, inside a
// CUDA graph capture too, make no attribute call.
template <typename Kernel, typename T>
cudaError_t launch_with(Kernel kernel, int threads, int smem, bool& ready,
                        const T* q, const T* k, const T* v, T* out,
                        float* lse, int B, int S, int T_, int H, int Kv,
                        int d, int causal, int window, float scale,
                        cudaStream_t stream) {
  if (!ready) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  const int BQ = kRows / (H / Kv);
  dim3 grid((S + BQ - 1) / BQ, B * Kv);
  kernel<<<grid, threads, smem, stream>>>(q, k, v, out, lse, S, T_, H, Kv,
                                          d, causal, window, scale);
  return cudaGetLastError();
}

// bf16: the wgmma kernel at the host's plan (bq positions a block); f32:
// the CUDA-core kernel. Both on the D-column instance for head_dim d <= D
// (kExact: d == D).
template <typename T, int D, bool kExact>
cudaError_t launch(const T* q, const T* k, const T* v, T* out, float* lse,
                   int B, int S, int T_, int H, int Kv, int d, int causal,
                   int window, float scale, int bq, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return flash::wg::launch<D, kExact>(q, k, v, out, lse, B, S, T_, H, Kv,
                                        d, causal, window, scale, bq, stream);
  } else {
    static bool ready = false;
    return launch_with(flash_kernel<D, kExact>, kThreads,
                       (int)sizeof(Smem<D>), ready, q, k, v, out, lse, B, S,
                       T_, H, Kv, d, causal, window, scale, stream);
  }
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* out,
                     float* lse, int B, int S, int T_, int H, int Kv, int D,
                     int causal, int window, float scale, int bq,
                     cudaStream_t s) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
  if (D == 64)
    return launch<T, 64, true>(qt, kt, vt, ot, lse, B, S, T_, H, Kv, D,
                               causal, window, scale, bq, s);
  if (D == 128)
    return launch<T, 128, true>(qt, kt, vt, ot, lse, B, S, T_, H, Kv, D,
                                causal, window, scale, bq, s);
  if (D == 96 || D == 120)
    return launch<T, 128, false>(qt, kt, vt, ot, lse, B, S, T_, H, Kv, D,
                                 causal, window, scale, bq, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// q and out (B, S, H, D), k and v (B, T, Kv, D): contiguous, 16-byte
// aligned, bf16 when is_bf16 else f32. lse: null, or (B, H, S) f32 for
// each row's logsumexp. D is 64, 96, 120 or 128; G = H / Kv is at most
// 64. window <= 0 means no window. bf16 takes bq query
// positions a block (the host's plan, G * bq <= 128); f32 takes 64 / G.
// Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() of the launch (cudaErrorInvalidValue for a shape it
// does not take).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, float* lse,
                                      int B, int S, int T, int H, int Kv,
                                      int D, int causal, int window,
                                      float scale, int is_bf16, int bq,
                                      void* stream) {
  if (Kv <= 0 || H % Kv || H / Kv > kRows) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)launch_d<__nv_bfloat16>(q, k, v, out, lse, B, S, T, H, Kv,
                                        D, causal, window, scale, bq, s);
  return (int)launch_d<float>(q, k, v, out, lse, B, S, T, H, Kv, D, causal,
                              window, scale, bq, s);
}
