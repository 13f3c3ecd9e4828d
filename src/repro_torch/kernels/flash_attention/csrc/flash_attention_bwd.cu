// Flash attention backward for Hopper (sm_90a): dQ, dK and dV of
//   out (B, S, H, d) = softmax(q k^T / sqrt(d) + mask) v
// the function flash_attention.cu computes, with q (B, S, H, d), k and v
// (B, T, Kv, d), query head h reading KV head h / G (G = H / Kv), a
// causal mask (key <= query, both counted from 0) and an optional sliding
// window (key > query - window).
//
// Replaces: no TPU kernel. The Pallas flash_attention_pallas
// (src/repro/kernels/flash_attention/kernel.py) has no backward, and the
// reference trains through XLA's attention, which jax.grad differentiates.
// The port puts its flash kernel on the model path, so training needs the
// gradient of that kernel: this file.
//
// Arithmetic, FlashAttention-2's recompute from the forward's per-row
// logsumexp lse = m + log(l) (f32, (B, H, S), written by the forward):
//   D  = rowsum(dO * O)                         (bwd_delta_kernel)
//   P  = exp(q k^T / sqrt(d) - lse), 0 where masked
//   dV = P^T dO,  dP = dO v^T,  dS = P * (dP - D)
//   dK = dS^T q / sqrt(d),  dQ = dS k / sqrt(d)
// Every product sums in f32, and each output is rounded once to the input
// dtype; bf16 also rounds P to bf16 before dV and dS before dK and dQ (the
// operands of its tensor-core products). No atomics: every output element
// is summed by one thread in an order fixed by the shapes, so two calls on
// the same inputs agree bit for bit. Three launches a call: D, then dK/dV,
// then dQ.
//
// Bound on an H100 SXM: by operations. Five products of 2 * d FLOP per
// visible (query, key) pair and head: for stablelm-1.6b's causal (4, 1024)
// at 32 heads of 64, 43 GFLOP over 42 MB of bf16 q, k, v, out, dO, dq, dk,
// dv: 0.044 ms at the bf16 tensor-core peak against 0.013 ms for the bytes.
//
// What the design does about it:
// - bf16 (flash_bwd_wgmma.cuh): every product on wgmma, operands staged by
//   TMA over the natural layouts, warp-specialised as the forward. A
//   dK/dV block owns 128 keys of one KV head (64 at D = 128, its two
//   warpgroups splitting the output columns) and walks the 64-position
//   query tiles of its G query heads that may see them; a dQ block owns
//   the forward's 128 (position, head) rows and walks the forward's key
//   tiles. Both recompute S and dP (seven products against the bound's
//   five), the price of keeping dQ free of atomics.
// - f32 (bwd_dkdv_kernel, bwd_dq_kernel below): the CUDA cores, since
//   TF32 would round the operands and the f32 products must hold 1e-5 of
//   the plain version. A 16 x 16 thread grid, each thread a 4 x 4 block of
//   scores (rows ty + 16 i and keys tx + 16 j), every operand widened to
//   f32 in shared memory. Two passes, as FlashAttention-2:
//   bwd_dkdv_kernel owns 64 keys of one KV head and walks the query tiles
//   that may see them, for each of the G query heads of its group, so dK
//   and dV sum the group in registers (four products); bwd_dq_kernel owns
//   64 query positions of one head and walks the key tiles they may see
//   (the forward's key range; three products).
// Head dims 64 and 128 each have their instance; 96 and 120 run on the
// 128-column instance with the columns past d zero-filled (bf16: by TMA)
// and never stored.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_bwd_wgmma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;    // query positions and keys of a tile
constexpr int kSub = 4;      // rows and keys a thread owns: ty + 16 i
constexpr int kGrid = 16;    // threads along each side of the 16 x 16 grid

// the CUDA-core passes below run f32 only (bf16 takes flash_bwd_wgmma.cuh)
__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}

// the forward's mask (flash_wgmma.cuh, allowed)
__device__ __forceinline__ bool allowed(int qp, int kp, int causal,
                                        int window) {
  return (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
}

// n rows of d columns, row r at base + r * stride, into dst as f32; rows
// past n and columns past d are zeros
template <typename T, int D>
__device__ __forceinline__ void load_tile(float (*dst)[D + 1], const T* base,
                                          size_t stride, int n, int d) {
  for (int c = threadIdx.x; c < kTile * D; c += kThreads) {
    const int r = c / D, e = c % D;
    dst[r][e] = (r < n && e < d) ? to_f32(base[(size_t)r * stride + e]) : 0.f;
  }
}

// the thread's 4 x 4 block of S = q k^T and dP = dO v^T over D columns:
// rows ty + 16 i of q and dO, rows tx + 16 j of k and v
template <int D>
__device__ __forceinline__ void scores(const float (*q)[D + 1],
                                       const float (*dout)[D + 1],
                                       const float (*k)[D + 1],
                                       const float (*v)[D + 1], int ty, int tx,
                                       float (&s)[kSub][kSub],
                                       float (&dp)[kSub][kSub]) {
#pragma unroll
  for (int i = 0; i < kSub; ++i)
#pragma unroll
    for (int j = 0; j < kSub; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int e = 0; e < D; ++e) {
    float qa[kSub], da[kSub], kb[kSub], vb[kSub];
#pragma unroll
    for (int i = 0; i < kSub; ++i) {
      qa[i] = q[ty + kGrid * i][e];
      da[i] = dout[ty + kGrid * i][e];
      kb[i] = k[tx + kGrid * i][e];
      vb[i] = v[tx + kGrid * i][e];
    }
#pragma unroll
    for (int i = 0; i < kSub; ++i)
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
        dp[i][j] = fmaf(da[i], vb[j], dp[i][j]);
      }
  }
}

template <int D>
struct DkvSmem {
  float k[kTile][D + 1];      // +1: the rows of a column on distinct banks
  float v[kTile][D + 1];
  float q[kTile][D + 1];
  float dout[kTile][D + 1];
  float p[kTile][kTile + 1];
  float ds[kTile][kTile + 1];
  float lse[kTile];
  float delta[kTile];
};

template <int D>
struct DqSmem {
  float q[kTile][D + 1];
  float dout[kTile][D + 1];
  float k[kTile][D + 1];
  float v[kTile][D + 1];
  float ds[kTile][kTile + 1];
  float lse[kTile];
  float delta[kTile];
};

// D = rowsum(dO * O) of every (batch, position, head) row, one warp a row,
// stored (B, H, S) as lse is
template <typename T>
__global__ void __launch_bounds__(kThreads)
    bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                     float* __restrict__ delta, long rows, int S, int H,
                     int d) {
  const long row = ((long)blockIdx.x * kThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* po = o + (size_t)row * d;
  const T* pd = dout + (size_t)row * d;
  float s = 0.f;
  for (int e = lane; e < d; e += 32) s = fmaf(to_f32(po[e]), to_f32(pd[e]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {
    const int h = (int)(row % H);
    const long bs = row / H;
    delta[((size_t)(bs / S) * H + h) * S + bs % S] = s;
  }
}

// the query tile's lse and D into shared memory (0 past S)
__device__ __forceinline__ void load_rows(float* lse_s, float* delta_s,
                                          const float* lse,
                                          const float* delta, size_t off,
                                          int n) {
  if (threadIdx.x < kTile) {
    const bool in = (int)threadIdx.x < n;
    lse_s[threadIdx.x] = in ? lse[off + threadIdx.x] : 0.f;
    delta_s[threadIdx.x] = in ? delta[off + threadIdx.x] : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dk,
                    T* __restrict__ dv, int S, int T_, int H, int Kv, int d,
                    int causal, int window, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DkvSmem<D>& sm = *reinterpret_cast<DkvSmem<D>*>(smem_raw);
  constexpr int C = D / kGrid;            // columns a thread sums
  const int G = H / Kv;
  const int b = blockIdx.y / Kv, kv = blockIdx.y % Kv;
  const int k0 = blockIdx.x * kTile;
  const int nk = min(kTile, T_ - k0);
  const int ty = threadIdx.x / kGrid, tx = threadIdx.x % kGrid;

  const size_t kv_off = ((size_t)(b * T_ + k0) * Kv + kv) * d;
  load_tile<T, D>(sm.k, k + kv_off, (size_t)Kv * d, nk, d);
  load_tile<T, D>(sm.v, v + kv_off, (size_t)Kv * d, nk, d);

  float acc_k[kSub][C], acc_v[kSub][C];
#pragma unroll
  for (int i = 0; i < kSub; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  // the queries that may see keys k0 .. k0 + nk - 1
  int q_begin = 0, q_end = S;
  if (causal) {
    q_begin = k0;
    if (window > 0) q_end = min(S, k0 + nk - 1 + window);
  }
  for (int g = 0; g < G; ++g) {
    const int h = kv * G + g;
    for (int q0 = q_begin; q0 < q_end; q0 += kTile) {
      const int nq = min(kTile, S - q0);
      __syncthreads();   // the previous tile's q, dO, P and dS are read
      const size_t q_off = ((size_t)(b * S + q0) * H + h) * d;
      load_tile<T, D>(sm.q, q + q_off, (size_t)H * d, nq, d);
      load_tile<T, D>(sm.dout, dout + q_off, (size_t)H * d, nq, d);
      load_rows(sm.lse, sm.delta, lse, delta, ((size_t)b * H + h) * S + q0,
                nq);
      __syncthreads();

      float s[kSub][kSub], dp[kSub][kSub];
      scores<D>(sm.q, sm.dout, sm.k, sm.v, ty, tx, s, dp);
#pragma unroll
      for (int i = 0; i < kSub; ++i)
#pragma unroll
        for (int j = 0; j < kSub; ++j) {
          const int qi = ty + kGrid * i, kj = tx + kGrid * j;
          float p = 0.f;
          if (qi < nq && kj < nk && allowed(q0 + qi, k0 + kj, causal, window))
            p = expf(s[i][j] * scale - sm.lse[qi]);
          sm.p[qi][kj] = p;
          sm.ds[qi][kj] = p * (dp[i][j] - sm.delta[qi]);
        }
      __syncthreads();

      // dV += P^T dO and dK += dS^T q over the tile's queries
      for (int r = 0; r < nq; ++r) {
        float pa[kSub], sa[kSub];
#pragma unroll
        for (int i = 0; i < kSub; ++i) {
          pa[i] = sm.p[r][ty + kGrid * i];
          sa[i] = sm.ds[r][ty + kGrid * i];
        }
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float dov = sm.dout[r][tx + kGrid * c];
          const float qv = sm.q[r][tx + kGrid * c];
#pragma unroll
          for (int i = 0; i < kSub; ++i) {
            acc_v[i][c] = fmaf(pa[i], dov, acc_v[i][c]);
            acc_k[i][c] = fmaf(sa[i], qv, acc_k[i][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    const int kj = ty + kGrid * i;
    if (kj >= nk) continue;
    const size_t off = kv_off + (size_t)kj * Kv * d;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int e = tx + kGrid * c;
      if (e < d) {
        dk[off + e] = from_f32<T>(acc_k[i][c] * scale);
        dv[off + e] = from_f32<T>(acc_v[i][c]);
      }
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, T* __restrict__ dq, int S,
                  int T_, int H, int Kv, int d, int causal, int window,
                  float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DqSmem<D>& sm = *reinterpret_cast<DqSmem<D>*>(smem_raw);
  constexpr int C = D / kGrid;
  const int b = blockIdx.y / H, h = blockIdx.y % H, kv = h / (H / Kv);
  const int q0 = blockIdx.x * kTile;
  const int nq = min(kTile, S - q0);
  const int ty = threadIdx.x / kGrid, tx = threadIdx.x % kGrid;

  const size_t q_off = ((size_t)(b * S + q0) * H + h) * d;
  load_tile<T, D>(sm.q, q + q_off, (size_t)H * d, nq, d);
  load_tile<T, D>(sm.dout, dout + q_off, (size_t)H * d, nq, d);
  load_rows(sm.lse, sm.delta, lse, delta, ((size_t)b * H + h) * S + q0, nq);

  float acc[kSub][C];
#pragma unroll
  for (int i = 0; i < kSub; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.f;

  // the keys these queries may see (the forward's key range)
  int k_begin = 0, k_end = T_;
  if (causal) {
    k_end = min(T_, q0 + nq);
    if (window > 0) k_begin = max(0, q0 - window + 1);
  }
  for (int k0 = k_begin; k0 < k_end; k0 += kTile) {
    const int nk = min(kTile, T_ - k0);
    __syncthreads();     // the previous tile's k and dS are read
    const size_t kv_off = ((size_t)(b * T_ + k0) * Kv + kv) * d;
    load_tile<T, D>(sm.k, k + kv_off, (size_t)Kv * d, nk, d);
    load_tile<T, D>(sm.v, v + kv_off, (size_t)Kv * d, nk, d);
    __syncthreads();

    float s[kSub][kSub], dp[kSub][kSub];
    scores<D>(sm.q, sm.dout, sm.k, sm.v, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < kSub; ++i)
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const int qi = ty + kGrid * i, kj = tx + kGrid * j;
        float ds = 0.f;
        if (qi < nq && kj < nk && allowed(q0 + qi, k0 + kj, causal, window))
          ds = expf(s[i][j] * scale - sm.lse[qi]) * (dp[i][j] - sm.delta[qi]);
        sm.ds[qi][kj] = ds;
      }
    __syncthreads();

    // dQ += dS k over the tile's keys
    for (int kk = 0; kk < nk; ++kk) {
      float sa[kSub];
#pragma unroll
      for (int i = 0; i < kSub; ++i) sa[i] = sm.ds[ty + kGrid * i][kk];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float kv_ = sm.k[kk][tx + kGrid * c];
#pragma unroll
        for (int i = 0; i < kSub; ++i) acc[i][c] = fmaf(sa[i], kv_, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    const int qi = ty + kGrid * i;
    if (qi >= nq) continue;
    const size_t off = q_off + (size_t)qi * H * d;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int e = tx + kGrid * c;
      if (e < d) dq[off + e] = from_f32<T>(acc[i][c] * scale);
    }
  }
}

// the f32 D, dK/dV and dQ passes on the CUDA cores
template <int D>
cudaError_t launch_f32(const float* q, const float* k, const float* v,
                       const float* o, const float* dout, const float* lse,
                       float* delta, float* dq, float* dk, float* dv,
                       int B, int S, int T_, int H, int Kv, int d, int causal,
                       int window, float scale, cudaStream_t stream) {
  using T = float;
  // raised once per instance, so that later launches, inside a CUDA graph
  // capture too, make no attribute call
  static bool ready = false;
  if (!ready) {
    cudaError_t err = cudaFuncSetAttribute(
        bwd_dkdv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)sizeof(DkvSmem<D>));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(bwd_dq_kernel<T, D>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)sizeof(DqSmem<D>));
    if (err != cudaSuccess) return err;
    ready = true;
  }
  const long rows = (long)B * S * H;
  if (rows > 0) {
    const long blocks = (rows * 32 + kThreads - 1) / kThreads;
    bwd_delta_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
        o, dout, delta, rows, S, H, d);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (T_ > 0) {
    dim3 grid((T_ + kTile - 1) / kTile, B * Kv);
    bwd_dkdv_kernel<T, D><<<grid, kThreads, sizeof(DkvSmem<D>), stream>>>(
        q, k, v, dout, lse, delta, dk, dv, S, T_, H, Kv, d, causal, window,
        scale);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (S > 0) {
    dim3 grid((S + kTile - 1) / kTile, B * H);
    bwd_dq_kernel<T, D><<<grid, kThreads, sizeof(DqSmem<D>), stream>>>(
        q, k, v, dout, lse, delta, dq, S, T_, H, Kv, d, causal, window,
        scale);
  }
  return cudaGetLastError();
}

}  // namespace

// q, out, dout and dq (B, S, H, d); k, v, dk and dv (B, T, Kv, d):
// contiguous, 16-byte aligned, bf16 when is_bf16 else f32. lse (B, H, S)
// f32 from the forward; delta (B, H, S) f32 scratch. d is 64, 96, 120 or
// 128; H a multiple of Kv, at most 64 times it. window <= 0 means no
// window. bf16 takes bq query positions a dQ block (the host's plan,
// G * bq <= 128). Three launches on `stream` (D, then dK/dV, then dQ);
// does not synchronise; returns cudaGetLastError() of the launches
// (cudaErrorInvalidValue for a shape it does not take).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int B, int S, int T, int H, int Kv, int d, int causal,
    int window, float scale, int is_bf16, int bq, void* stream) {
  if (Kv <= 0 || H % Kv || B * H > 65535 || B * Kv > 65535)
    return (int)cudaErrorInvalidValue;
  if (d != 64 && d != 96 && d != 120 && d != 128)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    using bf = __nv_bfloat16;
    const bf* qt = static_cast<const bf*>(q);
    const bf* kt = static_cast<const bf*>(k);
    const bf* vt = static_cast<const bf*>(v);
    const bf* ot = static_cast<const bf*>(out);
    const bf* dt = static_cast<const bf*>(dout);
    bf* dqt = static_cast<bf*>(dq);
    bf* dkt = static_cast<bf*>(dk);
    bf* dvt = static_cast<bf*>(dv);
    if (d == 64)
      return (int)flash::bwd::launch<64, true>(
          qt, kt, vt, ot, dt, lse, delta, dqt, dkt, dvt, B, S, T, H, Kv, d,
          causal, window, scale, bq, s);
    if (d == 128)
      return (int)flash::bwd::launch<128, true>(
          qt, kt, vt, ot, dt, lse, delta, dqt, dkt, dvt, B, S, T, H, Kv, d,
          causal, window, scale, bq, s);
    return (int)flash::bwd::launch<128, false>(
        qt, kt, vt, ot, dt, lse, delta, dqt, dkt, dvt, B, S, T, H, Kv, d,
        causal, window, scale, bq, s);
  }
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  const float* ot = static_cast<const float*>(out);
  const float* dt = static_cast<const float*>(dout);
  float* dqt = static_cast<float*>(dq);
  float* dkt = static_cast<float*>(dk);
  float* dvt = static_cast<float*>(dv);
  if (d == 64)
    return (int)launch_f32<64>(qt, kt, vt, ot, dt, lse, delta, dqt, dkt, dvt,
                               B, S, T, H, Kv, d, causal, window, scale, s);
  return (int)launch_f32<128>(qt, kt, vt, ot, dt, lse, delta, dqt, dkt, dvt,
                              B, S, T, H, Kv, d, causal, window, scale, s);
}
