// Shared tile loops of the two dequant-matmul kernels (int8_matmul.cu,
// nf4_matmul.cu): out (M, N) = x (M, K) @ dequant(W) (K, N), with the
// weight dequantized in shared memory and registers, never written back
// to device memory. A format (Int8Format, NF4Format) supplies the tile
// loads, the dequantization and the epilogue; this file supplies the
// decode and tile loops and runs the one the host's plan names (launch,
// at the end). The bf16 prefill loop (TMA ring + wgmma) is in
// qmm_wgmma.cuh.
//
// Every block owns an output tile and walks the whole K axis itself (no
// split-K across blocks, so every sum is taken in one fixed order and the
// result is deterministic). Sums are f32. A product of two bf16 values is
// exact in f32, so the CUDA-core loops below do the arithmetic of a
// tensor-core bf16 x bf16 -> f32 product.
//
// qmm_tile_kernel (f32 compute, and any shape the other loops do not
// take): per K step it stages
//   xs (BM, BK): the activation tile, as floats holding compute-dtype
//                values;
//   ws (BK, BN): the weight tile, dequantized by the format's loader and
//                rounded to the compute dtype, as floats.
// The 256 threads are split into KS groups along the K step; each group
// covers all of the tile's outputs as (BM/TM) x (BN/TN) threads with a
// TM x TN micro-tile. With KS > 1 the KS partial sums are added in a
// fixed order through shared memory.
//
// qmm_decode_kernel (M <= 8, aligned shapes): decode reads every weight
// byte once and does little with it, so the loop is built to keep bytes
// in flight. Each block owns 16 columns. A ring of kStages shared-memory
// stages is filled with cp.async (16-byte copies, no registers held): the
// raw weight tile (512 rows x 16 columns of codes), the format's scales
// and the x tile in the compute dtype. While stage t is dequantized and
// multiplied, the copies of stages t+1 .. t+kStages-1 are in flight. 64
// k-groups of 4 threads each take every 64th row of a stage; a thread
// holds MR rows x 4 columns of sums, MR the least of 1, 2, 4, 8 that
// covers M. The 64 partial sums of each output are added in a fixed
// order at the end.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace qmm {

constexpr int kThreads = 256;

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(
    __nv_bfloat16 v) {
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

// round an f32 value to the compute dtype T and widen it back
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f<T>(from_f<T>(v));
}

template <typename T, int BM, int BN, int BK, int TM, int TN, int KS,
          class Format>
__global__ void __launch_bounds__(kThreads)
    qmm_tile_kernel(const T* __restrict__ x, Format fmt,
                    T* __restrict__ out, int M, int N, int K) {
  constexpr int NX = BN / TN;          // threads along N in a k-group
  constexpr int NY = BM / TM;          // threads along M in a k-group
  static_assert(NX * NY * KS == kThreads, "thread layout");
  static_assert(BK % KS == 0, "k split");
  constexpr int KPER = BK / KS;
  static_assert(KS == 1 || KS * BM * BN <= BK * BN, "reduction buffer");

  __shared__ float xs[BM][BK + 1];
  __shared__ __align__(16) float ws[BK][BN];

  const int tid = threadIdx.x;
  const int kg = tid / (NX * NY);
  const int r = tid % (NX * NY);
  const int ty = r / NX, tx = r % NX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * BK; i += kThreads) {
      const int mm = i / BK, kk = i % BK;
      const int gm = m0 + mm, gk = k0 + kk;
      xs[mm][kk] = (gm < M && gk < K) ? to_f<T>(x[(size_t)gm * K + gk])
                                      : 0.f;
    }
    fmt.template load_tile<T, BK, BN>(ws, k0, n0, K, N, tid);
    __syncthreads();
#pragma unroll 4
    for (int kk = kg * KPER; kk < (kg + 1) * KPER; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[ty + i * NY][kk];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ws[kk][tx + j * NX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  if (KS > 1) {
    // partial sums of the k-groups, reusing ws: red[kg][m][n]
    float* red = &ws[0][0];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j)
        red[(kg * BM + ty + i * NY) * BN + tx + j * NX] = acc[i][j];
    __syncthreads();
    if (kg != 0) return;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        float s = 0.f;
        for (int g = 0; g < KS; ++g)
          s += red[(g * BM + ty + i * NY) * BN + tx + j * NX];
        acc[i][j] = s;
      }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gm = m0 + ty + i * NY, gn = n0 + tx + j * NX;
      if (gm < M && gn < N)
        out[(size_t)gm * N + gn] = from_f<T>(fmt.epilogue(acc[i][j], gn));
    }
}

// ---------------------------------------------------------------------------
// decode
// ---------------------------------------------------------------------------
constexpr int kDecM = 8;        // most rows of x a decode block covers
// 16 columns a block: wider tiles (32 or 64 columns, 128-512 rows a
// stage) measured no faster at llama-3.1-8b's decode shapes, and fewer
// blocks would leave the (4096, 1024) projections on a quarter of the SMs
constexpr int kDecBN = 16;      // columns per block
constexpr int kDecBK = 512;     // K rows per stage
constexpr int kStages = 4;
constexpr int kColGroups = kDecBN / 4;             // 4 columns a thread
constexpr int kKGroups = kThreads / kColGroups;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// bytes of one stage's x tile for MR rows
template <typename T, int MR>
__host__ __device__ constexpr int dec_x_bytes() {
  return MR * kDecBK * (int)sizeof(T);
}

template <typename T, int MR, class Format>
__device__ __forceinline__ void dec_fetch(uint8_t* stage, int wbytes,
                                          const T* __restrict__ x,
                                          const Format& fmt, int kt, int n0,
                                          int M, int N, int K, int tid) {
  const int k0 = kt * kDecBK;
  fmt.dec_load(stage, k0, n0, N, tid);
  T* xs = reinterpret_cast<T*>(stage + wbytes);
  constexpr int per_row = kDecBK * (int)sizeof(T) / 16;
  constexpr int elems = 16 / (int)sizeof(T);
  for (int c = tid; c < M * per_row; c += kThreads) {
    const int m = c / per_row, j = c % per_row;
    cp_async16(xs + m * kDecBK + j * elems,
               x + (size_t)m * K + k0 + j * elems);
  }
}

// MR: rows of sums a thread keeps, the least of 1, 2, 4, 8 that covers M
template <typename T, int MR, class Format>
__global__ void __launch_bounds__(kThreads)
    qmm_decode_kernel(const T* __restrict__ x, Format fmt,
                      T* __restrict__ out, int M, int N, int K) {
  // the x tiles of the ring alone hold the partial sums reduced at the end
  static_assert(kStages * dec_x_bytes<T, MR>() >=
                    kKGroups * MR * kDecBN * (int)sizeof(float),
                "reduction buffer");
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ float lut[16];
  const int wbytes = fmt.dec_tile_bytes();
  const int sbytes = wbytes + dec_x_bytes<T, MR>();
  const int tid = threadIdx.x;
  const int kg = tid / kColGroups, cg = tid % kColGroups;
  const int n0 = blockIdx.x * kDecBN;
  const int nk = K / kDecBK;

  fmt.prepare(lut, tid);
  // rows M..MR-1 of every stage's x tile are never copied: zero them once
  for (int s = 0; s < kStages; ++s) {
    T* xs = reinterpret_cast<T*>(smem + s * sbytes + wbytes);
    for (int i = tid; i < (MR - M) * kDecBK; i += kThreads)
      xs[M * kDecBK + i] = from_f<T>(0.f);
  }
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk)
      dec_fetch<T, MR>(smem + s * sbytes, wbytes, x, fmt, s, n0, M, N, K,
                       tid);
    cp_async_commit();
  }

  float acc[MR][4];
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // stage kt landed; stage kt-1 is free to refill
    const int next = kt + kStages - 1;
    if (next < nk)
      dec_fetch<T, MR>(smem + (next % kStages) * sbytes, wbytes, x, fmt,
                       next, n0, M, N, K, tid);
    cp_async_commit();
    const uint8_t* stage = smem + (kt % kStages) * sbytes;
    fmt.template dec_compute<T, MR>(
        stage, reinterpret_cast<const T*>(stage + wbytes), lut, acc, kg,
        cg);
  }
  cp_async_wait<0>();
  __syncthreads();

  // red[g][m][c]: kKGroups x MR x kDecBN floats (at most 32 KiB), over
  // the stage ring
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      red[(kg * MR + m) * kDecBN + cg * 4 + j] = acc[m][j];
  __syncthreads();
  for (int o = tid; o < M * kDecBN; o += kThreads) {
    const int m = o / kDecBN, c = o % kDecBN;
    float s = 0.f;
    for (int g = 0; g < kKGroups; ++g)
      s += red[(g * MR + m) * kDecBN + c];
    out[(size_t)m * N + n0 + c] = from_f<T>(fmt.epilogue(s, n0 + c));
  }
}

static inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T, int MR, class Format>
cudaError_t launch_decode(const T* x, Format fmt, T* out, int M, int N,
                          int K, cudaStream_t stream) {
  auto kernel = qmm_decode_kernel<T, MR, Format>;
  const int smem = kStages * (fmt.dec_tile_bytes() + dec_x_bytes<T, MR>());
  // raise the kernel's dynamic shared memory limit once, to the most any
  // format's stages can take (nf4 with block 2: 16 KiB of scales a
  // stage), so that later launches, inside a CUDA graph capture too, make
  // no further attribute call
  static int limit = 0;
  if (smem > limit) {
    const int most = kStages * (kDecBK * kDecBN + kDecBK / 2 * kDecBN * 4 +
                                dec_x_bytes<T, MR>());
    const int want = most > smem ? most : smem;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, want);
    if (err != cudaSuccess) return err;
    limit = want;
  }
  kernel<<<N / kDecBN, kThreads, smem, stream>>>(x, fmt, out, M, N, K);
  return cudaGetLastError();
}

// The loops the host's plan names (quant_matmul/kernel.py, matmul_plan);
// kLoopWgmma is launched from qmm_wgmma.cuh.
enum Loop { kLoopDecode = 0, kLoopWgmma = 1, kLoopTile = 2 };

// The decode loop, or the tile loop: a 8 x 32 tile with a 256-deep K step
// for M <= 8, a 64 x 64 tile with a 4 x 4 micro-tile per thread above.
// Refuses (cudaErrorInvalidValue) a decode launch whose shape or pointers
// do not allow its 16-byte accesses: the plan never asks for one.
template <typename T, class Format>
cudaError_t launch(const T* x, Format fmt, T* out, int M, int N, int K,
                   int loop, cudaStream_t stream) {
  if (loop == kLoopDecode) {
    if (!(M <= kDecM && N % kDecBN == 0 && K % kDecBK == 0 &&
          aligned16(x) && fmt.dec_ok(K, N)))
      return cudaErrorInvalidValue;
    if (M == 1) return launch_decode<T, 1>(x, fmt, out, M, N, K, stream);
    if (M == 2) return launch_decode<T, 2>(x, fmt, out, M, N, K, stream);
    if (M <= 4) return launch_decode<T, 4>(x, fmt, out, M, N, K, stream);
    return launch_decode<T, 8>(x, fmt, out, M, N, K, stream);
  }
  if (loop != kLoopTile) return cudaErrorInvalidValue;
  if (M <= kDecM) {
    dim3 grid((N + 31) / 32, 1);
    qmm_tile_kernel<T, 8, 32, 256, 8, 1, 8, Format>
        <<<grid, kThreads, 0, stream>>>(x, fmt, out, M, N, K);
  } else {
    dim3 grid((N + 63) / 64, (M + 63) / 64);
    qmm_tile_kernel<T, 64, 64, 32, 4, 4, 1, Format>
        <<<grid, kThreads, 0, stream>>>(x, fmt, out, M, N, K);
  }
  return cudaGetLastError();
}

}  // namespace qmm
