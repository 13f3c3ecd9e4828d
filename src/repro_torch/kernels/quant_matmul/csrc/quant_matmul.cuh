// The CUDA-core tile loop of the two dequant-matmul kernels
// (int8_matmul.cu, nf4_matmul.cu): out (M, N) = x (M, K) @ dequant(W)
// (K, N), with the weight dequantized in shared memory, never written
// back to device memory. A format (Int8Format, NF4Format) supplies the
// tile loads and the epilogue. It runs f32 compute and every shape the
// bf16 loops of qmm_wgmma.cuh (decode, M <= 8; prefill, M > 8) do not
// take (launch, at the end).
//
// Grouped calls (E problems, x (E, M, K), out (E, M, N)) take one grid
// layer per expert (blockIdx.z) and the format of that expert (its
// expert()). Given each expert's kept rows (`rows`), a block writes zeros
// in its tile's rows at or past the count, and a tile with no kept row
// reads nothing.
//
// Every block owns an output tile and walks the whole K axis itself (no
// split-K across blocks, so every sum is taken in one fixed order and the
// result is deterministic). Sums are f32. A product of two bf16 values is
// exact in f32, so the loop does the arithmetic of a tensor-core bf16 x
// bf16 -> f32 product.
//
// qmm_tile_kernel: per K step it stages
//   xs (BM, BK): the activation tile, as floats holding compute-dtype
//                values;
//   ws (BK, BN): the weight tile, dequantized by the format's loader and
//                rounded to the compute dtype, as floats.
// The 256 threads are split into KS groups along the K step; each group
// covers all of the tile's outputs as (BM/TM) x (BN/TN) threads with a
// TM x TN micro-tile. With KS > 1 the KS partial sums are added in a
// fixed order through shared memory.
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
    qmm_tile_kernel(const T* __restrict__ x, Format fmt_all,
                    T* __restrict__ out, const int* __restrict__ rows,
                    int M, int N, int K) {
  constexpr int NX = BN / TN;          // threads along N in a k-group
  constexpr int NY = BM / TM;          // threads along M in a k-group
  static_assert(NX * NY * KS == kThreads, "thread layout");
  static_assert(BK % KS == 0, "k split");
  constexpr int KPER = BK / KS;
  static_assert(KS == 1 || KS * BM * BN <= BK * BN, "reduction buffer");

  __shared__ float xs[BM][BK + 1];
  __shared__ __align__(16) float ws[BK][BN];

  const Format fmt = fmt_all.expert(blockIdx.z, K, N);
  x += (size_t)blockIdx.z * M * K;
  out += (size_t)blockIdx.z * M * N;
  const int tid = threadIdx.x;
  const int kg = tid / (NX * NY);
  const int r = tid % (NX * NY);
  const int ty = r / NX, tx = r % NX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  // this expert's kept rows: the rest of the tile is zeros
  const int lim = rows ? min(max(rows[blockIdx.z], 0), M) : M;
  if (m0 >= lim) {
    for (int i = tid; i < BM * BN; i += kThreads) {
      const int gm = m0 + i / BN, gn = n0 + i % BN;
      if (gm < M && gn < N) out[(size_t)gm * N + gn] = from_f<T>(0.f);
    }
    return;
  }

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
        out[(size_t)gm * N + gn] =
            from_f<T>(gm < lim ? fmt.epilogue(acc[i][j], gn) : 0.f);
    }
}

// The loops the host's plan names (quant_matmul/kernel.py, matmul_plan);
// kLoopDecode and kLoopWgmma are launched from qmm_wgmma.cuh.
enum Loop { kLoopDecode = 0, kLoopWgmma = 1, kLoopTile = 2 };

// The tile loop over E experts (each expert's kept rows, or null for all
// M): a 8 x 32 tile with a 256-deep K step for M <= 8, a 64 x 64 tile
// with a 4 x 4 micro-tile per thread above.
template <typename T, class Format>
cudaError_t launch_tile(const T* x, Format fmt, T* out, const int* rows,
                        int E, int M, int N, int K, cudaStream_t stream) {
  if (E < 1 || E > 65535) return cudaErrorInvalidValue;
  if (M <= 8) {
    dim3 grid((N + 31) / 32, 1, E);
    qmm_tile_kernel<T, 8, 32, 256, 8, 1, 8, Format>
        <<<grid, kThreads, 0, stream>>>(x, fmt, out, rows, M, N, K);
  } else {
    dim3 grid((N + 63) / 64, (M + 63) / 64, E);
    qmm_tile_kernel<T, 64, 64, 32, 4, 4, 1, Format>
        <<<grid, kThreads, 0, stream>>>(x, fmt, out, rows, M, N, K);
  }
  return cudaGetLastError();
}

}  // namespace qmm
