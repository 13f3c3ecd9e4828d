// The 16-bit weight stage of the bf16 loops (qmm_wgmma.cuh), shared by
// fp16_matmul.cu (float16 weights, converted to bf16 in registers) and
// bf16_matmul.cu (bf16 weights, taken as they are): Stage16<W>, W the
// weight's element type (__half or __nv_bfloat16), and launch16, which
// runs either loop over it.
//
// A stage holds the raw (64, BN) 16-bit tile, copied by TMA (0 past N)
// as BN / 64 boxes of 64 rows x 128 bytes, each with the 128-byte
// swizzle (f16_at): a 128-column row is 256 bytes, twice the swizzle's
// span. Its bytes are twice int8's, so the decode ring keeps 8 stages
// (128 KB of weights in flight per SM) and the 256 x 128 prefill tile,
// whose ring holds four, is never planned (kernel.py, ring_stages).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include <type_traits>

#include "qmm_wgmma.cuh"
#include "quant_matmul.cuh"

namespace qmm {
namespace wg {

constexpr int kBox16 = kBK * 128;   // bytes of one 64-column box

// byte c (0..255 for BN = 128) of row k of a raw 16-bit tile
__device__ __forceinline__ int f16_at(int k, int c) {
  const int cc = c & 127;
  return (c >> 7) * kBox16 + k * 128 +
         ((((cc >> 4) ^ (k & 7)) << 4) | (cc & 15));
}

// Two weights of type W (the low half first) as a bf16x2 A-fragment
// register: bf16 as it is; fp16 converted exactly to f32, then rounded to
// bf16 (round to nearest even, what .to(torch.bfloat16) gives).
template <class W>
__device__ __forceinline__ uint32_t to_bf16x2(uint32_t p);
template <>
__device__ __forceinline__ uint32_t to_bf16x2<__nv_bfloat16>(uint32_t p) {
  return p;
}
template <>
__device__ __forceinline__ uint32_t to_bf16x2<__half>(uint32_t p) {
  const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&p));
  return pack_bf16(f.x, f.y);
}

template <class W>
struct Stage16 {
  CUtensorMap w;   // (E K, N) of W, box (64 rows, 64 columns)
  int N;
  static constexpr bool kOutliers = false;

  template <int BN>
  __host__ __device__ static constexpr int raw_bytes() {
    return kBK * BN * 2;
  }
  template <int BN>
  __device__ __forceinline__ uint32_t tx_bytes() const {
    return raw_bytes<BN>();
  }
  __device__ __forceinline__ void prepare(float*, int) const {}
  // the 64 weight rows from row k_row of the experts' stacked (E K, N);
  // a box that would start past N (the last tile of an N with a
  // 64-column remainder) copies the tile's first box again instead, for
  // columns that are never stored
  template <int BN>
  __device__ __forceinline__ void load(uint8_t* raw, uint64_t* bar,
                                       int k_row, int n0) const {
#pragma unroll
    for (int b = 0; b < BN / 64; ++b)
      tma_load_2d(raw + b * kBox16, &w, bar,
                  n0 + 64 * b < N ? n0 + 64 * b : n0, k_row);
  }
  // The thread's A fragments of the stage: for the 16 columns nb .. nb+15
  // of its warp, A row g (g = lane / 4) is column c = nb + 2g and row g + 8
  // column c + 1, as for the other formats. For each 16 K rows kk and each
  // half, one 4-byte load of columns c, c + 1 at K rows 2t and 2t + 1 (t =
  // lane % 4; + 8 for the second half) gives both columns' pairs along K
  // through two byte permutes (column c's K pair, then column c + 1's).
  // The swizzle puts a warp's four K rows in different banks.
  template <int BN>
  __device__ __forceinline__ void fragments(const uint8_t* raw, const float*,
                                            int nb, int lane,
                                            uint32_t (&f)[4][4]) const {
    const int cb = 2 * (nb + 2 * (lane / 4)), t = lane % 4;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = 16 * kk + 8 * h + 2 * t;
        const uint32_t u0 =
            *reinterpret_cast<const uint32_t*>(raw + f16_at(k, cb));
        const uint32_t u1 =
            *reinterpret_cast<const uint32_t*>(raw + f16_at(k + 1, cb));
        f[kk][2 * h] = to_bf16x2<W>(__byte_perm(u0, u1, 0x5410));
        f[kk][2 * h + 1] = to_bf16x2<W>(__byte_perm(u0, u1, 0x7632));
      }
  }
  __device__ __forceinline__ float epilogue(float acc, size_t) const {
    return acc;
  }
};

// The loop `loop` (kLoopWgmma or kLoopDecode) of x (E, M, K) bf16 against
// w (E, K, N) of W, out (E, M, N) bf16, at the host's plan (bm, bn,
// grid, seg; part and counter for decode), each expert's kept rows in
// `rows` or null for all M. Refuses (cudaErrorInvalidValue) another
// tile, a weight map that cannot be encoded, and what the loops refuse.
template <class W>
cudaError_t launch16(const void* x, const void* w, void* out, void* part,
                     void* counter, const int* rows, int E, int M, int N,
                     int K, int loop, int bm, int bn, int grid, int seg,
                     cudaStream_t s) {
  if (bn != 64 && bn != 128) return cudaErrorInvalidValue;
  Args<Stage16<W>> a;
  const auto type = std::is_same<W, __half>::value
                        ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (!make_map_cached(&a.st.w, w, type, 2, (uint64_t)E * K, N, kBK, 64,
                       CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  a.st.N = N;
  a.out = static_cast<__nv_bfloat16*>(out);
  a.part = static_cast<float*>(part);
  a.counter = static_cast<int*>(counter);
  a.rows = rows;
  a.E = E;
  a.M = M;
  a.N = N;
  a.K = K;
  a.seg = seg;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  if (loop == kLoopDecode) return launch_decode(a, xb, bn, grid, s);
  if (loop == kLoopWgmma) return launch(a, xb, bm, bn, grid, s);
  return cudaErrorInvalidValue;
}

}  // namespace wg
}  // namespace qmm
