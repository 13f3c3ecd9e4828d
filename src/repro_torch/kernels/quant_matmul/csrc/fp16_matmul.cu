// fp16-weight matmul for Hopper (sm_90a):
//   out (M, N) = x (M, K) @ bf16(w (K, N))
// with w stored in float16, each weight converted to the compute dtype
// (bf16: through f32, which is exact, then round to nearest even, what
// .to(torch.bfloat16) gives; f32: exactly), f32 sums, and one rounding to
// the compute dtype at the end.
//
// Replaces: no TPU kernel. The reference computes this product as
// jnp.einsum(x.astype(cd), w.astype(cd)) over a float16 weight under the
// float16 policy (src/repro/quant/apply.py:68-69), which XLA may fuse;
// the port's eager torch.matmul(x.to(cd), w.to(cd)) first wrote a bf16
// copy of the whole weight on every call and read it back. This kernel
// converts the weights in registers instead: the format's bytes are
// read once and no 16-bit copy is ever written.
//
// Bound on an H100 SXM: at decode (M = 1-8) the weight bytes. llama's
// (4096, 14336) w_gate is 117.4 MB, about 35 us at 3.35 TB/s, and its
// (4096, 128256) lm_head 1.05 GB, about 314 us. At prefill (M = 512) the
// 2*M*K*N operations bound it instead.
//
// What the design does about it: the bf16 loops of qmm_wgmma.cuh, with
// F16Stage below as the weight's stage: a TMA ring of raw 64 x BN fp16
// tiles (two 64-column boxes for BN = 128, since a 128-byte swizzle span
// holds 64 columns of 16 bits) and x tiles, each consumer thread reading
// its fragment's column pairs with 4-byte shared loads and converting
// them in registers, the A operand of wgmma (x is B). Decode (M <= 8)
// streams 128-column tiles with one block per SM, the K steps split
// evenly among the blocks and the split tiles merged in the same launch;
// prefill walks whole output tiles with a persistent grid. A stage holds
// twice int8's bytes: the decode ring keeps 8 stages, 128 KB of weights,
// in flight per SM, and the 256 x 128 prefill tile (four stages) is not
// planned. f32 compute and shapes the plan gives neither loop take the
// CUDA-core tile kernel (qmm_tile_kernel).
#include <cuda_fp16.h>

#include "qmm_wgmma.cuh"
#include "quant_matmul.cuh"

namespace {

// fp16 bits as f32: exact
__device__ __forceinline__ float f16_bits(uint32_t h) {
  return __half2float(__ushort_as_half((unsigned short)h));
}

struct F16Format {
  const __half* w;   // (K, N)
  static constexpr bool kOutliers = false;

  __device__ __forceinline__ F16Format expert(int e, int K, int N) const {
    return {w + (size_t)e * K * N};
  }

  // -- tile kernel: ws (BK, BN) <- w[k0:k0+BK, n0:n0+BN] rounded to the
  // compute dtype, 0 past the edges
  template <typename T, int BK, int BN>
  __device__ __forceinline__ void load_tile(float (*ws)[BN], int k0, int n0,
                                            int K, int N, int tid) const {
    for (int i = tid; i < BK * BN; i += qmm::kThreads) {
      const int kk = i / BN, nn = i % BN;
      const int gk = k0 + kk, gn = n0 + nn;
      ws[kk][nn] =
          (gk < K && gn < N)
              ? qmm::round_to<T>(__half2float(w[(size_t)gk * N + gn]))
              : 0.f;
    }
  }

  __device__ __forceinline__ float epilogue(float acc, int) const {
    return acc;
  }
};

// -- the bf16 loops (qmm_wgmma.cuh): a stage holds the raw (64, BN) fp16
// tile, copied by TMA (0 past N) as BN / 64 boxes of 64 rows x 128 bytes,
// each with the 128-byte swizzle (f16_at)
constexpr int kBox = qmm::wg::kBK * 128;   // bytes of one 64-column box

// byte c (0..255 for BN = 128) of row k of a raw fp16 tile
__device__ __forceinline__ int f16_at(int k, int c) {
  const int cc = c & 127;
  return (c >> 7) * kBox + k * 128 +
         ((((cc >> 4) ^ (k & 7)) << 4) | (cc & 15));
}

struct F16Stage {
  CUtensorMap w;   // (E K, N) fp16, box (64 rows, 64 columns)
  int N;
  static constexpr bool kOutliers = false;

  template <int BN>
  __host__ __device__ static constexpr int raw_bytes() {
    return qmm::wg::kBK * BN * 2;
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
      qmm::wg::tma_load_2d(raw + b * kBox, &w, bar,
                           n0 + 64 * b < N ? n0 + 64 * b : n0, k_row);
  }
  // The thread's A fragments of the stage: for the 16 columns nb .. nb+15
  // of its warp, A row g (g = lane / 4) is column c = nb + 2g and row g + 8
  // column c + 1, as for the other formats. For each 16 K rows kk and each
  // half, one 4-byte load of columns c, c + 1 at K rows 2t and 2t + 1 (t =
  // lane % 4; + 8 for the second half) gives both columns' pairs along K.
  // Each weight is converted exactly to f32, then rounded to bf16 (round
  // to nearest even). The swizzle puts a warp's four K rows in different
  // banks.
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
        f[kk][2 * h] = qmm::wg::pack_bf16(f16_bits(u0 & 0xFFFFu),
                                          f16_bits(u1 & 0xFFFFu));
        f[kk][2 * h + 1] =
            qmm::wg::pack_bf16(f16_bits(u0 >> 16), f16_bits(u1 >> 16));
      }
  }
  __device__ __forceinline__ float epilogue(float acc, size_t) const {
    return acc;
  }
};
}  // namespace

// x (E, M, K) and out (E, M, N) in the compute dtype (bf16 when is_bf16,
// else f32); w float16 (E, K, N); E = 1 for a 2-D call. All row-major and
// contiguous. `rows`: each expert's kept rows (E,) int32, or null for all
// M; rows at or past the count are written as zeros. `loop` is the host
// plan's loop (qmm::Loop); for the wgmma and decode loops, (bm, bn) its
// tile and `grid` its blocks, and for the decode loop `part` and
// `counter` its scratch and `seg` its K segments a column tile (0: the
// 2-D walk; kernel.py, matmul_plan and decode_scratch). Launches on
// `stream`, does not synchronise, and returns cudaGetLastError() of the
// launch, or cudaErrorInvalidValue for a loop the shape does not allow.
extern "C" int fp16_matmul_launch(const void* x, const void* w, void* out,
                                  void* part, void* counter, const void* rows,
                                  int E, int M, int N, int K, int is_bf16,
                                  int loop, int bm, int bn, int grid, int seg,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (E < 1) return (int)cudaErrorInvalidValue;
  const int* kept = static_cast<const int*>(rows);
  if (loop == qmm::kLoopWgmma || loop == qmm::kLoopDecode) {
    if (!is_bf16 || (bn != 64 && bn != 128))
      return (int)cudaErrorInvalidValue;
    qmm::wg::Args<F16Stage> a;
    if (!qmm::wg::make_map_cached(&a.st.w, w, CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
                                  2, (uint64_t)E * K, N, qmm::wg::kBK, 64,
                                  CU_TENSOR_MAP_SWIZZLE_128B))
      return (int)cudaErrorInvalidValue;
    a.st.N = N;
    a.out = static_cast<__nv_bfloat16*>(out);
    a.part = static_cast<float*>(part);
    a.counter = static_cast<int*>(counter);
    a.rows = kept;
    a.E = E;
    a.M = M;
    a.N = N;
    a.K = K;
    a.seg = seg;
    const auto* xb = static_cast<const __nv_bfloat16*>(x);
    if (loop == qmm::kLoopDecode)
      return (int)qmm::wg::launch_decode(a, xb, bn, grid, s);
    return (int)qmm::wg::launch(a, xb, bm, bn, grid, s);
  }
  if (loop != qmm::kLoopTile) return (int)cudaErrorInvalidValue;
  F16Format fmt{static_cast<const __half*>(w)};
  if (is_bf16)
    return (int)qmm::launch_tile(static_cast<const __nv_bfloat16*>(x), fmt,
                                 static_cast<__nv_bfloat16*>(out), kept, E,
                                 M, N, K, s);
  return (int)qmm::launch_tile(static_cast<const float*>(x), fmt,
                               static_cast<float*>(out), kept, E, M, N, K,
                               s);
}
