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
// Stage16<__half> (f16_stage.cuh, shared with bf16_matmul.cu) as the
// weight's stage: a TMA ring of raw 64 x BN fp16 tiles (two 64-column
// boxes for BN = 128, since a 128-byte swizzle span holds 64 columns of
// 16 bits) and x tiles, each consumer thread reading its fragment's
// column pairs with 4-byte shared loads and converting them in
// registers, the A operand of wgmma (x is B). Decode (M <= 8)
// streams 128-column tiles with one block per SM, the K steps split
// evenly among the blocks and the split tiles merged in the same launch;
// prefill walks whole output tiles with a persistent grid. A stage holds
// twice int8's bytes: the decode ring keeps 8 stages, 128 KB of weights,
// in flight per SM, and the 256 x 128 prefill tile (four stages) is not
// planned. f32 compute and shapes the plan gives neither loop take the
// CUDA-core tile kernel (qmm_tile_kernel). The grouped form
// (fp16_matmul_grouped: an MoE's float16 expert stack, E products in one
// launch) walks only the experts and rows the dispatch kept, as the int8
// and nf4 grouped calls do (qmm_wgmma.cuh).
#include <cuda_fp16.h>

#include "f16_stage.cuh"
#include "qmm_wgmma.cuh"
#include "quant_matmul.cuh"

namespace {

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
    if (!is_bf16) return (int)cudaErrorInvalidValue;
    return (int)qmm::wg::launch16<__half>(x, w, out, part, counter, kept, E,
                                          M, N, K, loop, bm, bn, grid, seg,
                                          s);
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
