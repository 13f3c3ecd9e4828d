// One token's depthwise causal conv of a Mamba2 decode step for Hopper
// (sm_90a), one launch a call:
//   y[r, c] = silu(sum_k window[r, k, c] * w[k, c] + b[c])
// where window[r] is the layer's conv cache (K - 1 inputs, oldest first)
// followed by the new input x[r]; the K products summed in f32 in tap
// order, each product and sum rounded as torch rounds them, the bias
// added, SiLU, one rounding to x's type: the port's plain version
// (kernels/fused/kernel.py ssm_conv_step_plain). The cache is shifted in
// place: it then holds window[r, 1:].
// x is bf16 or f32, a view of the input projection (channels contiguous,
// rows x_stride apart); the cache (rows, K - 1, C) contiguous, of x's
// type; the taps w (K, C) and the bias b (C,) f32, bf16 or fp16.
//
// Replaces: no TPU kernel. The reference's conv_step
// (src/repro/models/ssm.py:67) is a jnp chain (concatenate, einsum, bias,
// silu, cast) that XLA fuses under jax.jit(model.decode_step)
// (src/repro/serving/backend.py:451); the port ran it as about 8 eager
// kernels a Mamba layer and a copy of the new cache back into the stack.
//
// Bound on an H100 SXM: by bytes, x read, y written, the cache read and
// written back, the taps and bias read once: mamba2-2.7b at batch 4 (C
// 5376, K 4) in bf16 moves 0.40 MB, about 0.12 us, so at decode a call
// costs a launch.
//
// What the design does about it: one thread a (row, channel), neighbouring
// threads on neighbouring channels, so that every load and store of a tap
// row is coalesced. A thread reads its column of the cache tap by tap and
// writes each input one slot older as soon as it has read the next, so
// the shift needs no second pass and no other thread's data.
#include "fused.cuh"

namespace {

using fused::from_f32;
using fused::to_f32;

constexpr int kThreads = 256;

template <typename T, typename P>
__global__ void __launch_bounds__(kThreads)
    ssm_conv_step_kernel(const T* __restrict__ x, T* __restrict__ cache,
                         const P* __restrict__ w, const P* __restrict__ b,
                         T* __restrict__ y, int rows, int C, int K,
                         long long x_stride) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)rows * C) return;
  const int r = (int)(i / C), c = (int)(i % C);
  T* col = cache + (long long)r * (K - 1) * C + c;
  const T xin = x[r * x_stride + c];
  float acc = 0.f;
  for (int k = 0; k < K - 1; ++k) {
    const T v = col[(long long)k * C];
    const float wk = to_f32(w[(long long)k * C + c]);
    acc = __fadd_rn(acc, __fmul_rn(to_f32(v), wk));
    if (k) col[(long long)(k - 1) * C] = v;
  }
  const float wx = to_f32(w[(long long)(K - 1) * C + c]);
  acc = __fadd_rn(acc, __fmul_rn(to_f32(xin), wx));
  col[(long long)(K - 2) * C] = xin;
  y[i] = from_f32<T>(fused::silu(__fadd_rn(acc, to_f32(b[c]))));
}

template <typename T, typename P>
cudaError_t launch(const void* x, void* cache, const void* w, const void* b,
                   void* y, int rows, int C, int K, long long x_stride,
                   cudaStream_t stream) {
  const long long n = (long long)rows * C;
  const int blocks = (int)((n + kThreads - 1) / kThreads);
  ssm_conv_step_kernel<T, P><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(cache),
      static_cast<const P*>(w), static_cast<const P*>(b), static_cast<T*>(y),
      rows, C, K, x_stride);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_p(const void* x, void* cache, const void* w, const void* b,
                     void* y, int rows, int C, int K, long long x_stride,
                     int p_kind, cudaStream_t stream) {
  switch (p_kind) {
    case 0:
      return launch<T, float>(x, cache, w, b, y, rows, C, K, x_stride,
                              stream);
    case 1:
      return launch<T, __nv_bfloat16>(x, cache, w, b, y, rows, C, K,
                                      x_stride, stream);
    case 2:
      return launch<T, __half>(x, cache, w, b, y, rows, C, K, x_stride,
                               stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// x: rows of C elements of type x_kind (0 f32, 1 bf16), x_stride elements
// apart; cache (rows, K - 1, C) and y (rows, C) contiguous, of x's type;
// w (K, C) and b (C,) contiguous, of type p_kind (0 f32, 1 bf16, 2 fp16).
// K >= 2; x must not overlap y or the cache. Launches on `stream`, does
// not synchronise, and returns cudaGetLastError() of the launch
// (cudaErrorInvalidValue for arguments it does not take).
extern "C" int ssm_conv_step_launch(const void* x, void* cache, const void* w,
                                    const void* b, void* y, int rows, int C,
                                    int K, long long x_stride, int x_kind,
                                    int p_kind, void* stream) {
  if (rows < 1 || C < 1 || K < 2 || (rows > 1 && x_stride < C))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_kind == 1)
    return (int)launch_p<__nv_bfloat16>(x, cache, w, b, y, rows, C, K,
                                        x_stride, p_kind, s);
  if (x_kind == 0)
    return (int)launch_p<float>(x, cache, w, b, y, rows, C, K, x_stride,
                                p_kind, s);
  return (int)cudaErrorInvalidValue;
}
