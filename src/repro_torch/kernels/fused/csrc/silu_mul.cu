// The gated activation for Hopper (sm_90a), one launch a call:
//   out = silu(g) * u,   silu(x) = x / (1 + exp(-x))
// elementwise over g and u of one shape, bf16 or f32: silu in f32,
// rounded to the type, then the product in f32, rounded again: the
// rounding points of torch's F.silu(g) * u (the port's plain version).
// An MoE expert stack's rows past the dispatch's counts are zeros in g
// and u, and stay zeros (silu(0) * 0 = 0).
//
// Replaces: no TPU kernel. The reference's jax.nn.silu(g) * u
// (src/repro/models/layers.py:236, and src/repro/models/moe.py's expert
// FFN) is fused by XLA under jax.jit (src/repro/serving/backend.py:
// 451-452); the port ran it as two eager kernels a call.
//
// Bound on an H100 SXM: by bytes, g and u read and out written once:
// llama-3.1-8b's decode (4, 14336) in bf16 moves 344 KB, about 0.1 us;
// qwen3-moe-30b-a3b's expert stack (128, 8, 768) 4.7 MB, about 1.4 us.
//
// What the design does about it: a grid-stride loop of 16-byte vectors
// (8 bf16 or 4 f32 elements a thread and step) where every pointer is
// 16-byte aligned, then the tail that is not a whole vector element by
// element; exp is the precise expf and the division IEEE, as torch's.
#include "fused.cuh"

namespace {

using fused::from_f32;
using fused::to_f32;
using fused::Vec;

constexpr int kThreads = 256;

template <typename T>
__device__ __forceinline__ T silu_mul1(T g, T u) {
  const float s = to_f32(from_f32<T>(fused::silu(to_f32(g))));
  return from_f32<T>(__fmul_rn(s, to_f32(u)));
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    silu_mul_kernel(const T* __restrict__ g, const T* __restrict__ u,
                    T* __restrict__ out, long long n) {
  const long long nv = n / VEC;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const Vec<T, VEC>* gv = reinterpret_cast<const Vec<T, VEC>*>(g);
  const Vec<T, VEC>* uv = reinterpret_cast<const Vec<T, VEC>*>(u);
  Vec<T, VEC>* ov = reinterpret_cast<Vec<T, VEC>*>(out);
  for (long long i = first; i < nv; i += stride) {
    const Vec<T, VEC> a = gv[i], b = uv[i];
    Vec<T, VEC> o;
#pragma unroll
    for (int j = 0; j < VEC; ++j) o.v[j] = silu_mul1(a.v[j], b.v[j]);
    ov[i] = o;
  }
  for (long long i = nv * VEC + first; i < n; i += stride)
    out[i] = silu_mul1(g[i], u[i]);
}

template <typename T>
cudaError_t launch(const void* g, const void* u, void* out, long long n,
                   int vec, int blocks, cudaStream_t stream) {
  const T* gp = static_cast<const T*>(g);
  const T* up = static_cast<const T*>(u);
  T* op = static_cast<T*>(out);
  if (vec == 1)
    silu_mul_kernel<T, 1><<<blocks, kThreads, 0, stream>>>(gp, up, op, n);
  else
    silu_mul_kernel<T, 16 / sizeof(T)><<<blocks, kThreads, 0, stream>>>(
        gp, up, op, n);
  return cudaGetLastError();
}

}  // namespace

// g, u and out: n contiguous elements of type is_bf16 ? bf16 : f32. vec
// is 1 or 16 / sizeof(type), the latter only for 16-byte aligned
// pointers (the host checks); blocks: the grid of the host's plan
// (kernel.py silu_mul_plan). Launches on `stream`, does not synchronise,
// and returns cudaGetLastError() of the launch (cudaErrorInvalidValue
// for arguments it does not take).
extern "C" int silu_mul_launch(const void* g, const void* u, void* out,
                               long long n, int vec, int blocks, int is_bf16,
                               void* stream) {
  const int wide = is_bf16 ? 8 : 4;
  if (n < 1 || blocks < 1 || (vec != 1 && vec != wide))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)launch<__nv_bfloat16>(g, u, out, n, vec, blocks, s);
  return (int)launch<float>(g, u, out, n, vec, blocks, s);
}
