// RMS normalisation for Hopper (sm_90a), one launch a call:
//   out[r, :] = (x[r, :] * rsqrt(mean(x[r, :]^2) + eps)) * gamma
// over the last axis of x (rows, D), f32 throughout and rounded once to
// x's type: the rounding points of the port's plain version
// (models/layers.py rms_norm, kernels/fused/kernel.py rms_norm_plain).
// x is bf16 or f32, gamma (D,) f32, bf16 or fp16 (a float16-format model
// keeps bf16 activations and fp16 gammas).
//
// Replaces: no TPU kernel. The reference's rms_norm
// (src/repro/models/layers.py:24) is a jnp chain that XLA fuses under
// jax.jit (src/repro/serving/backend.py:451-452); the port ran it as
// about 9 eager kernels a call, twice a layer and once more for the final
// norm, each a node of the replayed decode graph.
//
// Bound on an H100 SXM: by bytes, x read and out written once and gamma
// read once: llama-3.1-8b's decode norm (4, 4096) in bf16 moves 72 KB,
// about 21 ns at 3.35 TB/s, so at decode a call costs a launch. A
// prefill of 7936 rows moves 130 MB, about 39 us.
//
// What the design does about it: one block a row, one 16-byte vector a
// thread and step (VEC = 8 bf16 or 4 f32 elements) where the row allows
// it. The block sums the squares in f32 (per thread, then across the
// warp by shuffles and across the warps through shared memory), and a
// second pass reads the row again, from L1/L2, to scale it. The squares
// and products are written with __fmul_rn/__fadd_rn, so that nvcc's FMA
// contraction does not move a rounding point.
#include "fused.cuh"

namespace {

using fused::from_f32;
using fused::to_f32;
using fused::Vec;

template <typename T, typename G, int VEC>
__global__ void rms_norm_kernel(const T* __restrict__ x,
                                const G* __restrict__ gamma,
                                T* __restrict__ out, int D, float eps) {
  const long row = blockIdx.x;
  const Vec<T, VEC>* xr = reinterpret_cast<const Vec<T, VEC>*>(x + row * D);
  Vec<T, VEC>* outr = reinterpret_cast<Vec<T, VEC>*>(out + row * D);
  const int nv = D / VEC;
  float ss = 0.f;
  for (int i = threadIdx.x; i < nv; i += blockDim.x) {
    const Vec<T, VEC> a = xr[i];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float f = to_f32(a.v[j]);
      ss = __fadd_rn(ss, __fmul_rn(f, f));
    }
  }
  __shared__ float part[32];
  __shared__ float scale;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  ss = fused::warp_sum(ss);
  if (lane == 0) part[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float v = lane < (int)(blockDim.x + 31) / 32 ? part[lane] : 0.f;
    v = fused::warp_sum(v);
    if (lane == 0) scale = rsqrtf(__fadd_rn(__fdiv_rn(v, (float)D), eps));
  }
  __syncthreads();
  const float r = scale;
  for (int i = threadIdx.x; i < nv; i += blockDim.x) {
    const Vec<T, VEC> a = xr[i];
    Vec<T, VEC> o;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float g = to_f32(gamma[i * VEC + j]);
      o.v[j] = from_f32<T>(__fmul_rn(__fmul_rn(to_f32(a.v[j]), r), g));
    }
    outr[i] = o;
  }
}

template <typename T, typename G>
cudaError_t launch(const void* x, const void* gamma, void* out, int rows,
                   int D, float eps, int vec, cudaStream_t stream) {
  const int nv = D / vec;
  const int threads = nv >= 1024 ? 1024 : ((nv + 31) / 32) * 32;
  const T* xp = static_cast<const T*>(x);
  const G* gp = static_cast<const G*>(gamma);
  T* op = static_cast<T*>(out);
  if (vec == 1)
    rms_norm_kernel<T, G, 1><<<rows, threads, 0, stream>>>(xp, gp, op, D,
                                                           eps);
  else
    rms_norm_kernel<T, G, 16 / sizeof(T)><<<rows, threads, 0, stream>>>(
        xp, gp, op, D, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_g(const void* x, const void* gamma, void* out, int rows,
                     int D, float eps, int g_kind, int vec,
                     cudaStream_t stream) {
  switch (g_kind) {
    case 0:
      return launch<T, float>(x, gamma, out, rows, D, eps, vec, stream);
    case 1:
      return launch<T, __nv_bfloat16>(x, gamma, out, rows, D, eps, vec,
                                      stream);
    case 2:
      return launch<T, __half>(x, gamma, out, rows, D, eps, vec, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// x (rows, D) and out (rows, D) contiguous, of type x_kind (0 f32, 1
// bf16); gamma (D,) of type g_kind (0 f32, 1 bf16, 2 fp16). vec is 1 or
// 16 / sizeof(x's type), the latter only for D a multiple of it and
// 16-byte aligned x and out (the host checks). Launches on `stream`,
// does not synchronise, and returns cudaGetLastError() of the launch
// (cudaErrorInvalidValue for arguments it does not take).
extern "C" int rms_norm_launch(const void* x, const void* gamma, void* out,
                               int rows, int D, float eps, int x_kind,
                               int g_kind, int vec, void* stream) {
  const int wide = x_kind == 1 ? 8 : 4;
  if (rows < 1 || D < 1 || (vec != 1 && (vec != wide || D % vec)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_kind == 1)
    return (int)launch_g<__nv_bfloat16>(x, gamma, out, rows, D, eps, g_kind,
                                        vec, s);
  if (x_kind == 0)
    return (int)launch_g<float>(x, gamma, out, rows, D, eps, g_kind, vec, s);
  return (int)cudaErrorInvalidValue;
}
