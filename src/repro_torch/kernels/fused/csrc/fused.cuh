// Helpers of the fused elementwise kernels (rms_norm.cu, rope.cu,
// silu_mul.cu, ssm_conv_step.cu, ssd_step.cu): conversions between the
// storage types and f32, rounded to nearest even as torch's .to() rounds,
// a 16-byte vector of elements for coalesced loads and stores, a warp's
// sum, and SiLU as torch computes it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace fused {

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <>
__device__ __forceinline__ float to_f32<__half>(__half v) {
  return __half2float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// VEC elements of T read or written as one access (16 bytes when VEC is
// 16 / sizeof(T); the host passes VEC = 1 unless every pointer is 16-byte
// aligned and the row length a multiple of VEC)
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// silu(x) = x / (1 + exp(-x)) in f32 with the precise expf and an IEEE
// division: the bits of torch's F.silu on a float
__device__ __forceinline__ float silu(float x) {
  return __fdiv_rn(x, __fadd_rn(1.f, expf(-x)));
}

}  // namespace fused
