// One token's SSD state update and gated output of a Mamba2 decode step
// for Hopper (sm_90a), one launch a call. For row r, head i of group
// g = i / (nh / ng) and state row p:
//   dt   = softplus(dt_raw[r, i] + dt_bias[i])      (logaddexp(., 0))
//   dA   = exp(dt * -exp(A_log[i]))
//   h[r, i, p, :] = h * dA + (x[r, i, p] * dt) * B[r, g, :]   (in place)
//   y    = sum_s h[r, i, p, s] * C[r, g, s] + x[r, i, p] * D[i]
//   out[r, i, p] = round(round(y) * round(silu(z[r, i, p])))
// in f32, each product and sum rounded as torch rounds them, y and
// silu(z) rounded to the activation type before their product: the port's
// plain version (kernels/fused/kernel.py ssd_step_plain), whose output the
// gate norm takes. x, z, B, C and dt are bf16 or f32, views of the conv
// output and the input projection (last axis contiguous, the other axes
// any stride); dt_bias, A_log and D f32, bf16 or fp16; the state h
// (rows, nh, hd, ds) f32, contiguous, 16-byte aligned, ds a multiple of 4.
//
// Replaces: no TPU kernel. The reference's ssd_decode_step
// (src/repro/models/ssm.py:154) and the dt, A and gate lines of
// mamba_block_decode (:249-255) are jnp chains that XLA fuses under
// jax.jit(model.decode_step) (src/repro/serving/backend.py:451); the port
// ran them as about 30 eager kernels a Mamba layer, which read and wrote
// the state about nine times, and a copy of the new state into the stack.
//
// Bound on an H100 SXM: by bytes, the state read and written once and the
// rest read or written once: mamba2-2.7b at batch 4 (nh 80, hd 64, ds
// 128) in bf16 moves 21.1 MB, about 6.3 us; zamba2-1.2b (nh 64, hd 64, ds
// 64) 8.4 MB, about 2.5 us.
//
// What the design does about it: one pass over the state. A warp takes a
// state row (r, i, p): each lane reads its float4s of the row (lane j
// takes elements 4j..4j+3, then 4j+128...), updates them, writes them
// back and sums their products with C in order; a butterfly of shuffles
// sums the lanes. A block takes kWarps rows of one (r, i), so that even
// one row of the batch (mamba2: 80 heads) gives hundreds of blocks and
// keeps many loads of the state in flight. Every element's arithmetic and
// the order of each sum over ds depend on ds alone, never on the batch or
// the grid: a row of a batch gets the bits it gets alone.
#include "fused.cuh"

namespace {

using fused::from_f32;
using fused::to_f32;

constexpr int kWarps = 8;

struct Args {
  const void* x;
  const void* B;
  const void* C;
  const void* z;
  const void* dt;
  const void* dt_bias;
  const void* A_log;
  const void* D;
  float* h;
  void* g;
  int rows, nh, hd, ng, ds;
  long long x_s0, x_s1, B_s0, B_s1, C_s0, C_s1, z_s0, z_s1, dt_s0;
};

// logaddexp(v, 0) as torch computes it for a float: max + log1p(exp(-|d|))
__device__ __forceinline__ float softplus(float v) {
  return __fadd_rn(fmaxf(v, 0.f), log1pf(expf(-fabsf(v))));
}

template <typename T, typename P>
__global__ void __launch_bounds__(kWarps * 32) ssd_step_kernel(const Args a) {
  const int chunks = (a.hd + kWarps - 1) / kWarps;
  const int chunk = blockIdx.x % chunks;
  const int rh = blockIdx.x / chunks;  // r * nh + i
  const int i = rh % a.nh, r = rh / a.nh;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int p = chunk * kWarps + warp;
  if (p >= a.hd) return;  // the whole warp
  const T* x = static_cast<const T*>(a.x);
  const T* z = static_cast<const T*>(a.z);
  const T* dt_raw = static_cast<const T*>(a.dt);
  const P* dt_bias = static_cast<const P*>(a.dt_bias);
  const P* A_log = static_cast<const P*>(a.A_log);
  const P* D = static_cast<const P*>(a.D);
  const float dt = softplus(
      __fadd_rn(to_f32(dt_raw[r * a.dt_s0 + i]), to_f32(dt_bias[i])));
  const float dA = expf(__fmul_rn(dt, -expf(to_f32(A_log[i]))));
  const float xv = to_f32(x[r * a.x_s0 + i * a.x_s1 + p]);
  const float xdt = __fmul_rn(xv, dt);
  const int grp = i / (a.nh / a.ng);
  const T* Bg = static_cast<const T*>(a.B) + r * a.B_s0 + grp * a.B_s1;
  const T* Cg = static_cast<const T*>(a.C) + r * a.C_s0 + grp * a.C_s1;
  float4* hp =
      reinterpret_cast<float4*>(a.h + ((long long)rh * a.hd + p) * a.ds);
  float acc = 0.f;
  for (int j = lane; j < a.ds / 4; j += 32) {
    const float4 s = hp[j];
    float e[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = 4 * j + q;
      e[q] = __fadd_rn(__fmul_rn(e[q], dA), __fmul_rn(xdt, to_f32(Bg[k])));
      acc = __fadd_rn(acc, __fmul_rn(e[q], to_f32(Cg[k])));
    }
    hp[j] = make_float4(e[0], e[1], e[2], e[3]);
  }
  acc = fused::warp_sum(acc);
  if (lane == 0) {
    const T y = from_f32<T>(__fadd_rn(acc, __fmul_rn(xv, to_f32(D[i]))));
    const float zv = to_f32(z[r * a.z_s0 + i * a.z_s1 + p]);
    const float s = to_f32(from_f32<T>(fused::silu(zv)));
    static_cast<T*>(a.g)[(long long)rh * a.hd + p] =
        from_f32<T>(__fmul_rn(to_f32(y), s));
  }
}

template <typename T, typename P>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const long long blocks =
      (long long)a.rows * a.nh * ((a.hd + kWarps - 1) / kWarps);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  ssd_step_kernel<T, P><<<(int)blocks, kWarps * 32, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_p(const Args& a, int p_kind, cudaStream_t stream) {
  switch (p_kind) {
    case 0:
      return launch<T, float>(a, stream);
    case 1:
      return launch<T, __nv_bfloat16>(a, stream);
    case 2:
      return launch<T, __half>(a, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// x and z (rows, nh, hd), B and C (rows, ng, ds), dt (rows, nh), of type
// x_kind (0 f32, 1 bf16), each with its last axis contiguous and the
// strides of its other axes given (dt: its row stride); dt_bias, A_log
// and D (nh,) contiguous, of type p_kind (0 f32, 1 bf16, 2 fp16); h
// (rows, nh, hd, ds) f32, contiguous and 16-byte aligned, updated in
// place; g (rows, nh, hd) contiguous, of x's type. ng divides nh, 4
// divides ds. Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() of the launch (cudaErrorInvalidValue for arguments
// it does not take).
extern "C" int ssd_step_launch(
    const void* x, const void* B, const void* C, const void* z,
    const void* dt, const void* dt_bias, const void* A_log, const void* D,
    void* h, void* g, int rows, int nh, int hd, int ng, int ds,
    long long x_s0, long long x_s1, long long B_s0, long long B_s1,
    long long C_s0, long long C_s1, long long z_s0, long long z_s1,
    long long dt_s0, int x_kind, int p_kind, void* stream) {
  if (rows < 1 || nh < 1 || hd < 1 || ng < 1 || nh % ng || ds < 4 ||
      ds % 4 || reinterpret_cast<unsigned long long>(h) % 16)
    return (int)cudaErrorInvalidValue;
  const Args a{x, B, C, z, dt, dt_bias, A_log, D,
               static_cast<float*>(h), g, rows, nh, hd, ng, ds,
               x_s0, x_s1, B_s0, B_s1, C_s0, C_s1, z_s0, z_s1, dt_s0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_kind == 1) return (int)launch_p<__nv_bfloat16>(a, p_kind, s);
  if (x_kind == 0) return (int)launch_p<float>(a, p_kind, s);
  return (int)cudaErrorInvalidValue;
}
