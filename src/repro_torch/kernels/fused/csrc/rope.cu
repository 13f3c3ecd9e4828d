// Rotary position embedding of q and k for Hopper (sm_90a), both in one
// launch (halves, not interleaved):
//   a_i = float(pos[b, s]) * freq[i],   i < half = head_dim / 2
//   out[.., i]        = x[.., i] * cos(a_i) - x[.., i + half] * sin(a_i)
//   out[.., i + half] = x[.., i] * sin(a_i) + x[.., i + half] * cos(a_i)
// for every head of q (B, S, H, hd) and of k (B, S, Kv, hd), f32 and
// rounded once to the input's type (bf16 or f32). Positions are int32 or
// int64, (B, S) or (S,) (a zero batch stride). freq is the f32 table
// rope_frequencies fills once per (head_dim, theta, device)
// (kernels/fused/kernel.py), so its bits are the plain version's.
//
// Replaces: no TPU kernel. The reference's apply_rope
// (src/repro/models/layers.py:46) is a jnp chain that XLA fuses under
// jax.jit (src/repro/serving/backend.py:451-452); the port ran it as
// about 18 eager kernels a tensor, twice a layer, four of them
// recomputing the frequencies.
//
// Bound on an H100 SXM: by bytes, q and k read and written once, the
// positions and the table read once: llama-3.1-8b's decode (4 tokens,
// 32 + 8 heads of 128) moves 82 KB, about 25 ns, so at decode a call
// costs a launch; a prefill of (2, 3968) moves 163 MB, about 49 us. The
// angles' sin and cos are precise sincosf (angles reach 4096 rad over a
// ring of 4096 slots, past where __sinf/__cosf are accurate), computed
// once a token and frequency, not once a head.
//
// What the design does about it: a block takes one token and a run of
// its heads (q's, then k's), so that decode's few tokens still spread
// over tens of blocks; it computes its token's cos and sin into shared
// memory, then its threads walk (head, i) pairs, neighbouring threads on
// neighbouring columns. The rotation is written with __fmul_rn,
// __fadd_rn and __fsub_rn, so that nvcc's FMA contraction keeps torch's
// separate roundings of each product and sum.
#include <cstdint>

#include "fused.cuh"

namespace {

using fused::from_f32;
using fused::to_f32;

constexpr int kMaxHalf = 256;
constexpr int kThreads = 256;

struct Args {
  const void* q;
  const void* k;
  void* q_out;
  void* k_out;
  const void* pos;
  const float* freq;
  int S, H, Kv, half, heads_per_block;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, p_sb, p_ss;
};

template <typename T, typename P>
__global__ void __launch_bounds__(kThreads) rope_qk_kernel(const Args a) {
  __shared__ float cs[kMaxHalf];
  __shared__ float sn[kMaxHalf];
  const long long token = blockIdx.x;
  const long long b = token / a.S, s = token % a.S;
  const float p =
      (float)static_cast<const P*>(a.pos)[b * a.p_sb + s * a.p_ss];
  for (int i = threadIdx.x; i < a.half; i += blockDim.x) {
    float sv, cv;
    sincosf(__fmul_rn(p, a.freq[i]), &sv, &cv);
    cs[i] = cv;
    sn[i] = sv;
  }
  __syncthreads();
  const int h0 = blockIdx.y * a.heads_per_block;
  const int h1 = min(h0 + a.heads_per_block, a.H + a.Kv);
  const int hd = 2 * a.half;
  const int n = (h1 - h0) * a.half;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int h = h0 + e / a.half, i = e % a.half;
    const T* src;
    T* dst;
    if (h < a.H) {
      src = static_cast<const T*>(a.q) + b * a.q_sb + s * a.q_ss + h * a.q_sh;
      dst = static_cast<T*>(a.q_out) + (token * a.H + h) * hd;
    } else {
      const int hk = h - a.H;
      src = static_cast<const T*>(a.k) + b * a.k_sb + s * a.k_ss +
            hk * a.k_sh;
      dst = static_cast<T*>(a.k_out) + (token * a.Kv + hk) * hd;
    }
    const float x1 = to_f32(src[i]), x2 = to_f32(src[i + a.half]);
    const float c = cs[i], sv = sn[i];
    dst[i] = from_f32<T>(__fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, sv)));
    dst[i + a.half] =
        from_f32<T>(__fadd_rn(__fmul_rn(x1, sv), __fmul_rn(x2, c)));
  }
}

template <typename T>
cudaError_t launch(const Args& a, int tokens, int pos_i64,
                   cudaStream_t stream) {
  dim3 grid(tokens, (a.H + a.Kv + a.heads_per_block - 1) / a.heads_per_block);
  if (pos_i64)
    rope_qk_kernel<T, int64_t><<<grid, kThreads, 0, stream>>>(a);
  else
    rope_qk_kernel<T, int32_t><<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// q (B, S, H, hd) and k (B, S, Kv, hd) of type is_bf16 ? bf16 : f32, each
// with the element strides of its first three axes given (the last axis
// contiguous); q_out and k_out contiguous of the same shapes and type;
// pos int64 (pos_i64) or int32 with element strides p_sb (0 for (S,)
// positions) and p_ss; freq (hd / 2,) f32. heads_per_block: the run of
// heads (q's, then k's) a block takes (the host's plan, kernel.py
// rope_plan). Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() of the launch (cudaErrorInvalidValue for arguments
// it does not take).
extern "C" int rope_launch(const void* q, const void* k, void* q_out,
                           void* k_out, const void* pos, const void* freq,
                           int B, int S, int H, int Kv, int hd,
                           long long q_sb, long long q_ss, long long q_sh,
                           long long k_sb, long long k_ss, long long k_sh,
                           long long p_sb, long long p_ss, int pos_i64,
                           int heads_per_block, int is_bf16, void* stream) {
  if (B < 1 || S < 1 || H < 1 || Kv < 0 || hd < 2 || hd % 2 ||
      hd / 2 > kMaxHalf || heads_per_block < 1)
    return (int)cudaErrorInvalidValue;
  Args a = {q, k, q_out, k_out, pos, static_cast<const float*>(freq),
            S, H, Kv, hd / 2, heads_per_block,
            q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, p_sb, p_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tokens = B * S;
  if (is_bf16) return (int)launch<__nv_bfloat16>(a, tokens, pos_i64, s);
  return (int)launch<float>(a, tokens, pos_i64, s);
}
