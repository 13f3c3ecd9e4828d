// Flash attention (prefill) for Hopper (sm_90a):
//   out (B, S, H, d) = softmax(q k^T / sqrt(d) + mask) v
// with q (B, S, H, d), k and v (B, T, Kv, d), query head h reading KV head
// h / G (G = H / Kv), a causal mask (key <= query, both counted from 0) and
// an optional sliding window (key > query - window).
//
// Replaces: src/repro/kernels/flash_attention/kernel.py,
// flash_attention_pallas (body _flash_kernel). Same arithmetic: f32
// scores times 1/sqrt(d), masked entries set to the finite -1e30 (never
// -inf, so a row whose first tiles are wholly masked adds exp(0) terms
// that the next real score wipes with corr = exp(-1e30 - m) = 0, as on
// the TPU), an online softmax over key tiles with f32 running max and
// sum, the unnormalised p rounded to v's dtype before the PV product, f32
// sums, and acc / max(l, 1e-20) cast once to q's dtype. Unlike the Pallas
// kernel it takes any S, T >= 1: keys past T get p = 0 and rows past S
// are not stored.
//
// Bound on an H100 SXM: by operations. A causal llama-3.1-8b prefill of
// S = 2048 tokens does 2 * 2 * H * d * S(S+1)/2 = 34 GFLOP per layer over
// 42 MB of bf16 q, k, v and out: 0.035 ms at the bf16 tensor-core peak
// against 0.013 ms for the bytes. In f32 (no TF32) the 67 TFLOP/s of the
// CUDA cores make it 0.51 ms.
//
// What the design does about it: one block owns 64 query rows, made of
// 64 / G positions times all G query heads of one KV head, so each K/V
// tile is read from device memory once for the whole group and never
// repeated per query head. The block walks the key tiles of 64 keys that
// its rows may see (causal tiles past the diagonal, and tiles wholly
// before the window, are skipped), staged in shared memory.
// bf16 (flash_mma_kernel) runs both products on the tensor cores with
// mma.sync m16n8k16 and f32 sums: 4 warps of 16 rows, Q fragments held in
// registers, p rounded to bf16 straight into the A fragments of the PV
// product. f32 (flash_kernel) runs on the CUDA cores, since TF32 would
// round the inputs: 8 warps of 8 rows, K, V and Q staged as f32, a lane
// computing the scores of 2 keys, p through shared memory, and a lane
// keeping the output sums of d / 32 columns. Loads are plain and
// synchronous: a cp.async or TMA pipeline and wgmma are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 64;                   // (position, head) rows a block owns
constexpr int kRowsPerWarp = kRows / kWarps;
constexpr int kBK = 64;                     // keys per tile

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
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
// round an f32 value to T and widen it back
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// 16 bytes of T at src, widened to floats at dst (16-byte aligned)
template <typename T>
__device__ __forceinline__ void load16(float* dst, const T* src) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<uint4*>(dst) = raw;
  } else {
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
    float4 a, b;
    a.x = to_f(h[0]); a.y = to_f(h[1]); a.z = to_f(h[2]); a.w = to_f(h[3]);
    b.x = to_f(h[4]); b.y = to_f(h[5]); b.z = to_f(h[6]); b.w = to_f(h[7]);
    reinterpret_cast<float4*>(dst)[0] = a;
    reinterpret_cast<float4*>(dst)[1] = b;
  }
}

template <typename T>
__device__ __forceinline__ void zero16(float* dst) {
  constexpr int n = 16 / (int)sizeof(T);
#pragma unroll
  for (int i = 0; i < n; i += 4)
    *reinterpret_cast<float4*>(dst + i) = make_float4(0.f, 0.f, 0.f, 0.f);
}

// a lane's N consecutive columns of a shared f32 row, as one vector load
template <int N>
__device__ __forceinline__ void load_cols(float (&dst)[N], const float* src) {
  static_assert(N == 2 || N == 4, "columns per lane");
  if constexpr (N == 4) {
    const float4 t = *reinterpret_cast<const float4*>(src);
    dst[0] = t.x; dst[1] = t.y; dst[2] = t.z; dst[3] = t.w;
  } else {
    const float2 t = *reinterpret_cast<const float2*>(src);
    dst[0] = t.x; dst[1] = t.y;
  }
}

// The key tiles [k_begin, k_end) that query positions q0 .. q0 + BQ - 1
// may see: causal tiles past the diagonal, and tiles wholly before the
// window, are skipped.
__device__ __forceinline__ void key_range(int q0, int BQ, int S, int T_,
                                          int causal, int window,
                                          int& k_begin, int& k_end) {
  const int q_last = min(S, q0 + BQ) - 1;
  k_begin = 0;
  k_end = T_;
  if (causal) {
    k_end = min(T_, q_last + 1);
    if (window > 0) k_begin = max(0, q0 - window + 1) / kBK * kBK;
  }
}

// whether query position qp may see key position kp (kp < T_)
__device__ __forceinline__ bool allowed(int qp, int kp, int causal,
                                        int window) {
  return (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
}

template <int D>
struct Smem {
  static constexpr int kStride = D + 4;     // K rows: conflict-free float4
  float q[kRows][D];
  float k[kBK][kStride];
  float v[kBK][D];
  float p[kRows][kBK];
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int S, int T_,
                 int H, int Kv, int causal, int window, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(smem_raw);
  constexpr int E = 16 / (int)sizeof(T);    // elements per 16-byte piece
  constexpr int CPR = D / E;                // pieces per row
  constexpr int DPL = D / 32;               // output columns per lane

  const int G = H / Kv;
  const int BQ = kRows / G;                 // query positions per block
  const int rows = BQ * G;
  const int b = blockIdx.y / Kv, kv = blockIdx.y % Kv;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int r0 = warp * kRowsPerWarp;

  // query tile: row r is position q0 + r / G, head kv * G + r % G
  for (int c = tid; c < kRows * CPR; c += kThreads) {
    const int r = c / CPR, e = (c % CPR) * E;
    const int qi = q0 + r / G;
    if (r < rows && qi < S)
      load16<T>(&sm.q[r][e],
                q + ((size_t)(b * S + qi) * H + kv * G + r % G) * D + e);
    else
      zero16<T>(&sm.q[r][e]);
  }

  int qpos[kRowsPerWarp];
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DPL];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    qpos[i] = q0 + (r0 + i) / G;
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[i][c] = 0.f;
  }

  int k_begin, k_end;
  key_range(q0, BQ, S, T_, causal, window, k_begin, k_end);
  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();   // the previous tile's K and V are no longer read
    const int nk = min(kBK, T_ - k0);
    for (int c = tid; c < kBK * CPR; c += kThreads) {
      const int j = c / CPR, e = (c % CPR) * E;
      if (j < nk) {
        const size_t off = ((size_t)(b * T_ + k0 + j) * Kv + kv) * D + e;
        load16<T>(&sm.k[j][e], k + off);
        load16<T>(&sm.v[j][e], v + off);
      } else {
        zero16<T>(&sm.k[j][e]);
        zero16<T>(&sm.v[j][e]);
      }
    }
    __syncthreads();

    // scores of keys k0 + lane and k0 + lane + 32 for the warp's 8 rows
    float s[kRowsPerWarp][2];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 4
    for (int e = 0; e < D; e += 4) {
      const float4 ka = *reinterpret_cast<const float4*>(&sm.k[lane][e]);
      const float4 kb =
          *reinterpret_cast<const float4*>(&sm.k[lane + 32][e]);
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(&sm.q[r0 + i][e]);
        s[i][0] = fmaf(qv.x, ka.x, s[i][0]);
        s[i][0] = fmaf(qv.y, ka.y, s[i][0]);
        s[i][0] = fmaf(qv.z, ka.z, s[i][0]);
        s[i][0] = fmaf(qv.w, ka.w, s[i][0]);
        s[i][1] = fmaf(qv.x, kb.x, s[i][1]);
        s[i][1] = fmaf(qv.y, kb.y, s[i][1]);
        s[i][1] = fmaf(qv.z, kb.z, s[i][1]);
        s[i][1] = fmaf(qv.w, kb.w, s[i][1]);
      }
    }

    float corr[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      float mt = kNegInf;
      bool exists[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kp = k0 + lane + 32 * h;
        exists[h] = kp < T_;
        const bool allow = exists[h] && allowed(qpos[i], kp, causal, window);
        s[i][h] = allow ? s[i][h] * scale : kNegInf;
        mt = fmaxf(mt, s[i][h]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      const float m_new = fmaxf(m[i], mt);
      float sum = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float p = exists[h] ? expf(s[i][h] - m_new) : 0.f;
        sum += p;
        sm.p[r0 + i][lane + 32 * h] = round_to<T>(p);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      corr[i] = expf(m[i] - m_new);
      l[i] = l[i] * corr[i] + sum;
      m[i] = m_new;
    }
    __syncwarp();

    // acc = acc * corr + p @ v over the tile's keys, f32 sums
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
      for (int c = 0; c < DPL; ++c) acc[i][c] *= corr[i];
    for (int j = 0; j < kBK; j += 4) {
      float4 pv[kRowsPerWarp];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i)
        pv[i] = *reinterpret_cast<const float4*>(&sm.p[r0 + i][j]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float vv[DPL];
        load_cols<DPL>(vv, &sm.v[j + jj][lane * DPL]);
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          const float pj = jj == 0 ? pv[i].x
                         : jj == 1 ? pv[i].y
                         : jj == 2 ? pv[i].z
                                   : pv[i].w;
#pragma unroll
          for (int c = 0; c < DPL; ++c) acc[i][c] = fmaf(pj, vv[c], acc[i][c]);
        }
      }
    }
    __syncwarp();      // the warp's p rows are read before the next tile
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = r0 + i;
    const int qi = q0 + r / G;
    if (r >= rows || qi >= S) continue;
    const float denom = fmaxf(l[i], 1e-20f);
    T* o = out + ((size_t)(b * S + qi) * H + kv * G + r % G) * D + lane * DPL;
#pragma unroll
    for (int c = 0; c < DPL; ++c) o[c] = from_f<T>(acc[i][c] / denom);
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16, bf16 in, f32 sums)
// ---------------------------------------------------------------------------
constexpr int kMmaThreads = 128;            // 4 warps of 16 rows
constexpr int kPad = 8;   // bf16 per shared row: ldmatrix without conflicts

template <int D>
struct MmaSmem {
  __nv_bfloat16 q[kRows][D + kPad];
  __nv_bfloat16 k[kBK][D + kPad];
  __nv_bfloat16 v[kBK][D + kPad];
};

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// two f32 values rounded to bf16, the first in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// The same rows, tiles, masks and rounding points as flash_kernel, with
// the two products on the tensor cores. Each warp owns 16 rows; its Q
// fragments stay in registers for the whole key loop. S = Q K^T comes out
// in the mma accumulator layout (a lane holds rows lane/4 and lane/4 + 8,
// two columns per 8-key tile); the row max and sum are reduced over the 4
// lanes of a quad; p is rounded to bf16 straight into the A fragments of
// the PV product, whose V fragments are read with ldmatrix.trans.
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
    flash_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ out, int S, int T_, int H,
                     int Kv, int causal, int window, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  MmaSmem<D>& sm = *reinterpret_cast<MmaSmem<D>*>(smem_raw);
  constexpr int CPR = D / 8;                // 16-byte pieces per row
  constexpr int NT = kBK / 8;               // 8-key tiles of S
  constexpr int DT = D / 8;                 // 8-column tiles of the output
  constexpr int KS = D / 16;                // 16-deep steps over d

  const int G = H / Kv;
  const int BQ = kRows / G;
  const int rows = BQ * G;
  const int b = blockIdx.y / Kv, kv = blockIdx.y % Kv;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  for (int c = tid; c < kRows * CPR; c += kMmaThreads) {
    const int r = c / CPR, e = (c % CPR) * 8;
    const int qi = q0 + r / G;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < rows && qi < S)
      val = *reinterpret_cast<const uint4*>(
          q + ((size_t)(b * S + qi) * H + kv * G + r % G) * D + e);
    *reinterpret_cast<uint4*>(&sm.q[r][e]) = val;
  }
  __syncthreads();
  unsigned qa[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    ldmatrix_x4(qa[ks], &sm.q[warp * 16 + lane % 16][ks * 16 + (lane / 16) * 8]);

  // this lane's two rows (h = 0, 1) and their query positions
  int row[2], qp[2];
  float m[2], l[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = warp * 16 + lane / 4 + 8 * h;
    qp[h] = q0 + row[h] / G;
    m[h] = kNegInf;
    l[h] = 0.f;
  }
  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  int k_begin, k_end;
  key_range(q0, BQ, S, T_, causal, window, k_begin, k_end);
  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();   // the previous tile's K and V are no longer read
    const int nk = min(kBK, T_ - k0);
    for (int c = tid; c < kBK * CPR; c += kMmaThreads) {
      const int j = c / CPR, e = (c % CPR) * 8;
      uint4 kval = make_uint4(0, 0, 0, 0), vval = kval;
      if (j < nk) {
        const size_t off = ((size_t)(b * T_ + k0 + j) * Kv + kv) * D + e;
        kval = *reinterpret_cast<const uint4*>(k + off);
        vval = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(&sm.k[j][e]) = kval;
      *reinterpret_cast<uint4*>(&sm.v[j][e]) = vval;
    }
    __syncthreads();

    // S (16 x 64) of the warp's rows: element (row[h], key nt*8 + 2*(lane%4)
    // + e) is sc[nt][2*h + e]
    float sc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        unsigned kb[4];
        ldmatrix_x4(kb, &sm.k[nt * 8 + lane % 8 + (lane / 16) * 8]
                            [ks * 16 + ((lane / 8) % 2) * 8]);
        mma_bf16(sc[nt], qa[ks], kb[0], kb[1]);
        mma_bf16(sc[nt + 1], qa[ks], kb[2], kb[3]);
      }

    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mt = kNegInf;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kp = k0 + nt * 8 + (lane % 4) * 2 + e;
          float& x = sc[nt][2 * h + e];
          x = kp < T_ && allowed(qp[h], kp, causal, window) ? x * scale
                                                            : kNegInf;
          mt = fmaxf(mt, x);
        }
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float m_new = fmaxf(m[h], mt);
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kp = k0 + nt * 8 + (lane % 4) * 2 + e;
          float& x = sc[nt][2 * h + e];
          x = kp < T_ ? expf(x - m_new) : 0.f;
          sum += x;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      corr[h] = expf(m[h] - m_new);
      l[h] = l[h] * corr[h] + sum;
      m[h] = m_new;
    }
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      o[j][0] *= corr[0];
      o[j][1] *= corr[0];
      o[j][2] *= corr[1];
      o[j][3] *= corr[1];
    }

    // o += p @ v: p rounded to bf16 as the A fragments, 16 keys a step
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      unsigned pa[4];
      pa[0] = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
      pa[1] = pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
      pa[2] = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      pa[3] = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
#pragma unroll
      for (int j = 0; j < DT; j += 2) {
        unsigned vb[4];
        ldmatrix_x4_trans(vb, &sm.v[kk * 16 + lane % 16][j * 8 + (lane / 16) * 8]);
        mma_bf16(o[j], pa, vb[0], vb[1]);
        mma_bf16(o[j + 1], pa, vb[2], vb[3]);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row[h];
    if (r >= rows || qp[h] >= S) continue;
    const float denom = fmaxf(l[h], 1e-20f);
    __nv_bfloat16* dst =
        out + ((size_t)(b * S + qp[h]) * H + kv * G + r % G) * D +
        (lane % 4) * 2;
#pragma unroll
    for (int j = 0; j < DT; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + j * 8) = __floats2bfloat162_rn(
          o[j][2 * h] / denom, o[j][2 * h + 1] / denom);
  }
}

// Launch `kernel` with `smem` bytes of dynamic shared memory. The limit
// is raised once per kernel (`ready`), so that later launches, inside a
// CUDA graph capture too, make no attribute call.
template <typename Kernel, typename T>
cudaError_t launch_with(Kernel kernel, int threads, int smem, bool& ready,
                        const T* q, const T* k, const T* v, T* out, int B,
                        int S, int T_, int H, int Kv, int causal, int window,
                        float scale, cudaStream_t stream) {
  if (!ready) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  const int BQ = kRows / (H / Kv);
  dim3 grid((S + BQ - 1) / BQ, B * Kv);
  kernel<<<grid, threads, smem, stream>>>(q, k, v, out, S, T_, H, Kv, causal,
                                          window, scale);
  return cudaGetLastError();
}

// bf16 on the tensor cores, f32 on the CUDA cores
template <typename T, int D>
cudaError_t launch(const T* q, const T* k, const T* v, T* out, int B, int S,
                   int T_, int H, int Kv, int causal, int window, float scale,
                   cudaStream_t stream) {
  static bool ready = false;
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return launch_with(flash_mma_kernel<D>, kMmaThreads,
                       (int)sizeof(MmaSmem<D>), ready, q, k, v, out, B, S, T_,
                       H, Kv, causal, window, scale, stream);
  else
    return launch_with(flash_kernel<T, D>, kThreads, (int)sizeof(Smem<D>),
                       ready, q, k, v, out, B, S, T_, H, Kv, causal, window,
                       scale, stream);
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* out,
                     int B, int S, int T_, int H, int Kv, int D, int causal,
                     int window, float scale, cudaStream_t s) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
  if (D == 64)
    return launch<T, 64>(qt, kt, vt, ot, B, S, T_, H, Kv, causal, window,
                         scale, s);
  if (D == 128)
    return launch<T, 128>(qt, kt, vt, ot, B, S, T_, H, Kv, causal, window,
                          scale, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// q and out (B, S, H, D), k and v (B, T, Kv, D): contiguous, 16-byte
// aligned, bf16 when is_bf16 else f32. D is 64 or 128; G = H / Kv is at
// most 64. window <= 0 means no window. Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() of the launch.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int S,
                                      int T, int H, int Kv, int D,
                                      int causal, int window, float scale,
                                      int is_bf16, void* stream) {
  if (Kv <= 0 || H % Kv || H / Kv > kRows) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)launch_d<__nv_bfloat16>(q, k, v, out, B, S, T, H, Kv, D,
                                        causal, window, scale, s);
  return (int)launch_d<float>(q, k, v, out, B, S, T, H, Kv, D, causal,
                              window, scale, s);
}
