// NF4 dequant-matmul for Hopper (sm_90a):
//   out (M, N) = x (M, K) @ W (K, N),
//   W[k, n] = round_to_compute(NF4[code(k, n)] * absmax[k / block, n])
// with f32 accumulation, no epilogue scale, and the compute dtype (bf16
// or f32) as output.
//
// Replaces: src/repro/kernels/quant_matmul/kernel.py, nf4_matmul_pallas
// (body _nf4_kernel). Same unpacking (two codes per byte along K, the
// even row in the low nibble), the same 16-entry codebook, and the same
// rounding of each dequantized weight to the compute dtype before the
// product (kernel.py:103).
//
// Bound on an H100 SXM: at decode (M = 1-8) the weight bytes. The
// (4096, 14336) w_gate is 29.4 MB of packed codes plus 3.7 MB of f32
// absmax (block 64), about 9.9 us at 3.35 TB/s. At prefill (M = 512) the
// 2*M*K*N operations bound it instead.
//
// What the design does about it: each packed byte and each absmax value
// is read from device memory once and dequantized on chip, so no 16-bit
// copy of the weight is ever written back. At decode the codes and scales
// stream through a 4-stage cp.async ring in shared memory
// (quant_matmul.cuh, qmm_decode_kernel) and are dequantized from there
// into registers, 8 weights per 4-byte read, and multiplied on the CUDA
// cores in f32. The codebook lives in __constant__ memory and is copied
// to shared memory once per block. At prefill in bf16 (qmm_mma_kernel)
// each 32 x 128 tile is dequantized to bf16 in shared memory and fed to
// the tensor cores with mma.sync; f32 compute and unaligned shapes take
// the CUDA-core tile kernel (qmm_tile_kernel). wgmma, TMA, a multi-stage
// prefill pipeline and a persistent grid are later work.
#include "quant_matmul.cuh"

namespace {

// The 16 NF4 code points (Dettmers et al. 2023), as in
// repro_torch/quant/nf4.py::NF4_CODEBOOK.
__constant__ float kNF4[16] = {
    -1.0f, -0.6961928009986877f, -0.5250730514526367f,
    -0.39491748809814453f, -0.28444138169288635f, -0.18477343022823334f,
    -0.09105003625154495f, 0.0f, 0.07958029955625534f,
    0.16093020141124725f, 0.24611230194568634f, 0.33791524171829224f,
    0.44070982933044434f, 0.5626170039176941f, 0.7229568362236023f, 1.0f};

struct NF4Format {
  const uint8_t* packed;   // (K / 2, N)
  const float* absmax;     // (K / block, N)
  int block;               // even, divides K

  // dequantize one code with its absmax, rounded to the compute dtype
  template <typename T>
  __device__ __forceinline__ static float dq(const float* lut, int code,
                                             float a) {
    return qmm::round_to<T>(lut[code] * a);
  }

  // -- tile kernel: ws (BK, BN) <- dequantized rows k0:k0+BK, 0 past the
  // edges. BK and k0 are even and K is a multiple of the (even) block, so
  // a byte's two rows share one absmax and never straddle K.
  template <typename T, int BK, int BN>
  __device__ __forceinline__ void load_tile(float (*ws)[BN], int k0, int n0,
                                            int K, int N, int tid) const {
    for (int i = tid; i < (BK / 2) * BN; i += qmm::kThreads) {
      const int pp = i / BN, nn = i % BN;
      const int gk = k0 + 2 * pp, gn = n0 + nn;
      float lo = 0.f, hi = 0.f;
      if (gk < K && gn < N) {
        const uint8_t b = packed[(size_t)(gk >> 1) * N + gn];
        const float a = absmax[(size_t)(gk / block) * N + gn];
        lo = qmm::round_to<T>(kNF4[b & 0x0F] * a);
        hi = qmm::round_to<T>(kNF4[b >> 4] * a);
      }
      ws[2 * pp][nn] = lo;
      ws[2 * pp + 1][nn] = hi;
    }
  }

  __device__ __forceinline__ float epilogue(float acc, int) const {
    return acc;
  }

  // -- tensor-core kernel: ws (32, 128) <- dequantized bf16, 0 past N.
  // Each thread unpacks 8 bytes of one packed row: rows 2p and 2p+1 of 8
  // columns (N % 16 == 0).
  bool mma_ok(int, int) const {
    return (reinterpret_cast<uintptr_t>(packed) & 7) == 0 &&
           qmm::aligned16(absmax);
  }
  __device__ __forceinline__ void load_mma_tile(qmm::MmaWTile& ws,
                                                const float* lut, int k0,
                                                int n0, int N,
                                                int tid) const {
    const int p = tid / 16, c = (tid % 16) * 8, k = k0 + 2 * p;
    __align__(16) __nv_bfloat16 lo[8], hi[8];
    if (n0 + c < N) {
      const uint2 raw = *reinterpret_cast<const uint2*>(
          packed + (size_t)(k / 2) * N + n0 + c);
      const uint8_t* b = reinterpret_cast<const uint8_t*>(&raw);
      const float4* ap = reinterpret_cast<const float4*>(
          absmax + (size_t)(k / block) * N + n0 + c);
      const float4 a0 = ap[0], a1 = ap[1];
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        lo[j] = __float2bfloat16_rn(lut[b[j] & 0x0F] * a[j]);
        hi[j] = __float2bfloat16_rn(lut[b[j] >> 4] * a[j]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) lo[j] = hi[j] = __float2bfloat16_rn(0.f);
    }
    *reinterpret_cast<uint4*>(&ws[2 * p][c]) = *reinterpret_cast<uint4*>(lo);
    *reinterpret_cast<uint4*>(&ws[2 * p + 1][c]) =
        *reinterpret_cast<uint4*>(hi);
  }

  // -- decode kernel: a stage holds the raw (kDecBK / 2, kDecBN) packed
  // tile, then the (kDecBK / block, kDecBN) absmax tile
  bool dec_ok(int, int) const {
    return qmm::kDecBK % block == 0 && qmm::aligned16(packed) &&
           qmm::aligned16(absmax);
  }
  __host__ __device__ int packed_bytes() const {
    return qmm::kDecBK / 2 * qmm::kDecBN;
  }
  __host__ __device__ int dec_tile_bytes() const {
    return packed_bytes() + qmm::kDecBK / block * qmm::kDecBN * 4;
  }
  // the codebook, copied from __constant__ memory to shared memory once
  // per block: lookups by 32 different codes then cost one shared access
  // instead of up to 16 serialised constant-cache reads
  __device__ __forceinline__ void prepare(float* lut, int tid) const {
    if (tid < 16) lut[tid] = kNF4[tid];
  }
  __device__ __forceinline__ void dec_load(uint8_t* stage, int k0, int n0,
                                           int N, int tid) const {
    constexpr int per_row = qmm::kDecBN / 16;       // 16-byte pieces
    for (int c = tid; c < qmm::kDecBK / 2 * per_row; c += qmm::kThreads) {
      const int r = c / per_row, j = (c % per_row) * 16;
      qmm::cp_async16(stage + r * qmm::kDecBN + j,
                      packed + (size_t)(k0 / 2 + r) * N + n0 + j);
    }
    uint8_t* am = stage + packed_bytes();
    constexpr int am_row = qmm::kDecBN / 4;         // 16-byte pieces
    const int chunks = qmm::kDecBK / block * am_row;
    for (int c = tid; c < chunks; c += qmm::kThreads)
      qmm::cp_async16(am + c * 16, absmax +
                                       (size_t)(k0 / block + c / am_row) * N +
                                       n0 + (c % am_row) * 4);
  }
  // packed rows kg, kg + kKGroups, ... (K rows 2p and 2p+1); columns
  // 4*cg .. 4*cg+3
  template <typename T, int MR>
  __device__ __forceinline__ void dec_compute(
      const uint8_t* stage, const T* xs, const float* lut,
      float (&acc)[MR][4], int kg, int cg) const {
    const float* am = reinterpret_cast<const float*>(stage + packed_bytes());
#pragma unroll 2
    for (int i = 0; i < qmm::kDecBK / 2 / qmm::kKGroups; ++i) {
      const int p = i * qmm::kKGroups + kg, k = 2 * p;
      const uchar4 b = *reinterpret_cast<const uchar4*>(
          stage + p * qmm::kDecBN + cg * 4);
      const float4 a = *reinterpret_cast<const float4*>(
          am + (k / block) * qmm::kDecBN + cg * 4);
      const float lo[4] = {dq<T>(lut, b.x & 0x0F, a.x),
                           dq<T>(lut, b.y & 0x0F, a.y),
                           dq<T>(lut, b.z & 0x0F, a.z),
                           dq<T>(lut, b.w & 0x0F, a.w)};
      const float hi[4] = {dq<T>(lut, b.x >> 4, a.x),
                           dq<T>(lut, b.y >> 4, a.y),
                           dq<T>(lut, b.z >> 4, a.z),
                           dq<T>(lut, b.w >> 4, a.w)};
#pragma unroll
      for (int m = 0; m < MR; ++m) {
        const float x0 = qmm::to_f<T>(xs[m * qmm::kDecBK + k]);
        const float x1 = qmm::to_f<T>(xs[m * qmm::kDecBK + k + 1]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[m][j] = fmaf(x1, hi[j], fmaf(x0, lo[j], acc[m][j]));
      }
    }
  }
};

}  // namespace

// x (M, K) and out (M, N) in the compute dtype (bf16 when is_bf16, else
// f32); packed uint8 (K/2, N); absmax f32 (K/block, N). All row-major and
// contiguous. Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() of the launch.
extern "C" int nf4_matmul_launch(const void* x, const void* packed,
                                 const void* absmax, void* out, int M,
                                 int N, int K, int block, int is_bf16,
                                 void* stream) {
  NF4Format fmt{static_cast<const uint8_t*>(packed),
                static_cast<const float*>(absmax), block};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)qmm::launch(static_cast<const __nv_bfloat16*>(x), fmt,
                            static_cast<__nv_bfloat16*>(out), M, N, K, s);
  return (int)qmm::launch(static_cast<const float*>(x), fmt,
                          static_cast<float*>(out), M, N, K, s);
}
