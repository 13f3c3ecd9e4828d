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
// to shared memory once per block. At prefill in bf16 (M > 8;
// qmm_wgmma.cuh) a persistent grid of warp-specialised blocks keeps a
// 4-stage TMA ring full: x tiles, raw 32 x BN packed tiles and the absmax
// rows of the same 64 K rows (NF4Stage below); each consumer thread
// dequantizes its fragment of the weights to bf16 in registers, the A
// operand of wgmma (x is B).
// f32 compute, blocks other than 32 or a multiple of 64, and shapes the
// plan gives neither loop take the CUDA-core tile kernel
// (qmm_tile_kernel).
#include "qmm_wgmma.cuh"
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

// -- the wgmma prefill loop (qmm_wgmma.cuh): a stage holds the raw
// (32, BN) packed tile (K rows 64 kt .. 64 kt + 63, with the swizzle of
// qmm::wg::raw_at), then the absmax rows those K rows use: one for a
// block that is a multiple of 64, two for block 32. Both copied by TMA
// (0 past N).
struct NF4Stage {
  CUtensorMap packed;   // (K / 2, N) uint8, box (32 rows, BN)
  CUtensorMap absmax;   // (K / block, N) f32, box (rows, BN)
  int block;            // 32, or a multiple of 64
  int rows;             // absmax rows a stage holds: 64 / block, or 1

  template <int BN>
  __host__ __device__ static constexpr int raw_bytes() {
    return qmm::wg::kBK / 2 * BN + 2 * BN * 4;
  }
  template <int BN>
  __device__ __forceinline__ uint32_t tx_bytes() const {
    return qmm::wg::kBK / 2 * BN + rows * BN * 4;
  }
  __device__ __forceinline__ void prepare(float* lut, int tid) const {
    if (tid < 16) lut[tid] = kNF4[tid];
  }
  template <int BN>
  __device__ __forceinline__ void load(uint8_t* raw, uint64_t* bar, int kt,
                                       int n0) const {
    qmm::wg::tma_load_2d(raw, &packed, bar, n0, kt * qmm::wg::kBK / 2);
    qmm::wg::tma_load_2d(raw + qmm::wg::kBK / 2 * BN, &absmax, bar, n0,
                         kt * qmm::wg::kBK / block);
  }
  // The thread's A fragments of the stage: of columns nb + 2g and nb + 2g
  // + 1 (g = lane / 4), packed rows p = 8 kk + t and 8 kk + t + 4 (t = lane
  // % 4) for K step kk; one byte holds K rows 2p (low nibble) and 2p + 1
  // (high), which make one bf16 pair of the fragment. Each weight is the
  // codebook value times its absmax in f32, rounded to bf16.
  template <int BN>
  __device__ __forceinline__ void fragments(const uint8_t* raw,
                                            const float* lut, int nb,
                                            int lane,
                                            uint32_t (&f)[4][4]) const {
    const int c = nb + 2 * (lane / 4), t = lane % 4;
    const float* am =
        reinterpret_cast<const float*>(raw + qmm::wg::kBK / 2 * BN) + c;
    const float2 a0 = *reinterpret_cast<const float2*>(am);
    const float2 a1 = *reinterpret_cast<const float2*>(am + (rows - 1) * BN);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = 8 * kk + t + 4 * h;
        const uint32_t v = *reinterpret_cast<const uint16_t*>(
            raw + qmm::wg::raw_at<BN>(p, c));
        const float2 s = 2 * p / block ? a1 : a0;
        const uint32_t b0 = v & 0xFF, b1 = v >> 8;
        f[kk][2 * h] = qmm::wg::pack_bf16(lut[b0 & 0x0F] * s.x,
                                          lut[b0 >> 4] * s.x);
        f[kk][2 * h + 1] = qmm::wg::pack_bf16(lut[b1 & 0x0F] * s.y,
                                              lut[b1 >> 4] * s.y);
      }
  }
  __device__ __forceinline__ float epilogue(float acc, int) const {
    return acc;
  }
};

}  // namespace

// x (M, K) and out (M, N) in the compute dtype (bf16 when is_bf16, else
// f32); packed uint8 (K/2, N); absmax f32 (K/block, N). All row-major and
// contiguous. `loop` is the host plan's loop (qmm::Loop); for the wgmma
// loop, (bm, bn) its tile and `grid` its blocks. Launches on `stream`,
// does not synchronise, and returns cudaGetLastError() of the launch, or
// cudaErrorInvalidValue for a loop the shape does not allow.
extern "C" int nf4_matmul_launch(const void* x, const void* packed,
                                 const void* absmax, void* out, int M,
                                 int N, int K, int block, int is_bf16,
                                 int loop, int bm, int bn, int grid,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (loop == qmm::kLoopWgmma) {
    if (!is_bf16 || !(block == 32 || block % qmm::wg::kBK == 0))
      return (int)cudaErrorInvalidValue;
    qmm::wg::Args<NF4Stage> a;
    a.st.block = block;
    a.st.rows = block < qmm::wg::kBK ? qmm::wg::kBK / block : 1;
    if (!qmm::wg::make_map(&a.st.packed, packed,
                           CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, K / 2, N,
                           qmm::wg::kBK / 2, bn, qmm::wg::raw_swizzle(bn)) ||
        !qmm::wg::make_map(&a.st.absmax, absmax,
                           CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, K / block, N,
                           a.st.rows, bn, CU_TENSOR_MAP_SWIZZLE_NONE))
      return (int)cudaErrorInvalidValue;
    a.out = static_cast<__nv_bfloat16*>(out);
    a.M = M;
    a.N = N;
    a.K = K;
    return (int)qmm::wg::launch(a, static_cast<const __nv_bfloat16*>(x), bm,
                                bn, grid, s);
  }
  NF4Format fmt{static_cast<const uint8_t*>(packed),
                static_cast<const float*>(absmax), block};
  if (is_bf16)
    return (int)qmm::launch(static_cast<const __nv_bfloat16*>(x), fmt,
                            static_cast<__nv_bfloat16*>(out), M, N, K, loop,
                            s);
  return (int)qmm::launch(static_cast<const float*>(x), fmt,
                          static_cast<float*>(out), M, N, K, loop, s);
}
