// int8 dequant-matmul for Hopper (sm_90a):
//   out (M, N) = (x (M, K) @ codes (K, N) as compute dtype) * scale[n]
// with f32 accumulation and the compute dtype (bf16 or f32) as output.
//
// Replaces: src/repro/kernels/quant_matmul/kernel.py, int8_matmul_pallas
// (body _int8_kernel). Same rounding points: x and the codes in the
// compute dtype (int8 is exact in bf16), f32 sums over K, the per-column
// scale in the epilogue, one rounding to the compute dtype at the end.
//
// Bound on an H100 SXM: at decode (M = 1-8) the weight bytes. The
// (4096, 14336) w_gate is 58.7 MB of codes, about 17.5 us at 3.35 TB/s;
// every other byte (x, scale, out) is under 1% of that. At prefill
// (M = 512) the 2*M*K*N operations bound it instead.
//
// What the design does about it: each weight byte is read from device
// memory once and dequantized on chip, so no 16-bit copy of the weight is
// ever written back (the extra pass the paper blames for int8's decode
// cost). At decode the codes stream through a 4-stage cp.async ring in
// shared memory (quant_matmul.cuh, qmm_decode_kernel): 16 columns per
// block, so even the (4096, 1024) projections spread over 64 blocks, and
// up to three 8 KiB stages of codes in flight per block; the products run
// on the CUDA cores in f32. At prefill in bf16 (M > 8; qmm_wgmma.cuh) a
// persistent grid of warp-specialised blocks keeps a 4-stage TMA ring of
// x tiles and raw 64 x BN code tiles full (Int8Stage below); each
// consumer thread converts its fragment of the codes to bf16 in
// registers, the A operand of wgmma (x is B), with the per-column scale
// in the f32 epilogue.
// f32 compute and shapes the plan gives neither loop take the CUDA-core
// tile kernel (qmm_tile_kernel).
#include "qmm_wgmma.cuh"
#include "quant_matmul.cuh"

namespace {

struct Int8Format {
  const int8_t* codes;   // (K, N)
  const float* scale;    // (N,)

  // -- tile kernel: ws (BK, BN) <- codes[k0:k0+BK, n0:n0+BN] as floats,
  // 0 past the edges. Codes in [-127, 127] are exact in bf16, so no
  // rounding is needed.
  template <typename T, int BK, int BN>
  __device__ __forceinline__ void load_tile(float (*ws)[BN], int k0, int n0,
                                            int K, int N, int tid) const {
    if ((N & 3) == 0) {
      constexpr int BN4 = BN / 4;
      for (int i = tid; i < BK * BN4; i += qmm::kThreads) {
        const int kk = i / BN4, nn = (i % BN4) * 4;
        const int gk = k0 + kk, gn = n0 + nn;
        char4 c = make_char4(0, 0, 0, 0);
        if (gk < K && gn < N)
          c = *reinterpret_cast<const char4*>(codes + (size_t)gk * N + gn);
        *reinterpret_cast<float4*>(&ws[kk][nn]) =
            make_float4((float)c.x, (float)c.y, (float)c.z, (float)c.w);
      }
    } else {
      for (int i = tid; i < BK * BN; i += qmm::kThreads) {
        const int kk = i / BN, nn = i % BN;
        const int gk = k0 + kk, gn = n0 + nn;
        ws[kk][nn] = (gk < K && gn < N)
                         ? (float)codes[(size_t)gk * N + gn]
                         : 0.f;
      }
    }
  }

  __device__ __forceinline__ float epilogue(float acc, int n) const {
    return acc * scale[n];
  }

  // -- decode kernel: a stage holds the raw (kDecBK, kDecBN) code tile
  bool dec_ok(int, int) const {
    return qmm::aligned16(codes);
  }
  __host__ __device__ int dec_tile_bytes() const {
    return qmm::kDecBK * qmm::kDecBN;
  }
  __device__ __forceinline__ void prepare(float*, int) const {}
  __device__ __forceinline__ void dec_load(uint8_t* stage, int k0, int n0,
                                           int N, int tid) const {
    constexpr int per_row = qmm::kDecBN / 16;
    for (int c = tid; c < qmm::kDecBK * per_row; c += qmm::kThreads) {
      const int r = c / per_row, j = (c % per_row) * 16;
      qmm::cp_async16(stage + r * qmm::kDecBN + j,
                      codes + (size_t)(k0 + r) * N + n0 + j);
    }
  }
  // rows kg, kg + kKGroups, ... of the stage; columns 4*cg .. 4*cg+3
  template <typename T, int MR>
  __device__ __forceinline__ void dec_compute(
      const uint8_t* stage, const T* xs, const float*,
      float (&acc)[MR][4], int kg, int cg) const {
#pragma unroll 2
    for (int i = 0; i < qmm::kDecBK / qmm::kKGroups; ++i) {
      const int r = i * qmm::kKGroups + kg;
      // four codes to exact floats without the slow int->float unit:
      // flip each byte's sign bit (b + 128 in 0..255), place it in the
      // mantissa of 2^23, and subtract 2^23 + 128
      const unsigned u = *reinterpret_cast<const unsigned*>(
                             stage + r * qmm::kDecBN + cg * 4) ^
                         0x80808080u;
      float w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        w[j] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + j)) -
               8388736.0f;
#pragma unroll
      for (int m = 0; m < MR; ++m) {
        const float xv = qmm::to_f<T>(xs[m * qmm::kDecBK + r]);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[m][j] = fmaf(xv, w[j], acc[m][j]);
      }
    }
  }
};

// -- the wgmma prefill loop (qmm_wgmma.cuh): a stage holds the raw
// (64, BN) code tile, copied by TMA (0 past N) with the swizzle of
// qmm::wg::raw_at
struct Int8Stage {
  CUtensorMap codes;     // (K, N) int8, box (64 rows, BN)
  const float* scale;    // (N,)

  template <int BN>
  __host__ __device__ static constexpr int raw_bytes() {
    return qmm::wg::kBK * BN;
  }
  template <int BN>
  __device__ __forceinline__ uint32_t tx_bytes() const {
    return raw_bytes<BN>();
  }
  __device__ __forceinline__ void prepare(float*, int) const {}
  template <int BN>
  __device__ __forceinline__ void load(uint8_t* raw, uint64_t* bar, int kt,
                                       int n0) const {
    qmm::wg::tma_load_2d(raw, &codes, bar, n0, kt * qmm::wg::kBK);
  }
  // The thread's A fragments of the stage: for the 16 columns nb .. nb+15
  // of its warp, two transposed ldmatrix.x4 over the code rows (each 8 x 8
  // matrix: 8 K rows of 16 codes) give it the codes of K rows 2t, 2t + 1
  // (t = lane % 4) of columns 2g, 2g + 1 (g = lane / 4) in each 8-row
  // group. Each code becomes bf16 exactly (flip its sign bit, place it in
  // the mantissa of 2^23, subtract 2^23 + 128), paired along K.
  template <int BN>
  __device__ __forceinline__ void fragments(const uint8_t* raw, const float*,
                                            int nb, int lane,
                                            uint32_t (&f)[4][4]) const {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int k = 32 * half + lane;   // lane / 8: matrix, lane % 8: row
      uint32_t r[4];
      qmm::wg::ldmatrix_x4_trans(r, raw + qmm::wg::raw_at<BN>(k, nb));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // bytes: (2t, 2g), (2t, 2g + 1), (2t + 1, 2g), (2t + 1, 2g + 1)
        const uint32_t u = r[i] ^ 0x80808080u;
        float w[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          w[j] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + j)) -
                 8388736.0f;
        // matrix i: K rows 8i .. 8i+7 of this half, the first or second
        // 8 of K step 2 half + i / 2
        f[2 * half + i / 2][2 * (i % 2)] = qmm::wg::pack_bf16(w[0], w[2]);
        f[2 * half + i / 2][2 * (i % 2) + 1] = qmm::wg::pack_bf16(w[1], w[3]);
      }
    }
  }
  __device__ __forceinline__ float epilogue(float acc, int n) const {
    return acc * scale[n];
  }
};
}  // namespace

// x (M, K) and out (M, N) in the compute dtype (bf16 when is_bf16, else
// f32); codes int8 (K, N); scale f32 (N,). All row-major and contiguous;
// codes 4-byte aligned. `loop` is the host plan's loop (qmm::Loop); for
// the wgmma loop, (bm, bn) its tile and `grid` its blocks. Launches on
// `stream`, does not synchronise, and returns cudaGetLastError() of the
// launch, or cudaErrorInvalidValue for a loop the shape does not allow.
extern "C" int int8_matmul_launch(const void* x, const void* codes,
                                  const void* scale, void* out, int M,
                                  int N, int K, int is_bf16, int loop,
                                  int bm, int bn, int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (loop == qmm::kLoopWgmma) {
    if (!is_bf16) return (int)cudaErrorInvalidValue;
    qmm::wg::Args<Int8Stage> a;
    if (!qmm::wg::make_map(&a.st.codes, codes, CU_TENSOR_MAP_DATA_TYPE_UINT8,
                           1, K, N, qmm::wg::kBK, bn,
                           qmm::wg::raw_swizzle(bn)))
      return (int)cudaErrorInvalidValue;
    a.st.scale = static_cast<const float*>(scale);
    a.out = static_cast<__nv_bfloat16*>(out);
    a.M = M;
    a.N = N;
    a.K = K;
    return (int)qmm::wg::launch(a, static_cast<const __nv_bfloat16*>(x), bm,
                                bn, grid, s);
  }
  Int8Format fmt{static_cast<const int8_t*>(codes),
                 static_cast<const float*>(scale)};
  if (is_bf16)
    return (int)qmm::launch(static_cast<const __nv_bfloat16*>(x), fmt,
                            static_cast<__nv_bfloat16*>(out), M, N, K, loop,
                            s);
  return (int)qmm::launch(static_cast<const float*>(x), fmt,
                          static_cast<float*>(out), M, N, K, loop, s);
}
