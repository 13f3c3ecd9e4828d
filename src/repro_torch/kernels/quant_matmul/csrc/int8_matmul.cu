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
// on the CUDA cores in f32. At prefill in bf16 (qmm_mma_kernel) each
// 32 x 128 code tile is converted to bf16 in shared memory and fed to the
// tensor cores with mma.sync; f32 compute and unaligned shapes take the
// CUDA-core tile kernel (qmm_tile_kernel). wgmma, TMA, a multi-stage
// prefill pipeline and a persistent grid are later work.
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

  // -- tensor-core kernel: ws (32, 128) <- codes as bf16, 0 past N. Each
  // thread converts 16 codes of one row (N % 16 == 0).
  bool mma_ok(int, int) const { return qmm::aligned16(codes); }
  __device__ __forceinline__ void load_mma_tile(qmm::MmaWTile& ws,
                                                const float*, int k0, int n0,
                                                int N, int tid) const {
    const int r = tid / 8, c = (tid % 8) * 16;
    int4 v = make_int4(0, 0, 0, 0);
    if (n0 + c < N)
      v = *reinterpret_cast<const int4*>(codes + (size_t)(k0 + r) * N + n0 +
                                         c);
    const int8_t* b = reinterpret_cast<const int8_t*>(&v);
    __align__(16) __nv_bfloat16 w[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) w[j] = __float2bfloat16_rn((float)b[j]);
    *reinterpret_cast<uint4*>(&ws[r][c]) = *reinterpret_cast<uint4*>(w);
    *reinterpret_cast<uint4*>(&ws[r][c + 8]) =
        *reinterpret_cast<uint4*>(w + 8);
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

}  // namespace

// x (M, K) and out (M, N) in the compute dtype (bf16 when is_bf16, else
// f32); codes int8 (K, N); scale f32 (N,). All row-major and contiguous;
// codes 4-byte aligned. Launches on `stream`, does not synchronise, and
// returns cudaGetLastError() of the launch.
extern "C" int int8_matmul_launch(const void* x, const void* codes,
                                  const void* scale, void* out, int M,
                                  int N, int K, int is_bf16, void* stream) {
  Int8Format fmt{static_cast<const int8_t*>(codes),
                 static_cast<const float*>(scale)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)qmm::launch(static_cast<const __nv_bfloat16*>(x), fmt,
                            static_cast<__nv_bfloat16*>(out), M, N, K, s);
  return (int)qmm::launch(static_cast<const float*>(x), fmt,
                          static_cast<float*>(out), M, N, K, s);
}
