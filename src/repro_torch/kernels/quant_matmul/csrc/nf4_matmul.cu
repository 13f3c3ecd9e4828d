// NF4 dequant-matmul for Hopper (sm_90a):
//   out (M, N) = x (M, K) @ W (K, N),
//   W[k, n] = round_to_compute(NF4[code(k, n)] * absmax[k / block, n])
// with f32 accumulation, no epilogue scale, and the compute dtype (bf16
// or f32) as output; grouped, E such products in one launch (out[e] =
// x[e] @ W[e], the experts of an MoE layer).
//
// Replaces: src/repro/kernels/quant_matmul/kernel.py, nf4_matmul_pallas
// (body _nf4_kernel), and that kernel under jax.vmap over the experts
// (src/repro/models/moe.py, _expert_dense). Same unpacking (two codes per
// byte along K, the even row in the low nibble), the same 16-entry
// codebook, and the same rounding of each dequantized weight to the
// compute dtype before the product (kernel.py:103).
//
// Bound on an H100 SXM: at decode (M = 1-8) the weight bytes. The
// (4096, 14336) w_gate is 29.4 MB of packed codes plus 3.7 MB of f32
// absmax (block 64), about 9.9 us at 3.35 TB/s. At prefill (M = 512) the
// 2*M*K*N operations bound it instead. Grouped, at qwen3-moe-30b-a3b's
// experts (E = 128, (K, N) = (2048, 768)), one call streams 101 MB of
// packed codes and 12.6 MB of absmax, about 34 us.
//
// What the design does about it: each packed byte and each absmax value
// is read from device memory once and dequantized on chip, so no 16-bit
// copy of the weight is ever written back. In bf16 both loops are those
// of qmm_wgmma.cuh: a ring of TMA copies of raw 32 x BN packed tiles and
// the absmax rows of the same 64 K rows (NF4Stage below) and x tiles,
// each consumer thread dequantizing its fragment of the weights to bf16
// in registers (the codebook from shared memory), the A operand of wgmma
// (x is B). Decode (M <= 8) streams 128-column tiles with one block per
// SM, the K steps split evenly among the blocks and the split tiles
// merged in the same launch; prefill walks whole output tiles with a
// persistent grid. Grouped, both walk only the experts and rows the
// dispatch kept (qmm_wgmma.cuh).
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

  // the format of expert e of a grouped call
  __device__ __forceinline__ NF4Format expert(int e, int K, int N) const {
    return {packed + (size_t)e * (K / 2) * N,
            absmax + (size_t)e * (K / block) * N, block};
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
};

// -- the bf16 loops (qmm_wgmma.cuh): a stage holds the raw
// (32, BN) packed tile (K rows 64 kt .. 64 kt + 63, with the swizzle of
// qmm::wg::raw_at), then the absmax rows those K rows use: one for a
// block that is a multiple of 64, two for block 32. Both copied by TMA
// (0 past N).
struct NF4Stage {
  CUtensorMap packed;   // (E K / 2, N) uint8, box (32 rows, BN)
  CUtensorMap absmax;   // (E K / block, N) f32, box (rows, BN)
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
  // the packed and absmax rows of the 64 K rows from row k_row of the
  // experts' stacked (E K, N) weight (K is a multiple of the block)
  template <int BN>
  __device__ __forceinline__ void load(uint8_t* raw, uint64_t* bar,
                                       int k_row, int n0) const {
    qmm::wg::tma_load_2d(raw, &packed, bar, n0, k_row / 2);
    qmm::wg::tma_load_2d(raw + qmm::wg::kBK / 2 * BN, &absmax, bar, n0,
                         k_row / block);
  }
  // The thread's A fragments of the stage: of columns c = nb + 2g and
  // c + 1 (g = lane / 4), packed rows 8 kk + t and 8 kk + t + 4 (t = lane
  // % 4) for K step kk; one byte holds K rows 2p (low nibble) and 2p + 1
  // (high) of packed row p, which make one bf16 pair of the fragment.
  // One transposed ldmatrix.x4 fetches all of them: matrix kk takes packed
  // rows 8 kk + i / 2 + 4 (i % 2) as its rows i, 16 bytes of columns nb ..
  // nb + 15 each, so that r[kk] holds bytes c, c + 1 of row 8 kk + t (low
  // half) and of row 8 kk + t + 4 (high half). Each weight is the
  // codebook value times its absmax in f32, rounded to bf16.
  template <int BN>
  __device__ __forceinline__ void fragments(const uint8_t* raw,
                                            const float* lut, int nb,
                                            int lane,
                                            uint32_t (&f)[4][4]) const {
    const int c = nb + 2 * (lane / 4), i = lane % 8;
    const float* am =
        reinterpret_cast<const float*>(raw + qmm::wg::kBK / 2 * BN) + c;
    const float2 a0 = *reinterpret_cast<const float2*>(am);
    const float2 a1 = *reinterpret_cast<const float2*>(am + (rows - 1) * BN);
    uint32_t r[4];
    qmm::wg::ldmatrix_x4_trans(
        r, raw + qmm::wg::raw_at<BN>(8 * (lane / 8) + i / 2 + 4 * (i % 2),
                                     nb));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // K rows 16 kk .. 16 kk + 15 take absmax row 2 p / block: the
      // second for block 32 from kk = 2 on, else the first (a1 == a0)
      const float2 s = kk >= 2 ? a1 : a0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t v = r[kk] >> (16 * h);
        const uint32_t b0 = v & 0xFF, b1 = (v >> 8) & 0xFF;
        f[kk][2 * h] = qmm::wg::pack_bf16(lut[b0 & 0x0F] * s.x,
                                          lut[b0 >> 4] * s.x);
        f[kk][2 * h + 1] = qmm::wg::pack_bf16(lut[b1 & 0x0F] * s.y,
                                              lut[b1 >> 4] * s.y);
      }
    }
  }
  __device__ __forceinline__ float epilogue(float acc, size_t) const {
    return acc;
  }
};

}  // namespace

// x (E, M, K) and out (E, M, N) in the compute dtype (bf16 when is_bf16,
// else f32); packed uint8 (E, K/2, N); absmax f32 (E, K/block, N); E = 1
// for a 2-D call. All row-major and contiguous. `rows`: each expert's
// kept rows (E,) int32, or null for all M; rows at or past the count are
// written as zeros. `loop` is the host plan's loop (qmm::Loop); for the
// wgmma and decode loops, (bm, bn) its tile and `grid` its blocks, and
// for the decode loop `part` and `counter` its scratch and `seg` its K
// segments a column tile (0: the 2-D walk; kernel.py, matmul_plan and
// decode_scratch). Launches on `stream`, does not synchronise, and
// returns cudaGetLastError() of the launch, or cudaErrorInvalidValue for
// a loop the shape does not allow.
extern "C" int nf4_matmul_launch(const void* x, const void* packed,
                                 const void* absmax, void* out, void* part,
                                 void* counter, const void* rows, int E,
                                 int M, int N, int K, int block, int is_bf16,
                                 int loop, int bm, int bn, int grid, int seg,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (E < 1 || block < 2 || K % block) return (int)cudaErrorInvalidValue;
  const int* kept = static_cast<const int*>(rows);
  if (loop == qmm::kLoopWgmma || loop == qmm::kLoopDecode) {
    if (!is_bf16 || !(block == 32 || block % qmm::wg::kBK == 0))
      return (int)cudaErrorInvalidValue;
    qmm::wg::Args<NF4Stage> a;
    a.st.block = block;
    a.st.rows = block < qmm::wg::kBK ? qmm::wg::kBK / block : 1;
    if (!qmm::wg::make_map_cached(&a.st.packed, packed,
                                  CU_TENSOR_MAP_DATA_TYPE_UINT8, 1,
                                  (uint64_t)E * K / 2, N, qmm::wg::kBK / 2,
                                  bn, qmm::wg::raw_swizzle(bn)) ||
        !qmm::wg::make_map_cached(&a.st.absmax, absmax,
                                  CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                                  (uint64_t)E * (K / block), N, a.st.rows,
                                  bn, CU_TENSOR_MAP_SWIZZLE_NONE))
      return (int)cudaErrorInvalidValue;
    a.out = static_cast<__nv_bfloat16*>(out);
    a.part = static_cast<float*>(part);
    a.counter = static_cast<int*>(counter);
    a.rows = kept;
    a.E = E;
    a.M = M;
    a.N = N;
    a.K = K;
    a.seg = seg;
    const auto* xb = static_cast<const __nv_bfloat16*>(x);
    if (loop == qmm::kLoopDecode)
      return (int)qmm::wg::launch_decode(a, xb, bn, grid, s);
    return (int)qmm::wg::launch(a, xb, bm, bn, grid, s);
  }
  if (loop != qmm::kLoopTile) return (int)cudaErrorInvalidValue;
  NF4Format fmt{static_cast<const uint8_t*>(packed),
                static_cast<const float*>(absmax), block};
  if (is_bf16)
    return (int)qmm::launch_tile(static_cast<const __nv_bfloat16*>(x), fmt,
                                 static_cast<__nv_bfloat16*>(out), kept, E,
                                 M, N, K, s);
  return (int)qmm::launch_tile(static_cast<const float*>(x), fmt,
                               static_cast<float*>(out), kept, E, M, N, K,
                               s);
}
