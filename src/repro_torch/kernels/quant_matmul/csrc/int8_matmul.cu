// int8 dequant-matmul for Hopper (sm_90a):
//   out (M, N) = (x (M, K) @ codes (K, N) as compute dtype) * scale[n]
// with f32 accumulation and the compute dtype (bf16 or f32) as output;
// grouped, E such products in one launch: out[e] = (x[e] (M, K) @
// codes[e] (K, N)) * scale[e, n], the experts of an MoE layer.
//
// Replaces: src/repro/kernels/quant_matmul/kernel.py, int8_matmul_pallas
// (body _int8_kernel), and that kernel under jax.vmap over the experts
// (src/repro/models/moe.py, _expert_dense). Same rounding points: x and
// the codes in the compute dtype (int8 is exact in bf16), f32 sums over
// K, the per-column scale in the epilogue, one rounding to the compute
// dtype at the end.
//
// Bound on an H100 SXM: at decode (M = 1-8) the weight bytes. The
// (4096, 14336) w_gate is 58.7 MB of codes, about 17.5 us at 3.35 TB/s;
// every other byte (x, scale, out) is under 1% of that. At prefill
// (M = 512) the 2*M*K*N operations bound it instead. Grouped, at
// qwen3-moe-30b-a3b's experts (E = 128, (K, N) = (2048, 768)), one call
// streams 201 MB of codes, about 60 us, at M = 8 (decode) and M = 40
// (prefill) alike.
//
// What the design does about it: each weight byte is read from device
// memory once and dequantized on chip, so no 16-bit copy of the weight is
// ever written back (the extra pass the paper blames for int8's decode
// cost). In bf16 both loops are those of qmm_wgmma.cuh: a ring of TMA
// copies of raw 64 x BN code tiles (Int8Stage below) and x tiles, each
// consumer thread converting its fragment of the codes to bf16 in
// registers, the A operand of wgmma (x is B), with the per-column scale
// in the f32 epilogue. Decode (M <= 8) streams 128-column tiles (whole
// 128-byte lines) with one block per SM, the K steps split evenly among
// the blocks and the split tiles merged in the same launch; prefill walks
// whole output tiles with a persistent grid.
// f32 compute and shapes the plan gives neither loop take the CUDA-core
// tile kernel (qmm_tile_kernel).
#include "qmm_wgmma.cuh"
#include "quant_matmul.cuh"

namespace {

struct Int8Format {
  const int8_t* codes;   // (K, N)
  const float* scale;    // (N,)

  // the format of expert e of a grouped call
  __device__ __forceinline__ Int8Format expert(int e, int K, int N) const {
    return {codes + (size_t)e * K * N, scale + (size_t)e * N};
  }

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
};

// -- the bf16 loops (qmm_wgmma.cuh): a stage holds the raw
// (64, BN) code tile, copied by TMA (0 past N) with the swizzle of
// qmm::wg::raw_at
struct Int8Stage {
  CUtensorMap codes;     // (E K, N) int8, box (64 rows, BN)
  const float* scale;    // (E, N)

  template <int BN>
  __host__ __device__ static constexpr int raw_bytes() {
    return qmm::wg::kBK * BN;
  }
  template <int BN>
  __device__ __forceinline__ uint32_t tx_bytes() const {
    return raw_bytes<BN>();
  }
  __device__ __forceinline__ void prepare(float*, int) const {}
  // the 64 code rows from row k_row of the experts' stacked (E K, N)
  template <int BN>
  __device__ __forceinline__ void load(uint8_t* raw, uint64_t* bar,
                                       int k_row, int n0) const {
    qmm::wg::tma_load_2d(raw, &codes, bar, n0, k_row);
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
  // col: e N + n, column n of expert e
  __device__ __forceinline__ float epilogue(float acc, size_t col) const {
    return acc * scale[col];
  }
};
}  // namespace

// x (E, M, K) and out (E, M, N) in the compute dtype (bf16 when is_bf16,
// else f32); codes int8 (E, K, N); scale f32 (E, N); E = 1 for a 2-D
// call. All row-major and contiguous; codes 4-byte aligned. `rows`: each
// expert's kept rows (E,) int32, or null for all M; rows at or past the
// count are written as zeros. `loop` is the host plan's loop (qmm::Loop);
// for the wgmma and decode loops, (bm, bn) its tile and `grid` its
// blocks, and for the decode loop `part` and `counter` its scratch and
// `seg` its K segments a column tile (0: the 2-D walk; kernel.py,
// matmul_plan and decode_scratch). Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() of the launch, or
// cudaErrorInvalidValue for a loop the shape does not allow.
extern "C" int int8_matmul_launch(const void* x, const void* codes,
                                  const void* scale, void* out, void* part,
                                  void* counter, const void* rows, int E,
                                  int M, int N, int K, int is_bf16, int loop,
                                  int bm, int bn, int grid, int seg,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (E < 1) return (int)cudaErrorInvalidValue;
  const int* kept = static_cast<const int*>(rows);
  if (loop == qmm::kLoopWgmma || loop == qmm::kLoopDecode) {
    if (!is_bf16) return (int)cudaErrorInvalidValue;
    qmm::wg::Args<Int8Stage> a;
    if (!qmm::wg::make_map_cached(&a.st.codes, codes,
                                  CU_TENSOR_MAP_DATA_TYPE_UINT8, 1,
                                  (uint64_t)E * K, N, qmm::wg::kBK, bn,
                                  qmm::wg::raw_swizzle(bn)))
      return (int)cudaErrorInvalidValue;
    a.st.scale = static_cast<const float*>(scale);
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
  Int8Format fmt{static_cast<const int8_t*>(codes),
                 static_cast<const float*>(scale)};
  if (is_bf16)
    return (int)qmm::launch_tile(static_cast<const __nv_bfloat16*>(x), fmt,
                                 static_cast<__nv_bfloat16*>(out), kept, E,
                                 M, N, K, s);
  return (int)qmm::launch_tile(static_cast<const float*>(x), fmt,
                               static_cast<float*>(out), kept, E, M, N, K,
                               s);
}
