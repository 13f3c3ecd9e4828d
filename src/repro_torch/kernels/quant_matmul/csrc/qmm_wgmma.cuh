// The bf16 prefill loop of the two dequant-matmul kernels (M > 8), for
// Hopper (sm_90a): out (M, N) = x (M, K) @ dequant(W) (K, N), bf16 in and
// out, f32 sums.
//
// Bound: at llama-3.1-8b's prefill shapes (M = 81-512) the 2*M*K*N
// operations on the tensor cores, not the bytes. What the design does
// about it (the mixed-input design of CUTLASS, written out by hand):
//
// - The operands are swapped: each warpgroup computes out^T for 64
//   output columns, D (64 n x BM m) += W^T (64 n x 16 k) @ x^T (16 k x BM
//   m), with wgmma.mma_async m64nBMk16. The dequantized weight is the A
//   operand, built in registers straight from the raw codes in shared
//   memory; x is the B operand, read by wgmma from shared memory. So the
//   weight never makes a bf16 round trip through shared memory, and the
//   consumer warpgroups never wait for each other.
// - A persistent grid: the host plans the output tile (BM = 64, 128 or
//   256 rows of x; BN = 64 or 128 output columns, one consumer warpgroup
//   per 64) and a grid of at most one block per SM from the shapes alone
//   (quant_matmul/kernel.py, matmul_plan); each block walks output tiles
//   t = blockIdx.x, blockIdx.x + gridDim.x, ..., column tile t / m_tiles,
//   row tile t % m_tiles, so blocks that run together read the same
//   weight columns. Every tile walks the whole K axis in one block, in
//   one fixed order: no split-K, and the sums do not depend on M.
// - Warp specialisation: one producer thread (in the last warpgroup,
//   which gives its registers to the consumers) keeps a ring of as many
//   stages as fit in shared memory (5-8) full with TMA copies. A stage
//   holds the x tile (BM rows x 64 K, bf16, 128-byte swizzle; TMA fills
//   rows past M with zeros) and the format's raw weight tile for the same
//   64 K rows (int8: 64 x BN codes; nf4: 32 x BN packed bytes, then the
//   absmax rows those K rows use), swizzled so that the reads below meet
//   no bank conflicts. Each stage has a full and an empty mbarrier.
// - A consumer thread gathers its fragment of W^T for a whole stage (32
//   weights of two adjacent columns: A row g of a warp's 16 rows is
//   column 2g of its 16, row g + 8 column 2g + 1) and dequantizes it in
//   registers, then issues four wgmma, one per 16 K. The A fragments are
//   double-buffered: a stage's products run while the next stage's
//   fragments are built, and a consumer waits for the group before last
//   (wgmma.wait_group 1) before it releases that group's stage.
// - The epilogue (the format's per-column scale, one rounding to bf16)
//   runs from the registers straight to device memory, two adjacent
//   columns per store.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../csrc/hopper.cuh"

namespace qmm {
namespace wg {

constexpr int kBK = 64;        // K rows per stage: one 128-byte row of x

// mbarriers, TMA, wgmma descriptors and fences, tensor-map encoding:
// the shared Hopper helpers
using namespace ::hopper;

// -- the raw weight tile ------------------------------------------------------
// Byte c of row r of a stage's raw tile with BN-byte rows, as TMA lays it
// out: its 16-byte chunks swizzled by the 128-byte pattern (BN = 128:
// chunk ^ r % 8) or the 64-byte one (BN = 64: chunk ^ (r / 2) % 4). The
// tile starts on 1024 bytes.
template <int BN>
__device__ __forceinline__ int raw_at(int r, int c) {
  static_assert(BN == 64 || BN == 128, "64 or 128 columns");
  const int x = BN == 128 ? (r & 7) : ((r >> 1) & 3);
  return r * BN + ((((c >> 4) ^ x) << 4) | (c & 15));
}

// -- wgmma -----------------------------------------------------------------
// d (64 x N, f32) += A (64 x 16, bf16, registers) @ B (16 x N, bf16,
// K-major in shared memory, 128-byte swizzle)
__device__ __forceinline__ void wgmma_rs_m64n64(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_m64n128(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_m64n256(float (&d)[128],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (N == 64) wgmma_rs_m64n64(d, a, db);
  else if constexpr (N == 128) wgmma_rs_m64n128(d, a, db);
  else wgmma_rs_m64n256(d, a, db);
}

// -- the loop --------------------------------------------------------------
// BM rows of x (64, 128 or 256) by BN output columns (64 or 128, one
// consumer warpgroup per 64). Shared memory, in bytes from a 1024-aligned
// base: the x tiles of the stages, then their raw weight tiles (each
// rounded up to 1024 bytes), as many stages as fit (at most 8).
constexpr int kSmemMax = 232448;   // a block's dynamic shared memory, H100

template <class Stage, int BM, int BN>
struct Layout {
  static constexpr int x_bytes = BM * kBK * 2;
  static constexpr int raw_bytes =
      (Stage::template raw_bytes<BN>() + 1023) / 1024 * 1024;
  static constexpr int fit = (kSmemMax - 2048) / (x_bytes + raw_bytes);
  static constexpr int stages = fit < 8 ? fit : 8;
  static constexpr int raw_off = stages * x_bytes;
  static constexpr int total = raw_off + stages * raw_bytes + 1024;
  static_assert(stages >= 5, "a ring of at least five stages");
};

template <class Stage>
struct Args {
  CUtensorMap x;   // (M, K) bf16, box (BM rows, 64), 128-byte swizzle
  Stage st;        // the format's tensor maps and epilogue data
  __nv_bfloat16* out;
  int M, N, K, m_tiles, tiles;
};

template <class Stage, int BM, int BN>
__global__ void __launch_bounds__(128 * (BN / 64 + 1), 1)
    qmm_wgmma_kernel(const __grid_constant__ Args<Stage> a) {
  using L = Layout<Stage, BM, BN>;
  constexpr int S = L::stages;
  constexpr int NWG = BN / 64;    // consumer warpgroups
  constexpr int NT = 128 * NWG;   // consumer threads
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[S], empty[S];
  __shared__ float lut[16];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x;
  const int nk = a.K / kBK;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NT);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  a.st.prepare(lut, tid);
  __syncthreads();

  if (tid >= NT) {
    // producer warpgroup: gives its registers to the consumers; one
    // thread issues every copy, S stages ahead
    if constexpr (NWG == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == NT) {
      int it = 0;
      for (int t = blockIdx.x; t < a.tiles; t += gridDim.x) {
        const int m0 = (t % a.m_tiles) * BM, n0 = (t / a.m_tiles) * BN;
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % S;
          mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
          mbar_expect_tx(&full[s], L::x_bytes + a.st.template tx_bytes<BN>());
          tma_load_2d(smem + s * L::x_bytes, &a.x, &full[s], kt * kBK, m0);
          a.st.template load<BN>(smem + L::raw_off + s * L::raw_bytes,
                                 &full[s], kt, n0);
        }
      }
    }
  } else {
    if constexpr (NWG == 2)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int warp = tid / 32, lane = tid % 32;
    // this warp's 16 columns of the tile: A rows g and g + 8 of the warp
    // are columns 2g and 2g + 1 of them
    const int nb = warp * 16;
    int it = 0;
    for (int t = blockIdx.x; t < a.tiles; t += gridDim.x) {
      const int m0 = (t % a.m_tiles) * BM, n0 = (t / a.m_tiles) * BN;
      float acc[BM / 2];
#pragma unroll
      for (int i = 0; i < BM / 2; ++i) acc[i] = 0.f;
      uint32_t f0[kBK / 16][4], f1[kBK / 16][4];
      // one stage: its fragments into `cur`, four products, and the
      // release of the stage before it, once its products are done (they
      // read `prev`)
      auto step = [&](uint32_t (&cur)[kBK / 16][4],
                      uint32_t (&prev)[kBK / 16][4], int kt) {
        const int s = it % S;
        mbar_wait(&full[s], (it / S) & 1);
        a.st.template fragments<BN>(smem + L::raw_off + s * L::raw_bytes,
                                    lut, nb, lane, cur);
        const uint32_t xa = smem_u32(smem + s * L::x_bytes);
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          wgmma_rs<BM>(acc, cur[kk], desc(xa + kk * 32, 16, 1024));
        wgmma_commit();
        fence_acc(acc);
        wgmma_wait<1>();
        fence_acc(acc);
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) fence_regs(prev[kk]);
        if (kt > 0) mbar_arrive(&empty[(it - 1) % S]);
        ++it;
      };
      int kt = 0;
      for (; kt + 1 < nk; kt += 2) {
        step(f0, f1, kt);
        step(f1, f0, kt + 1);
      }
      if (kt < nk) step(f0, f1, kt);
      wgmma_wait<0>();
      fence_acc(acc);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        fence_regs(f0[kk]);
        fence_regs(f1[kk]);
      }
      mbar_arrive(&empty[(it - 1) % S]);

      // acc[j * 4 + h * 2 + e]: D row 16 * (warp % 4) + lane / 4 + 8 h,
      // that is column n0 + nb + 2 (lane / 4) + h; D column j * 8 + 2 (lane
      // % 4) + e, that is row m0 + j * 8 + 2 (lane % 4) + e of x
      const int n = n0 + nb + 2 * (lane / 4);
      if (n < a.N) {   // N is even, so n + 1 < N too
#pragma unroll
        for (int j = 0; j < BM / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int m = m0 + j * 8 + 2 * (lane % 4) + e;
            if (m < a.M)
              *reinterpret_cast<uint32_t*>(a.out + (size_t)m * a.N + n) =
                  pack_bf16(a.st.epilogue(acc[j * 4 + e], n),
                            a.st.epilogue(acc[j * 4 + 2 + e], n + 1));
          }
      }
    }
  }
}

// -- host --------------------------------------------------------------------
// the swizzle of a raw weight tile with BN-byte rows (raw_at)
inline CUtensorMapSwizzle raw_swizzle(int bn) {
  return bn == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
}

template <class Stage, int BM, int BN>
cudaError_t launch_tiles(Args<Stage>& a, const __nv_bfloat16* x, int grid,
                         cudaStream_t stream) {
  using L = Layout<Stage, BM, BN>;
  if (!make_map(&a.x, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a.M, a.K, BM,
                kBK, CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  a.m_tiles = (a.M + BM - 1) / BM;
  a.tiles = a.m_tiles * ((a.N + BN - 1) / BN);
  auto kernel = qmm_wgmma_kernel<Stage, BM, BN>;
  // raised once per instance, so that later launches, inside a CUDA graph
  // capture too, make no attribute call
  static bool raised = false;
  if (!raised) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::total);
    if (err != cudaSuccess) return err;
    raised = true;
  }
  kernel<<<grid, 128 * (BN / 64 + 1), L::total, stream>>>(a);
  return cudaGetLastError();
}

// The loop at the host's plan: BM in {256, 128, 64} rows of x by BN in
// {128, 64} columns, `grid` blocks. The caller has filled a.st with the
// format's tensor maps for BN. Refuses (cudaErrorInvalidValue) what the
// plan never gives it: K not a multiple of 64, N not a multiple of 16,
// another tile.
template <class Stage>
cudaError_t launch(Args<Stage>& a, const __nv_bfloat16* x, int bm, int bn,
                   int grid, cudaStream_t stream) {
  if (a.K % kBK || a.N % 16 || grid < 1) return cudaErrorInvalidValue;
  if (bn == 128) {
    if (bm == 256) return launch_tiles<Stage, 256, 128>(a, x, grid, stream);
    if (bm == 128) return launch_tiles<Stage, 128, 128>(a, x, grid, stream);
    if (bm == 64) return launch_tiles<Stage, 64, 128>(a, x, grid, stream);
  }
  if (bn == 64) {
    if (bm == 256) return launch_tiles<Stage, 256, 64>(a, x, grid, stream);
    if (bm == 128) return launch_tiles<Stage, 128, 64>(a, x, grid, stream);
    if (bm == 64) return launch_tiles<Stage, 64, 64>(a, x, grid, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace wg
}  // namespace qmm
