// Grouped bf16-weight matmul for Hopper (sm_90a), an MoE's 16-bit
// experts:
//   out (E, C, N)[e] = x (E, C, K)[e] @ w (E, K, N)[e]
// bf16 in and out, f32 sums, one rounding to bf16 at the end, with each
// expert's kept rows from the capacity dispatch: only the experts with a
// kept row are read and only their kept rows computed; the rows at or
// past a count are written as zeros.
//
// Replaces: no TPU kernel. The reference computes this product as
// jax.vmap of linear_apply over the experts (src/repro/models/moe.py:147,
// _expert_dense), which reduces to jnp.einsum(x.astype(cd), w.astype(cd),
// preferred_element_type=cd) (src/repro/quant/apply.py:68-69), no Pallas
// kernel. The port's batched torch.matmul read every expert whatever the
// dispatch kept: qwen3-moe-30b-a3b's 128 experts, 1.21 GB a layer in
// bf16, on every decode step.
//
// Bound on an H100 SXM: at decode (C = 8 rows an expert) the kept
// experts' weight bytes: at qwen3's w_gate (2048 x 768, 3.1 MB an
// expert) a batch-4 step keeps about 26 of the 128, about 82 MB, about
// 24 us at 3.35 TB/s (every expert: 403 MB, 120 us). At prefill (C = 40)
// still the bytes: 16 GFLOP a call against 403 MB.
//
// What the design does about it: the bf16 loops of qmm_wgmma.cuh with
// Stage16<__nv_bfloat16> (f16_stage.cuh, the fp16 kernel's stage with
// no conversion) as the weight's stage: a TMA ring of raw 64 x BN bf16
// tiles (two 64-column boxes a 128-column stage) and x tiles; each
// consumer thread takes its A fragments from 4-byte shared loads of a
// column pair and two byte permutes. The launch reads the dispatch's
// counts on the device (no host sync): decode shares the K segments of
// the kept experts' column tiles over one block per SM, prefill walks the
// output tiles of their kept rows, and idle producer threads write the
// zero rows. A stage holds twice int8's bytes: the decode ring keeps 8
// stages, and the 256 x 128 prefill tile is not planned. bf16 compute
// only: f32 compute keeps torch.matmul (kernel.py, linear routing).
#include "f16_stage.cuh"
#include "qmm_wgmma.cuh"
#include "quant_matmul.cuh"

// x (E, M, K) bf16, w bf16 (E, K, N), out (E, M, N) bf16, all row-major
// and contiguous. `rows`: each expert's kept rows (E,) int32, or null for
// all M. `loop` is the host plan's loop (qmm::Loop: decode or wgmma; the
// tile loop is refused); (bm, bn) its tile and `grid` its blocks, and for
// the decode loop `part` and `counter` its scratch and `seg` its K
// segments a column tile (kernel.py, matmul_plan and decode_scratch).
// Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() of the launch, or cudaErrorInvalidValue for a loop
// the shape does not allow.
extern "C" int bf16_matmul_launch(const void* x, const void* w, void* out,
                                  void* part, void* counter, const void* rows,
                                  int E, int M, int N, int K, int loop,
                                  int bm, int bn, int grid, int seg,
                                  void* stream) {
  if (E < 1) return (int)cudaErrorInvalidValue;
  return (int)qmm::wg::launch16<__nv_bfloat16>(
      x, w, out, part, counter, static_cast<const int*>(rows), E, M, N, K,
      loop, bm, bn, grid, seg, static_cast<cudaStream_t>(stream));
}
