// Paged decode attention for Hopper (sm_90a): one query token per
// sequence over a pool of K/V pages reached through a page table,
//   out[b, h] = softmax(q[b, h] . K_b^T / sqrt(d)) V_b
// where K_b, V_b are the slots t < seq_lens[b] of the pages
// page_table[b, 0..n_max) (ids < 0 are unassigned and masked). Optional:
// int8 pages with f32 scales per slot and head, each element dequantized
// as the reference's dequantize_kv does it (src/repro/models/
// transformer.py, (code * scale) rounded once to q's dtype); and a
// per-slot position test, slot_pos[slot] in [0, pos[b]] and, with a
// window, > pos[b] - window (the reference's decode_attention_mask).
//
// Replaces: src/repro/kernels/paged_attention/kernel.py,
// paged_attention_pallas (body _paged_kernel). Same arithmetic: f32
// scores times 1/sqrt(d), an online softmax with f32 running max and sum,
// masked slots (t >= seq_len, or an unassigned page) contributing p = 0,
// the unnormalised p rounded to v's dtype before the PV product, f32
// sums, and acc / max(l, 1e-20) cast once to q's dtype, so a row with
// seq_len 0 returns 0. Unlike the TPU kernel, which loads page 0 in place
// of an unassigned page and masks it, this kernel never reads a masked
// slot (nor a page id at or past the pool's end). Any page size works.
//
// Bound on an H100 SXM: by bytes. Each valid slot's K and V rows are read
// once, 2 * Kv * d * 2 bytes (bf16) per slot and sequence, for 4 * H * d
// FLOP: llama-3.1-8b at batch 4 over 512 slots reads 8.4 MB, 2.5 us at
// 3.35 TB/s. int8 pages halve the rows' bytes and add 8 bytes of scales a
// slot and KV head; the position test adds 4 bytes a slot.
//
// What the design does about it:
// - One block per (KV head, sequence, split) handles all G = H / Kv query
//   heads of that KV head, so each K and V row is read from device memory
//   once for the whole group. A row's slots are cut into splits planned on
//   the host from the shapes alone (kernel.py, split_slots), so that the
//   blocks fill every SM.
// - Loads. A producer warp stages the block's slots in chunks of 64 with
//   TMA, into a ring of 2 to 6 stages (up to 128 KB), each with a full and
//   an empty mbarrier: all of a block's bytes are in flight together when
//   its split fits the ring. The tensor maps run
//   over the pool as (d, Kv, n_pool * page) with boxes of 128 bytes of a
//   row (64 bf16 or 32 f32 columns, 128-byte swizzle) by 64, 32, ..., 1
//   rows; a box's coordinates come from the page table on the device. The
//   valid slots of a chunk that lie in one page are cut into boxes of
//   those sizes, so a page longer than 64 slots (the ring of a long
//   prompt, 261) takes several and no box reads a slot past seq_len, an
//   unassigned page or a page id at or past n_pool. Slots never loaded
//   are masked in registers, so whatever their shared memory holds never
//   reaches a sum.
// - Products. Two sets of 4 consumer warps take alternate chunks, each
//   warp 16 slots of its set's chunks. bf16: both products on the tensor
//   cores with mma.sync m16n8k16; the A rows are the G
//   query heads padded to 16 (decode is bound by bytes, and wgmma's 64-row
//   minimum would waste 60 of 64 rows); K fragments by ldmatrix, V by
//   ldmatrix.trans, both conflict-free through the swizzle. f32: on the
//   CUDA cores, a lane per slot and half of d for the scores, then a lane
//   per d / 32 output columns, reading K and V from shared memory.
// - Head dims. 64 and 128 each have their instance (kExact: d is the
//   compile-time D); 96 and 120 run on a D = 128 instance. The tensor maps
//   keep the true d as their inner extent (row pitches of 192 and 240
//   bytes in bf16, 384 and 480 in f32, multiples of 16 as TMA asks), so
//   the boxes past d are zero-filled and still count whole towards a
//   stage's expect-tx bytes. q's columns past d are zero, so those columns
//   add exact zeros to the scores; the output columns past d are never
//   stored, and the merge scratch keeps D.
// - int8 pages. TMA cannot describe an int8 pool as (d, Kv, slots) when d *
//   1 byte is no multiple of 16 (d = 120), nor start a box at a column that
//   is not (kv * 120 is 8 past one for odd kv), so the maps run over (Kv *
//   d, slots) with boxes 128 columns wide at column kv * d rounded down to
//   16: a row of the stage is 128 bytes (the alignment TMA asks of a box's
//   shared address) holding the head's d codes at offset 0 or 8; the other
//   columns belong to the neighbouring heads or lie past the pool
//   (zero-filled) and are never used. Each consumer warp dequantizes its 16
//   slots of a chunk into its rows of a tile that has the layout of a bf16
//   or f32 stage, frees the int8 stage, and runs the same products on that
//   tile; columns past d are written as 0.
// - Slot positions and scales. The whole producer warp tests the slots of
//   4 chunks at a time (8 a lane: page, slot position, window), folds the
//   result into each chunk's valid bit mask, so the consumers stay as
//   they are, and for int8 pages loads the slots' K and V scales into
//   shared memory (0 for a slot it did not load). The test's loads are a
//   chain (page id, then position or scale), cold in L2 after a step's
//   other layers; a group's chain runs over the chunks of the group
//   before, in flight while lane 0 issues their boxes (SlotTest).
// - One launch. Each block merges its 8 warps' online softmaxes; with one
//   split that is the output, otherwise the block writes its (acc, max,
//   sum) to `part`, and the last block of a (sequence, KV head) to finish
//   (an atomic counter in `counter`, which it resets to 0 for the next
//   launch and CUDA-graph replay) merges the splits in split order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "../../csrc/hopper.cuh"

namespace {

using namespace ::hopper;

constexpr float kNegInf = -1e30f;
constexpr int kMaxG = 8;            // query heads per KV head
constexpr int kCh = 64;             // slots per chunk (a ring stage)
constexpr int kSets = 2;            // chunks in the consumers' hands at once
constexpr int kSetWarps = 4;        // warps of a set, 16 slots of a chunk each
constexpr int kWarps = kSets * kSetWarps;      // consumer warps
constexpr int kThreads = 32 * (kWarps + 1);    // + the producer warp
constexpr int kBoxSizes = 7;        // box rows 64, 32, ..., 1
constexpr int kRingBytes = 131072;

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
}

constexpr int kQPitch = 128;        // bytes of an int8 row in a stage
constexpr int kQRingBytes = 65536;  // the int8 stages of a block

// The shared memory of an instance. T tiles: boxes of 128 bytes of a row
// (64 bf16 or 32 f32 columns) by kCh rows, 128-byte swizzle. Pages of T:
// a ring of T stages. int8 pages (kQ): a ring of int8 stages (kCh rows of
// K, then of V, kQPitch apart) and one T stage per set, into which its
// warps dequantize their rows.
template <typename T, int D, bool kQ = false>
struct Cfg {
  static constexpr int NB = D * (int)sizeof(T) / 128;  // boxes to a row
  static constexpr int EB = 128 / (int)sizeof(T);      // columns to a box
  static constexpr int region = kCh * 128;             // a box of a chunk
  static constexpr int stage_bytes = 2 * NB * region;  // K boxes, V boxes
  static constexpr int ring_stage = kQ ? 2 * kCh * kQPitch : stage_bytes;
  // a multiple of kSets, so that a stage always goes to the same set and
  // a set's parity waits on it never alias another set's phase
  static constexpr int fit =
      (kQ ? kQRingBytes : kRingBytes) / ring_stage / kSets * kSets;
  static constexpr int stages = fit < kSets ? kSets : (fit > 6 ? 6 : fit);
  static constexpr int tile_bytes = kQ ? kSets * stage_bytes : 0;
  static constexpr int total = tile_bytes + stages * ring_stage + 1024;
  // the warps' online softmaxes, merged after the loop in the ring's place
  static_assert(kWarps * kMaxG * (D + 2) * 4 <= total - 1024,
                "merge scratch fits the ring");
};

struct Args {
  CUtensorMap k[kBoxSizes];   // box rows 64 >> i
  CUtensorMap v[kBoxSizes];
  const void* q;
  void* out;
  float* part;
  int* counter;
  const int* page_table;
  const int* seq_lens;
  const float* k_scale;  // (n_pool * page, Kv) with int8 pages, else null
  const float* v_scale;
  const int* slot_pos;   // (n_pool * page): the position test, or null
  const int* pos;        // (B,) with slot_pos
  int d;      // head_dim <= D (== D when kExact): the row pitch of q,
              // out and the pages
  int H, Kv, n_pool, page, n_max, split, n_split;
  int window;            // > 0: the position test's window
  float scale;
};

__device__ __forceinline__ void ldmatrix_x4_t(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// int8 pages: the column of the pool row at which a box of KV head kv
// starts, kv * d rounded down to 16 bytes (TMA starts a box only there),
// and the offset of the head's first code in the box's row (0 or 8 at
// d = 120, so that the head's codes end within the box's 128 bytes)
__device__ __forceinline__ int qcol(const Args& a, int kv) {
  return (kv * a.d) & ~15;
}
__device__ __forceinline__ int qoff(const Args& a, int kv) {
  return (kv * a.d) & 15;
}

// The slot tests of the producer warp, kAhead chunks (a group) at a time:
// a lane takes slots c0 + 32 k + lane, k < 2 kAhead. Each chunk's bit
// mask of slots that pass the page and position tests goes to pmask, its
// scales (int8 pages; 0 for a slot not loaded) to scl, both at chunk
// index % kPre. The loads form a chain (the page id, then the slot
// position or scales), so a group's test runs in three steps spread over
// the chunks of the group before it, the loads of each in flight while
// lane 0 issues boxes: pages() at its first chunk, values() at its
// second, finish() (the ballots and stores) at its last. Only finish()
// writes shared memory, after its first ballot, which lane 0 reaches
// only past its wait for the stage of that chunk; so kPre >= kAhead +
// stages + 1: an entry is overwritten only after the consumers released
// the stages of the chunks kPre before it (at chunk i lane 0 has waited
// for the stages of chunks i - stages and i - 1 - stages, one of each
// set).
constexpr int kAhead = 4;
constexpr int kPre = 12;

template <bool kQ>
struct SlotTest {
  static constexpr int N = 2 * kAhead;    // slots a lane takes
  int pid[N], off[N];                     // page id (-1: none), offset
  int sp[N];
  float ks[N], vs[N];

  __device__ __forceinline__ void pages(const Args& a, int b, int c0,
                                        int s1) {
    const int lane = threadIdx.x % 32;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int t = c0 + 32 * k + lane;
      const int j = t / a.page;
      pid[k] = t < s1 ? a.page_table[(size_t)b * a.n_max + j] : -1;
      off[k] = t - j * a.page;
    }
  }

  __device__ __forceinline__ void values(const Args& a, int kv) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      if (pid[k] < 0 || pid[k] >= a.n_pool) pid[k] = -1;
      const int row = pid[k] * a.page + off[k];
      sp[k] = pid[k] >= 0 && a.slot_pos ? a.slot_pos[row] : 0;
      if constexpr (kQ) {
        const size_t at = (size_t)row * a.Kv + kv;
        ks[k] = pid[k] >= 0 ? a.k_scale[at] : 0.f;
        vs[k] = pid[k] >= 0 ? a.v_scale[at] : 0.f;
      }
    }
  }

  __device__ __forceinline__ void finish(const Args& a, uint64_t* pmask,
                                         float (*scl)[2][kCh], int i,
                                         long long pb) {
    const int lane = threadIdx.x % 32;
#pragma unroll
    for (int k = 0; k < N; k += 2) {
      uint32_t keep[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long v = sp[k + h];
        const bool ok = pid[k + h] >= 0 &&
                        (!a.slot_pos ||
                         (v >= 0 && v <= pb &&
                          (a.window <= 0 || v > pb - a.window)));
        keep[h] = __ballot_sync(0xffffffffu, ok);
        if constexpr (kQ) {
          scl[(i + k / 2) % kPre][0][32 * h + lane] = ks[k + h];
          scl[(i + k / 2) % kPre][1][32 * h + lane] = vs[k + h];
        }
      }
      if (lane == 0)
        pmask[(i + k / 2) % kPre] = keep[0] | (uint64_t)keep[1] << 32;
    }
    __syncwarp();     // the stores before lane 0's arrivals
  }
};

// Lane 0 of the producer: the boxes of chunk i's loaded slots, page by
// page, each counted into the stage's full barrier; returns the chunk's
// loaded slots as a bit mask.
template <typename T, int D, bool kQ>
__device__ __forceinline__ uint64_t issue(const Args& a, uint8_t* ring,
                                          uint64_t* full, int b, int kv,
                                          int s0, int s1, int i) {
  using C = Cfg<T, D, kQ>;
  const int st = i % C::stages;
  uint8_t* base = ring + st * C::ring_stage;
  const int c0 = s0 + i * kCh, c1 = min(c0 + kCh, s1);
  uint64_t vm = 0;
  for (int j = c0 / a.page; j * a.page < c1; ++j) {
    const int pid = a.page_table[(size_t)b * a.n_max + j];
    if (pid < 0 || pid >= a.n_pool) continue;
    const int lo = max(c0, j * a.page), hi = min(c1, (j + 1) * a.page);
    int n = hi - lo, row = pid * a.page + (lo - j * a.page), r = lo - c0;
    vm |= (n == 64 ? ~0ull : ((1ull << n) - 1)) << r;
#pragma unroll
    for (int z = 0; z < kBoxSizes; ++z) {
      const int rows = kCh >> z;
      if (!(n & rows)) continue;
      if constexpr (kQ) {
        mbar_add_tx(&full[st], 2 * rows * kQPitch);
        tma_load_2d(base + r * kQPitch, &a.k[z], &full[st], qcol(a, kv),
                    row);
        tma_load_2d(base + (kCh + r) * kQPitch, &a.v[z], &full[st],
                    qcol(a, kv), row);
      } else {
        mbar_add_tx(&full[st], 2 * C::NB * rows * 128);
        for (int c = 0; c < C::NB; ++c) {
          tma_load_3d(base + c * C::region + r * 128, &a.k[z], &full[st],
                      c * C::EB, kv, row);
          tma_load_3d(base + (C::NB + c) * C::region + r * 128, &a.v[z],
                      &full[st], c * C::EB, kv, row);
        }
      }
      row += rows;
      r += rows;
    }
  }
  return vm;
}

// The producer: for each chunk of the block's slots [s0, s1), the boxes
// of its valid slots, page by page, then one arrival on the stage's full
// barrier, with the chunk's valid slots as a bit mask in valid[stage].
// Lane 0 issues the boxes. With slot positions or int8 pages the whole
// warp tests the slots (SlotTest) a group of chunks at a time, ahead of
// the boxes of the group, and the mask keeps only the slots that pass.
template <typename T, int D, bool kQ>
__device__ void produce(const Args& a, uint8_t* ring, uint64_t* full,
                        uint64_t* empty, uint64_t* valid, uint64_t* pmask,
                        float (*scl)[2][kCh], int b, int kv, int s0, int s1,
                        int nch) {
  using C = Cfg<T, D, kQ>;
  static_assert(kPre >= kAhead + C::stages + 1, "slot tests outlive a chunk");
  const int lane = threadIdx.x % 32;
  const bool coop = kQ || a.slot_pos != nullptr;
  if (!coop && lane != 0) return;
  const long long pb = a.slot_pos ? a.pos[b] : 0;
  SlotTest<kQ> test;
  for (int i = 0; i < nch; ++i) {
    const int st = i % C::stages;
    uint64_t vm = 0;
    // only lane 0 polls the barrier; the others wait in the tests'
    // ballots, which lane 0 reaches only past the wait
    if (lane == 0) {
      mbar_wait(&empty[st], ((i / C::stages) & 1) ^ 1);
      vm = issue<T, D, kQ>(a, ring, full, b, kv, s0, s1, i);
    }
    // the next group, if any, is tested over this group's chunks (all
    // kAhead of them exist then)
    const int g = i % kAhead;
    const bool next = coop && i - g + kAhead < nch;
    if (coop && i == 0) {
      test.pages(a, b, s0, s1);
      test.values(a, kv);
      test.finish(a, pmask, scl, 0, pb);
    }
    if (next && g == 0) test.pages(a, b, s0 + (i + kAhead) * kCh, s1);
    if (next && g == 1) test.values(a, kv);
    if (lane == 0) {
      valid[st] = coop ? vm & pmask[i % kPre] : vm;
      mbar_arrive(&full[st]);
    }
    if (next && g == kAhead - 1) test.finish(a, pmask, scl, i + 1, pb);
  }
}

// Four int8 codes (a word) as floats, exactly: each byte, its sign bit
// flipped (code + 128), is the low byte of the float 2^23 + code + 128,
// from which 2^23 + 128 is taken. A byte permute and a subtraction a
// code, where a conversion instruction runs at a quarter of the rate.
__device__ __forceinline__ void codes_to_float(uint32_t u, float* f) {
  const uint32_t x = u ^ 0x80808080u;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    f[e] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7540 + e)) -
           8388736.f;
}

// int8 pages: warp w's 16 rows of an int8 stage (K rows, then V rows,
// kQPitch bytes apart, the head's codes from src) dequantized into the
// same rows of a tile laid out as a T stage (Cfg<T, D>): (code * scale)
// rounded once to T, as the reference's dequantize_kv; columns at or
// past d are 0. A lane takes 8 codes (8 bytes) at a time.
template <typename T, int D>
__device__ __forceinline__ void dequant_rows(const uint8_t* src,
                                             const float (*scl)[kCh],
                                             uint8_t* dst, int w, int lane,
                                             int d) {
  using C = Cfg<T, D>;
  constexpr int W8 = D / 8;                 // 8-code groups of a row
#pragma unroll 4
  for (int idx = lane; idx < 2 * 16 * W8; idx += 32) {
    const int m = idx / (16 * W8);          // 0: K, 1: V
    const int r = 16 * w + idx / W8 % 16;
    const int col = 8 * (idx % W8);
    // d is a multiple of 8: a group lies wholly before d or at or past it
    const bool in = col < d;
    const uint2 u = in ? *reinterpret_cast<const uint2*>(
                             src + (m * kCh + r) * kQPitch + col)
                       : make_uint2(0u, 0u);
    const float s = scl[m][r];
    float f[8];
    codes_to_float(u.x, f);
    codes_to_float(u.y, f + 4);
#pragma unroll
    for (int e = 0; e < 8; ++e) f[e] = in ? __fmul_rn(f[e], s) : 0.f;
    if constexpr (std::is_same<T, float>::value) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = col + 4 * h;
        uint8_t* at = dst + (m * C::NB + c / 32) * C::region + r * 128 +
                      ((((c % 32) / 4) ^ (r & 7)) << 4);
        *reinterpret_cast<float4*>(at) =
            make_float4(f[4 * h], f[4 * h + 1], f[4 * h + 2], f[4 * h + 3]);
      }
    } else {
      uint8_t* at = dst + (m * C::NB + col / 64) * C::region + r * 128 +
                    ((((col % 64) / 8) ^ (r & 7)) << 4);
      *reinterpret_cast<uint4*>(at) =
          make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]),
                     pack_bf16(f[4], f[5]), pack_bf16(f[6], f[7]));
    }
  }
}

// bf16 consumer warp: 16 slots of every chunk of its set (chunks i with
// i % kSets == set) on the tensor cores. The warp's online softmax (rows
// g = lane / 4 of the 16; rows g + 8 and rows >= G are padding) ends in m,
// l and o (o[j][e]: row g, column 8 j + 2 (lane % 4) + e).
template <int D, bool kQ>
__device__ void consume_bf16(const Args& a, const uint8_t* ring,
                             uint8_t* tile, const float (*scl)[2][kCh],
                             uint64_t* full, uint64_t* empty,
                             const uint64_t* valid, int nch, int G, int d,
                             const __nv_bfloat16* q, float& m, float& l,
                             float (&o)[D / 8][4]) {
  using C = Cfg<__nv_bfloat16, D, kQ>;
  constexpr int KS = D / 16, DT = D / 8;
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32 % kSetWarps;
  const int set = threadIdx.x / 32 / kSetWarps;
  const int g = lane / 4, c = lane % 4;
  // the A fragments of q: row g (zero past G and at columns past d),
  // rows g + 8 zero
  uint32_t qa[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    qa[ks][1] = qa[ks][3] = 0u;
    qa[ks][0] = qa[ks][2] = 0u;
    if (g < G) {
      const uint32_t* qr = reinterpret_cast<const uint32_t*>(q + g * d);
      if (16 * ks + 2 * c < d) qa[ks][0] = qr[ks * 8 + c];
      if (16 * ks + 8 + 2 * c < d) qa[ks][2] = qr[ks * 8 + c + 4];
    }
  }
  const uint32_t ring_a = smem_u32(ring);
  for (int i = set; i < nch; i += kSets) {
    const int st = i % C::stages;
    mbar_wait(&full[st], (i / C::stages) & 1);
    const uint32_t vm = (uint32_t)(valid[st] >> (16 * w)) & 0xFFFFu;
    uint32_t kb = ring_a + st * C::ring_stage;
    if constexpr (kQ) {
      uint8_t* t = tile + set * C::stage_bytes;
      if (vm)
        dequant_rows<__nv_bfloat16, D>(
            ring + st * C::ring_stage + qoff(a, blockIdx.x), scl[i % kPre],
            t, w, lane, d);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
      kb = smem_u32(t);
    }
    if (vm) {
      const uint32_t vb = kb + C::NB * C::region;
      // S (16 x 16 slots): sc[nt][e] is row g, slot 8 nt + 2 c + e
      float sc[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t kf[4];
        const int r = 16 * w + lane % 8 + (lane / 16) * 8;
        ldmatrix_x4(kf, swz(kb + (ks / 4) * C::region, r,
                            (ks % 4) * 2 + (lane / 8) % 2));
        mma_bf16(sc[0], qa[ks], kf[0], kf[1]);
        mma_bf16(sc[1], qa[ks], kf[2], kf[3]);
      }
      bool ok[2][2];
      float mt = kNegInf;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          ok[nt][e] = (vm >> (8 * nt + 2 * c + e)) & 1u;
          sc[nt][e] = ok[nt][e] ? sc[nt][e] * a.scale : kNegInf;
          mt = fmaxf(mt, sc[nt][e]);
        }
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float m_new = fmaxf(m, mt);
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sc[nt][e] = ok[nt][e] ? expf(sc[nt][e] - m_new) : 0.f;
          sum += sc[nt][e];
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float corr = expf(m - m_new);
      l = l * corr + sum;
      m = m_new;
      uint32_t pa[4];
      pa[0] = pack_bf16(sc[0][0], sc[0][1]);
      pa[1] = 0u;
      pa[2] = pack_bf16(sc[1][0], sc[1][1]);
      pa[3] = 0u;
      // slots 2c, 2c + 1 (keep0) and 8 + 2c, 9 + 2c (keep1) of the warp's
      // 16 in the V fragments: a masked slot's shared row was never loaded
      const uint32_t keep0 = (ok[0][0] ? 0xFFFFu : 0u) |
                             (ok[0][1] ? 0xFFFF0000u : 0u);
      const uint32_t keep1 = (ok[1][0] ? 0xFFFFu : 0u) |
                             (ok[1][1] ? 0xFFFF0000u : 0u);
      const int r = 16 * w + lane % 16;
#pragma unroll
      for (int j = 0; j < DT; j += 2) {
        o[j][0] *= corr;
        o[j][1] *= corr;
        o[j + 1][0] *= corr;
        o[j + 1][1] *= corr;
        const int chunk = j + lane / 16;    // 8-column chunk of d
        uint32_t vf[4];
        ldmatrix_x4_t(vf, swz(vb + (chunk / 8) * C::region, r, chunk % 8));
        mma_bf16(o[j], pa, vf[0] & keep0, vf[1] & keep1);
        mma_bf16(o[j + 1], pa, vf[2] & keep0, vf[3] & keep1);
      }
    }
    __syncwarp();
    if (!kQ && lane == 0) mbar_arrive(&empty[st]);
  }
}

// f32 consumer warp on the CUDA cores, over the chunks of its set: lane
// l scores slot l % 16 of the warp's 16 over half l / 16 of d, then keeps the output sums of columns
// l * D / 32 .. + D / 32 - 1 (acc[g][cc]) for the G heads.
template <int D, bool kQ>
__device__ void consume_f32(const Args& a, const uint8_t* ring,
                            uint8_t* tile, const float (*scl)[2][kCh],
                            uint64_t* full, uint64_t* empty,
                            const uint64_t* valid, int nch, int G, int d,
                            const float (*qs)[D], float (&m)[kMaxG],
                            float (&l)[kMaxG], float (&acc)[kMaxG][D / 32]) {
  using C = Cfg<float, D, kQ>;
  constexpr int DPL = D / 32;
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32 % kSetWarps;
  const int set = threadIdx.x / 32 / kSetWarps;
  const int jj = lane % 16, half = lane / 16;
  for (int i = set; i < nch; i += kSets) {
    const int st = i % C::stages;
    mbar_wait(&full[st], (i / C::stages) & 1);
    const uint32_t vm = (uint32_t)(valid[st] >> (16 * w)) & 0xFFFFu;
    const uint8_t* kb = ring + st * C::ring_stage;
    if constexpr (kQ) {
      uint8_t* t = tile + set * C::stage_bytes;
      if (vm)
        dequant_rows<float, D>(kb + qoff(a, blockIdx.x), scl[i % kPre], t, w,
                               lane, d);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
      kb = t;
    }
    if (vm) {
      const uint8_t* vb = kb + C::NB * C::region;
      const int r = 16 * w + jj;
      const bool mine = (vm >> jj) & 1u;
      float s[kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) s[g] = 0.f;
      if (mine) {
#pragma unroll 4
        for (int e = half * D / 2; e < (half + 1) * D / 2; e += 4) {
          const float4 kk = *reinterpret_cast<const float4*>(
              kb + (e / 32) * C::region + r * 128 +
              ((((e % 32) / 4) ^ (r & 7)) << 4));
#pragma unroll
          for (int g = 0; g < kMaxG; ++g) {
            if (g < G) {
              const float4 qv = *reinterpret_cast<const float4*>(&qs[g][e]);
              s[g] = fmaf(qv.x, kk.x, s[g]);
              s[g] = fmaf(qv.y, kk.y, s[g]);
              s[g] = fmaf(qv.z, kk.z, s[g]);
              s[g] = fmaf(qv.w, kk.w, s[g]);
            }
          }
        }
      }
      float p[kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        p[g] = 0.f;
        if (g >= G) continue;
        s[g] += __shfl_xor_sync(0xffffffffu, s[g], 16);
        const float sg = mine ? s[g] * a.scale : kNegInf;
        float mt = sg;
#pragma unroll
        for (int o = 8; o > 0; o >>= 1)
          mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
        const float m_new = fmaxf(m[g], mt);
        const float pg = mine ? expf(sg - m_new) : 0.f;
        float sum = pg;
#pragma unroll
        for (int o = 8; o > 0; o >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
        const float corr = expf(m[g] - m_new);
        l[g] = l[g] * corr + sum;
        m[g] = m_new;
#pragma unroll
        for (int cc = 0; cc < DPL; ++cc) acc[g][cc] *= corr;
        p[g] = pg;
      }
      const int col = lane * DPL;
      const uint8_t* vcol = vb + (col / 32) * C::region;
      const int vch = (col % 32) / 4, vin = (col % 4) * 4;
      for (int u = 0; u < 16; ++u) {
        if (!((vm >> u) & 1u)) continue;
        const int ru = 16 * w + u;
        const float* vr = reinterpret_cast<const float*>(
            vcol + ru * 128 + ((vch ^ (ru & 7)) << 4) + vin);
        float vv[DPL];
#pragma unroll
        for (int cc = 0; cc < DPL; ++cc) vv[cc] = vr[cc];
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) {
          if (g < G) {
            const float pj = __shfl_sync(0xffffffffu, p[g], u);
#pragma unroll
            for (int cc = 0; cc < DPL; ++cc)
              acc[g][cc] = fmaf(pj, vv[cc], acc[g][cc]);
          }
        }
      }
    }
    __syncwarp();
    if (!kQ && lane == 0) mbar_arrive(&empty[st]);
  }
}

template <typename T, int D, bool kExact, bool kQ>
__global__ void __launch_bounds__(kThreads)
    paged_kernel(const __grid_constant__ Args a) {
  using C = Cfg<T, D, kQ>;
  const int d = kExact ? D : a.d;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[C::stages], empty[C::stages];
  __shared__ uint64_t valid[C::stages];
  __shared__ __align__(16) float qs[std::is_same<T, float>::value ? kMaxG
                                                                   : 1][D];
  __shared__ uint64_t pmask[kPre];                     // SlotTest
  __shared__ float scl[kQ ? kPre : 1][2][kCh];         // int8 pages' scales
  __shared__ int is_last;
  // the dequantized tiles (int8 pages), then the ring; 1024-aligned for
  // the 128-byte swizzle
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* tile = smem;
  uint8_t* ring = smem + C::tile_bytes;
  const int G = a.H / a.Kv;
  const int kv = blockIdx.x, b = blockIdx.y, z = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const T* q = static_cast<const T*>(a.q) + ((size_t)b * a.H + kv * G) * d;

  // this block's slots [s0, s1) of the row, in chunks of 64
  const int L = max(0, min(a.seq_lens[b], a.n_max * a.page));
  const int s0 = z * a.split, s1 = min(L, s0 + a.split);
  const int nch = s1 > s0 ? (s1 - s0 + kCh - 1) / kCh : 0;

  if (tid == 0) {
    for (int s = 0; s < C::stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kSetWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (std::is_same<T, float>::value)
    for (int i = tid; i < G * D; i += kThreads)
      qs[i / D][i % D] = i % D < d ? q[i / D * d + i % D] : 0.f;
  __syncthreads();

  // the warps' online softmaxes: rows g < G, columns as each path keeps them
  float m[kMaxG], l[kMaxG];
  float o[D / 8][4];                 // bf16: row g = lane / 4
  float acc[kMaxG][D / 32];          // f32
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int cc = 0; cc < D / 32; ++cc) acc[g][cc] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  if (warp == kWarps) {
    produce<T, D, kQ>(a, ring, full, empty, valid, pmask, scl, b, kv, s0, s1,
                      nch);
  } else if constexpr (std::is_same<T, float>::value) {
    consume_f32<D, kQ>(a, ring, tile, scl, full, empty, valid, nch, G, d,
                       qs, m, l, acc);
  } else {
    consume_bf16<D, kQ>(a, ring, tile, scl, full, empty, valid, nch, G, d,
                        q, m[0], l[0], o);
  }
  __syncthreads();   // every stage consumed: the ring is scratch now

  // merge the consumer warps' online softmaxes, warp by warp
  float* mw = reinterpret_cast<float*>(smem);          // [kWarps][kMaxG]
  float* lw = mw + kWarps * kMaxG;                     // [kWarps][kMaxG]
  float* aw = lw + kWarps * kMaxG;                     // [kWarps][kMaxG][D]
  if (warp < kWarps) {
    if constexpr (std::is_same<T, float>::value) {
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g >= G) break;
        if (lane == 0) {
          mw[warp * kMaxG + g] = m[g];
          lw[warp * kMaxG + g] = l[g];
        }
#pragma unroll
        for (int cc = 0; cc < D / 32; ++cc)
          aw[(warp * kMaxG + g) * D + lane * (D / 32) + cc] = acc[g][cc];
      }
    } else {
      const int g = lane / 4;
      if (g < G) {
        if (lane % 4 == 0) {
          mw[warp * kMaxG + g] = m[0];
          lw[warp * kMaxG + g] = l[0];
        }
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            aw[(warp * kMaxG + g) * D + 8 * j + 2 * (lane % 4) + e] = o[j][e];
      }
    }
  }
  __syncthreads();
  T* out = static_cast<T*>(a.out) + ((size_t)b * a.H + kv * G) * d;
  float* pp = a.n_split > 1
                  ? a.part + (((size_t)b * a.Kv + kv) * a.n_split + z) *
                                 kMaxG * (D + 2)
                  : nullptr;
  for (int i = tid; i < G * d; i += kThreads) {
    const int g = i / d, e = i % d;
    float mx = kNegInf;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, mw[w * kMaxG + g]);
    float num = 0.f, den = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(mw[w * kMaxG + g] - mx);
      num = fmaf(aw[(w * kMaxG + g) * D + e], f, num);
      den = fmaf(lw[w * kMaxG + g], f, den);
    }
    if (pp) {
      pp[g * (D + 2) + e] = num;
      if (e == 0) {
        pp[g * (D + 2) + D] = mx;
        pp[g * (D + 2) + D + 1] = den;
      }
    } else {
      out[i] = from_f<T>(num / fmaxf(den, 1e-20f));
    }
  }
  if (!pp) return;

  // the last split of (b, kv) to finish merges all of them, in order
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* cnt = a.counter + (size_t)b * a.Kv + kv;
    const int done = atomicAdd(cnt, 1);
    is_last = done == a.n_split - 1;
    if (is_last) *cnt = 0;   // ready for the next launch or graph replay
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const float* p0 =
      a.part + ((size_t)b * a.Kv + kv) * a.n_split * kMaxG * (D + 2);
  constexpr int kStride = kMaxG * (D + 2);
  for (int i = tid; i < G * d; i += kThreads) {
    const int g = i / d, e = i % d;
    float mx = kNegInf;
    for (int s = 0; s < a.n_split; ++s)
      mx = fmaxf(mx, __ldcg(p0 + s * kStride + g * (D + 2) + D));
    float num = 0.f, den = 0.f;
    for (int s = 0; s < a.n_split; ++s) {
      const float* ps = p0 + s * kStride + g * (D + 2);
      const float f = expf(__ldcg(ps + D) - mx);
      num = fmaf(__ldcg(ps + e), f, num);
      den = fmaf(__ldcg(ps + D + 1), f, den);
    }
    out[i] = from_f<T>(num / fmaxf(den, 1e-20f));
  }
}

// The tensor maps of the pool, filled into `a`, and the launch. Pages of
// T: (d, Kv, slots) with boxes of 128 bytes of a row, 128-byte swizzle.
// int8 pages: (Kv * d, slots) with boxes of kQPitch columns, no swizzle.
template <typename T, int D, bool kExact, bool kQ>
cudaError_t launch(Args a, const void* kp, const void* vp, int B,
                   cudaStream_t stream) {
  using C = Cfg<T, D, kQ>;
  const int d = a.d, Kv = a.Kv, n_pool = a.n_pool, page = a.page;
  if (a.split % kCh || (a.n_split > 1 && (!a.part || !a.counter)) ||
      (uint64_t)n_pool * page >= (1ull << 31) || d < 1 || d > D || d % 8 ||
      (kExact && d != D) || (kQ && (!a.k_scale || !a.v_scale)) ||
      (kQ && (Kv * d) % 16) || (a.slot_pos && !a.pos))
    return cudaErrorInvalidValue;
  if (n_pool > 0) {
    for (int z = 0; z < kBoxSizes; ++z) {
      bool ok;
      if constexpr (kQ) {
        const uint64_t dims[2] = {(uint64_t)Kv * d, (uint64_t)n_pool * page};
        const uint64_t strides[1] = {(uint64_t)Kv * d};
        const uint32_t box[2] = {(uint32_t)kQPitch, (uint32_t)(kCh >> z)};
        ok = make_map_nd(&a.k[z], kp, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, dims,
                         strides, box, CU_TENSOR_MAP_SWIZZLE_NONE) &&
             make_map_nd(&a.v[z], vp, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, dims,
                         strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
      } else {
        const CUtensorMapDataType type =
            sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                           : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
        const uint64_t dims[3] = {(uint64_t)d, (uint64_t)Kv,
                                  (uint64_t)n_pool * page};
        const uint64_t strides[2] = {d * sizeof(T),
                                     (uint64_t)Kv * d * sizeof(T)};
        const uint32_t box[3] = {(uint32_t)C::EB, 1, (uint32_t)(kCh >> z)};
        ok = make_map_nd(&a.k[z], kp, type, 3, dims, strides, box,
                         CU_TENSOR_MAP_SWIZZLE_128B) &&
             make_map_nd(&a.v[z], vp, type, 3, dims, strides, box,
                         CU_TENSOR_MAP_SWIZZLE_128B);
      }
      if (!ok) return cudaErrorInvalidValue;
    }
  }
  auto kernel = paged_kernel<T, D, kExact, kQ>;
  // raised once per instance, so that later launches, inside a CUDA graph
  // capture too, make no attribute call
  static bool raised = false;
  if (!raised) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::total);
    if (err != cudaSuccess) return err;
    raised = true;
  }
  kernel<<<dim3(Kv, B, a.n_split), kThreads, C::total, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, bool kQ>
cudaError_t launch_d(const Args& a, const void* kp, const void* vp, int B,
                     cudaStream_t s) {
  if (a.d == 64) return launch<T, 64, true, kQ>(a, kp, vp, B, s);
  if (a.d == 128) return launch<T, 128, true, kQ>(a, kp, vp, B, s);
  if (a.d == 96 || a.d == 120)
    return launch<T, 128, false, kQ>(a, kp, vp, B, s);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_q(const Args& a, const void* kp, const void* vp, int B,
                     cudaStream_t s) {
  return a.k_scale ? launch_d<T, true>(a, kp, vp, B, s)
                   : launch_d<T, false>(a, kp, vp, B, s);
}

}  // namespace

// q and out (B, H, D); k_pages and v_pages (n_pool, page, Kv, D), of q's
// dtype, or int8 with k_scale and v_scale f32 (n_pool, page, Kv);
// page_table (B, n_max) int32, -1 for an unassigned page; seq_lens (B,)
// int32; optional slot_pos int32 (n_pool, page) with pos (B,) int32 and
// window (> 0, or 0 for none): the position test. All contiguous and
// 16-byte aligned; q bf16 when is_bf16 else f32. D is 64, 96, 120 or
// 128; G = H / Kv is at most 8; with int8 pages Kv * D is a multiple of
// 16. Each row's n_max * page slots are cut into n_split splits of
// `split` slots (a multiple of 64), one block per (KV head, row, split).
// With more than one split, `part` is f32 scratch of B * Kv * n_split * 8
// * (D' + 2) floats, D' the instance's width (64 for D = 64, else 128),
// and `counter` B * Kv int32 that are 0 before the launch (and are left
// 0 after it). One launch; does not synchronise; returns
// cudaGetLastError() of the launch.
extern "C" int paged_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_table, const void* seq_lens, void* out, void* part,
    void* counter, const void* k_scale, const void* v_scale,
    const void* slot_pos, const void* pos, int B, int H, int Kv, int D,
    int n_pool, int page, int n_max, int split, int n_split, int window,
    float scale, int is_bf16, void* stream) {
  if (Kv <= 0 || H % Kv || H / Kv > kMaxG || split <= 0 || n_split <= 0 ||
      page <= 0 || (!k_scale != !v_scale) || window < 0)
    return (int)cudaErrorInvalidValue;
  Args a = {};
  a.q = q;
  a.out = out;
  a.part = static_cast<float*>(part);
  a.counter = static_cast<int*>(counter);
  a.page_table = static_cast<const int*>(page_table);
  a.seq_lens = static_cast<const int*>(seq_lens);
  a.k_scale = static_cast<const float*>(k_scale);
  a.v_scale = static_cast<const float*>(v_scale);
  a.slot_pos = static_cast<const int*>(slot_pos);
  a.pos = static_cast<const int*>(pos);
  a.d = D;
  a.H = H;
  a.Kv = Kv;
  a.n_pool = n_pool;
  a.page = page;
  a.n_max = n_max;
  a.split = split;
  a.n_split = n_split;
  a.window = window;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)launch_q<__nv_bfloat16>(a, k_pages, v_pages, B, s);
  return (int)launch_q<float>(a, k_pages, v_pages, B, s);
}
