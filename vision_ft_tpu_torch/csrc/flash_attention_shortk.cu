// Short-K attention over (B, H, S, D) for Hopper (sm_90a), CUDA C++: the
// forward (kernel H) and its backward (kernel I), both warp-specialized
// persistent TMA + wgmma kernels on hopper_gemm.cuh.
//
// Replaces vision_ft_tpu/ops/pallas/flash_attention.py::_fwd_kernel_shortk
// (launched by _shortk_fwd_call) and ::_bwd_kernel_shortk (launched by
// _shortk_core_bwd), the entry flash_attention_shortk: SDXL's cross
// attention over the 77 (or up to 192) CLIP tokens, where the whole key
// context fits on chip.
//
// Forward, per batch b and head h, with sk <= 192 keys, no mask, not causal:
//   S = Q K^T * scale (fp32), P = exp(S - max), O = bf16(P) V / rowsum(P),
//   lse = max + log(rowsum(P)) (fp32, (B, H, Sq)).
// Backward, from q, k, v, dO (bf16), lse and delta = rowsum(dO * O) (fp32
// (B, H, Sq), computed outside as the JAX package does it):
//   P = exp(S - lse), dP = dO V^T, dS = bf16(P * (dP - delta) * scale),
//   dV = bf16(P)^T dO, dK = dS^T Q, dQ = dS K,
// fp32 accumulators, outputs written once in bf16.
//
// Keys are padded to SKP (64, 80, 96, 128, 160 or 192: a template
// parameter, so every per-key array stays in registers): the pad keys are
// zero rows in shared memory (TMA's fill) that weigh exactly 0, as the TPU
// kernel's padded keys, scored a finite -1e30, do. The forward takes the
// row max on raw scores with the scale folded into the exponent, so it
// needs scale > 0 (the wrapper raises on the card otherwise); the backward
// takes any scale. q rows at or past sq are neither read (TMA's zeros) nor
// written (TMA stores drop them).
//
// Layout: every bf16 tensor is addressed through (batch, head, row) strides
// with a contiguous last axis, so SDXL's cross-attention operands, views of
// the (B, S, H*D) projections, are read in place and the outputs keep that
// memory.
//
// What bounds them on an H100: bytes. Per head the forward reads Sq*D q
// elements and writes Sq*D out (4 bytes a q element) for 4*Sq*Sk*D
// operations (4*Sk a q element): 77 operations a byte at Sk 77, against the
// card's 295 bf16 operations a byte, so every Sk <= 192 is memory-bound. The
// backward moves q, dO, dq (6 bytes a q element) for 10*Sk operations.
//
// Design:
//   - Kernel H: one persistent block per SM of consumer warpgroups (4, 3
//     or 2 by D and SKP: consumer_warpgroups) and one producer warp. Work
//     items are (batch, head, 64-row q tile), walked in head order; a block
//     takes a contiguous run of them (blocks and runs fixed by the shape
//     and the SM count, ops.flash_attention.shortk_fwd_plan), and its
//     warpgroups take the run's items in turn, each on its own, so one
//     warpgroup's exponentials overlap another's products and stores. A
//     block loads a head's K and V once per head it meets (two heads at
//     most at SDXL's shapes). The producer's lane 0 issues TMA through 4-D
//     tensor maps over (D, S, H, B) with the tensors' own strides: K and V
//     of a head as one box of SKP rows each (TMA's zero fill past sk is
//     the pad), into two buffers where they fit, so the next head's load
//     hides behind this head's tiles; and a ring of q tiles, three stages a
//     warpgroup (a stage always serves the same warpgroup).
//   - A warpgroup's tile: S = Q K^T is one wgmma m64n{SKP}k16 per 16
//     columns of D, both operands K-major; the one-pass softmax (no online
//     rescaling: the keys fit) runs on the accumulator in registers in the
//     exp2 domain, skipping 8-key groups that are all pad; P is register A
//     of O = P V, with V read MN-major through the transpose bit: no
//     transposed copy. The S registers are dead once P is packed, so S
//     (SKP / 2), P (SKP / 4) and O (D / 2) are never all live.
//   - The epilogue normalizes O into the tile's own q slot (128-byte
//     swizzled, the layout TMA reads), and one thread stores it with a 4-D
//     TMA store at out's strides, which drops rows past sq; the slot is
//     released once the store has read it (checked at the warpgroup's next
//     tile). lse is written by plain stores.
//   - Kernel I: the same persistent walk (blocks and runs from
//     ops.flash_attention.shortk_bwd_plan) over (batch, head, half, 64-row
//     q tile) items, a "unit" being (batch, head, half): the half is the
//     64 columns of dq, dk and dv an item writes (always 0 at D = 64; at
//     D = 128 an item computes S and dP over all of D and its half of the
//     gradients). A block has one producer warp, kNs score warpgroups and
//     kNg gradient warpgroups (struct Bwd). The producer's lane 0 loads K
//     and V of a head once per head the block meets, as kernel H's does,
//     and streams a ring of (Q, dO) tile pairs; its 32 lanes write each
//     tile's lse (times log2 e) and delta into the stage, read four items
//     ahead. (Tried and dropped: reading them one item ahead, a global load
//     on the producer's path every item: the loads alone took 23 us at (4,
//     10, 4096, 77, 64); the score warpgroups reading their rows' themselves:
//     each proxy fence before a TMA or wgmma read of shared memory then
//     waited for those loads.)
//   - A score warpgroup takes every kNs-th item: S = Q K^T and dP = dO V^T
//     (wgmma m64n{chunk}k16, both operands K-major) in key chunks of 64, 80
//     or 96, so that a chunk's S and dP stay within 96 fp32 a thread; P =
//     exp2(S scale log2 e - lse log2 e), 0 on pad keys and on rows past sq
//     (lse +inf); dS = P (dP - delta) scale; P and dS go in bf16 to the
//     warpgroup's own pair of shared buffers, in 64-key boxes laid out as a
//     128-byte-swizzled TMA box would be (sw128_offset). Then dQ = dS K: A =
//     dS K-major from shared memory, B = K's half read MN-major through the
//     transpose bit, one wgmma m64n64k16 per 16 keys; dQ goes out through
//     a 64 x 64 box by a 4-D TMA store, which drops rows past sq. (Tried
//     and dropped: bf16 pairs stored straight from the accumulator, 7%
//     slower at (4, 10, 4096, 77, 64); dQ on the gradient warpgroup up to 80
//     keys, where its accumulators and dQ's spill and ptxas serializes the
//     wgmma: 1.4-1.5x slower.)
//   - The gradient warpgroups take every item in order: dV^T += dO^T P and
//     dK^T += Q^T dS over the tile's 64 rows, wgmma m64n{SKP}k16 with both
//     operands MN-major: dO and Q as they landed, P and dS as the score
//     warpgroup wrote them. No transposed copy is made anywhere. The two
//     accumulators (64 columns of the half x SKP keys, fp32) stay in
//     registers over a unit's tiles: one warpgroup holds both up to 96
//     keys, two hold one each past that. At a unit's last tile in the
//     block they go, in fp32, to the unit's partial slot block + unit.
//   - After a grid barrier (the launch is cooperative: one block an SM,
//     all resident), every thread of the grid sums some of the units'
//     values, each over the unit's slots in slot order, which is block
//     order, and writes dk and dv in bf16. No atomics: the order of every
//     sum is a function of the shape and the SM count alone, so reruns are
//     bit-identical. One launch a call. (Tried and dropped: the last block
//     to finish a unit, found by an atomic count, summing its slots alone,
//     with few loads in flight: 20-40 us more a call; and units held by
//     one block written from the gradient warpgroup's registers, whose
//     address arithmetic spilled.)
//   - Registers: a score warpgroup holds a chunk's S and dP (at most 96
//     fp32), then dQ (32); a gradient warpgroup its accumulators (at most
//     96); nothing else is held across phases. So three warpgroups and the
//     producer warp, 416 threads: two score warpgroups and one gradient
//     warpgroup up to 96 keys, one and two past them. A block's registers
//     are four sub-partitions' 16384, and its 13 warps put four on one of
//     them: 128 registers a thread (with two of each, 17 warps, five on
//     one: 96, too few for a wgmma m64n160k16's accumulator and its
//     operands).
// Not carried over from the TPU kernel: the V-ones row sum, the padding of
// q, k and v in device memory, the 8-sublane lse and delta replication.
// Tried and dropped for kernel H (PERF.md): 128-row items shared by
// two warpgroups (3-13% slower up to 96 keys, 3-13% faster past them),
// three warpgroups past 96 keys (spills at 160 and 192). Left for later
// work: the wrappers' host cost, which sets a call's time at SDXL's shapes;
// kernel I's partials and their sum after the grid barrier (8 of 45 us at
// (4, 10, 4096, 77, 64), 12 of 28 at (4, 20, 1024, 77, 64)) and its score
// warpgroups' serial chain a tile (PERF.md).

#include <cooperative_groups.h>

#include "hopper_gemm.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace hopper;

constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------- kernel H

constexpr int kTileRows = 64;       // q rows a work item: one consumer warpgroup's wgmma rows
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may use

// Consumer warpgroups: as many as S, P and O fit the registers of without
// spills (ptxas's -v): four at D = 64 and three at D = 128 up to 96 keys
// (544 and 416 threads), two from 128 keys on (288 threads).
template <int D, int SKP>
constexpr int consumer_warpgroups() {
  return SKP > 96 ? 2 : D == 64 ? 4 : 3;
}

// Shared memory: K and V of a head (each D / 64 boxes of SKP rows x 128
// bytes) in kKvBufs buffers, a ring of kQStages q tiles (D / 64 boxes of 64
// rows; the tile's output goes back into its slot), barriers. kQStages is
// three a warpgroup: one computed, one whose store may still read it, one
// loading.
template <int D, int SKP>
struct FwdSmem {
  static constexpr int kWgs = consumer_warpgroups<D, SKP>();
  static constexpr int kQBytes = kTileRows * D * 2;
  static constexpr int kKvTileBytes = SKP * D * 2;
  static constexpr int kKvBytes = 2 * kKvTileBytes;
  static constexpr int kBarrierBytes = 256;
  static constexpr int kKvBufs =
      1024 + 2 * kKvBytes + 3 * kWgs * kQBytes + kBarrierBytes <= kSmemLimit ? 2 : 1;
  static constexpr int kQFit = (kSmemLimit - 1024 - kKvBufs * kKvBytes - kBarrierBytes) / kQBytes;
  static constexpr int kQStages = 3 * kWgs;
  static_assert(kQFit >= kQStages, "kernel H needs three q stages a warpgroup");
  static constexpr int kBytes = 1024 + kKvBufs * kKvBytes + kQStages * kQBytes + kBarrierBytes;
  static_assert(2 * kQStages + 2 * kKvBufs <= kBarrierBytes / 8, "barriers");
  uint8_t* kv;
  uint8_t* q;
  uint64_t* q_full;
  uint64_t* q_empty;   // one arrival, once the tile's store has read the slot
  uint64_t* kv_full;
  uint64_t* kv_empty;  // one arrival per consumer warp
  __device__ __forceinline__ explicit FwdSmem(uint8_t* raw) {
    kv = align_1024(raw);
    q = kv + kKvBufs * kKvBytes;
    q_full = reinterpret_cast<uint64_t*>(q + kQStages * kQBytes);
    q_empty = q_full + kQStages;
    kv_full = q_empty + kQStages;
    kv_empty = kv_full + kKvBufs;
  }
  __device__ __forceinline__ uint8_t* k(int buf) const { return kv + buf * kKvBytes; }
  __device__ __forceinline__ uint8_t* v(int buf) const { return k(buf) + kKvTileBytes; }
  __device__ __forceinline__ uint8_t* q_tile(int stage) const { return q + stage * kQBytes; }
};

template <int D, int SKP>
constexpr int fwd_threads() {
  return consumer_warpgroups<D, SKP>() * 128 + 32;
}

template <int D, int SKP>
__global__ void __launch_bounds__(fwd_threads<D, SKP>(), 1)
shortk_fwd_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                  const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_o,
                  float* __restrict__ lse, int sq, int sk, int num_heads, int q_tiles,
                  int items, float scale_log2) {
  using S = FwdSmem<D, SKP>;
  constexpr int kBoxes = D / 64;
  constexpr int kWgs = S::kWgs;
  extern __shared__ uint8_t smem_raw[];
  const S sm(smem_raw);
  // this block's contiguous run of work items (batch, head, q tile); item
  // begin + i goes to warpgroup i % kWgs through stage i % kQStages
  const int begin = static_cast<int>(static_cast<long long>(blockIdx.x) * items / gridDim.x);
  const int end = static_cast<int>(static_cast<long long>(blockIdx.x + 1) * items / gridDim.x);

  if (threadIdx.x == 0) {
    for (int s = 0; s < S::kQStages; ++s) {
      mbar_init(&sm.q_full[s], 1);
      mbar_init(&sm.q_empty[s], 1);
    }
    for (int buf = 0; buf < S::kKvBufs; ++buf) {
      mbar_init(&sm.kv_full[buf], 1);
      mbar_init(&sm.kv_empty[buf], 4 * kWgs);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kWgs) {
    if (threadIdx.x == kWgs * 128) {  // the producer
      int head = -1, heads_loaded = 0;
      for (int item = begin; item < end; ++item) {
        const int bh = item / q_tiles, qt = item % q_tiles;
        const int b = bh / num_heads, h = bh % num_heads;
        if (bh != head) {  // K and V of the next head, into the next buffer
          const int buf = heads_loaded % S::kKvBufs;
          mbar_wait(&sm.kv_empty[buf], ((heads_loaded / S::kKvBufs) & 1u) ^ 1u);
          mbar_arrive_expect_tx(&sm.kv_full[buf], S::kKvBytes);
#pragma unroll
          for (int box = 0; box < kBoxes; ++box) {
            tma_load_4d(sm.k(buf) + box * SKP * 128, &map_k, &sm.kv_full[buf], 64 * box, 0, h, b);
            tma_load_4d(sm.v(buf) + box * SKP * 128, &map_v, &sm.kv_full[buf], 64 * box, 0, h, b);
          }
          ++heads_loaded;
          head = bh;
        }
        const int i = item - begin;
        const int stage = i % S::kQStages;
        mbar_wait(&sm.q_empty[stage], ((i / S::kQStages) & 1u) ^ 1u);
        mbar_arrive_expect_tx(&sm.q_full[stage], S::kQBytes);
#pragma unroll
        for (int box = 0; box < kBoxes; ++box) {
          tma_load_4d(sm.q_tile(stage) + box * kTileRows * 128, &map_q, &sm.q_full[stage],
                      64 * box, qt * kTileRows, h, b);
        }
      }
    }
  } else {
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int r_lo = 16 * (t / 32) + lane / 4;  // this thread's rows r_lo, r_lo + 8 of the 64
    const int c0 = 2 * (lane % 4);              // and its first column of each 8
    int head = -1, heads_seen = 0, buf = 0, pending = -1;
    for (int item = begin; item < end; ++item) {
      const int bh = item / q_tiles, qt = item % q_tiles;
      const int b = bh / num_heads, h = bh % num_heads;
      if (bh != head) {  // every warpgroup waits for every head's K and V, in order
        buf = heads_seen % S::kKvBufs;
        mbar_wait(&sm.kv_full[buf], (heads_seen / S::kKvBufs) & 1u);
        ++heads_seen;
        head = bh;
      }
      const int i = item - begin;
      const bool last_of_head = item + 1 == end || (item + 1) / q_tiles != bh;
      if (i % kWgs != wg) {  // another warpgroup's tile
        if (last_of_head && lane == 0) mbar_arrive(&sm.kv_empty[buf]);
        continue;
      }
      const int stage = i % S::kQStages;
      mbar_wait(&sm.q_full[stage], (i / S::kQStages) & 1u);
      uint8_t* q_tile = sm.q_tile(stage);

      // S = Q K^T over every key at once. The accumulators are defined
      // afresh on every tile, so no tile's S, P and O registers are live
      // together across the loop
      float s[SKP / 2];
#pragma unroll
      for (int j = 0; j < SKP / 2; ++j) s[j] = 0.f;
      const uint64_t desc_q = desc_sw128(q_tile);
      const uint64_t desc_k = desc_sw128(sm.k(buf));
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_ss<SKP>(s, desc_q + k_major_step<kTileRows>(kk), desc_k + k_major_step<SKP>(kk),
                      kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(s);

      // one-pass softmax in the exp2 domain. The row max is taken on raw
      // scores (scale > 0) over the keys below sk, and the scale folds into
      // the exponent's one FMA. An 8-key group (this thread's columns 8j +
      // c0, 8j + c0 + 1) of keys below sk takes no test, a group of pad keys
      // only weighs 0, and the group sk falls in tests each key.
      float m_lo = -INFINITY, m_hi = -INFINITY;
#pragma unroll
      for (int j = 0; j < SKP / 8; ++j) {
        if (8 * j + 8 <= sk) {
          m_lo = fmaxf(m_lo, fmaxf(s[4 * j], s[4 * j + 1]));
          m_hi = fmaxf(m_hi, fmaxf(s[4 * j + 2], s[4 * j + 3]));
        } else if (8 * j < sk) {
          const bool k0 = 8 * j + c0 < sk, k1 = 8 * j + c0 + 1 < sk;
          m_lo = fmaxf(m_lo, fmaxf(k0 ? s[4 * j] : -INFINITY, k1 ? s[4 * j + 1] : -INFINITY));
          m_hi = fmaxf(m_hi, fmaxf(k0 ? s[4 * j + 2] : -INFINITY, k1 ? s[4 * j + 3] : -INFINITY));
        }
      }
      // finite: every row has key 0
      m_lo = fmaxf(m_lo, __shfl_xor_sync(0xffffffffu, m_lo, 1));
      m_lo = fmaxf(m_lo, __shfl_xor_sync(0xffffffffu, m_lo, 2));
      m_hi = fmaxf(m_hi, __shfl_xor_sync(0xffffffffu, m_hi, 1));
      m_hi = fmaxf(m_hi, __shfl_xor_sync(0xffffffffu, m_hi, 2));
      const float mb_lo = m_lo * scale_log2, mb_hi = m_hi * scale_log2;
      float l_lo = 0.f, l_hi = 0.f;
#pragma unroll
      for (int j = 0; j < SKP / 8; ++j) {
        if (8 * j < sk) {
          s[4 * j] = ex2_approx(fmaf(s[4 * j], scale_log2, -mb_lo));
          s[4 * j + 1] = ex2_approx(fmaf(s[4 * j + 1], scale_log2, -mb_lo));
          s[4 * j + 2] = ex2_approx(fmaf(s[4 * j + 2], scale_log2, -mb_hi));
          s[4 * j + 3] = ex2_approx(fmaf(s[4 * j + 3], scale_log2, -mb_hi));
          if (8 * j + 8 > sk) {
            const bool k0 = 8 * j + c0 < sk, k1 = 8 * j + c0 + 1 < sk;
            if (!k0) s[4 * j] = s[4 * j + 2] = 0.f;
            if (!k1) s[4 * j + 1] = s[4 * j + 3] = 0.f;
          }
          l_lo += s[4 * j] + s[4 * j + 1];
          l_hi += s[4 * j + 2] + s[4 * j + 3];
        } else {
          s[4 * j] = s[4 * j + 1] = s[4 * j + 2] = s[4 * j + 3] = 0.f;
        }
      }
      l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
      l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
      l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
      l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);

      // O = P V: P as register A fragments, V read MN-major
      uint32_t p_frag[SKP / 16][4];
      acc_to_a_fragments<SKP>(p_frag, s);
      float o_acc[D / 2];
#pragma unroll
      for (int j = 0; j < D / 2; ++j) o_acc[j] = 0.f;
      wgmma_fence();
      mma_rs_mn<D, SKP / 16>(o_acc, p_frag, sm.v(buf), SKP * 128);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(o_acc);
      if (last_of_head && lane == 0) mbar_arrive(&sm.kv_empty[buf]);

      // O / l into the tile's q slot (l >= 1: the row's largest score
      // contributes exp2(0)), then one TMA store
      const float inv_lo = rcp_approx(l_lo), inv_hi = rcp_approx(l_hi);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        uint8_t* box = q_tile + (j / 8) * kTileRows * 128;
        *reinterpret_cast<uint32_t*>(box + sw128_offset(r_lo, j % 8, lane % 4)) =
            pack_bf16x2(o_acc[4 * j] * inv_lo, o_acc[4 * j + 1] * inv_lo);
        *reinterpret_cast<uint32_t*>(box + sw128_offset(r_lo + 8, j % 8, lane % 4)) =
            pack_bf16x2(o_acc[4 * j + 2] * inv_hi, o_acc[4 * j + 3] * inv_hi);
      }
      fence_async_shared();
      named_barrier_sync(1 + wg, 128);
      const int row0 = qt * kTileRows;
      if (t == 0) {
        // this warpgroup's previous store has read its slot: release it
        if (pending >= 0) {
          tma_store_wait_read<0>();
          mbar_arrive(&sm.q_empty[pending]);
        }
#pragma unroll
        for (int box = 0; box < kBoxes; ++box) {
          tma_store_4d(&map_o, q_tile + box * kTileRows * 128, 64 * box, row0, h, b);
        }
        tma_store_commit();
        pending = stage;
      }
      if (lse != nullptr && lane % 4 == 0) {
        const float ln2 = 0.69314718055994531f;
        float* lh = lse + static_cast<long long>(bh) * sq;
        if (row0 + r_lo < sq) lh[row0 + r_lo] = (mb_lo + lg2_approx(l_lo)) * ln2;
        if (row0 + r_lo + 8 < sq) lh[row0 + r_lo + 8] = (mb_hi + lg2_approx(l_hi)) * ln2;
      }
    }
    if (t == 0) tma_store_wait<0>();  // the last store is written before the block exits
  }
}

// ---------------------------------------------------------------- kernel I

constexpr int kBoxBytes = kTileRows * 128;  // 64 rows of one 64-column, 128-byte-swizzled box

// Kernel I at head dim DIN and SKP padded keys: its warpgroups (kNs score,
// kNg gradient, then the producer warp), the key chunk of the score pass,
// and its shared memory: K and V of a head in kKvBufs buffers; a ring of
// kStages (Q, dO) tile pairs (DIN / 64 boxes each) with the tile's 64 lse
// and 64 delta values; per score warpgroup a P and a dS buffer (SKP keys in
// 64-key boxes of 64 rows) and one dQ box; the barriers. Two KV buffers
// where four stages fit beside them, up to six stages.
template <int DIN, int SKP>
struct Bwd {
  static constexpr int kNg = SKP <= 96 ? 1 : 2;
  static constexpr int kNs = 3 - kNg;
  static constexpr int kChunk = SKP == 96 ? 96 : SKP % 80 == 0 ? 80 : 64;
  static constexpr int kThreads = (kNs + kNg) * 128 + 32;
  static constexpr int kHalves = DIN / 64;
  static constexpr int kKeyBoxes = (SKP + 63) / 64;
  static constexpr int kTileBytes = kHalves * kBoxBytes;
  static constexpr int kKvTileBytes = SKP * DIN * 2;
  static constexpr int kKvBytes = 2 * kKvTileBytes;
  static constexpr int kPdsBytes = 2 * kKeyBoxes * kBoxBytes;
  static constexpr int kBarrierBytes = 256;
  static constexpr int kFixed = 1024 + kNs * (kPdsBytes + kBoxBytes) + kBarrierBytes;
  static constexpr int kStatsFloats = 2 * kTileRows;  // a tile's lse and delta
  static constexpr int kStageCost = 2 * kTileBytes + kStatsFloats * 4;
  static constexpr int kKvBufs = (kSmemLimit - kFixed - 2 * kKvBytes) / kStageCost >= 4 ? 2 : 1;
  static constexpr int kFit = (kSmemLimit - kFixed - kKvBufs * kKvBytes) / kStageCost;
  static constexpr int kStages = kFit < 6 ? kFit : 6;
  static_assert(kStages >= 2, "kernel I needs two (Q, dO) stages");
  static constexpr int kBytes = kFixed + kKvBufs * kKvBytes + kStages * kStageCost;
  static_assert(kBytes <= kSmemLimit, "shared memory");
  static_assert((2 * kStages + 2 * kKvBufs + 2 * kNs) * 8 <= kBarrierBytes, "barriers");
  static_assert(SKP % kChunk == 0, "key chunks");

  uint8_t* kv;
  uint8_t* ring;
  uint8_t* pds;
  uint8_t* dq;
  float* stats;
  uint64_t* q_full;     // the producer's 32 lanes (lse, delta) and the tile's bytes
  uint64_t* q_empty;    // one arrival per gradient warp
  uint64_t* kv_full;
  uint64_t* kv_empty;   // one arrival per score warp
  uint64_t* pds_full;   // per score warpgroup: one arrival per its warps
  uint64_t* pds_empty;  // one arrival per gradient warp
  __device__ __forceinline__ explicit Bwd(uint8_t* raw) {
    kv = align_1024(raw);
    ring = kv + kKvBufs * kKvBytes;
    pds = ring + kStages * 2 * kTileBytes;
    dq = pds + kNs * kPdsBytes;
    stats = reinterpret_cast<float*>(dq + kNs * kBoxBytes);
    q_full = reinterpret_cast<uint64_t*>(stats + kStages * kStatsFloats);
    q_empty = q_full + kStages;
    kv_full = q_empty + kStages;
    kv_empty = kv_full + kKvBufs;
    pds_full = kv_empty + kKvBufs;
    pds_empty = pds_full + kNs;
  }
  __device__ __forceinline__ uint8_t* k(int buf) const { return kv + buf * kKvBytes; }
  __device__ __forceinline__ uint8_t* v(int buf) const { return k(buf) + kKvTileBytes; }
  __device__ __forceinline__ uint8_t* q_tile(int stage) const {
    return ring + stage * 2 * kTileBytes;
  }
  __device__ __forceinline__ uint8_t* do_tile(int stage) const {
    return q_tile(stage) + kTileBytes;
  }
  __device__ __forceinline__ uint8_t* p_buf(int wg) const { return pds + wg * kPdsBytes; }
  __device__ __forceinline__ uint8_t* ds_buf(int wg) const { return p_buf(wg) + kPdsBytes / 2; }
  __device__ __forceinline__ uint8_t* dq_box(int wg) const { return dq + wg * kBoxBytes; }
  __device__ __forceinline__ float* stage_stats(int stage) const {
    return stats + stage * kStatsFloats;
  }
};

// The pair (row r, keys key, key + 1) of a 64-row tile of SKP keys stored as
// 64-key boxes of 64 rows, 128-byte swizzled (key even).
__device__ __forceinline__ int key_pair_offset(int r, int key) {
  return (key / 64) * kBoxBytes + sw128_offset(r, (key % 64) / 8, (key % 8) / 2);
}

template <int DIN, int SKP>
__global__ void __launch_bounds__(Bwd<DIN, SKP>::kThreads, 1)
shortk_bwd_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                  const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_do,
                  const __grid_constant__ CUtensorMap map_dq, const float* __restrict__ lse,
                  const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                  __nv_bfloat16* __restrict__ dv, float4* __restrict__ partials, int sq,
                  int sk, int num_heads, int tiles,
                  int items, long long dk_sb, long long dk_sh, long long dk_ss, long long dv_sb,
                  long long dv_sh, long long dv_ss, float scale) {
  using S = Bwd<DIN, SKP>;
  extern __shared__ uint8_t smem_raw[];
  const S sm(smem_raw);
  // this block's contiguous run of items; item -> unit = item / tiles (a
  // (batch, head, half)), head = item / head_items
  const int begin = static_cast<int>(static_cast<long long>(blockIdx.x) * items / gridDim.x);
  const int end = static_cast<int>(static_cast<long long>(blockIdx.x + 1) * items / gridDim.x);
  const int head_items = S::kHalves * tiles;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(&sm.q_full[s], 32);
      mbar_init(&sm.q_empty[s], 4 * S::kNg);
    }
    for (int buf = 0; buf < S::kKvBufs; ++buf) {
      mbar_init(&sm.kv_full[buf], 1);
      mbar_init(&sm.kv_empty[buf], 4 * S::kNs);
    }
    for (int w = 0; w < S::kNs; ++w) {
      mbar_init(&sm.pds_full[w], 4);
      mbar_init(&sm.pds_empty[w], 4 * S::kNg);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  if (wg == S::kNs + S::kNg) {
    // ------------------------------------------------ the producer warp
    constexpr int kAhead = 4;
    float ahead[kAhead][4];
    auto load_stats = [&](int item, float (&out)[4]) {
      if (item >= end) return;
      const long long base = static_cast<long long>(item / head_items) * sq;
      const int row = (item % tiles) * kTileRows + lane;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const bool in = row + 32 * r < sq;
        out[r] = in ? __fmul_rn(lse[base + row + 32 * r], kLog2e) : INFINITY;
        out[2 + r] = in ? delta[base + row + 32 * r] : 0.f;
      }
    };
#pragma unroll
    for (int a = 0; a < kAhead; ++a) load_stats(begin + a, ahead[a]);
    int head = -1, heads_loaded = 0;
    // items item0 + a, a < kAhead unrolled, so that each one's prefetched
    // values stay in their own registers
    for (int item0 = begin; item0 < end; item0 += kAhead) {
#pragma unroll
      for (int a = 0; a < kAhead; ++a) {
        const int item = item0 + a;
        if (item >= end) break;
        const int bh = item / head_items;
        const int b = bh / num_heads, h = bh % num_heads;
        if (bh != head) {  // K and V of the next head, into the next buffer
          if (lane == 0) {
            const int buf = heads_loaded % S::kKvBufs;
            mbar_wait(&sm.kv_empty[buf], ((heads_loaded / S::kKvBufs) & 1u) ^ 1u);
            mbar_arrive_expect_tx(&sm.kv_full[buf], S::kKvBytes);
#pragma unroll
            for (int box = 0; box < S::kHalves; ++box) {
              tma_load_4d(sm.k(buf) + box * SKP * 128, &map_k, &sm.kv_full[buf], 64 * box, 0, h,
                          b);
              tma_load_4d(sm.v(buf) + box * SKP * 128, &map_v, &sm.kv_full[buf], 64 * box, 0, h,
                          b);
            }
          }
          ++heads_loaded;
          head = bh;
        }
        // the tile's lse (times log2 e, rounded on its own) and delta rows
        // lane and lane + 32 (+inf and 0 past sq), read kAhead items ahead,
        // into the stage, and Q and dO by TMA (lane 0)
        const int i = item - begin;
        const int stage = i % S::kStages;
        const int row0 = (item % tiles) * kTileRows;
        mbar_wait(&sm.q_empty[stage], ((i / S::kStages) & 1u) ^ 1u);
        float* st = sm.stage_stats(stage);
        st[lane] = ahead[a][0];
        st[lane + 32] = ahead[a][1];
        st[kTileRows + lane] = ahead[a][2];
        st[kTileRows + lane + 32] = ahead[a][3];
        load_stats(item + kAhead, ahead[a]);
        if (lane == 0) {
          mbar_arrive_expect_tx(&sm.q_full[stage], 2 * S::kTileBytes);
#pragma unroll
          for (int box = 0; box < S::kHalves; ++box) {
            tma_load_4d(sm.q_tile(stage) + box * kBoxBytes, &map_q, &sm.q_full[stage], 64 * box,
                        row0, h, b);
            tma_load_4d(sm.do_tile(stage) + box * kBoxBytes, &map_do, &sm.q_full[stage],
                        64 * box, row0, h, b);
          }
        } else {
          mbar_arrive(&sm.q_full[stage]);
        }
      }
    }
  } else if (wg < S::kNs) {
    // ------------------------------------------------ a score warpgroup
    const int r_lo = 16 * (t / 32) + lane / 4;  // this thread's rows r_lo, r_lo + 8 of the 64
    const int c0 = 2 * (lane % 4);              // and its first column of each 8
    const float scale_log2 = scale * kLog2e;
    uint8_t* p_buf = sm.p_buf(wg);
    uint8_t* ds_buf = sm.ds_buf(wg);
    uint8_t* dq_box = sm.dq_box(wg);
    int head = -1, heads_seen = 0, buf = 0, own = 0;
    for (int item = begin; item < end; ++item) {
      const int bh = item / head_items;
      if (bh != head) {  // every score warpgroup waits for every head's K and V, in order
        buf = heads_seen % S::kKvBufs;
        mbar_wait(&sm.kv_full[buf], (heads_seen / S::kKvBufs) & 1u);
        ++heads_seen;
        head = bh;
      }
      const int i = item - begin;
      const bool last_of_head = item + 1 == end || (item + 1) / head_items != bh;
      if (i % S::kNs != wg) {  // another warpgroup's tile
        if (last_of_head && lane == 0) mbar_arrive(&sm.kv_empty[buf]);
        continue;
      }
      const int stage = i % S::kStages;
      mbar_wait(&sm.q_full[stage], (i / S::kStages) & 1u);
      const float* st = sm.stage_stats(stage);
      const float lse_lo = st[r_lo], lse_hi = st[r_lo + 8];
      const float delta_lo = st[kTileRows + r_lo], delta_hi = st[kTileRows + r_lo + 8];
      const uint64_t desc_q = desc_sw128(sm.q_tile(stage));
      const uint64_t desc_do = desc_sw128(sm.do_tile(stage));

#pragma unroll 1
      for (int c = 0; c < SKP / S::kChunk; ++c) {
        // S and dP of the chunk's keys; their registers are defined afresh
        // in every chunk, so no two chunks' are live together
        float s[S::kChunk / 2], dp[S::kChunk / 2];
        const uint64_t desc_k = desc_sw128(sm.k(buf) + c * S::kChunk * 128);
        const uint64_t desc_v = desc_sw128(sm.v(buf) + c * S::kChunk * 128);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DIN / 16; ++kk) {
          wgmma_ss<S::kChunk>(s, desc_q + k_major_step<kTileRows>(kk),
                              desc_k + k_major_step<SKP>(kk), kk > 0);
        }
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < DIN / 16; ++kk) {
          wgmma_ss<S::kChunk>(dp, desc_do + k_major_step<kTileRows>(kk),
                              desc_v + k_major_step<SKP>(kk), kk > 0);
        }
        wgmma_commit();
        // the buffers are free once the gradient warpgroups have read this
        // warpgroup's previous tile
        if (c == 0) mbar_wait(&sm.pds_empty[wg], (own & 1u) ^ 1u);
        wgmma_wait<1>();
        fence_operands(s);
        // P = exp2(S scale log2 e - lse log2 e): 0 on pad keys (an 8-key
        // group of keys below sk takes no test) and on rows past sq
#pragma unroll
        for (int j = 0; j < S::kChunk / 8; ++j) {
          const int key = c * S::kChunk + 8 * j + c0;
          const bool all_in = c * S::kChunk + 8 * j + 8 <= sk;
          const bool in0 = all_in || key < sk, in1 = all_in || key + 1 < sk;
          s[4 * j] = in0 ? ex2_approx(fmaf(s[4 * j], scale_log2, -lse_lo)) : 0.f;
          s[4 * j + 1] = in1 ? ex2_approx(fmaf(s[4 * j + 1], scale_log2, -lse_lo)) : 0.f;
          s[4 * j + 2] = in0 ? ex2_approx(fmaf(s[4 * j + 2], scale_log2, -lse_hi)) : 0.f;
          s[4 * j + 3] = in1 ? ex2_approx(fmaf(s[4 * j + 3], scale_log2, -lse_hi)) : 0.f;
          *reinterpret_cast<uint32_t*>(p_buf + key_pair_offset(r_lo, key)) =
              pack_bf16x2(s[4 * j], s[4 * j + 1]);
          *reinterpret_cast<uint32_t*>(p_buf + key_pair_offset(r_lo + 8, key)) =
              pack_bf16x2(s[4 * j + 2], s[4 * j + 3]);
        }
        wgmma_wait<0>();
        fence_operands(dp);
        // dS = P (dP - delta) scale
#pragma unroll
        for (int j = 0; j < S::kChunk / 8; ++j) {
          const int key = c * S::kChunk + 8 * j + c0;
          dp[4 * j] = s[4 * j] * (dp[4 * j] - delta_lo) * scale;
          dp[4 * j + 1] = s[4 * j + 1] * (dp[4 * j + 1] - delta_lo) * scale;
          dp[4 * j + 2] = s[4 * j + 2] * (dp[4 * j + 2] - delta_hi) * scale;
          dp[4 * j + 3] = s[4 * j + 3] * (dp[4 * j + 3] - delta_hi) * scale;
          *reinterpret_cast<uint32_t*>(ds_buf + key_pair_offset(r_lo, key)) =
              pack_bf16x2(dp[4 * j], dp[4 * j + 1]);
          *reinterpret_cast<uint32_t*>(ds_buf + key_pair_offset(r_lo + 8, key)) =
              pack_bf16x2(dp[4 * j + 2], dp[4 * j + 3]);
        }
      }
      // P and dS visible to wgmma (the gradient warpgroups' and dQ's); the
      // previous dQ store has read the dQ box
      fence_async_shared();
      if (t == 0) tma_store_wait_read<0>();
      named_barrier_sync(1 + wg, 128);
      if (lane == 0) mbar_arrive(&sm.pds_full[wg]);

      // dQ (this item's 64 columns) = dS K: dS K-major from its buffer, K's
      // half read MN-major
      const int half = (item / tiles) % S::kHalves;
      float dq_acc[32];
      const uint64_t desc_ds = desc_sw128(ds_buf);
      const uint64_t desc_kt = desc_sw128_mn(sm.k(buf) + half * SKP * 128, SKP * 128);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < SKP / 16; ++kk) {
        wgmma_ss<64, 0, 1>(dq_acc, desc_ds + k_major_step<kTileRows>(kk), desc_kt + 128 * kk,
                           kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(dq_acc);
      if (last_of_head && lane == 0) mbar_arrive(&sm.kv_empty[buf]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        *reinterpret_cast<uint32_t*>(dq_box + sw128_offset(r_lo, j, lane % 4)) =
            pack_bf16x2(dq_acc[4 * j], dq_acc[4 * j + 1]);
        *reinterpret_cast<uint32_t*>(dq_box + sw128_offset(r_lo + 8, j, lane % 4)) =
            pack_bf16x2(dq_acc[4 * j + 2], dq_acc[4 * j + 3]);
      }
      fence_async_shared();
      named_barrier_sync(1 + wg, 128);
      if (t == 0) {
        tma_store_4d(&map_dq, dq_box, 64 * half, (item % tiles) * kTileRows, bh % num_heads,
                     bh / num_heads);
        tma_store_commit();
      }
      ++own;
    }
    if (t == 0) tma_store_wait<0>();  // the last store is written before the block exits
  } else {
    // ------------------------------------------------ a gradient warpgroup
    // accumulators: dV^T (which 0) and dK^T (which 1) of the unit's half,
    // 64 rows (its columns of D) x SKP keys; both here or one of two
    const int gw = wg - S::kNs;
    constexpr int kAccs = 2 / S::kNg;
    float acc[kAccs][SKP / 2];
    auto which = [&](int a) { return S::kNg == 1 ? a : gw; };
    // this thread's float4 of group g of accumulator w (which) in partial
    // slot `slot`
    auto slot_ptr = [&](int slot, int w, int g) {
      return partials + ((static_cast<long long>(slot) * 2 + w) * (SKP / 8) + g) * 128 + t;
    };
    int unit = -1;
    for (int item = begin; item < end; ++item) {
      const int u = item / tiles;
      if (u != unit) {
#pragma unroll
        for (int a = 0; a < kAccs; ++a) {
#pragma unroll
          for (int r = 0; r < SKP / 2; ++r) acc[a][r] = 0.f;
        }
        unit = u;
      }
      const int i = item - begin;
      const int stage = i % S::kStages;
      const int sw = i % S::kNs;
      mbar_wait(&sm.q_full[stage], (i / S::kStages) & 1u);
      mbar_wait(&sm.pds_full[sw], (i / S::kNs) & 1u);
      const int half = u % S::kHalves;
      wgmma_fence();
#pragma unroll
      for (int a = 0; a < kAccs; ++a) {
        // dV^T += dO^T P, dK^T += Q^T dS: A = dO's or Q's half, B = P or dS,
        // both MN-major; K runs over the tile's 64 rows
        const uint8_t* tile_a = (which(a) == 0 ? sm.do_tile(stage) : sm.q_tile(stage)) +
                                half * kBoxBytes;
        const uint8_t* tile_b = which(a) == 0 ? sm.p_buf(sw) : sm.ds_buf(sw);
        const uint64_t desc_a = desc_sw128_mn(tile_a, kBoxBytes);
        const uint64_t desc_b = desc_sw128_mn(tile_b, kBoxBytes);
#pragma unroll
        for (int kk = 0; kk < kTileRows / 16; ++kk) {
          wgmma_ss<SKP, 1, 1>(acc[a], desc_a + 128 * kk, desc_b + 128 * kk, 1);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int a = 0; a < kAccs; ++a) fence_operands(acc[a]);
      if (lane == 0) {
        mbar_arrive(&sm.q_empty[stage]);
        mbar_arrive(&sm.pds_empty[sw]);
      }
      if (item + 1 < end && (item + 1) / tiles == u) continue;

      // the unit's last tile in this block: its sums over this block's
      // tiles to slot blockIdx.x + u, summed after the grid barrier below
#pragma unroll
      for (int a = 0; a < kAccs; ++a) {
#pragma unroll
        for (int g = 0; g < SKP / 8; ++g) {
          *slot_ptr(blockIdx.x + u, which(a), g) =
              make_float4(acc[a][4 * g], acc[a][4 * g + 1], acc[a][4 * g + 2], acc[a][4 * g + 3]);
        }
      }
    }
  }

  // Every block's partials are written. Work items (unit, accumulator,
  // float4 group, thread of the gradient warpgroup) over every thread of
  // the grid: each the sum of one float4 over the unit's slots in slot
  // (block) order, written as four bf16 values of dv or dk.
  cg::this_grid().sync();
  // each unit's first and last block, computed once a block into the K and
  // V buffers (free now) where they fit, else per work item
  const int units = items / tiles;
  auto block_of = [&](int x) {
    return static_cast<int>((static_cast<long long>(x + 1) * gridDim.x - 1) / items);
  };
  int* span = reinterpret_cast<int*>(sm.kv);
  const bool cached = 2LL * units * 4 <= S::kKvBufs * S::kKvBytes;
  if (cached) {
    for (int u = threadIdx.x; u < units; u += blockDim.x) {
      span[2 * u] = block_of(u * tiles);
      span[2 * u + 1] = block_of((u + 1) * tiles - 1);
    }
    __syncthreads();
  }
  const int work = units * 2 * (SKP / 8) * 128;
  for (int w = blockIdx.x * blockDim.x + threadIdx.x; w < work; w += gridDim.x * blockDim.x) {
    const int tt = w % 128;
    const int g = w / 128 % (SKP / 8);
    const int a = w / (128 * (SKP / 8)) % 2;
    const int u = w / (256 * (SKP / 8));
    const int first = cached ? span[2 * u] : block_of(u * tiles);
    const int last = cached ? span[2 * u + 1] : block_of((u + 1) * tiles - 1);
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int blk = first; blk <= last; ++blk) {
      const float4 x =
          __ldcg(partials + ((static_cast<long long>(blk + u) * 2 + a) * (SKP / 8) + g) * 128 + tt);
      sum.x += x.x;
      sum.y += x.y;
      sum.z += x.z;
      sum.w += x.w;
    }
    // the four values' places: row d of dV^T / dK^T is column 64 half + d
    // of dv / dk, their columns keys (wgmma's accumulator layout)
    const int bh = u / S::kHalves, half = u % S::kHalves;
    const int b = bh / num_heads, h = bh % num_heads;
    const long long ss = a == 0 ? dv_ss : dk_ss;
    const int key = 8 * g + 2 * (tt % 4);
    __nv_bfloat16* row = (a == 0 ? dv + b * dv_sb + h * dv_sh : dk + b * dk_sb + h * dk_sh) +
                         64 * half + 16 * (tt / 32) + (tt % 32) / 4 + key * ss;
    if (key < sk) {
      row[0] = __float2bfloat16(sum.x);
      row[8] = __float2bfloat16(sum.z);
    }
    if (key + 1 < sk) {
      row[ss] = __float2bfloat16(sum.y);
      row[ss + 8] = __float2bfloat16(sum.w);
    }
  }
}

template <int D, int SKP>
int launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse, int batch,
               int sq, int sk, int num_heads, const long long* st, float scale_log2, int blocks,
               cudaStream_t stream) {
  using S = FwdSmem<D, SKP>;
  const int q_tiles = (sq + kTileRows - 1) / kTileRows;
  const long long items = static_cast<long long>(batch) * num_heads * q_tiles;
  if (blocks < 1 || blocks > items || items >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap map_q, map_k, map_v, map_o;
  int err = make_map_4d(&map_q, q, batch, num_heads, sq, D, st[0], st[1], st[2], kTileRows);
  if (!err) err = make_map_4d(&map_k, k, batch, num_heads, sk, D, st[3], st[4], st[5], SKP);
  if (!err) err = make_map_4d(&map_v, v, batch, num_heads, sk, D, st[6], st[7], st[8], SKP);
  if (!err) err = make_map_4d(&map_o, o, batch, num_heads, sq, D, st[9], st[10], st[11], 64);
  if (!err) err = allow_dynamic_smem<shortk_fwd_kernel<D, SKP>>(S::kBytes);
  if (err) return err;
  shortk_fwd_kernel<D, SKP><<<blocks, fwd_threads<D, SKP>(), S::kBytes, stream>>>(
      map_q, map_k, map_v, map_o, lse, sq, sk, num_heads, q_tiles, static_cast<int>(items),
      scale_log2);
  return static_cast<int>(cudaGetLastError());
}

template <int DIN, int SKP>
int launch_bwd(const void* const (&in)[6], void* dq, void* dk, void* dv, void* scratch,
               const long long* dims, float scale, cudaStream_t stream) {
  using S = Bwd<DIN, SKP>;
  const int batch = static_cast<int>(dims[0]), num_heads = static_cast<int>(dims[1]);
  const int sq = static_cast<int>(dims[2]), sk = static_cast<int>(dims[3]);
  const int blocks = static_cast<int>(dims[5]);
  const long long* st = dims + 6;  // (batch, head, row) of q, k, v, dout, dq, dk, dv
  const int tiles = (sq + kTileRows - 1) / kTileRows;
  const long long units = static_cast<long long>(batch) * num_heads * S::kHalves;
  const long long items = units * tiles;
  if (blocks < 1 || blocks > items || static_cast<long long>(batch) * num_heads * sq >= (1LL << 31) ||
      units * 2 * (SKP / 8) * 128 >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_q, map_k, map_v, map_do, map_dq;
  int err = make_map_4d(&map_q, in[0], batch, num_heads, sq, DIN, st[0], st[1], st[2], kTileRows);
  if (!err) err = make_map_4d(&map_k, in[1], batch, num_heads, sk, DIN, st[3], st[4], st[5], SKP);
  if (!err) err = make_map_4d(&map_v, in[2], batch, num_heads, sk, DIN, st[6], st[7], st[8], SKP);
  if (!err) {
    err = make_map_4d(&map_do, in[3], batch, num_heads, sq, DIN, st[9], st[10], st[11], kTileRows);
  }
  if (!err) {
    err = make_map_4d(&map_dq, dq, batch, num_heads, sq, DIN, st[12], st[13], st[14], kTileRows);
  }
  if (!err) err = allow_dynamic_smem<shortk_bwd_kernel<DIN, SKP>>(S::kBytes);
  if (err) return err;
  // a grid barrier precedes the partials' sum: one block an SM, launched
  // cooperatively (refused where the blocks cannot all be resident)
  float4* partials = static_cast<float4*>(scratch);
  const float* lse = static_cast<const float*>(in[4]);
  const float* delta = static_cast<const float*>(in[5]);
  auto* dkb = static_cast<__nv_bfloat16*>(dk);
  auto* dvb = static_cast<__nv_bfloat16*>(dv);
  int items_i = static_cast<int>(items);
  void* args[] = {&map_q, &map_k, &map_v, &map_do, &map_dq, &lse, &delta, &dkb, &dvb,
                  &partials, const_cast<int*>(&sq), const_cast<int*>(&sk),
                  const_cast<int*>(&num_heads), const_cast<int*>(&tiles), &items_i,
                  const_cast<long long*>(st + 15), const_cast<long long*>(st + 16),
                  const_cast<long long*>(st + 17), const_cast<long long*>(st + 18),
                  const_cast<long long*>(st + 19), const_cast<long long*>(st + 20), &scale};
  err = static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(shortk_bwd_kernel<DIN, SKP>), dim3(blocks), dim3(S::kThreads),
      args, S::kBytes, stream));
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entries, bound with ctypes. Strides are in elements, (batch, head, row)
// for each bf16 tensor; the last axis is contiguous, every stride is a
// multiple of 8 elements and every base 16-byte aligned (the wrapper checks
// all three). k and v have q's head count. lse and delta are contiguous
// fp32 (B, H, Sq); lse may be null in the forward. Each launches on
// `stream` and returns the first error: of the tensor maps' encoding, of
// the shared-memory attribute, or cudaGetLastError() after the launch.

// The forward: `blocks` persistent blocks (1 to B * H * ceil(Sq / 64)) walk
// the work items in order, a contiguous run each; skp is sk rounded up to a
// multiple of 32 (32 to 192); scale > 0.
extern "C" int flash_attention_shortk_fwd(const void* q, const void* k, const void* v, void* o,
                                          void* lse, int batch, int sq, int sk, int skp,
                                          int num_heads, int head_dim, long long q_sb,
                                          long long q_sh, long long q_ss, long long k_sb,
                                          long long k_sh, long long k_ss, long long v_sb,
                                          long long v_sh, long long v_ss, long long o_sb,
                                          long long o_sh, long long o_ss, float scale, int blocks,
                                          void* stream) {
  if (sk < 1 || sk > skp) return static_cast<int>(cudaErrorInvalidValue);
  const long long st[12] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss};
  const float scale_log2 = scale * kLog2e;
  auto* lb = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!(scale > 0.f)) return static_cast<int>(cudaErrorInvalidValue);  // the max is on raw scores
  // wgmma widths: the keys rounded up to 64, 80, 96, 128, 160 or 192
  switch (head_dim * 1000 + (sk <= 64 ? 64 : sk <= 80 ? 80 : skp)) {
    case 64064: return launch_fwd<64, 64>(q, k, v, o, lb, batch, sq, sk, num_heads, st, scale_log2, blocks, s);
    case 64080: return launch_fwd<64, 80>(q, k, v, o, lb, batch, sq, sk, num_heads, st, scale_log2, blocks, s);
    case 64096: return launch_fwd<64, 96>(q, k, v, o, lb, batch, sq, sk, num_heads, st, scale_log2, blocks, s);
    case 64128: return launch_fwd<64, 128>(q, k, v, o, lb, batch, sq, sk, num_heads, st, scale_log2, blocks, s);
    case 64160: return launch_fwd<64, 160>(q, k, v, o, lb, batch, sq, sk, num_heads, st, scale_log2, blocks, s);
    case 64192: return launch_fwd<64, 192>(q, k, v, o, lb, batch, sq, sk, num_heads, st, scale_log2, blocks, s);
    case 128064: return launch_fwd<128, 64>(q, k, v, o, lb, batch, sq, sk, num_heads, st, scale_log2, blocks, s);
    case 128080: return launch_fwd<128, 80>(q, k, v, o, lb, batch, sq, sk, num_heads, st, scale_log2, blocks, s);
    case 128096: return launch_fwd<128, 96>(q, k, v, o, lb, batch, sq, sk, num_heads, st, scale_log2, blocks, s);
    case 128128: return launch_fwd<128, 128>(q, k, v, o, lb, batch, sq, sk, num_heads, st, scale_log2, blocks, s);
    case 128160: return launch_fwd<128, 160>(q, k, v, o, lb, batch, sq, sk, num_heads, st, scale_log2, blocks, s);
    case 128192: return launch_fwd<128, 192>(q, k, v, o, lb, batch, sq, sk, num_heads, st, scale_log2, blocks, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The backward, one cooperative launch. dims: batch, heads, sq, sk,
// head_dim, blocks (1 to B * H * (head_dim / 64) * ceil(Sq / 64), all
// resident: at most one an SM), then the (batch, head, row) strides of q,
// k, v, dout, dq, dk and dv (27 values). scratch: (blocks + units) * 2 *
// 64 * skp * 4 bytes, 16-byte aligned, units = B * H * (head_dim / 64), skp
// the padded key count (64, 80, or sk rounded up to 32). Any scale.
extern "C" int flash_attention_shortk_bwd(const void* q, const void* k, const void* v,
                                          const void* dout, const void* lse, const void* delta,
                                          void* dq, void* dk, void* dv, void* scratch,
                                          const long long* dims, float scale, void* stream) {
  const long long sk = dims[3], head_dim = dims[4];
  if (sk < 1 || sk > 192 || dims[2] < 1) return static_cast<int>(cudaErrorInvalidValue);
  const void* const in[6] = {q, k, v, dout, lse, delta};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // wgmma widths: the keys rounded up to 64, 80, 96, 128, 160 or 192
  switch (head_dim * 1000 + (sk <= 64 ? 64 : sk <= 80 ? 80 : (sk + 31) / 32 * 32)) {
    case 64064: return launch_bwd<64, 64>(in, dq, dk, dv, scratch, dims, scale, s);
    case 64080: return launch_bwd<64, 80>(in, dq, dk, dv, scratch, dims, scale, s);
    case 64096: return launch_bwd<64, 96>(in, dq, dk, dv, scratch, dims, scale, s);
    case 64128: return launch_bwd<64, 128>(in, dq, dk, dv, scratch, dims, scale, s);
    case 64160: return launch_bwd<64, 160>(in, dq, dk, dv, scratch, dims, scale, s);
    case 64192: return launch_bwd<64, 192>(in, dq, dk, dv, scratch, dims, scale, s);
    case 128064: return launch_bwd<128, 64>(in, dq, dk, dv, scratch, dims, scale, s);
    case 128080: return launch_bwd<128, 80>(in, dq, dk, dv, scratch, dims, scale, s);
    case 128096: return launch_bwd<128, 96>(in, dq, dk, dv, scratch, dims, scale, s);
    case 128128: return launch_bwd<128, 128>(in, dq, dk, dv, scratch, dims, scale, s);
    case 128160: return launch_bwd<128, 160>(in, dq, dk, dv, scratch, dims, scale, s);
    case 128192: return launch_bwd<128, 192>(in, dq, dk, dv, scratch, dims, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
