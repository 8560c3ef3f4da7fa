// Short-K attention over (B, H, S, D) for Hopper (sm_90a), CUDA C++: the
// forward (kernel H, a warp-specialized TMA + wgmma kernel on
// hopper_gemm.cuh) and its backward (kernel I, mma.sync).
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
// Keys are padded to SKP (a template parameter, so every per-key array
// stays in registers): the pad keys are zero rows in shared memory (TMA's
// fill in the forward) that weigh exactly 0, as the TPU kernel's padded
// keys, scored a finite -1e30, do. The forward takes the row max on raw
// scores with the scale folded into the exponent, so it needs scale > 0
// (the wrapper raises on the card otherwise); the backward takes any
// scale. q rows at or past sq are neither read (TMA's zeros) nor written.
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
//     columns of D (SKP: sk rounded up to 64, 80, 96, 128, 160 or 192),
//     both operands K-major; the one-pass softmax (no online
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
// Not carried over from the TPU kernel: the V-ones row sum, the padding of
// q, k and v in device memory, the 8-sublane lse and delta replication.
// Tried and dropped (PERF.md, PR 13): 128-row items shared by two
// warpgroups (3-13% slower up to 96 keys, 3-13% faster past them), three
// warpgroups past 96 keys (spills at 160 and 192). Left for later work:
// kernel I on TMA + wgmma; the wrapper's host cost, which sets a call's
// time at SDXL's shapes.

#include "flash_attention_bshd.cuh"
#include "hopper_gemm.cuh"

namespace {

using namespace hopper;
using bshd::lds32;
using bshd::mma_16816;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kPad = 8;  // bf16 elements of padding per shared row (kernel I)

constexpr int kBwdRows = 32;  // q rows per backward tile

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

// Stage rows [row0, row0 + ROWS) of a (row, D) slice into shared memory,
// zero-filling rows at or past `rows`: ROWMAJOR into dst_r[row][d] with
// leading dimension LDR, TRANSPOSED into dst_t[d][row] with LDT.
template <int D, int ROWS, int THREADS, bool ROWMAJOR, bool TRANSPOSED, int LDR, int LDT>
__device__ __forceinline__ void stage(__nv_bfloat16* dst_r, __nv_bfloat16* dst_t,
                                      const __nv_bfloat16* src, long long row_stride, int row0,
                                      int rows) {
  constexpr int kVecPerRow = D / 8;
  for (int i = threadIdx.x; i < ROWS * kVecPerRow; i += THREADS) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < rows) {
      val = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * row_stride + c);
    }
    if (ROWMAJOR) {
      *reinterpret_cast<uint4*>(dst_r + r * LDR + c) = val;
    }
    if (TRANSPOSED) {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j) dst_t[(c + j) * LDT + r] = e[j];
    }
  }
}

// The A fragment (16 rows x 16 columns at column c0) of a row-major shared tile.
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* tile, int row0,
                                       int c0, int g, int t) {
  const __nv_bfloat16* base = tile + (row0 + g) * LD + c0 + 2 * t;
  a[0] = lds32(base);
  a[1] = lds32(base + 8 * LD);
  a[2] = lds32(base + 8);
  a[3] = lds32(base + 8 * LD + 8);
}

template <int D, int SKP>
constexpr int bwd_smem_bytes() {
  return (2 * SKP * (D + kPad) + D * (SKP + kPad) + 2 * kBwdRows * (D + kPad) +
          2 * D * (kBwdRows + kPad) + kBwdRows * (SKP + kPad)) * 2 +
         2 * kBwdRows * 4;
}

template <int D, int SKP>
__global__ void __launch_bounds__(SKP / 16 * 32)
shortk_bwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  __nv_bfloat16* __restrict__ dq, float* __restrict__ dk_part,
                  float* __restrict__ dv_part, int sq, int sk, int num_heads, long long q_sb,
                  long long q_sh, long long q_ss, long long k_sb, long long k_sh, long long k_ss,
                  long long v_sb, long long v_sh, long long v_ss, long long do_sb,
                  long long do_sh, long long do_ss, long long dq_sb, long long dq_sh,
                  long long dq_ss, float scale) {
  constexpr int kWarps = SKP / 16;
  constexpr int kThreads = kWarps * 32;
  constexpr int kLdR = D + kPad;         // [row][d] tiles
  constexpr int kLdK = SKP + kPad;       // sKt[d][key], sdS[q][key]
  constexpr int kLdT = kBwdRows + kPad;  // sQt[d][q], sdOt[d][q]
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sV = sK + SKP * kLdR;
  __nv_bfloat16* sKt = sV + SKP * kLdR;
  __nv_bfloat16* sQ = sKt + D * kLdK;
  __nv_bfloat16* sdO = sQ + kBwdRows * kLdR;
  __nv_bfloat16* sQt = sdO + kBwdRows * kLdR;
  __nv_bfloat16* sdOt = sQt + D * kLdT;
  __nv_bfloat16* sdS = sdOt + D * kLdT;
  float* sLse = reinterpret_cast<float*>(sdS + kBwdRows * kLdK);  // log2 domain
  float* sDelta = sLse + kBwdRows;

  const int bh = blockIdx.x;
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  const int b = bh / num_heads;
  const int h = bh % num_heads;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const float scale_log2 = scale * kLog2e;

  stage<D, SKP, kThreads, true, true, kLdR, kLdK>(sK, sKt, k + b * k_sb + h * k_sh, k_ss, 0, sk);
  stage<D, SKP, kThreads, true, false, kLdR, 0>(sV, nullptr, v + b * v_sb + h * v_sh, v_ss, 0,
                                                sk);

  const __nv_bfloat16* qh = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* doh = dout + b * do_sb + h * do_sh;
  __nv_bfloat16* dqh = dq + b * dq_sb + h * dq_sh;
  const float* lse_h = lse + (long long)bh * sq;
  const float* delta_h = delta + (long long)bh * sq;

  // this warp's 16 keys: rows g and g + 8 of the S^T accumulators
  const int key0 = warp * 16;
  const int key_lo = key0 + g;
  const int key_hi = key_lo + 8;

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    dk_acc[n][0] = dk_acc[n][1] = dk_acc[n][2] = dk_acc[n][3] = 0.f;
    dv_acc[n][0] = dv_acc[n][1] = dv_acc[n][2] = dv_acc[n][3] = 0.f;
  }

  const int num_tiles = (sq + kBwdRows - 1) / kBwdRows;
  const int tile_begin = (int)((long long)split * num_tiles / splits);
  const int tile_end = (int)((long long)(split + 1) * num_tiles / splits);
  for (int tile = tile_begin; tile < tile_end; ++tile) {
    const int q0 = tile * kBwdRows;
    __syncthreads();  // every warp is done with the previous tile (and K, V are staged)
    stage<D, kBwdRows, kThreads, true, true, kLdR, kLdT>(sQ, sQt, qh, q_ss, q0, sq);
    stage<D, kBwdRows, kThreads, true, true, kLdR, kLdT>(sdO, sdOt, doh, do_ss, q0, sq);
    if (threadIdx.x < kBwdRows) {
      const int row = q0 + threadIdx.x;
      // a padded row gets P = exp2(-inf) = 0
      sLse[threadIdx.x] = row < sq ? __fmul_rn(lse_h[row], kLog2e) : INFINITY;
      sDelta[threadIdx.x] = row < sq ? delta_h[row] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x 32 q rows
    float st[kBwdRows / 8][4], dpt[kBwdRows / 8][4];
#pragma unroll
    for (int j = 0; j < kBwdRows / 8; ++j) {
      st[j][0] = st[j][1] = st[j][2] = st[j][3] = 0.f;
      dpt[j][0] = dpt[j][1] = dpt[j][2] = dpt[j][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t kf[4], vf[4];
      load_a<kLdR>(kf, sK, key0, kk * 16, g, t);
      load_a<kLdR>(vf, sV, key0, kk * 16, g, t);
#pragma unroll
      for (int j = 0; j < kBwdRows / 8; ++j) {
        const __nv_bfloat16* qb = sQ + (j * 8 + g) * kLdR + kk * 16 + 2 * t;
        const __nv_bfloat16* ob = sdO + (j * 8 + g) * kLdR + kk * 16 + 2 * t;
        mma_16816(st[j], kf, lds32(qb), lds32(qb + 8));
        mma_16816(dpt[j], vf, lds32(ob), lds32(ob + 8));
      }
    }

    // P^T = exp(S^T - lse[q]) (0 on pad keys and padded rows),
    // dS^T = P^T (dP^T - delta[q]) scale; columns are q rows here
#pragma unroll
    for (int j = 0; j < kBwdRows / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t + (e & 1);
        const int key = e < 2 ? key_lo : key_hi;
        const float p = key < sk ? exp2f(st[j][e] * scale_log2 - sLse[col]) : 0.f;
        st[j][e] = p;
        dpt[j][e] = p * (dpt[j][e] - sDelta[col]) * scale;
      }
    }

    // dV += P^T dO and dK += dS^T Q over the tile's 32 rows
#pragma unroll
    for (int kk = 0; kk < kBwdRows / 16; ++kk) {
      uint32_t pf[4], dsf[4];
      pf[0] = pack_bf16x2(st[2 * kk][0], st[2 * kk][1]);
      pf[1] = pack_bf16x2(st[2 * kk][2], st[2 * kk][3]);
      pf[2] = pack_bf16x2(st[2 * kk + 1][0], st[2 * kk + 1][1]);
      pf[3] = pack_bf16x2(st[2 * kk + 1][2], st[2 * kk + 1][3]);
      dsf[0] = pack_bf16x2(dpt[2 * kk][0], dpt[2 * kk][1]);
      dsf[1] = pack_bf16x2(dpt[2 * kk][2], dpt[2 * kk][3]);
      dsf[2] = pack_bf16x2(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]);
      dsf[3] = pack_bf16x2(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const __nv_bfloat16* ob = sdOt + (n * 8 + g) * kLdT + kk * 16 + 2 * t;
        const __nv_bfloat16* qb = sQt + (n * 8 + g) * kLdT + kk * 16 + 2 * t;
        mma_16816(dv_acc[n], pf, lds32(ob), lds32(ob + 8));
        mma_16816(dk_acc[n], dsf, lds32(qb), lds32(qb + 8));
      }
    }

    // dS -> shared as [q][key], rounded to bf16 as for the products above
#pragma unroll
    for (int j = 0; j < kBwdRows / 8; ++j) {
      const int col = j * 8 + 2 * t;
      sdS[col * kLdK + key_lo] = __float2bfloat16(dpt[j][0]);
      sdS[(col + 1) * kLdK + key_lo] = __float2bfloat16(dpt[j][1]);
      sdS[col * kLdK + key_hi] = __float2bfloat16(dpt[j][2]);
      sdS[(col + 1) * kLdK + key_hi] = __float2bfloat16(dpt[j][3]);
    }
    __syncthreads();

    // dQ = dS K for the tile: items of (16-row group, 32-column chunk)
    constexpr int kItems = (kBwdRows / 16) * (D / 32);
    for (int item = warp; item < kItems; item += kWarps) {
      const int r0 = (item % (kBwdRows / 16)) * 16;
      const int c0 = (item / (kBwdRows / 16)) * 32;
      float acc[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < SKP / 16; ++kk) {
        uint32_t af[4];
        load_a<kLdK>(af, sdS, r0, kk * 16, g, t);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const __nv_bfloat16* kb = sKt + (c0 + n * 8 + g) * kLdK + kk * 16 + 2 * t;
          mma_16816(acc[n], af, lds32(kb), lds32(kb + 8));
        }
      }
      const int row_lo = q0 + r0 + g;
      const int row_hi = row_lo + 8;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int c = c0 + n * 8 + 2 * t;
        if (row_lo < sq) {
          *reinterpret_cast<uint32_t*>(dqh + (long long)row_lo * dq_ss + c) =
              pack_bf16x2(acc[n][0], acc[n][1]);
        }
        if (row_hi < sq) {
          *reinterpret_cast<uint32_t*>(dqh + (long long)row_hi * dq_ss + c) =
              pack_bf16x2(acc[n][2], acc[n][3]);
        }
      }
    }
  }

  // this block's partial dK and dV: (splits, B*H, SKP, D) fp32
  const long long part = ((long long)split * gridDim.x + bh) * SKP;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + 2 * t;
    *reinterpret_cast<float2*>(dk_part + (part + key_lo) * D + c) =
        make_float2(dk_acc[n][0], dk_acc[n][1]);
    *reinterpret_cast<float2*>(dk_part + (part + key_hi) * D + c) =
        make_float2(dk_acc[n][2], dk_acc[n][3]);
    *reinterpret_cast<float2*>(dv_part + (part + key_lo) * D + c) =
        make_float2(dv_acc[n][0], dv_acc[n][1]);
    *reinterpret_cast<float2*>(dv_part + (part + key_hi) * D + c) =
        make_float2(dv_acc[n][2], dv_acc[n][3]);
  }
}

// dk[b, h, key, :] = bf16(sum over splits of the partials), in split order,
// for keys below sk; likewise dv.
__global__ void shortk_bwd_reduce_kernel(const float* __restrict__ dk_part,
                                         const float* __restrict__ dv_part,
                                         __nv_bfloat16* __restrict__ dk,
                                         __nv_bfloat16* __restrict__ dv, int splits, int bh_count,
                                         int skp, int sk, int d, int num_heads, long long dk_sb,
                                         long long dk_sh, long long dk_ss, long long dv_sb,
                                         long long dv_sh, long long dv_ss) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)bh_count * sk * d) return;
  const int c = (int)(i % d);
  const int key = (int)((i / d) % sk);
  const int bh = (int)(i / ((long long)d * sk));
  float sum_k = 0.f, sum_v = 0.f;
  for (int s = 0; s < splits; ++s) {
    const long long off = (((long long)s * bh_count + bh) * skp + key) * d + c;
    sum_k += dk_part[off];
    sum_v += dv_part[off];
  }
  const int b = bh / num_heads;
  const int h = bh % num_heads;
  dk[b * dk_sb + h * dk_sh + key * dk_ss + c] = __float2bfloat16(sum_k);
  dv[b * dv_sb + h * dv_sh + key * dv_ss + c] = __float2bfloat16(sum_v);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                              cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
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

template <int D, int SKP>
int launch_bwd(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
               const __nv_bfloat16* dout, const float* lse, const float* delta,
               __nv_bfloat16* dq, float* dk_part, float* dv_part, int batch, int sq, int sk,
               int num_heads, int splits, const long long* st, float scale,
               cudaStream_t stream) {
  constexpr int kBytes = bwd_smem_bytes<D, SKP>();
  const cudaError_t err = allow_smem(shortk_bwd_kernel<D, SKP>, kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(batch * num_heads, splits);
  shortk_bwd_kernel<D, SKP><<<grid, SKP / 16 * 32, kBytes, stream>>>(
      q, k, v, dout, lse, delta, dq, dk_part, dv_part, sq, sk, num_heads, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], st[12], st[13], st[14],
      scale);
  return static_cast<int>(cudaGetLastError());
}

// The backward's switch over (D, SKP): F is launch_bwd.
#define SHORTK_DISPATCH(F, ...)                              \
  switch (head_dim * 1000 + skp) {                           \
    case 64032: return F<64, 32>(__VA_ARGS__);               \
    case 64064: return F<64, 64>(__VA_ARGS__);               \
    case 64096: return F<64, 96>(__VA_ARGS__);               \
    case 64128: return F<64, 128>(__VA_ARGS__);              \
    case 64160: return F<64, 160>(__VA_ARGS__);              \
    case 64192: return F<64, 192>(__VA_ARGS__);              \
    case 128032: return F<128, 32>(__VA_ARGS__);             \
    case 128064: return F<128, 64>(__VA_ARGS__);             \
    case 128096: return F<128, 96>(__VA_ARGS__);             \
    case 128128: return F<128, 128>(__VA_ARGS__);            \
    case 128160: return F<128, 160>(__VA_ARGS__);            \
    case 128192: return F<128, 192>(__VA_ARGS__);            \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }

}  // namespace

// C entries, bound with ctypes. Strides are in elements, (batch, head, row)
// for each bf16 tensor; the last axis is contiguous, every stride is a
// multiple of 8 elements and every base 16-byte aligned (the wrapper checks
// all three). k and v have q's head count; skp is sk rounded up to a
// multiple of 32 (32 to 192). lse and delta are contiguous fp32 (B, H, Sq);
// lse may be null in the forward. Each launches on `stream` and returns
// the first error: of the tensor maps' encoding, of the shared-memory
// attribute, or cudaGetLastError() after the launch.

// The forward: `blocks` persistent blocks (1 to B * H * ceil(Sq / 64)) walk
// the work items in order, a contiguous run each; scale > 0.
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

// The backward: the main kernel writes dq and the fp32 partials dk_part and
// dv_part (splits, B*H, skp, head_dim), then the reduction writes dk and dv.
extern "C" int flash_attention_shortk_bwd(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, void* dq, void* dk, void* dv, void* dk_part, void* dv_part, int batch,
    int sq, int sk, int skp, int num_heads, int head_dim, int splits, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, long long do_sb, long long do_sh,
    long long do_ss, long long dq_sb, long long dq_sh, long long dq_ss, long long dk_sb,
    long long dk_sh, long long dk_ss, long long dv_sb, long long dv_sh, long long dv_ss,
    float scale, void* stream) {
  if (sk < 1 || sk > skp || splits < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long st[15] = {q_sb,  q_sh,  q_ss,  k_sb,  k_sh,  k_ss,  v_sb, v_sh,
                            v_ss,  do_sb, do_sh, do_ss, dq_sb, dq_sh, dq_ss};
  const int err = [&]() -> int {
    SHORTK_DISPATCH(launch_bwd, static_cast<const __nv_bfloat16*>(q),
                    static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v),
                    static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse),
                    static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dq),
                    static_cast<float*>(dk_part), static_cast<float*>(dv_part), batch, sq, sk,
                    num_heads, splits, st, scale, s)
  }();
  if (err != 0) return err;
  const long long total = (long long)batch * num_heads * sk * head_dim;
  const int threads = 256;
  shortk_bwd_reduce_kernel<<<(unsigned)((total + threads - 1) / threads), threads, 0, s>>>(
      static_cast<const float*>(dk_part), static_cast<const float*>(dv_part),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), splits,
      batch * num_heads, skp, sk, head_dim, num_heads, dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss);
  return static_cast<int>(cudaGetLastError());
}
