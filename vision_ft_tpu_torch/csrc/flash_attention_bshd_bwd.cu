// BSHD flash attention backward for Hopper (sm_90a), CUDA C++: kernel C, a
// dk/dv kernel and a dq kernel, both TMA + wgmma.
//
// Replaces vision_ft_tpu/ops/pallas/flash_attention.py::_bwd_dkvq_kernel_bshd
// and ::_bwd_dq_kernel_bshd (launched by _flash_bwd_bshd, the backward of
// flash_attention_bshd).
//
// Computes, per batch b and head h, from q, k, v, dO (bf16, heads-packed
// (B, S, H*D), rows and batches at any 16-byte strides), lse (the forward's
// natural log-sum-exp of the scaled scores) and delta = rowsum(dO * O)
// (both fp32, (B, H, Sq)):
//     P  = exp(Q K^T * scale - lse)                  (recomputed, fp32)
//     dV = bf16(P)^T dO
//     dP = dO V^T
//     dS = bf16(P * (dP - delta) * scale)
//     dK = dS^T Q,   dQ = dS K
// with fp32 accumulators, each output written once as bf16.
//
// What bounds it on an H100: the tensor cores. The TPU kernel's grid walks
// in order and carries dq across steps; blocks on a GPU share nothing, so
// the work is two kernels that each own their outputs outright (no atomics,
// reruns bit-identical), and S and dP are computed in both: 8 B S^2 H D
// operations for dk/dv (S^T, dP^T, dV, dK) and 6 B S^2 H D for dq (S, dP,
// dQ). At (B, S, H*D) = (4, 4096, 640) that is 0.3474 + 0.2606 ms at 989
// TFLOP/s; the bytes (each tensor read once, each gradient written once, 13
// MB a tensor) take 0.03 ms. P and dS never leave the registers.
//
// Design: the warp-specialized pattern of hopper_gemm.cuh. A block of 384
// threads: consumer warpgroups 0 and 1 issue wgmma, one warp of warpgroup 2
// produces with TMA; setmaxnreg moves registers to the consumers.
//   - dk/dv kernel: one block per (128-key tile, head, batch); each consumer
//     warpgroup owns 64 keys. The producer loads the K and V tiles once and
//     streams a ring of Cfg<D>::kStages stages, each a 64-row Q tile, the same
//     rows of dO and those rows' lse (times log2 e) and delta. Per stage a
//     warpgroup computes the TRANSPOSED tiles S^T = K Q^T and dP^T = V dO^T
//     (wgmma m64n64k16, both operands K-major in D), P^T = exp2(S^T scale
//     log2 e - lse) with lse per column, dS^T = P^T (dP^T - delta) scale;
//     then dV += bf16(P^T) dO and dK += bf16(dS^T) Q take A from registers
//     (the accumulators rounded in place into A fragments) and read the same
//     dO and Q tiles MN-major through the transpose bit. Each Q and dO tile
//     lands in shared memory once, by TMA. The dK and dV accumulators (64 x
//     D fp32 per warpgroup) stay in registers to the end.
//   - dq kernel: one block per (128-row q tile, head, batch); each consumer
//     warpgroup owns 64 rows. Q and dO are loaded once, lse and delta sit in
//     registers, and the ring streams 64-key K and V tiles: S = Q K^T, dP =
//     dO V^T (K-major), dQ += bf16(dS) K (A from registers, K read MN-major).
//   - Per stage a warpgroup issues S, then dP, and computes P while dP is in
//     flight; the two warpgroups' wgmma and exp2 interleave on the SM. The
//     dk/dv producer loads each stage's lse and delta one stage ahead.
//     (Keeping a stage's accumulating products in flight while the next
//     stage's S and dP are issued made ptxas serialize the wgmma: slower.)
//   - Ragged lengths: 3-D tensor maps (H*D, S, B) over each tensor, so a
//     tile that overhangs a batch's last row reads zeros, never the next
//     batch's rows. q rows past sq get lse = +inf (P = 0); keys past sk in
//     the dq kernel's last tile get P = 0; in the dk/dv kernel they only
//     reach their own dk/dv rows, which are never stored. Stores are plain
//     bf16 pair stores guarded by the row count.
//   - D = 128 is two 64-column boxes a row (128-byte swizzle holds 64 bf16):
//     the K-major descriptors step to the second box after 4 K steps, and
//     the MN-major ones span both boxes through their leading byte offset.
//   - exp runs as ex2.approx with log2(e) folded into the scale and into lse.
//   - D = 256 (AuraFlow's 12 heads of 256): a consumer thread can hold a
//     64 x 128 fp32 accumulator (64 registers) beside S and dP, not 64 x 256
//     (128 registers): a 384-thread block is compiled for 168 registers a
//     thread whatever setmaxnreg asks. And 128 resident rows of two tensors
//     (128 KB) beside a ring of 64-row tiles of two (64 KB a stage) pass the
//     227 KB a block may have. So at D = 256 a block owns 64 rows (Cfg<256>),
//     its ring has 2 stages (198,696 bytes in all), and the two consumer
//     warpgroups split D's output columns instead of the rows:
//       dk/dv: one block per (64-key tile, half of D's columns, head,
//       batch); warpgroup 0 computes S^T and dP^T over all of D and makes
//       dK's half (dK += dS^T Q[:, half]), warpgroup 1 computes S^T and
//       makes dV's half (dV += P^T dO[:, half]). Each accumulator is 64 x
//       128. S^T is made in both warpgroups and in both halves' blocks,
//       dP^T in both halves' blocks: 8 B S^2 H D of products become 16.
//       dq: one block per (64-row q tile, head, batch); warpgroup w makes
//       dQ's columns [128 w, 128 w + 128) and computes S and dP over all of
//       D for the same 64 rows: 6 B S^2 H D become 10.
//     Simple and right first; the products done twice are what a faster
//     schedule would take away (P^T and dS^T shared through shared memory).
// Left for later work: persistent blocks, TMA stores of the gradients; at
// D = 128 the dk/dv consumers need more than the 168 registers a thread of
// a 384-thread block is compiled for (two 64 x 128 accumulators; ptxas does
// not grow them for setmaxnreg), so ptxas spills there and serializes the
// wgmma (kernel G's D > 64 path shows one way round it; D = 256's column
// split is another).
//
// hopper_wgmma_forms_probe (a test entry, on no model path) holds each
// wgmma form this file takes from hopper_gemm.cuh to one 64 x N product.

#include "hopper_gemm.cuh"

#include <math.h>

namespace {

using namespace hopper;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kStepRows = 64;     // q rows (dk/dv) or keys (dq) of a streamed tile
constexpr int kBoxBytes = 64 * 128;  // 64 rows of one 64-column box
constexpr int kProducerThread = 256;  // lane 0 of the producer warp

// Per head dim: the keys (dk/dv) or q rows (dq) a block owns, the ring's
// stages, and the parts D's output columns are split into (1: each
// consumer warpgroup owns 64 of the block's rows and all of D; 2: both
// warpgroups work on all the block's rows, the dk/dv blocks on one half of
// D each, see the head of the file).
template <int D>
struct Cfg {
  static constexpr int kRows = 128, kStages = 3, kSplit = 1;
};
template <>
struct Cfg<256> {
  static constexpr int kRows = 64, kStages = 2, kSplit = 2;
};

// Shared memory of both kernels: two resident tensors of kRows rows x D (K
// and V, or Q and dO), each D / 64 boxes of kRows rows; the ring, a stage
// holding two tensors of 64 rows x D (Q and dO, or K and V), each D / 64
// boxes of 64 rows; per stage 64 lse and 64 delta values (dk/dv kernel); the
// barriers.
template <int D>
struct Smem {
  static constexpr int kRows = Cfg<D>::kRows;
  static constexpr int kStages = Cfg<D>::kStages;
  static constexpr int kBoxes = D / 64;
  static constexpr int kResidentBytes = kRows * D * 2;
  static constexpr int kStreamBytes = kStepRows * D * 2;
  static constexpr int kStageBytes = 2 * kStreamBytes;
  static constexpr int kBytes = 1024 + 2 * kResidentBytes + kStages * kStageBytes +
                                kStages * 2 * kStepRows * 4 + (2 * kStages + 1) * 8;
  static_assert(kBytes <= 232448, "more shared memory than a block may have");
  uint8_t* resident[2];
  uint8_t* ring;
  float* stats;
  uint64_t* full;
  uint64_t* empty;
  uint64_t* loaded;  // the resident tensors
  __device__ __forceinline__ explicit Smem(uint8_t* raw) {
    resident[0] = align_1024(raw);
    resident[1] = resident[0] + kResidentBytes;
    ring = resident[1] + kResidentBytes;
    stats = reinterpret_cast<float*>(ring + kStages * kStageBytes);
    full = reinterpret_cast<uint64_t*>(stats + kStages * 2 * kStepRows);
    empty = full + kStages;
    loaded = empty + kStages;
  }
  __device__ __forceinline__ uint8_t* stage(int s) const { return ring + s * kStageBytes; }
};

// Thread 0: full[s] takes `full_arrivals` arrivals plus the stage's bytes,
// empty[s] one arrival per consumer warp, `loaded` one plus the bytes.
template <int D>
__device__ __forceinline__ void init_barriers(const Smem<D>& sm, uint32_t full_arrivals) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < Smem<D>::kStages; ++s) {
      mbar_init(&sm.full[s], full_arrivals);
      mbar_init(&sm.empty[s], kConsumerWarps);
    }
    mbar_init(sm.loaded, 1);
    fence_barrier_init();
  }
}

// Producer lane 0: the rows [row0, row0 + kRows) of head h, batch b of two
// tensors into the resident buffers.
template <int D>
__device__ __forceinline__ void load_resident(const Smem<D>& sm, const CUtensorMap* map0,
                                              const CUtensorMap* map1, int row0, int h, int b) {
  mbar_arrive_expect_tx(sm.loaded, 2 * Smem<D>::kResidentBytes);
#pragma unroll
  for (int box = 0; box < Smem<D>::kBoxes; ++box) {
    const int offset = box * Smem<D>::kRows * 128;
    tma_load_3d(sm.resident[0] + offset, map0, sm.loaded, h * D + 64 * box, row0, b);
    tma_load_3d(sm.resident[1] + offset, map1, sm.loaded, h * D + 64 * box, row0, b);
  }
}

// Producer lane 0: rows [row0, row0 + 64) of head h, batch b of two tensors
// into stage s, completing full[s]; arrives on full[s] with the bytes.
template <int D>
__device__ __forceinline__ void load_stage(const Smem<D>& sm, int s, const CUtensorMap* map0,
                                           const CUtensorMap* map1, int row0, int h, int b) {
  uint8_t* dst = sm.stage(s);
  mbar_arrive_expect_tx(&sm.full[s], Smem<D>::kStageBytes);
#pragma unroll
  for (int box = 0; box < Smem<D>::kBoxes; ++box) {
    tma_load_3d(dst + box * kBoxBytes, map0, &sm.full[s], h * D + 64 * box, row0, b);
    tma_load_3d(dst + Smem<D>::kStreamBytes + box * kBoxBytes, map1, &sm.full[s],
                h * D + 64 * box, row0, b);
  }
}

// Producer lane: lse and delta of rows `row` and `row + 32` into v (lse,
// lse, delta, delta); +inf and 0 past sq.
__device__ __forceinline__ void load_stats(float (&v)[4], const float* lse_h,
                                           const float* delta_h, int row, int sq) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    v[i] = INFINITY;
    v[2 + i] = 0.f;
    if (row + 32 * i < sq) {
      v[i] = lse_h[row + 32 * i];
      v[2 + i] = delta_h[row + 32 * i];
    }
  }
}

// x (64 x 64, fp32) = A B^T over D for this warpgroup's 64 resident rows (A)
// and a streamed 64-row tile (B), both K-major; committed as one group.
template <int D>
__device__ __forceinline__ void scores(float (&x)[32], uint64_t desc_a, uint64_t desc_b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wgmma_m64n64k16(x, desc_a + k_major_step<Smem<D>::kRows>(kk),
                    desc_b + k_major_step<kStepRows>(kk), kk > 0);
  }
  wgmma_commit();
}

// P^T = exp2(S^T scale log2 e - lse log2 e) of a dk/dv stage: the columns
// are q rows, lse per column (cols 8j + 2 (lane % 4) + {0, 1}); +inf past
// sq, so P^T = 0 there.
__device__ __forceinline__ void transposed_p(float (&p)[32], const float (&s)[32],
                                             const float* stats, int lane, float scale_log2) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 l = *reinterpret_cast<const float2*>(stats + 8 * j + 2 * (lane % 4));
    p[4 * j] = ex2_approx(fmaf(s[4 * j], scale_log2, -l.x));
    p[4 * j + 1] = ex2_approx(fmaf(s[4 * j + 1], scale_log2, -l.y));
    p[4 * j + 2] = ex2_approx(fmaf(s[4 * j + 2], scale_log2, -l.x));
    p[4 * j + 3] = ex2_approx(fmaf(s[4 * j + 3], scale_log2, -l.y));
  }
}

// dS^T = P^T (dP^T - delta) scale of a dk/dv stage, delta per column.
__device__ __forceinline__ void transposed_ds(float (&ds)[32], const float (&p)[32],
                                              const float (&dp)[32], const float* stats,
                                              int lane, float scale) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 dl = *reinterpret_cast<const float2*>(stats + kStepRows + 8 * j + 2 * (lane % 4));
    ds[4 * j] = p[4 * j] * (dp[4 * j] - dl.x) * scale;
    ds[4 * j + 1] = p[4 * j + 1] * (dp[4 * j + 1] - dl.y) * scale;
    ds[4 * j + 2] = p[4 * j + 2] * (dp[4 * j + 2] - dl.x) * scale;
    ds[4 * j + 3] = p[4 * j + 3] * (dp[4 * j + 3] - dl.y) * scale;
  }
}

// The dk/dv producer warp: K and V rows [k0, k0 + kRows) once, then every
// 64-row Q and dO tile of the head into the ring, each stage's lse (times
// log2 e) and delta written by the warp's 32 lanes one stage ahead, so that
// their latency passes while the producer waits for a free stage.
template <int D>
__device__ __forceinline__ void produce_dkv(const Smem<D>& sm, const CUtensorMap* map_q,
                                            const CUtensorMap* map_k, const CUtensorMap* map_v,
                                            const CUtensorMap* map_do, const float* lse,
                                            const float* delta, int sq, int num_heads, int k0,
                                            int h, int b) {
  const int lane = threadIdx.x - kProducerThread;
  const int num_qt = (sq + kStepRows - 1) / kStepRows;
  const float* lse_h = lse + ((long long)b * num_heads + h) * sq;
  const float* delta_h = delta + ((long long)b * num_heads + h) * sq;
  if (lane == 0) load_resident(sm, map_k, map_v, k0, h, b);
  float next[4];
  load_stats(next, lse_h, delta_h, lane, sq);
  int stage = 0;
  uint32_t phase = 0;
  for (int qt = 0; qt < num_qt; ++qt) {
    mbar_wait(&sm.empty[stage], phase ^ 1u);
    float* stats = sm.stats + stage * 2 * kStepRows;
    stats[lane] = next[0] * kLog2e;  // +inf past sq: P = 0 there
    stats[lane + 32] = next[1] * kLog2e;
    stats[kStepRows + lane] = next[2];
    stats[kStepRows + lane + 32] = next[3];
    if (qt + 1 < num_qt) load_stats(next, lse_h, delta_h, (qt + 1) * kStepRows + lane, sq);
    if (lane == 0) {
      load_stage(sm, stage, map_q, map_do, qt * kStepRows, h, b);
    } else {
      mbar_arrive(&sm.full[stage]);
    }
    if (++stage == Smem<D>::kStages) {
      stage = 0;
      phase ^= 1u;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_bshd_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          const __grid_constant__ CUtensorMap map_do,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int sq,
                          int sk, int num_heads, long long dk_sb, long long dk_ss,
                          long long dv_sb, long long dv_ss, float scale) {
  extern __shared__ uint8_t smem_raw[];
  const Smem<D> sm(smem_raw);
  static_assert(Cfg<D>::kSplit == 1, "D = 256 has a dk/dv kernel of its own");
  const int k0 = blockIdx.x * Smem<D>::kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int num_qt = (sq + kStepRows - 1) / kStepRows;

  init_barriers(sm, 32);  // the producer warp's 32 lanes write a stage's lse and delta
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    setmaxnreg_dec<40>();
    if (threadIdx.x < kProducerThread + 32) {
      produce_dkv(sm, &map_q, &map_k, &map_v, &map_do, lse, delta, sq, num_heads, k0, h, b);
    }
  } else {
    setmaxnreg_inc<232>();
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const float scale_log2 = scale * kLog2e;
    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    // this warpgroup's 64 keys of the resident K and V
    const uint64_t desc_k = desc_sw128(sm.resident[0] + wg * kBoxBytes);
    const uint64_t desc_v = desc_sw128(sm.resident[1] + wg * kBoxBytes);
    mbar_wait(sm.loaded, 0);

    int stage = 0;
    uint32_t phase = 0;
    for (int qt = 0; qt < num_qt; ++qt) {
      mbar_wait(&sm.full[stage], phase);
      const uint8_t* tile_q = sm.stage(stage);
      const uint8_t* tile_do = tile_q + Smem<D>::kStreamBytes;
      const float* stats = sm.stats + stage * 2 * kStepRows;

      float s[32], dp[32], p[32], ds[32];
      wgmma_fence();
      scores<D>(s, desc_k, desc_sw128(tile_q));   // S^T = K Q^T
      scores<D>(dp, desc_v, desc_sw128(tile_do));  // dP^T = V dO^T
      wgmma_wait<1>();  // S^T
      fence_operands(s);
      transposed_p(p, s, stats, lane, scale_log2);
      wgmma_wait<0>();
      fence_operands(dp);
      transposed_ds(ds, p, dp, stats, lane, scale);
      uint32_t p_frag[4][4], ds_frag[4][4];
      acc_to_a_fragments<64>(p_frag, p);
      acc_to_a_fragments<64>(ds_frag, ds);

      wgmma_fence();
      mma_rs_mn<D, 4>(dv_acc, p_frag, tile_do, kBoxBytes);  // dV += P^T dO
      mma_rs_mn<D, 4>(dk_acc, ds_frag, tile_q, kBoxBytes);  // dK += dS^T Q
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(dv_acc);
      fence_operands(dk_acc);
      if (lane == 0) mbar_arrive(&sm.empty[stage]);
      if (++stage == Smem<D>::kStages) {
        stage = 0;
        phase ^= 1u;
      }
    }

    const int key = k0 + 64 * wg + 16 * (t / 32) + lane / 4;
    const int col = h * D + 2 * (lane % 4);
    store_acc_rows<D>(dk + b * dk_sb + col, dk_ss, dk_acc, key, sk);
    store_acc_rows<D>(dv + b * dv_sb + col, dv_ss, dv_acc, key, sk);
  }
}

// D = 256: one block per (64-key tile, half of D's output columns, head,
// batch), blockIdx.x = 2 * tile + half. Warpgroup 0 makes dK's half: S^T
// and dP^T over all of D, then dK += bf16(dS^T) Q[:, half]; warpgroup 1
// makes dV's half: S^T, then dV += bf16(P^T) dO[:, half]. Each holds one
// 64 x 128 fp32 accumulator; the producer is the generic kernel's.
template <bool DK>
__device__ __forceinline__ void consume_dkv256(const Smem<256>& sm, __nv_bfloat16* out,
                                               long long out_ss, int sq, int sk, int k0, int half,
                                               int h, float scale) {
  constexpr int D = 256;
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int num_qt = (sq + kStepRows - 1) / kStepRows;
  const float scale_log2 = scale * kLog2e;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  const uint64_t desc_k = desc_sw128(sm.resident[0]);
  const uint64_t desc_v = desc_sw128(sm.resident[1]);
  mbar_wait(sm.loaded, 0);

  int stage = 0;
  uint32_t phase = 0;
  for (int qt = 0; qt < num_qt; ++qt) {
    mbar_wait(&sm.full[stage], phase);
    const uint8_t* tile_q = sm.stage(stage);
    const uint8_t* tile_do = tile_q + Smem<D>::kStreamBytes;
    const float* stats = sm.stats + stage * 2 * kStepRows;

    float s[32], p[32];
    uint32_t frag[4][4];
    wgmma_fence();
    scores<D>(s, desc_k, desc_sw128(tile_q));  // S^T = K Q^T
    if constexpr (DK) {
      float dp[32], ds[32];
      scores<D>(dp, desc_v, desc_sw128(tile_do));  // dP^T = V dO^T
      wgmma_wait<1>();
      fence_operands(s);
      transposed_p(p, s, stats, lane, scale_log2);
      wgmma_wait<0>();
      fence_operands(dp);
      transposed_ds(ds, p, dp, stats, lane, scale);
      acc_to_a_fragments<64>(frag, ds);
    } else {
      wgmma_wait<0>();
      fence_operands(s);
      transposed_p(p, s, stats, lane, scale_log2);
      acc_to_a_fragments<64>(frag, p);
    }
    // dK += dS^T Q[:, half] or dV += P^T dO[:, half]: two of the tile's four boxes
    wgmma_fence();
    mma_rs_mn<128, 4>(acc, frag, (DK ? tile_q : tile_do) + half * 2 * kBoxBytes, kBoxBytes);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(acc);
    if (lane == 0) mbar_arrive(&sm.empty[stage]);
    if (++stage == Smem<D>::kStages) {
      stage = 0;
      phase ^= 1u;
    }
  }
  const int key = k0 + 16 * (t / 32) + lane / 4;
  store_acc_rows<128>(out + h * D + 128 * half + 2 * (lane % 4), out_ss, acc, key, sk);
}

__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_bshd_d256_kernel(const __grid_constant__ CUtensorMap map_q,
                               const __grid_constant__ CUtensorMap map_k,
                               const __grid_constant__ CUtensorMap map_v,
                               const __grid_constant__ CUtensorMap map_do,
                               const float* __restrict__ lse, const float* __restrict__ delta,
                               __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                               int sq, int sk, int num_heads, long long dk_sb, long long dk_ss,
                               long long dv_sb, long long dv_ss, float scale) {
  extern __shared__ uint8_t smem_raw[];
  const Smem<256> sm(smem_raw);
  const int k0 = (blockIdx.x >> 1) * Smem<256>::kRows;
  const int half = blockIdx.x & 1;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  init_barriers(sm, 32);
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    setmaxnreg_dec<40>();
    if (threadIdx.x < kProducerThread + 32) {
      produce_dkv(sm, &map_q, &map_k, &map_v, &map_do, lse, delta, sq, num_heads, k0, h, b);
    }
  } else {
    setmaxnreg_inc<232>();
    if (wg == 0) {
      consume_dkv256<true>(sm, dk + b * dk_sb, dk_ss, sq, sk, k0, half, h, scale);
    } else {
      consume_dkv256<false>(sm, dv + b * dv_sb, dv_ss, sq, sk, k0, half, h, scale);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_bshd_kernel(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v,
                         const __grid_constant__ CUtensorMap map_do,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dq, int sq, int sk, int num_heads,
                         long long dq_sb, long long dq_ss, float scale) {
  extern __shared__ uint8_t smem_raw[];
  const Smem<D> sm(smem_raw);
  // kSplit 1: warpgroup wg owns q rows [64 wg, 64 wg + 64) of the block
  // and all of dQ's D columns; kSplit 2 (D = 256): both own the block's 64
  // rows, warpgroup wg dQ's columns [128 wg, 128 wg + 128)
  constexpr int kSplit = Cfg<D>::kSplit;
  constexpr int DN = D / kSplit;
  const int q0 = blockIdx.x * Smem<D>::kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int num_kt = (sk + kStepRows - 1) / kStepRows;

  init_barriers(sm, 1);
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == kProducerThread) {
      load_resident(sm, &map_q, &map_do, q0, h, b);
      int stage = 0;
      uint32_t phase = 0;
      for (int kt = 0; kt < num_kt; ++kt) {
        mbar_wait(&sm.empty[stage], phase ^ 1u);
        load_stage(sm, stage, &map_k, &map_v, kt * kStepRows, h, b);
        if (++stage == Smem<D>::kStages) {
          stage = 0;
          phase ^= 1u;
        }
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const float scale_log2 = scale * kLog2e;
    // this thread's q rows: row and row + 8; P = 0 past sq (lse = +inf)
    const int row_wg = kSplit == 1 ? 64 * wg : 0;
    const int col_wg = kSplit == 1 ? 0 : DN * wg;
    const int row = q0 + row_wg + 16 * (t / 32) + lane / 4;
    const float* lse_h = lse + ((long long)b * num_heads + h) * sq;
    const float* delta_h = delta + ((long long)b * num_heads + h) * sq;
    const float lse_lo = row < sq ? lse_h[row] * kLog2e : INFINITY;
    const float lse_hi = row + 8 < sq ? lse_h[row + 8] * kLog2e : INFINITY;
    const float delta_lo = row < sq ? delta_h[row] : 0.f;
    const float delta_hi = row + 8 < sq ? delta_h[row + 8] : 0.f;
    float dq_acc[DN / 2];
#pragma unroll
    for (int i = 0; i < DN / 2; ++i) dq_acc[i] = 0.f;
    const uint64_t desc_q = desc_sw128(sm.resident[0] + row_wg * 128);
    const uint64_t desc_do = desc_sw128(sm.resident[1] + row_wg * 128);
    mbar_wait(sm.loaded, 0);

    int stage = 0;
    uint32_t phase = 0;
    for (int kt = 0; kt < num_kt; ++kt) {
      mbar_wait(&sm.full[stage], phase);
      const uint8_t* tile_k = sm.stage(stage);
      const uint8_t* tile_v = tile_k + Smem<D>::kStreamBytes;

      float s[32], dp[32], p[32], ds[32];
      wgmma_fence();
      scores<D>(s, desc_q, desc_sw128(tile_k));   // S = Q K^T
      scores<D>(dp, desc_do, desc_sw128(tile_v));  // dP = dO V^T
      wgmma_wait<1>();  // S
      fence_operands(s);
      const int k0 = kt * kStepRows;
      const bool ragged = k0 + kStepRows > sk;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = ex2_approx(fmaf(s[4 * j + e], scale_log2, e < 2 ? -lse_lo : -lse_hi));
          p[4 * j + e] = ragged && k0 + 8 * j + 2 * (lane % 4) + (e & 1) >= sk ? 0.f : x;
        }
      }
      wgmma_wait<0>();
      fence_operands(dp);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ds[4 * j + e] = p[4 * j + e] * (dp[4 * j + e] - (e < 2 ? delta_lo : delta_hi)) * scale;
        }
      }
      uint32_t ds_frag[4][4];
      acc_to_a_fragments<64>(ds_frag, ds);

      wgmma_fence();
      mma_rs_mn<DN, 4>(dq_acc, ds_frag, tile_k + col_wg / 64 * kBoxBytes, kBoxBytes);  // dQ += dS K
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(dq_acc);
      if (lane == 0) mbar_arrive(&sm.empty[stage]);
      if (++stage == Smem<D>::kStages) {
        stage = 0;
        phase ^= 1u;
      }
    }

    store_acc_rows<DN>(dq + b * dq_sb + h * D + col_wg + 2 * (lane % 4), dq_ss, dq_acc, row, sq);
  }
}

// The four tensor maps of one launch: q and dO over sq rows in boxes of
// q_box rows, k and v over sk rows in boxes of k_box rows.
struct Maps {
  CUtensorMap q, k, v, dout;
};

int make_maps(Maps* maps, const void* q, const void* k, const void* v, const void* dout,
              int batch, int sq, int sk, int cols, long long q_sb, long long q_ss,
              long long k_sb, long long k_ss, long long v_sb, long long v_ss, long long do_sb,
              long long do_ss, uint32_t q_box, uint32_t k_box) {
  int err = make_map_3d(&maps->q, q, batch, sq, cols, q_sb, q_ss, q_box);
  if (!err) err = make_map_3d(&maps->k, k, batch, sk, cols, k_sb, k_ss, k_box);
  if (!err) err = make_map_3d(&maps->v, v, batch, sk, cols, v_sb, v_ss, k_box);
  if (!err) err = make_map_3d(&maps->dout, dout, batch, sq, cols, do_sb, do_ss, q_box);
  return err;
}

template <int D>
int launch_dkv(const Maps& maps, const float* lse, const float* delta, __nv_bfloat16* dk,
               __nv_bfloat16* dv, int batch, int sq, int sk, int num_heads, long long dk_sb,
               long long dk_ss, long long dv_sb, long long dv_ss, float scale,
               cudaStream_t stream) {
  constexpr int kRows = Smem<D>::kRows;
  if constexpr (Cfg<D>::kSplit == 1) {
    const int err = allow_dynamic_smem<flash_bwd_dkv_bshd_kernel<D>>(Smem<D>::kBytes);
    if (err) return err;
    const dim3 grid((sk + kRows - 1) / kRows, num_heads, batch);
    flash_bwd_dkv_bshd_kernel<D><<<grid, kThreads, Smem<D>::kBytes, stream>>>(
        maps.q, maps.k, maps.v, maps.dout, lse, delta, dk, dv, sq, sk, num_heads, dk_sb, dk_ss,
        dv_sb, dv_ss, scale);
  } else {
    const int err = allow_dynamic_smem<flash_bwd_dkv_bshd_d256_kernel>(Smem<D>::kBytes);
    if (err) return err;
    const dim3 grid(2 * ((sk + kRows - 1) / kRows), num_heads, batch);
    flash_bwd_dkv_bshd_d256_kernel<<<grid, kThreads, Smem<D>::kBytes, stream>>>(
        maps.q, maps.k, maps.v, maps.dout, lse, delta, dk, dv, sq, sk, num_heads, dk_sb, dk_ss,
        dv_sb, dv_ss, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq(const Maps& maps, const float* lse, const float* delta, __nv_bfloat16* dq,
              int batch, int sq, int sk, int num_heads, long long dq_sb, long long dq_ss,
              float scale, cudaStream_t stream) {
  const int err = allow_dynamic_smem<flash_bwd_dq_bshd_kernel<D>>(Smem<D>::kBytes);
  if (err) return err;
  const dim3 grid((sq + Smem<D>::kRows - 1) / Smem<D>::kRows, num_heads, batch);
  flash_bwd_dq_bshd_kernel<D><<<grid, kThreads, Smem<D>::kBytes, stream>>>(
      maps.q, maps.k, maps.v, maps.dout, lse, delta, dq, sq, sk, num_heads, dq_sb, dq_ss, scale);
  return static_cast<int>(cudaGetLastError());
}

// The probe: one warpgroup, d (64 x N, fp32), by FORM:
//   kFormSS (N = 64, 80, 96, 128, 160 or 192, kernel H's and I's padded key
//     counts): a (64 x 64) and b^T (N x 64) both K-major by TMA, b^T as one
//     box of N rows, the shared-memory wgmma_ss<N> (d = a b^T);
//   kFormRS (N = 64, 96 or 128): a read from device memory into
//     accumulator layout, rounded by acc_to_a_fragments into register A
//     fragments, b (64 x N, N contiguous) loaded by TMA through a 3-D map
//     and read MN-major (wgmma_rs, trans-b; at N = 96 the second box's last
//     32 columns are TMA's zeros, as kernel G's head dim 96 has them): d = a b;
//   kFormSSMN (N as kFormSS, kernel I's dV^T and dK^T): a (64 x 64, K rows
//     x M columns) and b (64 x N) both MN-major through the transpose bits,
//     b in 64-column boxes (wgmma_ss<N, 1, 1>): d = a^T b;
//   kFormSSBMN (N = 64, kernel I's dQ): a K-major, b (64 x N) MN-major
//     (wgmma_ss<N, 0, 1>): d = a b.
constexpr int kFormSS = 0, kFormRS = 1, kFormSSMN = 2, kFormSSBMN = 3;
constexpr int kProbeBBytes = 192 * 128;  // b: up to 192 rows, or 3 boxes of 64 rows, of 128 bytes

template <int N, int FORM>
__global__ void __launch_bounds__(128)
hopper_wgmma_forms_probe_kernel(const __grid_constant__ CUtensorMap map_a,
                                const __grid_constant__ CUtensorMap map_b,
                                const __nv_bfloat16* __restrict__ a, float* __restrict__ d) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* tile_a = align_1024(smem_raw);
  uint8_t* tile_b = tile_a + kBoxBytes;
  uint64_t* bar = reinterpret_cast<uint64_t*>(tile_b + kProbeBBytes);
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    fence_barrier_init();
  }
  __syncthreads();
  constexpr bool kMnB = FORM != kFormSS;  // b (64 x N) in boxes of 64 columns
  constexpr int kBoxesB = (N + 63) / 64;
  if (threadIdx.x == 0) {
    const int a_bytes = FORM == kFormRS ? 0 : kBoxBytes;
    mbar_arrive_expect_tx(bar, a_bytes + (kMnB ? kBoxesB * kBoxBytes : N * 128));
    if (FORM != kFormRS) tma_load_3d(tile_a, &map_a, bar, 0, 0, 0);
    if (kMnB) {
      for (int box = 0; box < kBoxesB; ++box) tma_load_3d(tile_b + box * kBoxBytes, &map_b, bar, 64 * box, 0, 0);
    } else {
      tma_load_3d(tile_b, &map_b, bar, 0, 0, 0);
    }
  }
  mbar_wait(bar, 0);
  const int lane = threadIdx.x % 32;
  const int row = 16 * (threadIdx.x / 32) + lane / 4;
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  if constexpr (FORM == kFormRS) {
    float a_acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = row + 8 * ((i % 4) / 2);
      const int c = 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
      a_acc[i] = __bfloat162float(a[r * 64 + c]);
    }
    uint32_t frag[4][4];
    acc_to_a_fragments<64>(frag, a_acc);
    wgmma_fence();
    mma_rs_mn<N, 4>(acc, frag, tile_b, kBoxBytes);
  } else {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if constexpr (FORM == kFormSS) {
        wgmma_ss<N>(acc, desc_sw128(tile_a) + 2 * kk, desc_sw128(tile_b) + 2 * kk, 1);
      } else if constexpr (FORM == kFormSSMN) {
        wgmma_ss<N, 1, 1>(acc, desc_sw128_mn(tile_a, kBoxBytes) + 128 * kk,
                          desc_sw128_mn(tile_b, kBoxBytes) + 128 * kk, 1);
      } else {
        wgmma_ss<N, 0, 1>(acc, desc_sw128(tile_a) + 2 * kk,
                          desc_sw128_mn(tile_b, kBoxBytes) + 128 * kk, 1);
      }
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_operands(acc);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    d[(row + 8 * ((i % 4) / 2)) * N + 8 * (i / 4) + 2 * (lane % 4) + (i % 2)] = acc[i];
  }
}

template <int FORM>
void launch_probe(int n, const CUtensorMap& map_a, const CUtensorMap& map_b,
                  const __nv_bfloat16* a, float* d, size_t smem, cudaStream_t s) {
  switch (n) {
    case 64: hopper_wgmma_forms_probe_kernel<64, FORM><<<1, 128, smem, s>>>(map_a, map_b, a, d); break;
    case 96: hopper_wgmma_forms_probe_kernel<96, FORM><<<1, 128, smem, s>>>(map_a, map_b, a, d); break;
    case 128: hopper_wgmma_forms_probe_kernel<128, FORM><<<1, 128, smem, s>>>(map_a, map_b, a, d); break;
    default:
      if constexpr (FORM == kFormSS || FORM == kFormSSMN) {
        switch (n) {
          case 80: hopper_wgmma_forms_probe_kernel<80, FORM><<<1, 128, smem, s>>>(map_a, map_b, a, d); break;
          case 160: hopper_wgmma_forms_probe_kernel<160, FORM><<<1, 128, smem, s>>>(map_a, map_b, a, d); break;
          default: hopper_wgmma_forms_probe_kernel<192, FORM><<<1, 128, smem, s>>>(map_a, map_b, a, d); break;
        }
      }
  }
}

}  // namespace

// C entries, bound with ctypes. Strides are in elements; the last dimension
// of every bf16 tensor is contiguous and every row and batch stride and
// base is 16-byte aligned (the wrapper checks all three); lse and delta
// are contiguous fp32 (B, H, Sq). Each launches on `stream` and returns the
// first error: of the tensor maps' encoding, of the shared-memory
// attribute, or cudaGetLastError() after the launch.

extern "C" int flash_attention_bshd_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, void* dk, void* dv, int batch, int sq, int sk, int num_heads, int head_dim,
    long long q_sb, long long q_ss, long long k_sb, long long k_ss, long long v_sb, long long v_ss,
    long long do_sb, long long do_ss, long long dk_sb, long long dk_ss, long long dv_sb,
    long long dv_ss, float scale, void* stream) {
  if (head_dim != 64 && head_dim != 128 && head_dim != 256) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // K and V are the resident tensors: boxes of the block's rows
  const uint32_t rows = head_dim == 256 ? Smem<256>::kRows : Smem<64>::kRows;
  Maps maps;
  const int err = make_maps(&maps, q, k, v, dout, batch, sq, sk, num_heads * head_dim, q_sb,
                            q_ss, k_sb, k_ss, v_sb, v_ss, do_sb, do_ss, kStepRows, rows);
  if (err) return err;
  const auto* lb = static_cast<const float*>(lse);
  const auto* db = static_cast<const float*>(delta);
  auto* dkb = static_cast<__nv_bfloat16*>(dk);
  auto* dvb = static_cast<__nv_bfloat16*>(dv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) {
    return launch_dkv<64>(maps, lb, db, dkb, dvb, batch, sq, sk, num_heads, dk_sb, dk_ss, dv_sb,
                          dv_ss, scale, s);
  }
  if (head_dim == 256) {
    return launch_dkv<256>(maps, lb, db, dkb, dvb, batch, sq, sk, num_heads, dk_sb, dk_ss, dv_sb,
                           dv_ss, scale, s);
  }
  return launch_dkv<128>(maps, lb, db, dkb, dvb, batch, sq, sk, num_heads, dk_sb, dk_ss, dv_sb,
                         dv_ss, scale, s);
}

extern "C" int flash_attention_bshd_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, void* dq, int batch, int sq, int sk, int num_heads, int head_dim,
    long long q_sb, long long q_ss, long long k_sb, long long k_ss, long long v_sb, long long v_ss,
    long long do_sb, long long do_ss, long long dq_sb, long long dq_ss, float scale,
    void* stream) {
  if (head_dim != 64 && head_dim != 128 && head_dim != 256) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // Q and dO are the resident tensors: boxes of the block's rows
  const uint32_t rows = head_dim == 256 ? Smem<256>::kRows : Smem<64>::kRows;
  Maps maps;
  const int err = make_maps(&maps, q, k, v, dout, batch, sq, sk, num_heads * head_dim, q_sb,
                            q_ss, k_sb, k_ss, v_sb, v_ss, do_sb, do_ss, rows, kStepRows);
  if (err) return err;
  const auto* lb = static_cast<const float*>(lse);
  const auto* db = static_cast<const float*>(delta);
  auto* dqb = static_cast<__nv_bfloat16*>(dq);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) {
    return launch_dq<64>(maps, lb, db, dqb, batch, sq, sk, num_heads, dq_sb, dq_ss, scale, s);
  }
  if (head_dim == 256) {
    return launch_dq<256>(maps, lb, db, dqb, batch, sq, sk, num_heads, dq_sb, dq_ss, scale, s);
  }
  return launch_dq<128>(maps, lb, db, dqb, batch, sq, sk, num_heads, dq_sb, dq_ss, scale, s);
}

// The probe (a test entry): a (64, 64) and b bf16, contiguous, 16-byte
// aligned; d (64, n) fp32. form 0 (shared memory, K-major): b is (n, 64),
// n = 64, 80, 96, 128, 160 or 192, d = a b^T; form 1 (register A): b is
// (64, n), n = 64, 96 or 128, d = a b; form 2 (shared memory, both
// MN-major): b is (64, n), n as form 0, d = a^T b; form 3 (shared memory, B
// MN-major): b is (64, n), n = 64, 96 or 128, d = a b.
extern "C" int hopper_wgmma_forms_probe(const void* a, const void* b, void* d, int n, int form,
                                        void* stream) {
  const bool ss_n = n == 64 || n == 80 || n == 96 || n == 128 || n == 160 || n == 192;
  const bool rs_n = n == 64 || n == 96 || n == 128;
  if (form < kFormSS || form > kFormSSBMN ||
      !(form == kFormSS || form == kFormSSMN ? ss_n : rs_n)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap map_a, map_b;
  int err = make_map_3d(&map_a, a, 1, 64, 64, 64 * 64, 64, 64);
  if (!err) {
    err = form != kFormSS ? make_map_3d(&map_b, b, 1, 64, n, 64LL * n, n, 64)
                          : make_map_3d(&map_b, b, 1, n, 64, 64LL * n, 64, n);
  }
  if (err) return err;
  const size_t smem = 1024 + kBoxBytes + kProbeBBytes + sizeof(uint64_t);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* ab = static_cast<const __nv_bfloat16*>(a);
  auto* df = static_cast<float*>(d);
  switch (form) {
    case kFormSS: launch_probe<kFormSS>(n, map_a, map_b, ab, df, smem, s); break;
    case kFormRS: launch_probe<kFormRS>(n, map_a, map_b, ab, df, smem, s); break;
    case kFormSSMN: launch_probe<kFormSSMN>(n, map_a, map_b, ab, df, smem, s); break;
    default: launch_probe<kFormSSBMN>(n, map_a, map_b, ab, df, smem, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}
