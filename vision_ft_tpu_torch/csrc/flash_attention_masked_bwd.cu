// Key-masked flash attention backward over (B, H, S, D) for Hopper
// (sm_90a), CUDA C++: kernel G, a dk/dv kernel and a dq kernel, both
// warp-specialized TMA + wgmma on hopper_gemm.cuh.
//
// Replaces vision_ft_tpu/ops/pallas/flash_attention.py::_bwd_dq_kernel and
// ::_bwd_dkv_kernel (launched by _flash_bwd, the backward of
// flash_attention_tpu), the gradient of flash_attention_masked.cu.
//
// Computes, per batch b and query head h (kv head hk = h / repeats), from
// q, k, v, dO (bf16), lse (the forward's natural log-sum-exp, fp32
// (B, H, Sq)) and delta = rowsum(dO * O) - dlse (fp32 (B, H, Sq)):
//     S  = Q K^T * scale + maskrow [causal]          (recomputed, fp32)
//     P  = exp(S - lse)
//     dV = bf16(P)^T dO
//     dP = dO V^T
//     dS = bf16(P * (dP - delta) * scale)
//     dK = dS^T Q,   dQ = dS K
// with fp32 accumulators, each output written once as bf16. dK and dV of a
// kv head sum over the `repeats` query heads that read it, inside the
// kernel, in fp32: the TPU path repeats k and v in device memory and lets
// autograd sum the repeat's transpose.
//
// Masking, as flash_attention_masked.cu scores it: a masked key (the (B, Sk)
// byte row is 0) or a causally excluded one (key > query, Sq == Sk) scores a
// finite -1e30, so P = exp(-1e30 - lse) is 0 on a row that keeps a key and 1
// on a row that keeps none (its lse is -1e30 itself): such a row spreads its
// gradient over all its keys, as the TPU kernel does. Keys at or past sk
// get P = 0 and their dk/dv rows are never written; q rows at or past sq
// get P = 0 (lse = +inf) and their dq rows are never written.
//
// What bounds it on an H100: the tensor cores. Per score pair the dk/dv
// kernel does four D-deep products (S^T, dP^T, dV, dK), the dq kernel three
// (S, dP, dQ), against 2 bytes of each of q, k, v, dO, dq, dk, dv per row
// and head: 8*pairs*D + 6*pairs*D operations over the pairs the masks
// leave. P and dS, the S x S matrices, never leave the registers.
//
// Design: kernel C's two kernels (flash_attention_bshd_bwd.cu), each owning
// its outputs outright (no atomics: reruns are bit-identical), recomputing
// S and dP in both. A block of 384 threads: consumer warpgroups 0 and 1
// issue wgmma, one warp of warpgroup 2 produces with TMA; setmaxnreg moves
// registers to the consumers.
//   - Tensor maps: 4-D over (D, S, H, B) with the tensors' own row, head and
//     batch strides, so the NextDiT's (B, S, heads, D) memory of its fused
//     qkv projection is read in place. A box is 64 columns x 64 or 128 rows
//     of one (batch, head) matrix; past a matrix's last row TMA fills zeros.
//   - Head dim 96: two 64-column boxes a row, the second box's last 32
//     columns filled with zeros by TMA (never the next head's columns). The
//     K-major products (S, dP) take 6 K steps of 16 and never read them; the
//     MN-major products with N = D (dV, dK, dQ) are wgmma m64n96k16, whose
//     columns 64-95 come from the first half of the second box.
//   - dk/dv kernel: one block per (128-key tile, kv head, batch); each
//     consumer warpgroup owns 64 keys. The producer loads K and V once and
//     streams a ring of kRingStages stages over (query head of the group,
//     64-row q tile), each a Q tile, the same rows of dO and those rows' lse
//     (times log2 e, rounded on its own) and delta, written by the producer
//     warp's 32 lanes one stage ahead. Per stage a warpgroup computes S^T =
//     K Q^T and dP^T = V dO^T (wgmma m64n64k16, K-major), P^T with lse per
//     column and the two keys' mask bits in registers, dS^T; then dV +=
//     bf16(P^T) dO and dK += bf16(dS^T) Q with A from registers and dO, Q
//     read MN-major through the transpose bit. The dK and dV accumulators
//     persist over the whole walk of the group's query heads. At D = 96 and
//     128, S^T and dP^T in flight together beside two 64 x D accumulators
//     need more than the 168 registers a thread of a 384-thread block is
//     compiled for (ptxas compiled the same spills with setmaxnreg at 232
//     and at 240), and ptxas then serializes every wgmma: so, at every head
//     dim, S^T first, P^T kept in fp32 in shared memory (32 KB), dV += P^T
//     dO, then dP^T, dS^T and dK.
//   - dq kernel: one block per (128-row q tile, head, batch); Q and dO are
//     loaded once, lse and delta sit in registers, and the ring streams
//     64-key K and V tiles of the head's kv head with the tile's mask bits
//     (a 64-bit word the producer warp ballots): S = Q K^T, dP = dO V^T
//     (K-major), dQ += bf16(dS) K (A from registers, K read MN-major).
//   - Key tiles masked whole: where a batch entry keeps at least one key and
//     there is no causal masking, every q row keeps a key, so P = 0 exactly
//     on a masked key and a tile of masked keys adds exactly nothing. The
//     dq kernel's producer then skips such 64-key tiles (it never loads
//     them; the consumers learn each stage's tile from the ring, and a last
//     stage with no tile ends the walk); the dk/dv kernel writes zeros for a
//     128-key block masked whole without reading Q or dO. A batch entry
//     that keeps no key (P = 1 everywhere) or causal masking skips nothing.
//   - exp runs as ex2.approx with log2(e) folded into the scale (one FMA),
//     into the masked score (kMasked) and into lse (lse * log2 e rounded on
//     its own, never fused into the subtraction, so that a fully masked
//     row's exponent is exactly 0).
// Not carried over from the TPU kernel: the fused-dq variant (a grid-
// persistent fp32 dq, which needs atomics here), the 8-sublane lse/delta
// replication and the padding of q, k and v in device memory. Tried and
// dropped (verdicts in PERF.md): S^T and dP^T together (at D = 96 spills,
// every wgmma serialized; at D = 64, which no model runs, a second schedule
// for a small gain), dS^T from the bf16-rounded P^T, dV in flight
// beside dP^T, the next stage's S (dq) or S^T (dk/dv) issued behind this
// stage's last product, the dq kernel launched as a programmatic dependent
// of the dk/dv kernel (within the spread). Left for later work: skipping q
// tiles past the causal diagonal, a persistent grid (the dk/dv grid makes
// 8.24 waves at the main stack), TMA stores of the gradients; at D = 128
// the dk/dv kernel still spills and serializes (as kernel C's does).

#include "hopper_gemm.cuh"

#include <math.h>

namespace {

using namespace hopper;

constexpr float kLog2e = 1.4426950408889634f;
// -1e30 in the exp2 domain: the forward's masked score, so exp2(kMasked -
// lse * log2 e) is exactly 1 for a row whose keys are all masked
constexpr float kMasked = -1.4426950408889634e30f;
constexpr int kBlockRows = 128;      // keys (dk/dv) or q rows (dq) a block owns
constexpr int kStepRows = 64;        // q rows (dk/dv) or keys (dq) of a streamed tile
constexpr int kRingStages = 3;
constexpr int kBoxBytes = 64 * 128;  // 64 rows of one 64-column box
constexpr int kProducerThread = 256;  // lane 0 of the producer warp

// Shared memory of both kernels: two resident tensors of 128 rows (K and V,
// or Q and dO), each ceil(D / 64) boxes of 128 rows; the ring, a stage
// holding two tensors of 64 rows (Q and dO, or K and V) in boxes of 64
// rows; each dk/dv consumer thread's fp32 P^T slice (32 values,
// stored as 8 float4 columns of the 256 threads, so a warp's accesses are
// contiguous; reserved in the dq kernel too, where one block fills the SM
// either way); per stage 64 lse and 64 delta values
// (dk/dv kernel) and the tile's index and mask bits (dq kernel); the
// barriers.
template <int D>
struct Smem {
  static constexpr int kBoxes = (D + 63) / 64;
  static constexpr int kResidentBytes = kBlockRows * kBoxes * 128;
  static constexpr int kStreamBytes = kStepRows * kBoxes * 128;
  static constexpr int kStageBytes = 2 * kStreamBytes;
  static constexpr int kStashBytes = 2 * 128 * 32 * 4;
  static constexpr int kBytes = 1024 + 2 * kResidentBytes + kRingStages * kStageBytes +
                                kStashBytes + kRingStages * (2 * kStepRows * 4 + 16) +
                                (2 * kRingStages + 1) * 8;
  uint8_t* resident[2];
  uint8_t* ring;
  float4* stash;
  float* stats;
  int* info;  // per stage: key tile index (-1: the walk ends), mask bits 0-31, 32-63
  uint64_t* full;
  uint64_t* empty;
  uint64_t* loaded;  // the resident tensors
  __device__ __forceinline__ explicit Smem(uint8_t* raw) {
    resident[0] = align_1024(raw);
    resident[1] = resident[0] + kResidentBytes;
    ring = resident[1] + kResidentBytes;
    stash = reinterpret_cast<float4*>(ring + kRingStages * kStageBytes);
    stats = reinterpret_cast<float*>(ring + kRingStages * kStageBytes + kStashBytes);
    info = reinterpret_cast<int*>(stats + kRingStages * 2 * kStepRows);
    full = reinterpret_cast<uint64_t*>(info + kRingStages * 4);
    empty = full + kRingStages;
    loaded = empty + kRingStages;
  }
  __device__ __forceinline__ uint8_t* stage(int s) const { return ring + s * kStageBytes; }
};

// Thread 0: full[s] takes `full_arrivals` arrivals plus the stage's bytes,
// empty[s] one arrival per consumer warp, `loaded` one plus the bytes.
template <int D>
__device__ __forceinline__ void init_barriers(const Smem<D>& sm, uint32_t full_arrivals) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < kRingStages; ++s) {
      mbar_init(&sm.full[s], full_arrivals);
      mbar_init(&sm.empty[s], kConsumerWarps);
    }
    mbar_init(sm.loaded, 1);
    fence_barrier_init();
  }
}

// Producer lane 0: rows [row0, row0 + 128) of head h, batch b of two
// tensors into the resident buffers.
template <int D>
__device__ __forceinline__ void load_resident(const Smem<D>& sm, const CUtensorMap* map0,
                                              const CUtensorMap* map1, int row0, int h, int b) {
  mbar_arrive_expect_tx(sm.loaded, 2 * Smem<D>::kResidentBytes);
#pragma unroll
  for (int box = 0; box < Smem<D>::kBoxes; ++box) {
    tma_load_4d(sm.resident[0] + box * 2 * kBoxBytes, map0, sm.loaded, 64 * box, row0, h, b);
    tma_load_4d(sm.resident[1] + box * 2 * kBoxBytes, map1, sm.loaded, 64 * box, row0, h, b);
  }
}

// Producer lane 0: rows [row0, row0 + 64) of head h, batch b of two tensors
// into stage s; arrives on full[s] with the stage's bytes.
template <int D>
__device__ __forceinline__ void load_stage(const Smem<D>& sm, int s, const CUtensorMap* map0,
                                           const CUtensorMap* map1, int row0, int h, int b) {
  uint8_t* dst = sm.stage(s);
  mbar_arrive_expect_tx(&sm.full[s], Smem<D>::kStageBytes);
#pragma unroll
  for (int box = 0; box < Smem<D>::kBoxes; ++box) {
    tma_load_4d(dst + box * kBoxBytes, map0, &sm.full[s], 64 * box, row0, h, b);
    tma_load_4d(dst + Smem<D>::kStreamBytes + box * kBoxBytes, map1, &sm.full[s], 64 * box,
                row0, h, b);
  }
}

// x (64 x 64, fp32) = A B^T over D for this warpgroup's 64 resident rows (A)
// and a streamed 64-row tile (B), both K-major; committed as one group.
template <int D>
__device__ __forceinline__ void scores(float (&x)[32], uint64_t desc_a, const uint8_t* tile_b) {
  const uint64_t desc_b = desc_sw128(tile_b);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wgmma_ss<64>(x, desc_a + k_major_step<kBlockRows>(kk), desc_b + k_major_step<kStepRows>(kk),
                 kk > 0);
  }
  wgmma_commit();
}

// Whether batch row `mb` (Sk mask bytes) keeps a key; every thread of the
// block takes part and gets the answer.
__device__ __forceinline__ bool block_any_kept(const unsigned char* mb, int sk) {
  bool any = false;
  for (int i = threadIdx.x; i < sk && !any; i += kThreads) any = mb[i] != 0;
  return __syncthreads_or(any) != 0;
}

// Rows [row0, row0 + 128) below `rows` of a (rows x D) bf16 matrix, zeroed
// by the whole block in 16-byte stores.
template <int D>
__device__ __forceinline__ void zero_rows(__nv_bfloat16* dst, long long row_stride, int row0,
                                          int rows) {
  for (int i = threadIdx.x; i < kBlockRows * (D / 8); i += kThreads) {
    const int row = row0 + i / (D / 8);
    if (row < rows) {
      *reinterpret_cast<uint4*>(dst + (long long)row * row_stride + 8 * (i % (D / 8))) =
          make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_masked_kernel(const __grid_constant__ CUtensorMap map_q,
                            const __grid_constant__ CUtensorMap map_k,
                            const __grid_constant__ CUtensorMap map_v,
                            const __grid_constant__ CUtensorMap map_do,
                            const unsigned char* __restrict__ mask,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                            int sq, int sk, int num_heads, int repeats, int causal,
                            long long dk_sb, long long dk_sh, long long dk_ss, long long dv_sb,
                            long long dv_sh, long long dv_ss, float scale) {
  extern __shared__ uint8_t smem_raw[];
  const Smem<D> sm(smem_raw);
  const int k0 = blockIdx.x * kBlockRows;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const unsigned char* mb = mask == nullptr ? nullptr : mask + (long long)b * sk;
  __nv_bfloat16* dk_h = dk + b * dk_sb + hk * dk_sh;
  __nv_bfloat16* dv_h = dv + b * dv_sb + hk * dv_sh;

  // a block of masked keys in a batch entry that keeps a key, no causal
  // masking: P = 0 on each of its keys, so dK = dV = 0 there
  if (mb != nullptr && causal == 0) {
    const int key = k0 + threadIdx.x;
    if (!__syncthreads_or(threadIdx.x < kBlockRows && key < sk && mb[key] != 0) &&
        block_any_kept(mb, sk)) {
      zero_rows<D>(dk_h, dk_ss, k0, sk);
      zero_rows<D>(dv_h, dv_ss, k0, sk);
      return;
    }
  }

  const int num_qt = (sq + kStepRows - 1) / kStepRows;
  const int steps = repeats * num_qt;  // (query head of the group, q tile), q tiles fastest
  init_barriers(sm, 32);  // the producer warp's 32 lanes write a stage's lse and delta
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    setmaxnreg_dec<40>();
    if (threadIdx.x < kProducerThread + 32) {
      const int lane = threadIdx.x - kProducerThread;
      if (lane == 0) load_resident(sm, &map_k, &map_v, k0, hk, b);
      // a stage's lse and delta (rows lane and lane + 32; +inf and 0 past
      // sq) are read one stage ahead, so that their latency passes while
      // the producer waits for a free stage
      float next[4];
      auto load_stats = [&](int step) {
        const int h = hk * repeats + step / num_qt;
        const int row = (step % num_qt) * kStepRows + lane;
        const float* lse_h = lse + ((long long)b * num_heads + h) * sq;
        const float* delta_h = delta + ((long long)b * num_heads + h) * sq;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          next[i] = row + 32 * i < sq ? __fmul_rn(lse_h[row + 32 * i], kLog2e) : INFINITY;
          next[2 + i] = row + 32 * i < sq ? delta_h[row + 32 * i] : 0.f;
        }
      };
      load_stats(0);
      int stage = 0;
      uint32_t phase = 0;
      for (int step = 0; step < steps; ++step) {
        mbar_wait(&sm.empty[stage], phase ^ 1u);
        float* stats = sm.stats + stage * 2 * kStepRows;
        stats[lane] = next[0];
        stats[lane + 32] = next[1];
        stats[kStepRows + lane] = next[2];
        stats[kStepRows + lane + 32] = next[3];
        if (step + 1 < steps) load_stats(step + 1);
        if (lane == 0) {
          load_stage(sm, stage, &map_q, &map_do, (step % num_qt) * kStepRows,
                     hk * repeats + step / num_qt, b);
        } else {
          mbar_arrive(&sm.full[stage]);
        }
        if (++stage == kRingStages) {
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
    // this thread's keys: key and key + 8 (rows of S^T); keys at or past sk
    // are never written, so their scores need no masking
    const int key = k0 + 64 * wg + 16 * (t / 32) + lane / 4;
    const bool masked_lo = mb != nullptr && key < sk && mb[key] == 0;
    const bool masked_hi = mb != nullptr && key + 8 < sk && mb[key + 8] == 0;
    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    // this warpgroup's 64 keys of the resident K and V
    const uint64_t desc_k = desc_sw128(sm.resident[0] + wg * kBoxBytes);
    const uint64_t desc_v = desc_sw128(sm.resident[1] + wg * kBoxBytes);
    mbar_wait(sm.loaded, 0);

    int stage = 0;
    uint32_t phase = 0;
    for (int step = 0; step < steps; ++step) {
      mbar_wait(&sm.full[stage], phase);
      const uint8_t* tile_q = sm.stage(stage);
      const uint8_t* tile_do = tile_q + Smem<D>::kStreamBytes;
      const float* stats = sm.stats + stage * 2 * kStepRows;
      const int q0 = (step % num_qt) * kStepRows;

      // P^T = exp(S^T - lse) of this thread's slice, in place; columns are
      // q rows (lse and delta per column, cols 8j + 2 (lane % 4) + {0, 1})
      auto probabilities = [&](float (&x)[32]) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 8 * j + 2 * (lane % 4);
          const float2 l = *reinterpret_cast<const float2*>(stats + col);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float lse2 = (e & 1) ? l.y : l.x;
            const bool masked = (e < 2 ? masked_lo : masked_hi) ||
                                (causal != 0 && key + 8 * (e / 2) > q0 + col + (e & 1));
            x[4 * j + e] =
                ex2_approx(masked ? kMasked - lse2 : fmaf(x[4 * j + e], scale_log2, -lse2));
          }
        }
      };
      // dS^T = P^T (dP^T - delta) scale in place, columns j's four P^T values in p
      auto dscores = [&](float (&x)[32], int j, float4 p) {
        const float2 dl =
            *reinterpret_cast<const float2*>(stats + kStepRows + 8 * j + 2 * (lane % 4));
        x[4 * j] = p.x * (x[4 * j] - dl.x) * scale;
        x[4 * j + 1] = p.y * (x[4 * j + 1] - dl.y) * scale;
        x[4 * j + 2] = p.z * (x[4 * j + 2] - dl.x) * scale;
        x[4 * j + 3] = p.w * (x[4 * j + 3] - dl.y) * scale;
      };
      // beside two 64 x D accumulators, S^T and dP^T at once (or the P^T and
      // dS^T fragments at once) leave ptxas too few registers at D = 96 and
      // 128, and it serializes the wgmma: S^T, then dV += P^T dO with P^T
      // kept in fp32 in shared memory, then dP^T
      uint32_t p_frag[4][4], ds_frag[4][4];
      float x[32];
      wgmma_fence();
      scores<D>(x, desc_k, tile_q);  // S^T = K Q^T
      wgmma_wait<0>();
      fence_operands(x);
      probabilities(x);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        sm.stash[j * 256 + threadIdx.x] =
            make_float4(x[4 * j], x[4 * j + 1], x[4 * j + 2], x[4 * j + 3]);
      }
      acc_to_a_fragments<64>(p_frag, x);
      wgmma_fence();
      mma_rs_mn<D, 4>(dv_acc, p_frag, tile_do, kBoxBytes);  // dV += P^T dO
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(dv_acc);
      wgmma_fence();
      scores<D>(x, desc_v, tile_do);  // dP^T = V dO^T
      wgmma_wait<0>();
      fence_operands(x);
#pragma unroll
      for (int j = 0; j < 8; ++j) dscores(x, j, sm.stash[j * 256 + threadIdx.x]);
      acc_to_a_fragments<64>(ds_frag, x);
      wgmma_fence();
      mma_rs_mn<D, 4>(dk_acc, ds_frag, tile_q, kBoxBytes);  // dK += dS^T Q
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(dv_acc);
      fence_operands(dk_acc);
      if (lane == 0) mbar_arrive(&sm.empty[stage]);
      if (++stage == kRingStages) {
        stage = 0;
        phase ^= 1u;
      }
    }

    const int col = 2 * (lane % 4);
    store_acc_rows<D>(dk_h + col, dk_ss, dk_acc, key, sk);
    store_acc_rows<D>(dv_h + col, dv_ss, dv_acc, key, sk);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_masked_kernel(const __grid_constant__ CUtensorMap map_q,
                           const __grid_constant__ CUtensorMap map_k,
                           const __grid_constant__ CUtensorMap map_v,
                           const __grid_constant__ CUtensorMap map_do,
                           const unsigned char* __restrict__ mask,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           __nv_bfloat16* __restrict__ dq, int sq, int sk, int num_heads,
                           int repeats, int causal, long long dq_sb, long long dq_sh,
                           long long dq_ss, float scale) {
  extern __shared__ uint8_t smem_raw[];
  const Smem<D> sm(smem_raw);
  const int q0 = blockIdx.x * kBlockRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / repeats;
  const int num_kt = (sk + kStepRows - 1) / kStepRows;
  const unsigned char* mb = mask == nullptr ? nullptr : mask + (long long)b * sk;

  init_barriers(sm, 1);
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    setmaxnreg_dec<40>();
    if (threadIdx.x < kProducerThread + 32) {
      const int lane = threadIdx.x - kProducerThread;
      // masked key tiles may be skipped where the batch entry keeps a key
      // and nothing is causally masked: then every row keeps a key
      bool skip = false;
      if (mb != nullptr && causal == 0) {
        for (int base = 0; base < sk && !skip; base += 32) {
          skip = __any_sync(0xffffffffu, base + lane < sk && mb[base + lane] != 0);
        }
      }
      // key lane and lane + 32 of a tile masked (keys past sk: not masked),
      // read one tile ahead
      auto masked_keys = [&](int kt, bool (&m)[2]) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int key = kt * kStepRows + lane + 32 * i;
          m[i] = mb != nullptr && kt < num_kt && key < sk && mb[key] == 0;
        }
      };
      bool next[2];
      masked_keys(0, next);
      if (lane == 0) load_resident(sm, &map_q, &map_do, q0, h, b);
      int stage = 0;
      uint32_t phase = 0;
      for (int kt = 0; kt < num_kt; ++kt) {
        const uint32_t lo = __ballot_sync(0xffffffffu, next[0]);
        const uint32_t hi = __ballot_sync(0xffffffffu, next[1]);
        masked_keys(kt + 1, next);
        if (skip && __popc(lo) + __popc(hi) == min(kStepRows, sk - kt * kStepRows)) continue;
        if (lane == 0) {
          mbar_wait(&sm.empty[stage], phase ^ 1u);
          int* info = sm.info + 4 * stage;
          info[0] = kt;
          info[1] = static_cast<int>(lo);
          info[2] = static_cast<int>(hi);
          load_stage(sm, stage, &map_k, &map_v, kt * kStepRows, hk, b);
        }
        if (++stage == kRingStages) {
          stage = 0;
          phase ^= 1u;
        }
      }
      if (lane == 0) {  // a last stage with no tile ends the consumers' walk
        mbar_wait(&sm.empty[stage], phase ^ 1u);
        sm.info[4 * stage] = -1;
        mbar_arrive(&sm.full[stage]);
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const float scale_log2 = scale * kLog2e;
    // this thread's q rows: row and row + 8; P = 0 past sq (lse = +inf)
    const int row = q0 + 64 * wg + 16 * (t / 32) + lane / 4;
    const float* lse_h = lse + ((long long)b * num_heads + h) * sq;
    const float* delta_h = delta + ((long long)b * num_heads + h) * sq;
    const float lse_lo = row < sq ? __fmul_rn(lse_h[row], kLog2e) : INFINITY;
    const float lse_hi = row + 8 < sq ? __fmul_rn(lse_h[row + 8], kLog2e) : INFINITY;
    const float delta_lo = row < sq ? delta_h[row] : 0.f;
    const float delta_hi = row + 8 < sq ? delta_h[row + 8] : 0.f;
    float dq_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;
    const uint64_t desc_q = desc_sw128(sm.resident[0] + wg * kBoxBytes);
    const uint64_t desc_do = desc_sw128(sm.resident[1] + wg * kBoxBytes);
    mbar_wait(sm.loaded, 0);

    int stage = 0;
    uint32_t phase = 0;
    for (;;) {
      mbar_wait(&sm.full[stage], phase);
      const int* info = sm.info + 4 * stage;
      const int kt = info[0];
      if (kt < 0) break;
      const uint64_t bits = static_cast<uint32_t>(info[1]) |
                            (static_cast<uint64_t>(static_cast<uint32_t>(info[2])) << 32);
      const uint8_t* tile_k = sm.stage(stage);
      const uint8_t* tile_v = tile_k + Smem<D>::kStreamBytes;

      float s[32], dp[32];
      wgmma_fence();
      scores<D>(s, desc_q, tile_k);   // S = Q K^T
      scores<D>(dp, desc_do, tile_v);  // dP = dO V^T
      wgmma_wait<1>();  // S
      fence_operands(s);
      const int k0 = kt * kStepRows;
      const bool ragged = k0 + kStepRows > sk;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * (lane % 4) + (e & 1);
          const float lse2 = e < 2 ? lse_lo : lse_hi;
          const bool masked =
              ((bits >> c) & 1u) != 0 || (causal != 0 && k0 + c > row + 8 * (e / 2));
          const float x =
              ex2_approx(masked ? kMasked - lse2 : fmaf(s[4 * j + e], scale_log2, -lse2));
          s[4 * j + e] = ragged && k0 + c >= sk ? 0.f : x;
        }
      }
      wgmma_wait<0>();
      fence_operands(dp);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - (e < 2 ? delta_lo : delta_hi)) * scale;
        }
      }
      uint32_t ds_frag[4][4];
      acc_to_a_fragments<64>(ds_frag, dp);

      wgmma_fence();
      mma_rs_mn<D, 4>(dq_acc, ds_frag, tile_k, kBoxBytes);  // dQ += dS K
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(dq_acc);
      if (lane == 0) mbar_arrive(&sm.empty[stage]);
      if (++stage == kRingStages) {
        stage = 0;
        phase ^= 1u;
      }
    }

    store_acc_rows<D>(dq + b * dq_sb + h * dq_sh + 2 * (lane % 4), dq_ss, dq_acc, row, sq);
  }
}

// The four tensor maps of one launch: q and dO over (B, H, Sq, D) in boxes
// of q_box rows, k and v over (B, Hkv, Sk, D) in boxes of k_box rows.
struct Maps {
  CUtensorMap q, k, v, dout;
};

int make_maps(Maps* maps, const void* q, const void* k, const void* v, const void* dout,
              int batch, int sq, int sk, int num_heads, int num_kv_heads, int head_dim,
              const long long (&strides)[12], uint32_t q_box, uint32_t k_box) {
  const long long* s = strides;  // (batch, head, row) of q, k, v, dout
  int err = make_map_4d(&maps->q, q, batch, num_heads, sq, head_dim, s[0], s[1], s[2], q_box);
  if (!err) {
    err = make_map_4d(&maps->k, k, batch, num_kv_heads, sk, head_dim, s[3], s[4], s[5], k_box);
  }
  if (!err) {
    err = make_map_4d(&maps->v, v, batch, num_kv_heads, sk, head_dim, s[6], s[7], s[8], k_box);
  }
  if (!err) {
    err = make_map_4d(&maps->dout, dout, batch, num_heads, sq, head_dim, s[9], s[10], s[11], q_box);
  }
  return err;
}

template <int D>
int launch_dkv(const Maps& maps, const unsigned char* mask, const float* lse, const float* delta,
               __nv_bfloat16* dk, __nv_bfloat16* dv, int batch, int sq, int sk, int num_heads,
               int num_kv_heads, int causal, const long long (&out_strides)[6], float scale,
               cudaStream_t stream) {
  const int err = allow_dynamic_smem<flash_bwd_dkv_masked_kernel<D>>(Smem<D>::kBytes);
  if (err) return err;
  const dim3 grid((sk + kBlockRows - 1) / kBlockRows, num_kv_heads, batch);
  const long long* s = out_strides;
  flash_bwd_dkv_masked_kernel<D><<<grid, kThreads, Smem<D>::kBytes, stream>>>(
      maps.q, maps.k, maps.v, maps.dout, mask, lse, delta, dk, dv, sq, sk, num_heads,
      num_heads / num_kv_heads, causal, s[0], s[1], s[2], s[3], s[4], s[5], scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq(const Maps& maps, const unsigned char* mask, const float* lse, const float* delta,
              __nv_bfloat16* dq, int batch, int sq, int sk, int num_heads, int num_kv_heads,
              int causal, const long long (&out_strides)[3], float scale, cudaStream_t stream) {
  const int err = allow_dynamic_smem<flash_bwd_dq_masked_kernel<D>>(Smem<D>::kBytes);
  if (err) return err;
  const dim3 grid((sq + kBlockRows - 1) / kBlockRows, num_heads, batch);
  const long long* s = out_strides;
  flash_bwd_dq_masked_kernel<D><<<grid, kThreads, Smem<D>::kBytes, stream>>>(
      maps.q, maps.k, maps.v, maps.dout, mask, lse, delta, dq, sq, sk, num_heads,
      num_heads / num_kv_heads, causal, s[0], s[1], s[2], scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entries, bound with ctypes. Strides are in elements, (batch, head, row)
// for each bf16 tensor; the last axis is contiguous and every stride and
// base is 16-byte aligned (the wrapper checks both). k, v, dk and dv have
// num_kv_heads heads, a divisor of num_heads. `mask` (B, Sk) bytes may be
// null; lse and delta are contiguous fp32 (B, H, Sq). Each launches on
// `stream` and returns the first error: of the tensor maps' encoding, of
// the shared-memory attribute, or cudaGetLastError() after the launch.

extern "C" int flash_attention_masked_bwd_dkv(
    const void* q, const void* k, const void* v, const void* mask, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int batch, int sq, int sk,
    int num_heads, int num_kv_heads, int head_dim, int causal, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, long long do_sb, long long do_sh, long long do_ss,
    long long dk_sb, long long dk_sh, long long dk_ss, long long dv_sb, long long dv_sh,
    long long dv_ss, float scale, void* stream) {
  if (num_kv_heads < 1 || num_heads % num_kv_heads != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (head_dim != 64 && head_dim != 96 && head_dim != 128) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long in_strides[12] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                                    v_sb, v_sh, v_ss, do_sb, do_sh, do_ss};
  const long long out_strides[6] = {dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss};
  Maps maps;
  const int err = make_maps(&maps, q, k, v, dout, batch, sq, sk, num_heads, num_kv_heads,
                            head_dim, in_strides, kStepRows, kBlockRows);
  if (err) return err;
  const auto* mb = static_cast<const unsigned char*>(mask);
  const auto* lb = static_cast<const float*>(lse);
  const auto* db = static_cast<const float*>(delta);
  auto* dkb = static_cast<__nv_bfloat16*>(dk);
  auto* dvb = static_cast<__nv_bfloat16*>(dv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return launch_dkv<64>(maps, mb, lb, db, dkb, dvb, batch, sq, sk, num_heads, num_kv_heads,
                            causal, out_strides, scale, s);
    case 96:
      return launch_dkv<96>(maps, mb, lb, db, dkb, dvb, batch, sq, sk, num_heads, num_kv_heads,
                            causal, out_strides, scale, s);
    default:
      return launch_dkv<128>(maps, mb, lb, db, dkb, dvb, batch, sq, sk, num_heads, num_kv_heads,
                             causal, out_strides, scale, s);
  }
}

extern "C" int flash_attention_masked_bwd_dq(
    const void* q, const void* k, const void* v, const void* mask, const void* dout,
    const void* lse, const void* delta, void* dq, int batch, int sq, int sk, int num_heads,
    int num_kv_heads, int head_dim, int causal, long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, long long do_sb, long long do_sh, long long do_ss, long long dq_sb,
    long long dq_sh, long long dq_ss, float scale, void* stream) {
  if (num_kv_heads < 1 || num_heads % num_kv_heads != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (head_dim != 64 && head_dim != 96 && head_dim != 128) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long in_strides[12] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                                    v_sb, v_sh, v_ss, do_sb, do_sh, do_ss};
  const long long out_strides[3] = {dq_sb, dq_sh, dq_ss};
  Maps maps;
  const int err = make_maps(&maps, q, k, v, dout, batch, sq, sk, num_heads, num_kv_heads,
                            head_dim, in_strides, kBlockRows, kStepRows);
  if (err) return err;
  const auto* mb = static_cast<const unsigned char*>(mask);
  const auto* lb = static_cast<const float*>(lse);
  const auto* db = static_cast<const float*>(delta);
  auto* dqb = static_cast<__nv_bfloat16*>(dq);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return launch_dq<64>(maps, mb, lb, db, dqb, batch, sq, sk, num_heads, num_kv_heads, causal,
                           out_strides, scale, s);
    case 96:
      return launch_dq<96>(maps, mb, lb, db, dqb, batch, sq, sk, num_heads, num_kv_heads, causal,
                           out_strides, scale, s);
    default:
      return launch_dq<128>(maps, mb, lb, db, dqb, batch, sq, sk, num_heads, num_kv_heads,
                            causal, out_strides, scale, s);
  }
}
