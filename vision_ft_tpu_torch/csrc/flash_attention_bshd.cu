// BSHD flash attention forward for Hopper (sm_90a), CUDA C++: kernel B, a
// warp-specialized TMA + wgmma kernel on hopper_gemm.cuh.
//
// Replaces vision_ft_tpu/ops/pallas/flash_attention.py::_fwd_kernel_bshd
// (launched by _flash_fwd_bshd, entry flash_attention_bshd).
//
// Computes, per batch b and head h, out = softmax(q k^T * scale) v, and
// optionally lse = log(sum(exp(q k^T * scale))) in fp32 as (B, H, Sq),
// straight from heads-packed (B, S, H*D) tensors: head h is the columns
// [h*D, (h+1)*D) of each row, addressed through the tensor maps' row and
// batch strides, so no head transpose ever touches device memory. bf16 in
// and out; the running max, running sum and output accumulator are fp32.
//
// What bounds it on an H100: the tensor cores, with the exponentials close
// behind. The two products do 4 Sq Sk D operations per head against 4 S D
// bytes of q/k/v/out traffic, hundreds of operations per byte; at D = 64
// the Sq Sk exponentials (16 a clock per SM) take as long as the products
// at the tensor peak, so the softmax has to overlap the other warpgroup's
// wgmma. The score matrix never leaves the registers.
//
// Design (kernel C's dq kernel, flash_attention_bshd_bwd.cu, as a forward):
//   - One block of 384 threads per (128-row q tile, head, batch): consumer
//     warpgroups 0 and 1 own 64 q rows each; one thread of warpgroup 2
//     produces with TMA; setmaxnreg moves registers to the consumers.
//   - Q is loaded once by TMA through a 3-D map over (H*D, S, B); a ring of
//     kStages stages streams K and V tiles of KN keys (Cfg<D>: KN = 128 at
//     D = 64; 64 at D = 128 and 256, where a 128-key ring would not fit
//     shared memory).
//   - D = 256 runs in two passes over the keys, each making half of O's
//     columns (kPasses = D / 128; V's tiles in a pass are that half): the O
//     accumulator of a whole row (128 fp32 registers a consumer thread, with
//     S's 32 and the P fragments' 16) does not fit the 168 registers a
//     thread of a 384-thread block is compiled for (ptxas gives no more
//     for setmaxnreg, nor for a 288-thread block; with O whole the build
//     spilled and ptxas serialized every wgmma, C7512 / C7520), while half
//     of it (64) sits as D = 128's does. Each pass computes S over all of D
//     again, so the products cost 1.5x those of one pass, and K is read
//     twice; the softmax statistics of the two passes are the same numbers
//     (the same S in the same order), and lse is written once.
//   - S = Q K^T by wgmma m64nKNk16, both operands K-major; the online
//     softmax runs on the accumulator in the exp2 domain (the row max taken
//     on raw scores, scale * log2 e folded into one FMA before ex2.approx:
//     so scale > 0, which the wrapper checks);
//     O += P V takes P as register A fragments (acc_to_a_fragments) and
//     reads V MN-major through the transpose bit. Per tile a warpgroup
//     issues P V and, behind it, the next tile's S, then releases the stage
//     once P V has completed; the two warpgroups' wgmma and exponentials
//     interleave on the SM.
//   - Ragged lengths: the 3-D maps zero-fill a tile that overhangs a
//     batch's last row; keys at or past sk score -inf in the last tile, q
//     rows at or past sq are never stored. The epilogue normalizes and
//     stores O as bf16 pairs guarded by the row count, and lse (natural
//     log) when asked: kernel C reads it.
// Not carried over from the TPU kernel: lane-aligned two-head groups, the
// V-ones row sum, the 8-sublane lse broadcast and the VFT_FLASH_* levers.
// Tried and dropped (verdicts in PERF.md): 64-key tiles at D = 64, 2
// stages, at D = 256 one pass with O whole in registers (spills, above),
// the next tile's softmax overlapped with this tile's P V inside a
// warpgroup (with or without the wgmma on divergent paths that ptxas
// serializes), a named-barrier ping-pong between the warpgroups, rescaling
// O only where a row's max moved.
// Left for later work: at D = 64 the Sq Sk exponentials alone (16 a clock
// per SM) match the products' time at the tensor peak: moving some of them
// to FMA polynomials; a persistent grid (the 1024-row shapes make 2.4
// waves); the host's cost of a call (three tensor maps, the wrapper).

#include "hopper_gemm.cuh"

#include <math.h>

namespace {

using namespace hopper;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBlockRows = 128;  // q rows a block owns, 64 per consumer warpgroup
constexpr int kProducerThread = 256;  // lane 0 of warpgroup 2

// Per head dim: keys a tile, stages of the ring, passes over O's columns.
template <int D>
struct Cfg;
template <>
struct Cfg<64> {
  static constexpr int kKeys = 128, kStages = 4, kPasses = 1;
};
template <>
struct Cfg<128> {
  static constexpr int kKeys = 64, kStages = 4, kPasses = 1;
};
template <>
struct Cfg<256> {
  static constexpr int kKeys = 64, kStages = 3, kPasses = 2;
};

// Shared memory: Q (D / 64 boxes of 128 rows x 128 bytes), the ring (a
// stage: K, D / 64 boxes of KN rows, then the pass's V columns, DO / 64
// boxes of KN rows), the barriers.
template <int D>
struct Smem {
  static constexpr int KN = Cfg<D>::kKeys;
  static constexpr int kStages = Cfg<D>::kStages;
  static constexpr int DO = D / Cfg<D>::kPasses;  // O's columns a pass
  static constexpr int kBoxes = D / 64;
  static constexpr int kVBoxes = DO / 64;
  static constexpr int kQBytes = kBlockRows * D * 2;
  static constexpr int kKBytes = KN * D * 2;
  static constexpr int kStageBytes = kKBytes + KN * DO * 2;
  static constexpr int kBytes = 1024 + kQBytes + kStages * kStageBytes + (2 * kStages + 1) * 8;
  static_assert(kBytes <= 232448, "more shared memory than a block may have");
  uint8_t* q;
  uint8_t* ring;
  uint64_t* full;
  uint64_t* empty;
  uint64_t* loaded;  // Q
  __device__ __forceinline__ explicit Smem(uint8_t* raw) {
    q = align_1024(raw);
    ring = q + kQBytes;
    full = reinterpret_cast<uint64_t*>(ring + kStages * kStageBytes);
    empty = full + kStages;
    loaded = empty + kStages;
  }
  __device__ __forceinline__ uint8_t* stage(int s) const { return ring + s * kStageBytes; }
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_bshd_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v, __nv_bfloat16* __restrict__ o,
                      float* __restrict__ lse, int sq, int sk, int num_heads, long long o_sb,
                      long long o_ss, float scale_log2) {
  using S = Smem<D>;
  constexpr int KN = S::KN;
  constexpr int DO = S::DO;
  constexpr int kStages = S::kStages;
  constexpr int kPasses = Cfg<D>::kPasses;
  extern __shared__ uint8_t smem_raw[];
  const S sm(smem_raw);
  const int q0 = blockIdx.x * kBlockRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int num_kt = (sk + KN - 1) / KN;
  const int num_tiles = kPasses * num_kt;  // tile t: keys of tile t % num_kt, pass t / num_kt

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kConsumerWarps);
    }
    mbar_init(sm.loaded, 1);
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == kProducerThread) {
      mbar_arrive_expect_tx(sm.loaded, S::kQBytes);
#pragma unroll
      for (int box = 0; box < S::kBoxes; ++box) {
        tma_load_3d(sm.q + box * kBlockRows * 128, &map_q, sm.loaded, h * D + 64 * box, q0, b);
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int t = 0; t < num_tiles; ++t) {
        const int pass = t / num_kt;
        const int kt = t - pass * num_kt;
        mbar_wait(&sm.empty[stage], phase ^ 1u);
        uint8_t* dst = sm.stage(stage);
        mbar_arrive_expect_tx(&sm.full[stage], S::kStageBytes);
#pragma unroll
        for (int box = 0; box < S::kBoxes; ++box) {
          tma_load_3d(dst + box * KN * 128, &map_k, &sm.full[stage], h * D + 64 * box, kt * KN, b);
        }
#pragma unroll
        for (int box = 0; box < S::kVBoxes; ++box) {
          tma_load_3d(dst + S::kKBytes + box * KN * 128, &map_v, &sm.full[stage],
                      h * D + DO * pass + 64 * box, kt * KN, b);
        }
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1u;
        }
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int t_wg = threadIdx.x % 128;
    const int lane = t_wg % 32;
    float o_acc[DO / 2];
#pragma unroll
    for (int i = 0; i < DO / 2; ++i) o_acc[i] = 0.f;
    // this thread's rows: row and row + 8 ("lo", "hi"); m is the raw
    // scores' running max, l this thread's partial running sum
    float m_lo = -INFINITY, m_hi = -INFINITY;
    float l_lo = 0.f, l_hi = 0.f;
    const uint64_t desc_q = desc_sw128(sm.q + wg * 64 * 128);
    mbar_wait(sm.loaded, 0);

    // S = Q K^T of the stage's K tile into s, committed as one group
    float s[KN / 2];
    auto issue_scores = [&](int st) {
      const uint64_t desc_k = desc_sw128(sm.stage(st));
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_ss<KN>(s, desc_q + k_major_step<kBlockRows>(kk), desc_k + k_major_step<KN>(kk),
                     kk > 0);
      }
      wgmma_commit();
    };
    // O's columns [DO pass, DO (pass + 1)) normalized and stored as bf16
    // pairs (rows below sq), and lse (natural log) in the first pass
    auto store = [&](int pass) {
      l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
      l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
      l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
      l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
      const float inv_lo = 1.f / fmaxf(l_lo, 1e-30f);
      const float inv_hi = 1.f / fmaxf(l_hi, 1e-30f);
      const int row = q0 + 64 * wg + 16 * (t_wg / 32) + lane / 4;
      __nv_bfloat16* lo = o + b * o_sb + (long long)row * o_ss + h * D + DO * pass + 2 * (lane % 4);
      __nv_bfloat16* hi = lo + 8 * o_ss;
#pragma unroll
      for (int j = 0; j < DO / 8; ++j) {
        if (row < sq) {
          *reinterpret_cast<uint32_t*>(lo + 8 * j) =
              pack_bf16x2(o_acc[4 * j] * inv_lo, o_acc[4 * j + 1] * inv_lo);
        }
        if (row + 8 < sq) {
          *reinterpret_cast<uint32_t*>(hi + 8 * j) =
              pack_bf16x2(o_acc[4 * j + 2] * inv_hi, o_acc[4 * j + 3] * inv_hi);
        }
      }
      if (pass == 0 && lse != nullptr && lane % 4 == 0) {
        const float ln2 = 0.69314718055994531f;
        float* lh = lse + ((long long)b * num_heads + h) * sq;
        if (row < sq) lh[row] = (m_lo * scale_log2 + log2f(fmaxf(l_lo, 1e-30f))) * ln2;
        if (row + 8 < sq) lh[row + 8] = (m_hi * scale_log2 + log2f(fmaxf(l_hi, 1e-30f))) * ln2;
      }
    };
    // per tile: the softmax of S, O += P V issued, the next tile's S issued
    // behind it; the stage is released once P V has completed
    int stage = 0;
    uint32_t phase = 0;
    int kt = 0;
    int pass = 0;
    mbar_wait(&sm.full[0], 0);
    wgmma_fence();
    issue_scores(0);
    wgmma_wait<0>();
    fence_operands(s);
    for (int t = 0; t < num_tiles; ++t) {
      // keys at or past sk (zero-filled rows of the last tile) score -inf
      const int k0 = kt * KN;
      if (k0 + KN > sk) {
#pragma unroll
        for (int i = 0; i < KN / 2; ++i) {
          if (k0 + 8 * (i / 4) + 2 * (lane % 4) + (i & 1) >= sk) s[i] = -INFINITY;
        }
      }
      float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
      for (int j = 0; j < KN / 8; ++j) {
        mx_lo = fmaxf(mx_lo, fmaxf(s[4 * j], s[4 * j + 1]));
        mx_hi = fmaxf(mx_hi, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
      // finite: key k0 < sk is in every tile; 0 on a pass's first tile (m = -inf)
      const float alpha_lo = ex2_approx((m_lo - mx_lo) * scale_log2);
      const float alpha_hi = ex2_approx((m_hi - mx_hi) * scale_log2);
      m_lo = mx_lo;
      m_hi = mx_hi;
      const float mb_lo = m_lo * scale_log2, mb_hi = m_hi * scale_log2;
      float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
      for (int j = 0; j < KN / 8; ++j) {
        s[4 * j] = ex2_approx(fmaf(s[4 * j], scale_log2, -mb_lo));
        s[4 * j + 1] = ex2_approx(fmaf(s[4 * j + 1], scale_log2, -mb_lo));
        s[4 * j + 2] = ex2_approx(fmaf(s[4 * j + 2], scale_log2, -mb_hi));
        s[4 * j + 3] = ex2_approx(fmaf(s[4 * j + 3], scale_log2, -mb_hi));
        sum_lo += s[4 * j] + s[4 * j + 1];
        sum_hi += s[4 * j + 2] + s[4 * j + 3];
      }
      l_lo = l_lo * alpha_lo + sum_lo;
      l_hi = l_hi * alpha_hi + sum_hi;
#pragma unroll
      for (int i = 0; i < DO / 2; ++i) o_acc[i] *= (i % 4 < 2) ? alpha_lo : alpha_hi;
      uint32_t p_frag[KN / 16][4];
      acc_to_a_fragments<KN>(p_frag, s);
      wgmma_fence();
      mma_rs_mn<DO, KN / 16>(o_acc, p_frag, sm.stage(stage) + S::kKBytes, KN * 128);  // O += P V
      wgmma_commit();
      const int current = stage;
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1u;
      }
      if (t + 1 < num_tiles) {
        mbar_wait(&sm.full[stage], phase);
        issue_scores(stage);
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
      fence_operands(o_acc);
      if (lane == 0) mbar_arrive(&sm.empty[current]);
      wgmma_wait<0>();
      fence_operands(s);
      if constexpr (kPasses > 1) {
        if (++kt == num_kt) {  // the pass's columns are final: store them, start the next pass
          store(pass);
          ++pass;
          kt = 0;
          m_lo = m_hi = -INFINITY;
          l_lo = l_hi = 0.f;
#pragma unroll
          for (int i = 0; i < DO / 2; ++i) o_acc[i] = 0.f;
        }
      } else {
        ++kt;
      }
    }
    if constexpr (kPasses == 1) store(0);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, __nv_bfloat16* o, float* lse, int batch,
           int sq, int sk, int num_heads, long long q_sb, long long q_ss, long long k_sb,
           long long k_ss, long long v_sb, long long v_ss, long long o_sb, long long o_ss,
           float scale_log2, cudaStream_t stream) {
  constexpr int KN = Cfg<D>::kKeys;
  const uint64_t cols = static_cast<uint64_t>(num_heads) * D;
  CUtensorMap map_q, map_k, map_v;
  int err = make_map_3d(&map_q, q, batch, sq, cols, q_sb, q_ss, kBlockRows);
  if (!err) err = make_map_3d(&map_k, k, batch, sk, cols, k_sb, k_ss, KN);
  if (!err) err = make_map_3d(&map_v, v, batch, sk, cols, v_sb, v_ss, KN);
  if (!err) err = allow_dynamic_smem<flash_fwd_bshd_kernel<D>>(Smem<D>::kBytes);
  if (err) return err;
  const dim3 grid((sq + kBlockRows - 1) / kBlockRows, num_heads, batch);
  flash_fwd_bshd_kernel<D><<<grid, kThreads, Smem<D>::kBytes, stream>>>(
      map_q, map_k, map_v, o, lse, sq, sk, num_heads, o_sb, o_ss, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
void describe(int* out) {
  out[0] = Cfg<D>::kKeys;
  out[1] = Cfg<D>::kStages;
  out[2] = Cfg<D>::kPasses;
  out[3] = Smem<D>::kBytes;
}

}  // namespace

// C entry, bound with ctypes. Strides are in elements; the last dimension
// is contiguous and every row and batch stride and base is 16-byte aligned
// (the wrapper checks all three). `lse` may be null. Launches on `stream`
// and returns the first error: of the tensor maps' encoding, of the
// shared-memory attribute, or cudaGetLastError() after the launch.
extern "C" int flash_attention_bshd_fwd(const void* q, const void* k, const void* v, void* o,
                                        void* lse, int batch, int sq, int sk, int num_heads,
                                        int head_dim, long long q_sb, long long q_ss,
                                        long long k_sb, long long k_ss, long long v_sb,
                                        long long v_ss, long long o_sb, long long o_ss,
                                        float scale, void* stream) {
  const float scale_log2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* ob = static_cast<__nv_bfloat16*>(o);
  auto* lb = static_cast<float*>(lse);
  switch (head_dim) {
    case 64:
      return launch<64>(q, k, v, ob, lb, batch, sq, sk, num_heads, q_sb, q_ss, k_sb, k_ss, v_sb,
                        v_ss, o_sb, o_ss, scale_log2, s);
    case 128:
      return launch<128>(q, k, v, ob, lb, batch, sq, sk, num_heads, q_sb, q_ss, k_sb, k_ss, v_sb,
                         v_ss, o_sb, o_ss, scale_log2, s);
    case 256:
      return launch<256>(q, k, v, ob, lb, batch, sq, sk, num_heads, q_sb, q_ss, k_sb, k_ss, v_sb,
                         v_ss, o_sb, o_ss, scale_log2, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// C entry: the launch shape of `head_dim`'s instantiation into out[4]: keys
// a tile, ring stages, passes over O's columns, dynamic shared-memory
// bytes. Returns 0, or cudaErrorInvalidValue for a head dim the kernel does
// not take.
extern "C" int flash_attention_bshd_fwd_config(int head_dim, int* out) {
  switch (head_dim) {
    case 64:
      describe<64>(out);
      return 0;
    case 128:
      describe<128>(out);
      return 0;
    case 256:
      describe<256>(out);
      return 0;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
