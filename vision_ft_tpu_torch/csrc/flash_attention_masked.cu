// Key-masked flash attention forward over (B, H, S, D) for Hopper (sm_90a),
// CUDA C++: kernel E, a warp-specialized TMA + wgmma kernel on
// hopper_gemm.cuh.
//
// Replaces vision_ft_tpu/ops/pallas/flash_attention.py::_fwd_kernel
// (launched by _flash_fwd, entry flash_attention_tpu).
//
// Computes, per batch b and query head h (kv head hk = h / repeats),
//   out = softmax(q k^T * scale + maskrow [causal]) v
// and optionally lse = log(sum(exp(scores))) in fp32 as (B, H, Sq). bf16 in
// and out; scores, running max, running sum and the output accumulator are
// fp32.
//
// Masking, as the kernel it replaces does it:
//   - `mask` is a (B, Sk) row of bytes (non-zero = attend) shared by every
//     head and query row of a batch: a masked key scores a finite -1e30, not
//     -inf. A partly masked row gives such keys weight exp(-1e30 - m) = 0; a
//     query row with every key masked gives them all weight 1, so its output
//     is the mean of v over the sk keys and its lse is about -1e30.
//   - causal: key position <= query position, with no Sk - Sq offset (the
//     wrapper only takes Sq == Sk); excluded keys score the same -1e30.
//   - ragged lengths: keys at or past sk score -inf (their K and V rows are
//     TMA's zeros); q rows at or past sq are never stored.
// Kernel G (flash_attention_masked_bwd.cu) reads the lse: a fully masked
// row's is (kMasked + log2(sk)) * ln 2, so that G's own lse * log2 e gives
// an exponent of exactly 0 there.
//
// What bounds it on an H100: the tensor cores, with the softmax close
// behind. The two products do 4 Sq Sk D operations per head over the key
// pairs the mask leaves, against 2 (Sq + Sk) D bytes a head of q, k, v and
// out: hundreds of operations a byte. At D = 96 the Sq Sk exponentials (16
// a clock per SM) take two thirds of the products' time at the tensor
// peak, and the softmax's other instructions as long again, so the softmax
// has to run while wgmma does.
//
// Design (kernel B's forward loop, flash_attention_bshd.cu, with kernel G's
// 4-D maps and mask words, flash_attention_masked_bwd.cu):
//   - One block of 384 threads per (128-row q tile, head, batch): consumer
//     warpgroups 0 and 1 own 64 q rows each; one warp of warpgroup 2
//     produces (lane 0 issues TMA); setmaxnreg moves registers to the
//     consumers.
//   - Tensor maps: 4-D over (D, S, H, B) with the tensors' own row, head and
//     batch strides, so the NextDiT's (B, S, heads, D) memory of its fused
//     qkv projection is read in place. Q is loaded once; a ring of 4 stages
//     streams K and V tiles of 64 keys of kv head hk. Head dim 96 is two
//     64-column boxes, the second's last 32 columns TMA's zeros: S takes 6 K
//     steps and never reads them; P V is wgmma m64n96k16.
//   - S = Q K^T by wgmma m64n64k16, both operands K-major. The online
//     softmax runs on the accumulator in the exp2 domain: scores are scaled
//     by scale * log2 e first (one FMUL), masked keys set to kMasked (-1e30 *
//     log2 e), so any scale works. O += P V takes P as register A fragments
//     and reads V MN-major through the transpose bit.
//   - Per tile a warpgroup issues the next tile's S, rescales O, issues
//     this tile's P V, and runs the next tile's softmax while P V is on the
//     tensor cores (the two wgmma groups retire in order: S first); P is
//     rounded to bf16 once P V has completed, and the stage is released.
//     Beside a 64 x D accumulator this holds the 64-key scores and one P
//     in registers (no spills at any head dim; 128-key tiles spill here).
//   - Each stage carries the tile's key index and its 64 mask bits (two
//     ballots of the producer warp). A tile without a masked key, causal
//     masking or a ragged tail takes the plain path (no per-key test).
//   - Skipped key tiles: where every q row of the block keeps a key (the
//     batch entry keeps one; under causal masking one at or before the
//     block's first row), a masked or causally excluded key weighs exactly
//     0, so a tile of such keys adds exactly nothing: the producer never
//     loads tiles masked whole, nor, under causal masking, tiles past the
//     block's last row; a last stage with no tile ends the consumers' walk.
//     A row that keeps no key weighs all sk keys alike, so such a block
//     skips nothing.
//   - The epilogue normalizes and stores O as bf16 pairs guarded by the row
//     count, at the output's own strides, and the lse (natural log) when
//     asked.
// Not carried over from the TPU kernel: the V-ones row sum, the 8-sublane
// bias and lse replication, the k/v padding in device memory and the
// VFT_FLASH_* levers. Tried and dropped (verdicts in PERF.md): Q as
// register A fragments of S, 128-key tiles at D = 96 (3 stages), the max on
// raw scores with the scale folded into one FMA, P rounded while P V is in
// flight, a named-barrier ping-pong of the two warpgroups' wgmma. Left for
// later work: a persistent grid, a TMA store of O, the host's cost of a
// call (three tensor maps and the wrapper's checks).

#include "hopper_gemm.cuh"

#include <math.h>

namespace {

using namespace hopper;

constexpr float kLog2e = 1.4426950408889634f;
// -1e30 in the exp2 domain (scores are scaled by scale * log2 e)
constexpr float kMasked = -1.4426950408889634e30f;
constexpr int kBlockRows = 128;  // q rows a block owns, 64 per consumer warpgroup
constexpr int kKeys = 64;        // keys a tile
constexpr int kProducerThread = 256;  // lane 0 of the producer warp
constexpr int kInfoInts = 4;          // per stage: key tile index (-1 ends the walk), mask bits

// Shared memory: Q (D / 64 boxes, rounded up, of 128 rows x 128 bytes), the
// ring (a stage: K, then V, each in boxes of 64 rows), per stage the tile's
// index and mask bits, the barriers.
template <int D>
struct Smem {
  static constexpr int kBoxes = (D + 63) / 64;
  static constexpr int kQBytes = kBlockRows * kBoxes * 128;
  static constexpr int kTileBytes = kKeys * kBoxes * 128;
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kBytes =
      1024 + kQBytes + kStages * kStageBytes + kStages * kInfoInts * 4 + (2 * kStages + 1) * 8;
  uint8_t* q;
  uint8_t* ring;
  int* info;
  uint64_t* full;
  uint64_t* empty;
  uint64_t* loaded;  // Q
  __device__ __forceinline__ explicit Smem(uint8_t* raw) {
    q = align_1024(raw);
    ring = q + kQBytes;
    info = reinterpret_cast<int*>(ring + kStages * kStageBytes);
    full = reinterpret_cast<uint64_t*>(info + kStages * kInfoInts);
    empty = full + kStages;
    loaded = empty + kStages;
  }
  __device__ __forceinline__ uint8_t* stage(int s) const { return ring + s * kStageBytes; }
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_masked_kernel(const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v,
                        const unsigned char* __restrict__ mask, __nv_bfloat16* __restrict__ o,
                        float* __restrict__ lse, int sq, int sk, int num_heads, int repeats,
                        int causal, long long o_sb, long long o_sh, long long o_ss,
                        float scale_log2) {
  using S = Smem<D>;
  extern __shared__ uint8_t smem_raw[];
  const S sm(smem_raw);
  const int q0 = blockIdx.x * kBlockRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / repeats;
  const int num_kt = (sk + kKeys - 1) / kKeys;
  const unsigned char* mb = mask == nullptr ? nullptr : mask + (long long)b * sk;

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
    if (threadIdx.x < kProducerThread + 32) {
      const int lane = threadIdx.x - kProducerThread;
      // where every q row of the block keeps a key (an unmasked one, under
      // causal masking at or before the block's first row), a masked or
      // causally excluded key weighs exactly 0: key tiles masked whole, and
      // under causal masking those past the block's last row, are skipped
      bool skip = mb == nullptr;
      if (mb != nullptr) {
        const int limit = causal != 0 ? min(sk, q0 + 1) : sk;
        for (int base = 0; base < limit && !skip; base += 32) {
          skip = __any_sync(0xffffffffu, base + lane < limit && mb[base + lane] != 0);
        }
      }
      const int last_kt =
          skip && causal != 0 ? min(num_kt, (q0 + kBlockRows - 1) / kKeys + 1) : num_kt;
      // key lane and lane + 32 of a tile masked (keys past sk: not masked),
      // read one tile ahead
      auto masked_keys = [&](int kt, bool (&m)[2]) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int key = kt * kKeys + lane + 32 * i;
          m[i] = mb != nullptr && kt < num_kt && key < sk && mb[key] == 0;
        }
      };
      bool next[2];
      masked_keys(0, next);
      if (lane == 0) {
        mbar_arrive_expect_tx(sm.loaded, S::kQBytes);
#pragma unroll
        for (int box = 0; box < S::kBoxes; ++box) {
          tma_load_4d(sm.q + box * kBlockRows * 128, &map_q, sm.loaded, 64 * box, q0, h, b);
        }
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int kt = 0; kt < last_kt; ++kt) {
        const uint32_t lo = __ballot_sync(0xffffffffu, next[0]);
        const uint32_t hi = __ballot_sync(0xffffffffu, next[1]);
        masked_keys(kt + 1, next);
        if (skip && __popc(lo) + __popc(hi) == min(kKeys, sk - kt * kKeys)) continue;
        if (lane == 0) {
          mbar_wait(&sm.empty[stage], phase ^ 1u);
          int* info = sm.info + kInfoInts * stage;
          info[0] = kt;
          info[1] = static_cast<int>(lo);
          info[2] = static_cast<int>(hi);
          uint8_t* dst = sm.stage(stage);
          mbar_arrive_expect_tx(&sm.full[stage], S::kStageBytes);
#pragma unroll
          for (int box = 0; box < S::kBoxes; ++box) {
            tma_load_4d(dst + box * kKeys * 128, &map_k, &sm.full[stage], 64 * box, kt * kKeys,
                        hk, b);
            tma_load_4d(dst + S::kTileBytes + box * kKeys * 128, &map_v, &sm.full[stage],
                        64 * box, kt * kKeys, hk, b);
          }
        }
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1u;
        }
      }
      if (lane == 0) {  // a last stage with no tile ends the consumers' walk
        mbar_wait(&sm.empty[stage], phase ^ 1u);
        sm.info[kInfoInts * stage] = -1;
        mbar_arrive(&sm.full[stage]);
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    // this thread's rows: row and row + 8 ("lo", "hi"); m is the running max
    // of the scaled scores, l this thread's partial running sum
    const int row = q0 + 64 * wg + 16 * (t / 32) + lane / 4;
    float o_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o_acc[i] = 0.f;
    float m_lo = -INFINITY, m_hi = -INFINITY;
    float l_lo = 0.f, l_hi = 0.f;
    const uint64_t desc_q = desc_sw128(sm.q + wg * 64 * 128);
    mbar_wait(sm.loaded, 0);

    // S = Q K^T of the stage's K tile into s, committed as one group
    float s[kKeys / 2];
    auto issue_scores = [&](int st) {
      const uint64_t desc_k = desc_sw128(sm.stage(st));
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_ss<kKeys>(s, desc_q + k_major_step<kBlockRows>(kk),
                        desc_k + k_major_step<kKeys>(kk), kk > 0);
      }
      wgmma_commit();
    };
    // the online softmax of s, key tile kt (its mask words in stage st), in
    // place: s becomes exp2(scaled score - new max); m and l move on; alpha
    // is what O's rows are to be scaled by
    float alpha_lo, alpha_hi;
    auto softmax = [&](int kt, int st) {
      const int* info = sm.info + kInfoInts * st;
      const uint64_t bits = static_cast<uint32_t>(info[1]) |
                            (static_cast<uint64_t>(static_cast<uint32_t>(info[2])) << 32);
      const int k0 = kt * kKeys;
      if (bits == 0 && causal == 0 && k0 + kKeys <= sk) {
#pragma unroll
        for (int i = 0; i < kKeys / 2; ++i) s[i] *= scale_log2;
      } else {
        // scaled scores; a masked or causally excluded key scores kMasked, a
        // key past sk -inf
#pragma unroll
        for (int i = 0; i < kKeys / 2; ++i) {
          const int c = 8 * (i / 4) + 2 * (lane % 4) + (i & 1);
          const int r = row + 8 * ((i / 2) & 1);
          const bool masked = ((bits >> c) & 1u) != 0 || (causal != 0 && k0 + c > r);
          s[i] = k0 + c >= sk ? -INFINITY : (masked ? kMasked : s[i] * scale_log2);
        }
      }
      float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j) {
        mx_lo = fmaxf(mx_lo, fmaxf(s[4 * j], s[4 * j + 1]));
        mx_hi = fmaxf(mx_hi, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
      // finite: key k0 < sk is in every tile; 0 on the first tile (m = -inf)
      alpha_lo = ex2_approx(m_lo - mx_lo);
      alpha_hi = ex2_approx(m_hi - mx_hi);
      m_lo = mx_lo;
      m_hi = mx_hi;
      float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j) {
        s[4 * j] = ex2_approx(s[4 * j] - m_lo);
        s[4 * j + 1] = ex2_approx(s[4 * j + 1] - m_lo);
        s[4 * j + 2] = ex2_approx(s[4 * j + 2] - m_hi);
        s[4 * j + 3] = ex2_approx(s[4 * j + 3] - m_hi);
        sum_lo += s[4 * j] + s[4 * j + 1];
        sum_hi += s[4 * j + 2] + s[4 * j + 3];
      }
      l_lo = l_lo * alpha_lo + sum_lo;
      l_hi = l_hi * alpha_hi + sum_hi;
    };
    auto rescale = [&]() {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o_acc[i] *= (i % 4 < 2) ? alpha_lo : alpha_hi;
    };
    int stage = 0;
    uint32_t phase = 0;
    mbar_wait(&sm.full[0], 0);
    int kt = sm.info[0];
    // per tile: the next tile's S issued, O rescaled, this tile's P V
    // issued; the next tile's softmax runs while P V is on the tensor cores;
    // P is rounded to bf16 once P V has completed
    if (kt >= 0) {
      wgmma_fence();
      issue_scores(0);
      wgmma_wait<0>();
      fence_operands(s);
      softmax(kt, 0);
      uint32_t p_frag[kKeys / 16][4];
      acc_to_a_fragments<kKeys>(p_frag, s);
      int current = 0;
      for (;;) {
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1u;
        }
        mbar_wait(&sm.full[stage], phase);
        kt = sm.info[kInfoInts * stage];
        if (kt < 0) break;
        wgmma_fence();
        issue_scores(stage);
        rescale();
        mma_rs_mn<D, kKeys / 16>(o_acc, p_frag, sm.stage(current) + S::kTileBytes, kKeys * 128);
        wgmma_commit();
        wgmma_wait<1>();  // S
        fence_operands(s);
        softmax(kt, stage);
        wgmma_wait<0>();  // P V
        fence_operands(o_acc);
        if (lane == 0) mbar_arrive(&sm.empty[current]);
        acc_to_a_fragments<kKeys>(p_frag, s);
        current = stage;
      }
      rescale();
      wgmma_fence();
      mma_rs_mn<D, kKeys / 16>(o_acc, p_frag, sm.stage(current) + S::kTileBytes, kKeys * 128);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(o_acc);
    }

    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
    const float inv_lo = 1.f / fmaxf(l_lo, 1e-30f);
    const float inv_hi = 1.f / fmaxf(l_hi, 1e-30f);
    __nv_bfloat16* lo = o + b * o_sb + h * o_sh + (long long)row * o_ss + 2 * (lane % 4);
    __nv_bfloat16* hi = lo + 8 * o_ss;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      if (row < sq) {
        *reinterpret_cast<uint32_t*>(lo + 8 * j) =
            pack_bf16x2(o_acc[4 * j] * inv_lo, o_acc[4 * j + 1] * inv_lo);
      }
      if (row + 8 < sq) {
        *reinterpret_cast<uint32_t*>(hi + 8 * j) =
            pack_bf16x2(o_acc[4 * j + 2] * inv_hi, o_acc[4 * j + 3] * inv_hi);
      }
    }
    if (lse != nullptr && lane % 4 == 0) {
      const float ln2 = 0.69314718055994531f;
      float* lh = lse + ((long long)b * num_heads + h) * sq;
      if (row < sq) lh[row] = (m_lo + log2f(fmaxf(l_lo, 1e-30f))) * ln2;
      if (row + 8 < sq) lh[row + 8] = (m_hi + log2f(fmaxf(l_hi, 1e-30f))) * ln2;
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const unsigned char* mask,
           __nv_bfloat16* o, float* lse, int batch, int sq, int sk, int num_heads,
           int num_kv_heads, int causal, const long long (&st)[12], float scale_log2,
           cudaStream_t stream) {
  CUtensorMap map_q, map_k, map_v;
  int err = make_map_4d(&map_q, q, batch, num_heads, sq, D, st[0], st[1], st[2], kBlockRows);
  if (!err) err = make_map_4d(&map_k, k, batch, num_kv_heads, sk, D, st[3], st[4], st[5], kKeys);
  if (!err) err = make_map_4d(&map_v, v, batch, num_kv_heads, sk, D, st[6], st[7], st[8], kKeys);
  if (!err) err = allow_dynamic_smem<flash_fwd_masked_kernel<D>>(Smem<D>::kBytes);
  if (err) return err;
  const dim3 grid((sq + kBlockRows - 1) / kBlockRows, num_heads, batch);
  flash_fwd_masked_kernel<D><<<grid, kThreads, Smem<D>::kBytes, stream>>>(
      map_q, map_k, map_v, mask, o, lse, sq, sk, num_heads, num_heads / num_kv_heads, causal,
      st[9], st[10], st[11], scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry, bound with ctypes. Strides are in elements, (batch, head, row) for
// each of q, k, v and o; the last axis is contiguous and every stride and
// base is 16-byte aligned (the wrapper checks both). k and v have
// num_kv_heads heads, a divisor of num_heads. `mask` (B, Sk) bytes and `lse`
// (B, H, Sq) fp32, both contiguous, may be null. Launches on `stream` and
// returns the first error: of the tensor maps' encoding, of the
// shared-memory attribute, or cudaGetLastError() after the launch.
extern "C" int flash_attention_masked_fwd(
    const void* q, const void* k, const void* v, const void* mask, void* o, void* lse, int batch,
    int sq, int sk, int num_heads, int num_kv_heads, int head_dim, int causal, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, long long o_sb, long long o_sh,
    long long o_ss, float scale, void* stream) {
  if (num_kv_heads < 1 || num_heads % num_kv_heads != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long st[12] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss};
  const float scale_log2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* mb = static_cast<const unsigned char*>(mask);
  auto* ob = static_cast<__nv_bfloat16*>(o);
  auto* lb = static_cast<float*>(lse);
  switch (head_dim) {
    case 64:
      return launch<64>(q, k, v, mb, ob, lb, batch, sq, sk, num_heads, num_kv_heads, causal, st,
                         scale_log2, s);
    case 96:
      return launch<96>(q, k, v, mb, ob, lb, batch, sq, sk, num_heads, num_kv_heads, causal, st,
                         scale_log2, s);
    case 128:
      return launch<128>(q, k, v, mb, ob, lb, batch, sq, sk, num_heads, num_kv_heads, causal, st,
                         scale_log2, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
