// Key-masked flash attention forward over (B, H, S, D) for Hopper (sm_90a),
// CUDA C++.
//
// Replaces vision_ft_tpu/ops/pallas/flash_attention.py::_fwd_kernel
// (launched by _flash_fwd, entry flash_attention_tpu).
//
// Computes, per batch b and query head h,
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
//   - ragged lengths: keys at or past sk are left out altogether (-inf, and
//     their V rows are staged as zeros, never read); q rows at or past sq
//     are neither read nor written.
//
// Layout: every tensor is addressed through (batch, head, row) strides with
// a contiguous last axis, so a (B, S, H, D) buffer seen as (B, H, S, D), or
// the v slice of a fused qkv projection, is read in place. Grouped-query
// attention needs no repeated k/v: query head h reads kv head h / repeats.
//
// What bounds it on an H100: the tensor cores (4*Sq*Sk*D operations a head
// against 2*(Sq + Sk)*D*2 bytes). Design, shared with the BSHD forward
// (flash_attention_bshd.cu): one block of 4 warps per (batch, head, 64-row
// q tile), a loop over 64-key tiles, bf16 mma.sync m16n8k16 with fp32
// accumulators, q and P fragments in registers, K row-major and V transposed
// in shared memory, online softmax in the exp2 domain. Head dims 64, 96 and
// 128: with the 8-element row padding the shared rows are 36, 52 and 68
// words long, which keeps each fragment load free of bank conflicts for all
// three. The mask row of a key tile is staged in shared memory with the
// tile. Not carried over from the TPU kernel: the V-ones row sum, the
// 8-sublane bias and lse replication, the k/v padding in device memory and
// the VFT_FLASH_* levers. Left for later work: skipping key tiles that are
// masked whole or lie past the causal diagonal, cp.async/TMA double
// buffering, wgmma.

#include "flash_attention_bshd.cuh"

namespace {

using namespace bshd;

// -1e30 in the exp2 domain (scores are scaled by scale * log2 e)
constexpr float kMasked = -1.4426950408889634e30f;

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_masked_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const unsigned char* __restrict__ mask, __nv_bfloat16* __restrict__ o,
                        float* __restrict__ lse, int sq, int sk, int num_heads, int repeats,
                        int causal, long long q_sb, long long q_sh, long long q_ss,
                        long long k_sb, long long k_sh, long long k_ss, long long v_sb,
                        long long v_sh, long long v_ss, long long o_sb, long long o_sh,
                        long long o_ss, float scale_log2) {
  constexpr int kLdK = D + kPad;        // sK[key][d]
  constexpr int kLdV = kBlockK + kPad;  // sVt[d][key]
  __shared__ __align__(16) __nv_bfloat16 sK[kBlockK * kLdK];
  __shared__ __align__(16) __nv_bfloat16 sVt[D * kLdV];
  __shared__ unsigned char sMasked[kBlockK];  // 1 = this key is masked out

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / repeats;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // row within the 8-row mma group
  const int t = lane % 4;  // column pair within the quad

  const __nv_bfloat16* qh = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kh = k + b * k_sb + hk * k_sh;
  const __nv_bfloat16* vh = v + b * v_sb + hk * v_sh;
  const unsigned char* mb = mask == nullptr ? nullptr : mask + (long long)b * sk;

  // q tile -> shared (through the K buffer) -> A fragments in registers
  stage_tile<D, true, false, kLdK, 0>(sK, nullptr, qh, q_ss, q0, sq);
  __syncthreads();
  uint32_t qf[D / 16][4];
  load_a_fragments<D, kLdK>(qf, sK, warp, g, t);

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY;  // rows g and g + 8, log2 domain
  float l_lo = 0.f, l_hi = 0.f;              // this thread's partial row sums
  const int row_lo = q0 + warp * 16 + g;
  const int row_hi = row_lo + 8;

  const int num_kt = (sk + kBlockK - 1) / kBlockK;
  for (int kt = 0; kt < num_kt; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // every warp is done with the previous tile
    stage_tile<D, true, false, kLdK, 0>(sK, nullptr, kh, k_ss, k0, sk);
    stage_tile<D, false, true, 0, kLdV>(nullptr, sVt, vh, v_ss, k0, sk);
    if (threadIdx.x < kBlockK) {
      const int key = k0 + threadIdx.x;
      sMasked[threadIdx.x] = (mb != nullptr && key < sk && mb[key] == 0) ? 1 : 0;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[kBlockK / 8][4];
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const __nv_bfloat16* kb = sK + (j * 8 + g) * kLdK + 2 * t;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        mma_16816(s[j], qf[kk], lds32(kb + kk * 16), lds32(kb + kk * 16 + 8));
      }
    }

    // scale; mask row and causal as a finite -1e30, ragged keys as -inf
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) {
      const int col = j * 8 + 2 * t;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = col + (e & 1);
        const int key = k0 + c;
        const int row = (e < 2) ? row_lo : row_hi;
        float sv = s[j][e] * scale_log2;
        if (sMasked[c] != 0 || (causal != 0 && key > row)) sv = kMasked;
        s[j][e] = key < sk ? sv : -INFINITY;
      }
      mx_lo = fmaxf(mx_lo, fmaxf(s[j][0], s[j][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[j][2], s[j][3]));
    }
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
    const float mn_lo = fmaxf(m_lo, mx_lo);  // finite: key k0 is below sk
    const float mn_hi = fmaxf(m_hi, mx_hi);
    const float alpha_lo = exp2f(m_lo - mn_lo);
    const float alpha_hi = exp2f(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;

    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) {
      s[j][0] = exp2f(s[j][0] - mn_lo);
      s[j][1] = exp2f(s[j][1] - mn_lo);
      s[j][2] = exp2f(s[j][2] - mn_hi);
      s[j][3] = exp2f(s[j][3] - mn_hi);
      sum_lo += s[j][0] + s[j][1];
      sum_hi += s[j][2] + s[j][3];
    }
    l_lo = l_lo * alpha_lo + sum_lo;
    l_hi = l_hi * alpha_hi + sum_hi;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= alpha_lo;
      acc[n][1] *= alpha_lo;
      acc[n][2] *= alpha_hi;
      acc[n][3] *= alpha_hi;
    }

    // O += P V: the score accumulators of key tiles 2kk and 2kk+1 are the
    // A fragment of one 16-key step
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      uint32_t pf[4];
      pf[0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
      pf[1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
      pf[2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pf[3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const __nv_bfloat16* vb = sVt + (n * 8 + g) * kLdV + kk * 16 + 2 * t;
        mma_16816(acc[n], pf, lds32(vb), lds32(vb + 8));
      }
    }
  }

  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
  const float inv_lo = 1.f / fmaxf(l_lo, 1e-30f);
  const float inv_hi = 1.f / fmaxf(l_hi, 1e-30f);

  __nv_bfloat16* oh = o + b * o_sb + h * o_sh + 2 * t;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    if (row_lo < sq) {
      *reinterpret_cast<uint32_t*>(oh + (long long)row_lo * o_ss + n * 8) =
          pack_bf16x2(acc[n][0] * inv_lo, acc[n][1] * inv_lo);
    }
    if (row_hi < sq) {
      *reinterpret_cast<uint32_t*>(oh + (long long)row_hi * o_ss + n * 8) =
          pack_bf16x2(acc[n][2] * inv_hi, acc[n][3] * inv_hi);
    }
  }
  if (lse != nullptr && t == 0) {
    const float ln2 = 0.69314718055994531f;
    float* lh = lse + ((long long)b * num_heads + h) * sq;
    if (row_lo < sq) lh[row_lo] = (m_lo + log2f(fmaxf(l_lo, 1e-30f))) * ln2;
    if (row_hi < sq) lh[row_hi] = (m_hi + log2f(fmaxf(l_hi, 1e-30f))) * ln2;
  }
}

}  // namespace

// C entry, bound with ctypes. Strides are in elements, (batch, head, row) for
// each of q, k, v and o; the last axis is contiguous and every row and head
// offset is 16-byte aligned (the wrapper checks both). k and v have
// num_kv_heads heads, a divisor of num_heads. `mask` (B, Sk) bytes and `lse`
// (B, H, Sq) fp32, both contiguous, may be null. Launches on `stream` and
// returns cudaGetLastError().
extern "C" int flash_attention_masked_fwd(
    const void* q, const void* k, const void* v, const void* mask, void* o, void* lse, int batch,
    int sq, int sk, int num_heads, int num_kv_heads, int head_dim, int causal, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, long long o_sb, long long o_sh,
    long long o_ss, float scale, void* stream) {
  if (num_kv_heads < 1 || num_heads % num_kv_heads != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((sq + kBlockQ - 1) / kBlockQ, num_heads, batch);
  const float scale_log2 = scale * 1.4426950408889634f;
  const int repeats = num_heads / num_kv_heads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  const auto* mb = static_cast<const unsigned char*>(mask);
  auto* ob = static_cast<__nv_bfloat16*>(o);
  auto* lb = static_cast<float*>(lse);
#define LAUNCH_MASKED(D)                                                                     \
  flash_fwd_masked_kernel<D><<<grid, kThreads, 0, s>>>(                                      \
      qb, kb, vb, mb, ob, lb, sq, sk, num_heads, repeats, causal, q_sb, q_sh, q_ss, k_sb,    \
      k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss, scale_log2)
  switch (head_dim) {
    case 64:
      LAUNCH_MASKED(64);
      break;
    case 96:
      LAUNCH_MASKED(96);
      break;
    case 128:
      LAUNCH_MASKED(128);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef LAUNCH_MASKED
  return static_cast<int>(cudaGetLastError());
}
