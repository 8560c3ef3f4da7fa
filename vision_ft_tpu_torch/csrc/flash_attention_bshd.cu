// BSHD flash attention forward for Hopper (sm_90a), CUDA C++.
//
// Replaces vision_ft_tpu/ops/pallas/flash_attention.py::_fwd_kernel_bshd
// (launched by _flash_fwd_bshd, entry flash_attention_bshd).
//
// Computes, per batch b and head h, out = softmax(q k^T * scale) v, and
// optionally lse = log(sum(exp(q k^T * scale))) in fp32 as (B, H, Sq),
// straight from heads-packed (B, S, H*D) tensors: head h is the columns
// [h*D, (h+1)*D) of each row, addressed through the row strides, so no
// head transpose ever touches device memory. bf16 in and out; the running
// max, running sum and output accumulator are fp32.
//
// What bounds it on an H100: the tensor cores. For SDXL self-attention
// (D = 64, Sq = Sk = 1024 or 4096) the two matmuls do 4*Sq*Sk*D flops per
// head against 4*S*D bytes of q/k/v/out traffic, hundreds of flops per
// byte, above the card's balance point; the score matrix is the traffic a
// naive kernel would add, and this kernel never writes it.
//
// Design:
//   - One thread block of 4 warps owns one (batch, head, 64-row q tile);
//     each warp owns 16 q rows. A loop over 64-key tiles inside the block
//     replaces the TPU kernel's sequential grid axis.
//   - Q·K^T and P·V run on the tensor cores with bf16 mma.sync m16n8k16
//     and fp32 accumulators. The q fragments stay in registers for the
//     whole loop; the P fragments are built from the score accumulators
//     in registers (FA2 layout), so P never leaves the warp.
//   - K tiles are staged row-major and V tiles transposed in shared
//     memory, so every mma operand is one 32-bit shared load.
//   - Online softmax in the exp2 domain (scale folded with log2 e); each
//     thread keeps partial row sums and the quad reduces them once at the
//     end.
//   - Ragged lengths are masked in the kernel: keys at or past sk score
//     -inf (p = 0) and their V rows are staged as zeros, never read from
//     memory; q rows at or past sq are neither read nor written.
// Not carried over from the TPU kernel: lane-aligned two-head groups, the
// V-ones row sum, the 8-sublane lse broadcast and the VFT_FLASH_* levers.
// Left for later work: cp.async/TMA double buffering, wgmma, ldmatrix.

#include "flash_attention_bshd.cuh"

namespace {

using namespace bshd;

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bshd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                      float* __restrict__ lse, int sq, int sk, int num_heads,
                      long long q_sb, long long q_ss, long long k_sb, long long k_ss,
                      long long v_sb, long long v_ss, long long o_sb, long long o_ss,
                      float scale_log2) {
  constexpr int kLdK = D + kPad;        // sK[key][d]
  constexpr int kLdV = kBlockK + kPad;  // sVt[d][key]
  __shared__ __align__(16) __nv_bfloat16 sK[kBlockK * kLdK];
  __shared__ __align__(16) __nv_bfloat16 sVt[D * kLdV];

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // row within the 8-row mma group
  const int t = lane % 4;  // column pair within the quad

  const __nv_bfloat16* qh = q + b * q_sb + (long long)h * D;
  const __nv_bfloat16* kh = k + b * k_sb + (long long)h * D;
  const __nv_bfloat16* vh = v + b * v_sb + (long long)h * D;

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

  const int num_kt = (sk + kBlockK - 1) / kBlockK;
  for (int kt = 0; kt < num_kt; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // every warp is done with the previous tile
    stage_tile<D, true, false, kLdK, 0>(sK, nullptr, kh, k_ss, k0, sk);
    stage_tile<D, false, true, 0, kLdV>(nullptr, sVt, vh, v_ss, k0, sk);
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

    // scale, mask ragged keys, running max
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) {
      const int key = k0 + j * 8 + 2 * t;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool valid = key + (e & 1) < sk;
        s[j][e] = valid ? s[j][e] * scale_log2 : -INFINITY;
      }
      mx_lo = fmaxf(mx_lo, fmaxf(s[j][0], s[j][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[j][2], s[j][3]));
    }
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
    const float mn_lo = fmaxf(m_lo, mx_lo);  // finite: key k0 is always valid
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

  const int row_lo = q0 + warp * 16 + g;
  const int row_hi = row_lo + 8;
  __nv_bfloat16* oh = o + b * o_sb + (long long)h * D + 2 * t;
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

// C entry, bound with ctypes. Strides are in elements; the last dimension
// is contiguous and every row and head offset is 16-byte aligned (the
// wrapper checks both). `lse` may be null. Launches on `stream` and
// returns cudaGetLastError().
extern "C" int flash_attention_bshd_fwd(const void* q, const void* k, const void* v, void* o,
                                        void* lse, int batch, int sq, int sk, int num_heads,
                                        int head_dim, long long q_sb, long long q_ss,
                                        long long k_sb, long long k_ss, long long v_sb,
                                        long long v_ss, long long o_sb, long long o_ss,
                                        float scale, void* stream) {
  const dim3 grid((sq + kBlockQ - 1) / kBlockQ, num_heads, batch);
  const float scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  auto* ob = static_cast<__nv_bfloat16*>(o);
  auto* lb = static_cast<float*>(lse);
  switch (head_dim) {
    case 64:
      flash_fwd_bshd_kernel<64><<<grid, kThreads, 0, s>>>(
          qb, kb, vb, ob, lb, sq, sk, num_heads, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb,
          o_ss, scale_log2);
      break;
    case 128:
      flash_fwd_bshd_kernel<128><<<grid, kThreads, 0, s>>>(
          qb, kb, vb, ob, lb, sq, sk, num_heads, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb,
          o_ss, scale_log2);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
