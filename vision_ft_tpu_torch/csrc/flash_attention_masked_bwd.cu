// Key-masked flash attention backward over (B, H, S, D) for Hopper
// (sm_90a), CUDA C++.
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
// get P = 0 and their dq rows are never written.
//
// What bounds it on an H100: the tensor cores. Per score pair the dk/dv
// kernel does four D-deep products (S^T, dP^T, dV, dK), the dq kernel three
// (S, dP, dQ), against 2 bytes of each of q, k, v, dO, dq, dk, dv per row
// and head: 8*pairs*D + 6*pairs*D operations over the pairs the masks
// leave. P and dS, the S x S matrices, never leave the registers.
//
// Design: kernel C's two-kernel scheme (flash_attention_bshd_bwd.cu), each
// kernel owning its outputs outright (no atomics: reruns are bit-identical),
// at the cost of recomputing S and dP in both, over (batch, head, row)
// strides so the (B, S, heads, D) memory of the fused qkv projection is read
// in place:
//   - dk/dv kernel: one block of 4 warps per (batch, kv head, 64-key tile),
//     each warp owning 16 keys whose K and V fragments stay in registers;
//     a loop over the repeats query heads of the group and over the 64-row
//     q tiles computes the TRANSPOSED tiles S^T = K Q^T and dP^T = V dO^T,
//     so P^T and dS^T leave the accumulators as the A operand of
//     dV += P^T dO and dK += dS^T Q. A thread's two keys have their mask
//     bits in registers; lse and delta are per-column values in shared
//     memory.
//   - dq kernel: one block per (batch, query head, 64-row q tile), a loop
//     over 64-key tiles: S = Q K^T, dP = dO V^T, dQ += dS K, with the Q and
//     dO fragments, lse and delta in registers and the key tile's mask row
//     in shared memory.
//   - bf16 mma.sync m16n8k16 with fp32 accumulators; exp runs as exp2 with
//     log2(e) folded into the scale, the masked score and lse (lse * log2 e
//     rounded on its own, never fused into the subtraction, so that a fully
//     masked row's exponent is exactly 0). Head dims 64, 96 and 128: with
//     the 8-element row padding the shared rows are 36, 52 and 68 words
//     long, so fragment loads stay free of bank conflicts.
// Not carried over from the TPU kernel: the fused-dq variant (a grid-
// persistent fp32 dq, which needs atomics here), the 8-sublane lse/delta
// replication and the padding of q, k and v in device memory. Left for later
// work: skipping key tiles that are masked whole or lie past the causal
// diagonal, cp.async/TMA double buffering, wgmma, ldmatrix.

#include "flash_attention_bshd.cuh"

namespace {

using namespace bshd;

constexpr float kLog2e = 1.4426950408889634f;
// -1e30 in the exp2 domain: the forward's masked score, so exp2(kMasked -
// lse * log2 e) is exactly 1 for a row whose keys are all masked
constexpr float kMasked = -1.4426950408889634e30f;

// Shared memory of the two kernels, in bytes (dynamic: past 48 KB at D >= 96).
template <int D>
constexpr int dkv_smem_bytes() {
  return (2 * kBlockQ * (D + kPad) + 2 * D * (kBlockQ + kPad)) * 2 + 2 * kBlockQ * 4;
}
template <int D>
constexpr int dq_smem_bytes() {
  return (2 * kBlockK * (D + kPad) + D * (kBlockK + kPad)) * 2 + kBlockK;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_masked_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const unsigned char* __restrict__ mask,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int sq, int sk, int num_heads, int repeats, int causal,
    long long q_sb, long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss, long long do_sb,
    long long do_sh, long long do_ss, long long dk_sb, long long dk_sh, long long dk_ss,
    long long dv_sb, long long dv_sh, long long dv_ss, float scale) {
  constexpr int kLdR = D + kPad;        // row-major tiles: [row][d]
  constexpr int kLdT = kBlockQ + kPad;  // transposed tiles: [d][row]
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sdO = sQ + kBlockQ * kLdR;
  __nv_bfloat16* sQt = sdO + kBlockQ * kLdR;
  __nv_bfloat16* sdOt = sQt + D * kLdT;
  float* sLse = reinterpret_cast<float*>(sdOt + D * kLdT);  // log2 domain
  float* sDelta = sLse + kBlockQ;

  const int k0 = blockIdx.x * kBlockK;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const float scale_log2 = scale * kLog2e;

  // this block's K and V tiles -> shared (through the Q and dO buffers) ->
  // A fragments in registers for the whole loop
  stage_tile<D, true, false, kLdR, 0>(sQ, nullptr, k + b * k_sb + hk * k_sh, k_ss, k0, sk);
  stage_tile<D, true, false, kLdR, 0>(sdO, nullptr, v + b * v_sb + hk * v_sh, v_ss, k0, sk);
  __syncthreads();
  uint32_t kf[D / 16][4], vf[D / 16][4];
  load_a_fragments<D, kLdR>(kf, sQ, warp, g, t);
  load_a_fragments<D, kLdR>(vf, sdO, warp, g, t);

  // this thread's two keys (rows g and g + 8 of the warp's 16); keys at or
  // past sk are never written, so their scores need no masking
  const int key_lo = k0 + warp * 16 + g;
  const int key_hi = key_lo + 8;
  const unsigned char* mb = mask == nullptr ? nullptr : mask + (long long)b * sk;
  const bool masked_lo = mb != nullptr && key_lo < sk && mb[key_lo] == 0;
  const bool masked_hi = mb != nullptr && key_hi < sk && mb[key_hi] == 0;

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    dk_acc[n][0] = dk_acc[n][1] = dk_acc[n][2] = dk_acc[n][3] = 0.f;
    dv_acc[n][0] = dv_acc[n][1] = dv_acc[n][2] = dv_acc[n][3] = 0.f;
  }

  const int num_qt = (sq + kBlockQ - 1) / kBlockQ;
  for (int r = 0; r < repeats; ++r) {
    const int h = hk * repeats + r;
    const __nv_bfloat16* qh = q + b * q_sb + h * q_sh;
    const __nv_bfloat16* doh = dout + b * do_sb + h * do_sh;
    const float* lse_h = lse + ((long long)b * num_heads + h) * sq;
    const float* delta_h = delta + ((long long)b * num_heads + h) * sq;
    for (int qt = 0; qt < num_qt; ++qt) {
      const int q0 = qt * kBlockQ;
      __syncthreads();  // every warp is done with the previous tile
      stage_tile<D, true, true, kLdR, kLdT>(sQ, sQt, qh, q_ss, q0, sq);
      stage_tile<D, true, true, kLdR, kLdT>(sdO, sdOt, doh, do_ss, q0, sq);
      if (threadIdx.x < kBlockQ) {
        const int row = q0 + threadIdx.x;
        sLse[threadIdx.x] = row < sq ? __fmul_rn(lse_h[row], kLog2e) : 0.f;
        sDelta[threadIdx.x] = row < sq ? delta_h[row] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys x 64 q rows
      float s[kBlockQ / 8][4], dp[kBlockQ / 8][4];
#pragma unroll
      for (int j = 0; j < kBlockQ / 8; ++j) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
        dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
        const __nv_bfloat16* qb = sQ + (j * 8 + g) * kLdR + 2 * t;
        const __nv_bfloat16* dob = sdO + (j * 8 + g) * kLdR + 2 * t;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          mma_16816(s[j], kf[kk], lds32(qb + kk * 16), lds32(qb + kk * 16 + 8));
          mma_16816(dp[j], vf[kk], lds32(dob + kk * 16), lds32(dob + kk * 16 + 8));
        }
      }

      // P^T = exp(S^T - lse[q]) with the masked scores (0 on padded q rows),
      // dS^T = P^T * (dP^T - delta[q]) * scale; columns are q rows here
#pragma unroll
      for (int j = 0; j < kBlockQ / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = j * 8 + 2 * t + (e & 1);
          const int row = q0 + col;
          const int key = e < 2 ? key_lo : key_hi;
          const bool masked = (e < 2 ? masked_lo : masked_hi) || (causal != 0 && key > row);
          const float sv = masked ? kMasked : s[j][e] * scale_log2;
          const float p = row < sq ? exp2f(sv - sLse[col]) : 0.f;
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - sDelta[col]) * scale;
        }
      }

      // dV += P^T dO and dK += dS^T Q: the accumulators of q tiles 2kk and
      // 2kk+1 are the A fragment of one 16-row step
#pragma unroll
      for (int kk = 0; kk < kBlockQ / 16; ++kk) {
        uint32_t pf[4], dsf[4];
        pf[0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
        pf[1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
        pf[2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pf[3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
        dsf[0] = pack_bf16x2(dp[2 * kk][0], dp[2 * kk][1]);
        dsf[1] = pack_bf16x2(dp[2 * kk][2], dp[2 * kk][3]);
        dsf[2] = pack_bf16x2(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
        dsf[3] = pack_bf16x2(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          const __nv_bfloat16* dob = sdOt + (n * 8 + g) * kLdT + kk * 16 + 2 * t;
          const __nv_bfloat16* qb = sQt + (n * 8 + g) * kLdT + kk * 16 + 2 * t;
          mma_16816(dv_acc[n], pf, lds32(dob), lds32(dob + 8));
          mma_16816(dk_acc[n], dsf, lds32(qb), lds32(qb + 8));
        }
      }
    }
  }

  __nv_bfloat16* dkh = dk + b * dk_sb + hk * dk_sh + 2 * t;
  __nv_bfloat16* dvh = dv + b * dv_sb + hk * dv_sh + 2 * t;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    if (key_lo < sk) {
      *reinterpret_cast<uint32_t*>(dkh + (long long)key_lo * dk_ss + n * 8) =
          pack_bf16x2(dk_acc[n][0], dk_acc[n][1]);
      *reinterpret_cast<uint32_t*>(dvh + (long long)key_lo * dv_ss + n * 8) =
          pack_bf16x2(dv_acc[n][0], dv_acc[n][1]);
    }
    if (key_hi < sk) {
      *reinterpret_cast<uint32_t*>(dkh + (long long)key_hi * dk_ss + n * 8) =
          pack_bf16x2(dk_acc[n][2], dk_acc[n][3]);
      *reinterpret_cast<uint32_t*>(dvh + (long long)key_hi * dv_ss + n * 8) =
          pack_bf16x2(dv_acc[n][2], dv_acc[n][3]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_masked_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const unsigned char* __restrict__ mask,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int sq, int sk,
    int num_heads, int repeats, int causal, long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, long long do_sb, long long do_sh, long long do_ss, long long dq_sb,
    long long dq_sh, long long dq_ss, float scale) {
  constexpr int kLdR = D + kPad;        // sK[key][d], sV[key][d]
  constexpr int kLdT = kBlockK + kPad;  // sKt[d][key]
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sV = sK + kBlockK * kLdR;
  __nv_bfloat16* sKt = sV + kBlockK * kLdR;
  unsigned char* sMasked = reinterpret_cast<unsigned char*>(sKt + D * kLdT);  // 1 = masked key

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / repeats;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const float scale_log2 = scale * kLog2e;

  const __nv_bfloat16* kh = k + b * k_sb + hk * k_sh;
  const __nv_bfloat16* vh = v + b * v_sb + hk * v_sh;
  const unsigned char* mb = mask == nullptr ? nullptr : mask + (long long)b * sk;
  const float* lse_h = lse + ((long long)b * num_heads + h) * sq;
  const float* delta_h = delta + ((long long)b * num_heads + h) * sq;

  // this block's Q and dO tiles -> shared (through the K and V buffers) ->
  // A fragments in registers for the whole loop
  stage_tile<D, true, false, kLdR, 0>(sK, nullptr, q + b * q_sb + h * q_sh, q_ss, q0, sq);
  stage_tile<D, true, false, kLdR, 0>(sV, nullptr, dout + b * do_sb + h * do_sh, do_ss, q0, sq);
  __syncthreads();
  uint32_t qf[D / 16][4], dof[D / 16][4];
  load_a_fragments<D, kLdR>(qf, sK, warp, g, t);
  load_a_fragments<D, kLdR>(dof, sV, warp, g, t);

  const int row_lo = q0 + warp * 16 + g;
  const int row_hi = row_lo + 8;
  const float lse_lo = row_lo < sq ? __fmul_rn(lse_h[row_lo], kLog2e) : 0.f;  // log2 domain
  const float lse_hi = row_hi < sq ? __fmul_rn(lse_h[row_hi], kLog2e) : 0.f;
  const float delta_lo = row_lo < sq ? delta_h[row_lo] : 0.f;
  const float delta_hi = row_hi < sq ? delta_h[row_hi] : 0.f;

  float dq_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) dq_acc[n][0] = dq_acc[n][1] = dq_acc[n][2] = dq_acc[n][3] = 0.f;

  const int num_kt = (sk + kBlockK - 1) / kBlockK;
  for (int kt = 0; kt < num_kt; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // every warp is done with the previous tile
    stage_tile<D, true, true, kLdR, kLdT>(sK, sKt, kh, k_ss, k0, sk);
    stage_tile<D, true, false, kLdR, 0>(sV, nullptr, vh, v_ss, k0, sk);
    if (threadIdx.x < kBlockK) {
      const int key = k0 + threadIdx.x;
      sMasked[threadIdx.x] = (mb != nullptr && key < sk && mb[key] == 0) ? 1 : 0;
    }
    __syncthreads();

    // S = Q K^T and dP = dO V^T for this warp's 16 q rows x 64 keys
    float s[kBlockK / 8][4], dp[kBlockK / 8][4];
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
      const __nv_bfloat16* kb = sK + (j * 8 + g) * kLdR + 2 * t;
      const __nv_bfloat16* vb = sV + (j * 8 + g) * kLdR + 2 * t;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        mma_16816(s[j], qf[kk], lds32(kb + kk * 16), lds32(kb + kk * 16 + 8));
        mma_16816(dp[j], dof[kk], lds32(vb + kk * 16), lds32(vb + kk * 16 + 8));
      }
    }

    // P = exp(S - lse[q]) with the masked scores (0 on padded keys),
    // dS = P (dP - delta[q]) scale
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + 2 * t + (e & 1);
        const int key = k0 + c;
        const int row = e < 2 ? row_lo : row_hi;
        const bool masked = sMasked[c] != 0 || (causal != 0 && key > row);
        const float sv = masked ? kMasked : s[j][e] * scale_log2;
        const float p = key < sk ? exp2f(sv - (e < 2 ? lse_lo : lse_hi)) : 0.f;
        dp[j][e] = p * (dp[j][e] - (e < 2 ? delta_lo : delta_hi)) * scale;
      }
    }

    // dQ += dS K
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      uint32_t dsf[4];
      dsf[0] = pack_bf16x2(dp[2 * kk][0], dp[2 * kk][1]);
      dsf[1] = pack_bf16x2(dp[2 * kk][2], dp[2 * kk][3]);
      dsf[2] = pack_bf16x2(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
      dsf[3] = pack_bf16x2(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const __nv_bfloat16* kb = sKt + (n * 8 + g) * kLdT + kk * 16 + 2 * t;
        mma_16816(dq_acc[n], dsf, lds32(kb), lds32(kb + 8));
      }
    }
  }

  __nv_bfloat16* dqh = dq + b * dq_sb + h * dq_sh + 2 * t;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    if (row_lo < sq) {
      *reinterpret_cast<uint32_t*>(dqh + (long long)row_lo * dq_ss + n * 8) =
          pack_bf16x2(dq_acc[n][0], dq_acc[n][1]);
    }
    if (row_hi < sq) {
      *reinterpret_cast<uint32_t*>(dqh + (long long)row_hi * dq_ss + n * 8) =
          pack_bf16x2(dq_acc[n][2], dq_acc[n][3]);
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                              cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

// C entries, bound with ctypes. Strides are in elements, (batch, head, row)
// for each bf16 tensor; the last axis is contiguous and every row and head
// offset is 16-byte aligned (the wrapper checks both). k, v, dk and dv have
// num_kv_heads heads, a divisor of num_heads. `mask` (B, Sk) bytes may be
// null; lse and delta are contiguous fp32 (B, H, Sq). Each launches on
// `stream` and returns cudaGetLastError().

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
  const dim3 grid((sk + kBlockK - 1) / kBlockK, num_kv_heads, batch);
  const int repeats = num_heads / num_kv_heads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  const auto* mb = static_cast<const unsigned char*>(mask);
  const auto* dob = static_cast<const __nv_bfloat16*>(dout);
  const auto* lb = static_cast<const float*>(lse);
  const auto* db = static_cast<const float*>(delta);
  auto* dkb = static_cast<__nv_bfloat16*>(dk);
  auto* dvb = static_cast<__nv_bfloat16*>(dv);
  cudaError_t err = cudaSuccess;
#define LAUNCH_DKV(D)                                                                          \
  err = allow_smem(flash_bwd_dkv_masked_kernel<D>, dkv_smem_bytes<D>());                      \
  if (err != cudaSuccess) return static_cast<int>(err);                                        \
  flash_bwd_dkv_masked_kernel<D><<<grid, kThreads, dkv_smem_bytes<D>(), s>>>(                 \
      qb, kb, vb, mb, dob, lb, db, dkb, dvb, sq, sk, num_heads, repeats, causal, q_sb, q_sh,   \
      q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, do_sb, do_sh, do_ss, dk_sb, dk_sh, dk_ss,      \
      dv_sb, dv_sh, dv_ss, scale)
  switch (head_dim) {
    case 64:
      LAUNCH_DKV(64);
      break;
    case 96:
      LAUNCH_DKV(96);
      break;
    case 128:
      LAUNCH_DKV(128);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef LAUNCH_DKV
  return static_cast<int>(cudaGetLastError());
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
  const dim3 grid((sq + kBlockQ - 1) / kBlockQ, num_heads, batch);
  const int repeats = num_heads / num_kv_heads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  const auto* mb = static_cast<const unsigned char*>(mask);
  const auto* dob = static_cast<const __nv_bfloat16*>(dout);
  const auto* lb = static_cast<const float*>(lse);
  const auto* db = static_cast<const float*>(delta);
  auto* dqb = static_cast<__nv_bfloat16*>(dq);
  cudaError_t err = cudaSuccess;
#define LAUNCH_DQ(D)                                                                           \
  err = allow_smem(flash_bwd_dq_masked_kernel<D>, dq_smem_bytes<D>());                        \
  if (err != cudaSuccess) return static_cast<int>(err);                                        \
  flash_bwd_dq_masked_kernel<D><<<grid, kThreads, dq_smem_bytes<D>(), s>>>(                   \
      qb, kb, vb, mb, dob, lb, db, dqb, sq, sk, num_heads, repeats, causal, q_sb, q_sh, q_ss,  \
      k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, do_sb, do_sh, do_ss, dq_sb, dq_sh, dq_ss, scale)
  switch (head_dim) {
    case 64:
      LAUNCH_DQ(64);
      break;
    case 96:
      LAUNCH_DQ(96);
      break;
    case 128:
      LAUNCH_DQ(128);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef LAUNCH_DQ
  return static_cast<int>(cudaGetLastError());
}
