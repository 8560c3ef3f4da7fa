// Short-K attention over (B, H, S, D) for Hopper (sm_90a), CUDA C++: the
// forward (kernel H) and its backward (kernel I).
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
// Keys are padded to SKP, a multiple of 32 (a template parameter, so every
// per-key array stays in registers): the pad keys are zero rows in shared
// memory that score a finite -1e30 in the forward and get P = 0 in the
// backward, as the TPU kernel's padded keys do. q rows at or past sq are
// neither read nor written.
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
//   - Kernel H: one block of 4 warps per (batch, head, 64-row q tile). The
//     head's K (row-major) and V (transposed) are staged whole into shared
//     memory, so the scores of a warp's 16 rows over all SKP keys sit in
//     registers at once: one max, one exp2 pass and one sum, with no online
//     rescaling (the TPU kernel's one-pass softmax). bf16 mma.sync m16n8k16,
//     fp32 accumulators; exp runs as exp2 with log2(e) folded into the
//     scale.
//   - Kernel I: the TPU kernel keeps dK and dV in grid-persistent fp32
//     accumulators because a TPU grid runs in order; here blocks run in no
//     order, so the q axis is split over `splits` blocks per (batch, head),
//     each looping over its contiguous run of 32-row q tiles. Its warps own
//     16 keys each (SKP / 16 warps) and hold their keys' dK and dV in fp32
//     registers across the run, computing the transposed tiles S^T = K Q^T
//     and dP^T = V dO^T so that P^T and dS^T leave the accumulators as the A
//     operand of dV += P^T dO and dK += dS^T Q. dS goes through shared
//     memory ([q][key]) for dQ = dS K, which the warps then share out by
//     (16-row group, 32-column chunk) and write per tile. Each block writes
//     its fp32 partial dK and dV (splits, B*H, SKP, D); a second kernel sums
//     the partials in split order and writes bf16. No atomics: reruns are
//     bit-identical.
// Not carried over from the TPU kernel: the V-ones row sum, the padding of
// q, k and v in device memory, the 8-sublane lse and delta replication.
// Left for later work: wgmma, TMA, ldmatrix, keeping K and V fragments in
// registers.

#include "flash_attention_bshd.cuh"

namespace {

using bshd::lds32;
using bshd::mma_16816;
using bshd::pack_bf16x2;

constexpr float kLog2e = 1.4426950408889634f;
// -1e30 in the exp2 domain: the score of a pad key
constexpr float kMasked = -1.4426950408889634e30f;
constexpr int kPad = 8;  // bf16 elements of padding per shared row

constexpr int kFwdRows = 64;  // q rows per forward block
constexpr int kFwdThreads = 128;
constexpr int kBwdRows = 32;  // q rows per backward tile

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
constexpr int fwd_smem_bytes() {
  return (SKP * (D + kPad) + D * (SKP + kPad) + kFwdRows * (D + kPad)) * 2;
}

template <int D, int SKP>
__global__ void __launch_bounds__(kFwdThreads)
shortk_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                  float* __restrict__ lse, int sq, int sk, int num_heads, long long q_sb,
                  long long q_sh, long long q_ss, long long k_sb, long long k_sh, long long k_ss,
                  long long v_sb, long long v_sh, long long v_ss, long long o_sb, long long o_sh,
                  long long o_ss, float scale_log2) {
  constexpr int kLdR = D + kPad;    // sK[key][d], sQ[row][d]
  constexpr int kLdV = SKP + kPad;  // sVt[d][key]
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sVt = sK + SKP * kLdR;
  __nv_bfloat16* sQ = sVt + D * kLdV;

  const int q0 = blockIdx.x * kFwdRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // row within the 8-row mma group
  const int t = lane % 4;  // column pair within the quad

  stage<D, SKP, kFwdThreads, true, false, kLdR, 0>(sK, nullptr, k + b * k_sb + h * k_sh, k_ss,
                                                   0, sk);
  stage<D, SKP, kFwdThreads, false, true, 0, kLdV>(nullptr, sVt, v + b * v_sb + h * v_sh, v_ss,
                                                   0, sk);
  stage<D, kFwdRows, kFwdThreads, true, false, kLdR, 0>(sQ, nullptr, q + b * q_sb + h * q_sh,
                                                        q_ss, q0, sq);
  __syncthreads();

  // S = Q K^T for this warp's 16 rows over every key
  float s[SKP / 8][4];
#pragma unroll
  for (int j = 0; j < SKP / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t qf[4];
    load_a<kLdR>(qf, sQ, warp * 16, kk * 16, g, t);
#pragma unroll
    for (int j = 0; j < SKP / 8; ++j) {
      const __nv_bfloat16* kb = sK + (j * 8 + g) * kLdR + kk * 16 + 2 * t;
      mma_16816(s[j], qf, lds32(kb), lds32(kb + 8));
    }
  }

  // one-pass softmax in the exp2 domain; pad keys score a finite -1e30
  float m_lo = kMasked, m_hi = kMasked;  // rows g and g + 8
#pragma unroll
  for (int j = 0; j < SKP / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = j * 8 + 2 * t + (e & 1);
      s[j][e] = key < sk ? s[j][e] * scale_log2 : kMasked;
    }
    m_lo = fmaxf(m_lo, fmaxf(s[j][0], s[j][1]));
    m_hi = fmaxf(m_hi, fmaxf(s[j][2], s[j][3]));
  }
  m_lo = fmaxf(m_lo, __shfl_xor_sync(0xffffffffu, m_lo, 1));
  m_lo = fmaxf(m_lo, __shfl_xor_sync(0xffffffffu, m_lo, 2));
  m_hi = fmaxf(m_hi, __shfl_xor_sync(0xffffffffu, m_hi, 1));
  m_hi = fmaxf(m_hi, __shfl_xor_sync(0xffffffffu, m_hi, 2));
  float l_lo = 0.f, l_hi = 0.f;
#pragma unroll
  for (int j = 0; j < SKP / 8; ++j) {
    s[j][0] = exp2f(s[j][0] - m_lo);
    s[j][1] = exp2f(s[j][1] - m_lo);
    s[j][2] = exp2f(s[j][2] - m_hi);
    s[j][3] = exp2f(s[j][3] - m_hi);
    l_lo += s[j][0] + s[j][1];
    l_hi += s[j][2] + s[j][3];
  }
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);

  // O = P V: the score accumulators of key tiles 2kk and 2kk+1 are the A
  // fragment of one 16-key step
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < SKP / 16; ++kk) {
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

  // l >= 1: the row's largest score contributes exp2(0)
  const float inv_lo = 1.f / l_lo;
  const float inv_hi = 1.f / l_hi;
  const int row_lo = q0 + warp * 16 + g;
  const int row_hi = row_lo + 8;
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
    if (row_lo < sq) lh[row_lo] = (m_lo + log2f(l_lo)) * ln2;
    if (row_hi < sq) lh[row_hi] = (m_hi + log2f(l_hi)) * ln2;
  }
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
int launch_fwd(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
               __nv_bfloat16* o, float* lse, int batch, int sq, int sk, int num_heads,
               const long long* st, float scale_log2, cudaStream_t stream) {
  constexpr int kBytes = fwd_smem_bytes<D, SKP>();
  const cudaError_t err = allow_smem(shortk_fwd_kernel<D, SKP>, kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kFwdRows - 1) / kFwdRows, num_heads, batch);
  shortk_fwd_kernel<D, SKP><<<grid, kFwdThreads, kBytes, stream>>>(
      q, k, v, o, lse, sq, sk, num_heads, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], st[9], st[10], st[11], scale_log2);
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

// One switch over (D, SKP) for both directions: F is launch_fwd or launch_bwd.
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
// for each bf16 tensor; the last axis is contiguous and every row and head
// offset is 16-byte aligned (the wrapper checks both). k and v have q's head
// count; skp is sk rounded up to a multiple of 32 (32 to 192). lse and delta
// are contiguous fp32 (B, H, Sq); lse may be null in the forward. Each
// launches on `stream` and returns cudaGetLastError().
extern "C" int flash_attention_shortk_fwd(const void* q, const void* k, const void* v, void* o,
                                          void* lse, int batch, int sq, int sk, int skp,
                                          int num_heads, int head_dim, long long q_sb,
                                          long long q_sh, long long q_ss, long long k_sb,
                                          long long k_sh, long long k_ss, long long v_sb,
                                          long long v_sh, long long v_ss, long long o_sb,
                                          long long o_sh, long long o_ss, float scale,
                                          void* stream) {
  if (sk < 1 || sk > skp) return static_cast<int>(cudaErrorInvalidValue);
  const long long st[12] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss};
  SHORTK_DISPATCH(launch_fwd, static_cast<const __nv_bfloat16*>(q),
                  static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v),
                  static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), batch, sq, sk,
                  num_heads, st, scale * kLog2e, static_cast<cudaStream_t>(stream))
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
