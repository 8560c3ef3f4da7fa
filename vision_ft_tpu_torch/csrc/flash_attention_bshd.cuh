// Device helpers of the mma.sync attention kernel I
// (flash_attention_shortk.cu, their one user): tile sizes, the bf16
// mma.sync wrapper and the shared-memory staging of one head's 64-row tile
// out of a strided tensor.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace bshd {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;  // bf16 elements of padding per shared row

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a(16x16, row) * b(16x8, col), bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Stage rows [row0, row0 + 64) of one head (D columns) into shared memory,
// zero-filling rows at or past `rows`. ROWMAJOR stores dst_r[row][d] with
// leading dimension LDR; TRANSPOSED stores dst_t[d][row] with LDT. Each
// 16-byte vector is read from device memory once, whichever copies are made.
template <int D, bool ROWMAJOR, bool TRANSPOSED, int LDR, int LDT>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* dst_r, __nv_bfloat16* dst_t,
                                           const __nv_bfloat16* src, long long row_stride,
                                           int row0, int rows) {
  constexpr int kVecPerRow = D / 8;
  for (int i = threadIdx.x; i < kBlockK * kVecPerRow; i += kThreads) {
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

// The A fragments (16 rows x D, this warp's rows) of a row-major shared tile.
template <int D, int LD>
__device__ __forceinline__ void load_a_fragments(uint32_t (&frag)[D / 16][4],
                                                 const __nv_bfloat16* tile, int warp, int g,
                                                 int t) {
  const __nv_bfloat16* base = tile + (warp * 16 + g) * LD + 2 * t;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    frag[kk][0] = lds32(base + kk * 16);
    frag[kk][1] = lds32(base + 8 * LD + kk * 16);
    frag[kk][2] = lds32(base + kk * 16 + 8);
    frag[kk][3] = lds32(base + 8 * LD + kk * 16 + 8);
  }
}

}  // namespace bshd
