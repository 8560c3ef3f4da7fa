// 3x3, stride-1, pad-1 NHWC convolution for Hopper (sm_90a), CUDA C++ (kernel K).
//
// Replaces vision_ft_tpu/ops/pallas/conv3x3.py::_kernel (launched by
// _conv3x3_fwd, entry conv3x3_tpu; its backward is the plain conv's, here
// as there).
//
//   y[b, h, w, co] = sum over (ky, kx, c) of
//                    x[b, h + ky - 1, w + kx - 1, c] * W[co, ky, kx, c]
//   x (B, H, W, C) bf16, W (CO, 3, 3, C) bf16 (the wrapper's repack of the
//   (CO, C, 3, 3) weight), y (B, H, W, CO) bf16, fp32 accumulation, no bias.
//
// What bounds it on an H100: the tensor cores at SDXL's and the VAE's
// widths. An implicit GEMM with M = B*H*W output pixels, N = CO and
// K = 9*C does 2*M*N*K operations on M*(C+CO)*2 + 9*C*CO*2 bytes: at
// (2, 64, 64, 640) -> 640, 60.4 GFLOP on 28 MB, some 2,000 operations a
// byte against the card's ~295.
//
// Design:
//   - One block of 8 warps owns a 128-pixel x 128-channel output tile and
//     loops over K in steps of 32: tap by tap, 32 input channels at a time.
//     The TPU kernel's VMEM row block with its three shifted views becomes
//     this loop; no padded copy and no shifted views are made.
//   - Each step stages the 128 x 32 input tile (the tap's shifted pixels)
//     and the 128 x 32 weight tile in shared memory with cp.async, four
//     stages in flight. A pixel whose tap falls outside the image is a
//     zero-filled load (cp.async with source size 0): the padding is
//     decided per pixel from its own (h, w), so a tile that spans several
//     image rows never reads a neighbouring row, and odd H and W need
//     nothing else. Channels at or past C read as zeros too.
//   - Warps multiply 64 x 32 sub-tiles with ldmatrix + mma.sync m16n8k16
//     bf16 into fp32 register accumulators (64 a thread), the scheme of
//     kernels B-E, and store bf16 pairs, masking pixels past B*H*W and
//     channels past CO.
//   - No atomics: a block owns its outputs, and runs are bit-identical.
// Shape contract (the wrapper checks it): C % 16 == 0, CO % 8 == 0,
// 1 <= B*H*W <= 65535 * 128, contiguous 16-byte aligned tensors.
// Left for later work: wgmma, TMA (whose out-of-bounds fill would take the
// padding), a persistent schedule, split-K for the small-M stages.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileM = 128;  // output pixels a block
constexpr int kTileN = 128;  // output channels a block
constexpr int kStepK = 32;   // input channels a step (of one tap)
constexpr int kStages = 4;
constexpr int kWarps = 8;    // 2 along M x 4 along N: a warp owns 64 x 32
constexpr int kThreads = kWarps * 32;
constexpr int kLd = kStepK + 8;  // bf16 a shared row: 80 bytes, ldmatrix conflict-free
constexpr int kStageElems = (kTileM + kTileN) * kLd;
constexpr int kSmemBytes = kStages * kStageElems * 2;  // 81,920

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 16 bytes from global to shared; `bytes` 0 fills the 16 with zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int bytes) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* smem) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a(16x16, row) * b(16x8, col), bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kThreads)
conv3x3_igemm_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                     __nv_bfloat16* __restrict__ y, int batch, int height, int width, int c,
                     int co) {
  extern __shared__ __align__(16) __nv_bfloat16 smem[];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int n0 = blockIdx.x * kTileN;
  const long long m0 = (long long)blockIdx.y * kTileM;
  const long long pixels = (long long)batch * height * width;
  const int chunks = (c + kStepK - 1) / kStepK;  // channel steps a tap
  const int steps = 9 * chunks;

  // This thread stages rows (tid / 4) and (tid / 4 + 64) of both tiles, 16
  // bytes (8 channels) at column (tid % 4) * 8 of the step. Its pixels'
  // (h, w) and centre addresses are fixed for the whole loop.
  const int vec = (tid % 4) * 8;
  int pix_h[2], pix_w[2];
  bool pix_ok[2];
  const __nv_bfloat16* pix_src[2];
  const __nv_bfloat16* w_src[2];
  bool co_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = tid / 4 + i * 64;
    const long long m = m0 + r;
    pix_ok[i] = m < pixels;
    const long long mm = pix_ok[i] ? m : 0;
    const int hw = (int)(mm % ((long long)height * width));
    pix_h[i] = hw / width;
    pix_w[i] = hw % width;
    pix_src[i] = x + mm * c + vec;
    co_ok[i] = n0 + r < co;
    w_src[i] = w + (long long)(co_ok[i] ? n0 + r : 0) * 9 * c + vec;
  }

  auto load_step = [&](int stage, int step) {
    const int tap = step / chunks;
    const int c0 = (step % chunks) * kStepK;
    const int dy = tap / 3 - 1;
    const int dx = tap % 3 - 1;
    const bool c_ok = c0 + vec < c;
    __nv_bfloat16* sa = smem + stage * kStageElems;
    __nv_bfloat16* sb = sa + kTileM * kLd;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = tid / 4 + i * 64;
      const int ih = pix_h[i] + dy;
      const int iw = pix_w[i] + dx;
      const bool ok = pix_ok[i] && c_ok && ih >= 0 && ih < height && iw >= 0 && iw < width;
      const __nv_bfloat16* src = ok ? pix_src[i] + ((long long)dy * width + dx) * c + c0 : x;
      cp_async16(sa + r * kLd + vec, src, ok ? 16 : 0);
      const bool wok = co_ok[i] && c_ok;
      cp_async16(sb + r * kLd + vec, wok ? w_src[i] + tap * c + c0 : w, wok ? 16 : 0);
    }
  };

  const int warp_m = (warp / 4) * 64;
  const int warp_n = (warp % 4) * 32;
  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
      acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load_step(s, s);
    cp_async_commit();  // empty groups past the end keep the wait counts uniform
  }

  // ldmatrix row addresses: A rows (lane % 16) at column (lane / 16) * 8;
  // B rows (lane % 8) + (lane / 16) * 8 at column ((lane / 8) % 2) * 8, so
  // that registers 0, 1 are b0, b1 of one 8-channel group and 2, 3 of the next
  const int a_row = lane % 16, a_col = (lane / 16) * 8;
  const int b_row = lane % 8 + (lane / 16) * 8, b_col = ((lane / 8) % 2) * 8;

  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // this step's tiles have landed; every warp is done with step - 1's stage
    const int next = step + kStages - 1;
    if (next < steps) load_step(next % kStages, next);
    cp_async_commit();

    const __nv_bfloat16* sa = smem + (step % kStages) * kStageElems;
    const __nv_bfloat16* sb = sa + kTileM * kLd;
#pragma unroll
    for (int kk = 0; kk < kStepK; kk += 16) {
      uint32_t af[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        ldmatrix_x4(af[mi], sa + (warp_m + mi * 16 + a_row) * kLd + kk + a_col);
      }
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        uint32_t bf[4];
        ldmatrix_x4(bf, sb + (warp_n + nj * 16 + b_row) * kLd + kk + b_col);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          mma_16816(acc[mi][2 * nj], af[mi], bf[0], bf[1]);
          mma_16816(acc[mi][2 * nj + 1], af[mi], bf[2], bf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  const int g = lane / 4;  // row within the 8-row mma group
  const int t = lane % 4;  // column pair within the quad
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
    const long long row_lo = m0 + warp_m + mi * 16 + g;
    const long long row_hi = row_lo + 8;
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n0 + warp_n + ni * 8 + 2 * t;
      if (col >= co) continue;
      if (row_lo < pixels) {
        *reinterpret_cast<uint32_t*>(y + row_lo * co + col) =
            pack_bf16x2(acc[mi][ni][0], acc[mi][ni][1]);
      }
      if (row_hi < pixels) {
        *reinterpret_cast<uint32_t*>(y + row_hi * co + col) =
            pack_bf16x2(acc[mi][ni][2], acc[mi][ni][3]);
      }
    }
  }
}

}  // namespace

// C entry, bound with ctypes. x (batch, height, width, c), w (co, 3, 3, c),
// y (batch, height, width, co): bf16, contiguous, 16-byte aligned. Launch on
// `stream` and return cudaGetLastError().
extern "C" int conv3x3_fwd(const void* x, const void* w, void* y, int batch, int height,
                           int width, int c, int co, void* stream) {
  const long long pixels = (long long)batch * height * width;
  if (pixels < 1 || c < 16 || c % 16 != 0 || co < 8 || co % 8 != 0 ||
      (pixels + kTileM - 1) / kTileM > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(conv3x3_igemm_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((co + kTileN - 1) / kTileN, (unsigned)((pixels + kTileM - 1) / kTileM));
  conv3x3_igemm_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<__nv_bfloat16*>(y), batch, height, width, c, co);
  return static_cast<int>(cudaGetLastError());
}
