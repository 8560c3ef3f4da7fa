// 3x3, stride-1, pad-1 NHWC convolution for Hopper (sm_90a), CUDA C++: kernel
// K, an implicit GEMM on hopper_gemm.cuh's warp-specialized TMA + wgmma
// main loop.
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
// Design (kernel F's TN main loop, csrc/fused_mlp.cu):
//   - One block of 384 threads owns a tile of 128 output pixels x BN output
//     channels: consumer warpgroups 0 and 1 take 64 pixels each (wgmma
//     m64nBNk16, the accumulator in registers), one producer thread keeps a
//     ring of 4 stages of TMA loads in flight; setmaxnreg moves registers to
//     the consumers. BN is the wrapper's choice: 256 where it divides CO
//     (SDXL's 1280, the VAE's 512 and 256), else 160 (SDXL's 320 and 640),
//     else 128. A wider tile reads its A tile once for more products, and
//     160 leaves no idle channels at 320 and 640.
//   - The pixels of a tile are a box of box_w x box_h (128 in all: 128 x 1
//     to 8 x 16, the wrapper's choice by W and H) of one image. K runs over
//     9 taps x ceil(C / 64) steps of 64 channels. The A tile of a step is one
//     TMA box of a 4-D map over x's (C, W, H, B) at (c0, x0 + kx - 1,
//     y0 + ky - 1, b): 128 K-major rows of 128 bytes in the swizzle wgmma
//     reads. TMA's zeros at coordinates outside the image (negative ones
//     too) are the padding, and past C the channels a step does not have.
//     No padded copy and no shifted views are made; the TPU kernel's VMEM
//     row block with its three shifted views becomes this loop.
//   - The B tile is one or two TMA boxes of the (CO, 3, 3, C) weight seen as
//     a 4-D map over (C, 9, CO, 1): 64 channels x 1 tap x 128 or 160 output
//     channels, zeros past C and past CO.
//   - The epilogue rounds each warpgroup's 64 x BN accumulator to bf16 in
//     64-channel swizzled boxes (at BN = 160 the last box 32 channels,
//     unswizzled) and stores them through 4-D maps over y, in boxes of the
//     warpgroup's half of the pixel box; TMA drops what overhangs W, H or
//     CO, so ragged widths need nothing else.
//   - Few tiles (SDXL's 32 x 32 stages at batch 2: 80 tiles on 132 SMs):
//     the wrapper splits K into `splits` parts; each writes an fp32 partial
//     and conv3x3_split_sum_kernel adds them in split order.
//   - No atomics and a fixed summation order: reruns are bit-identical.
// Shape contract (the wrapper checks it): C % 16 == 0, CO % 8 == 0, at
// least one pixel, contiguous 16-byte aligned tensors.
// Tried and dropped (verdicts in PERF.md): 6 stages at BN = 128, 256-wide
// tiles where CO % 256 != 0. Left for later work: a persistent schedule
// (the VAE's 128-channel stages run 18 K steps a tile), channel steps
// narrower than 64 for C = 16 and 48.

#include "hopper_gemm.cuh"

namespace {

using namespace hopper;

// Weight rows (output channels) a TMA box of B: 160 for 160-channel tiles,
// else 128 (a 256-channel tile is two boxes).
template <int BN>
__host__ __device__ constexpr int w_box_rows() {
  return BN == 160 ? 160 : 128;
}

template <int BN>
constexpr int smem_bytes() {
  return 1024 + Ring<BN>::kBytes + 2 * 2 * kEpiTileBytes + 2 * kStages * sizeof(uint64_t);
}

// The shared memory: the ring, two 64 x 64 output boxes per consumer
// warpgroup, the barriers.
template <int BN>
struct Layout {
  uint8_t* ring;
  uint8_t* epi;  // warpgroup w's boxes: epi + w * 2 * kEpiTileBytes
  uint64_t* full;
  uint64_t* empty;
  __device__ __forceinline__ explicit Layout(uint8_t* raw) {
    ring = align_1024(raw);
    epi = ring + Ring<BN>::kBytes;
    full = reinterpret_cast<uint64_t*>(epi + 2 * 2 * kEpiTileBytes);
    empty = full + kStages;
  }
};

// Tile (pixel box, channel tile of BN) of y, or with SPLIT the fp32 partial
// of K steps [k_begin, k_end) for split blockIdx.y.
template <int BN, bool SPLIT>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_kernel(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w,
               const __grid_constant__ CUtensorMap map_y,
               const __grid_constant__ CUtensorMap map_y32, float* __restrict__ partial,
               int batch, int height, int width, int c, int co, int box_w, int box_h,
               int tiles_x, int tiles_y, int splits) {
  using R = Ring<BN>;
  extern __shared__ uint8_t smem_raw[];
  const Layout<BN> smem(smem_raw);
  // consecutive blocks share the pixel box: its channel tiles together
  const int num_n = (co + BN - 1) / BN;
  const int box = blockIdx.x / num_n;
  const int n0 = (blockIdx.x % num_n) * BN;
  const int img = box / (tiles_x * tiles_y);
  const int x0 = (box % tiles_x) * box_w;
  const int y0 = (box / tiles_x % tiles_y) * box_h;
  const int chunks = (c + kBK - 1) / kBK;
  const int slices = 9 * chunks;
  const int k_begin = (int)((long long)blockIdx.y * slices / splits);
  const int k_end = (int)((long long)(blockIdx.y + 1) * slices / splits);

  init_ring_barriers(smem.full, smem.empty);
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      int stage = 0;
      uint32_t phase = 0;
      for (int k = k_begin; k < k_end; ++k) {
        const int tap = k / chunks;
        const int c0 = (k % chunks) * kBK;
        mbar_wait(&smem.empty[stage], phase ^ 1u);
        uint8_t* dst = smem.ring + stage * R::kStageBytes;
        mbar_arrive_expect_tx(&smem.full[stage], R::kStageBytes);
        tma_load_4d(dst, &map_x, &smem.full[stage], c0, x0 + tap % 3 - 1, y0 + tap / 3 - 1, img);
        constexpr int kRows = w_box_rows<BN>();
#pragma unroll
        for (int part = 0; part < BN / kRows; ++part) {
          tma_load_4d(dst + kATileBytes + part * kRows * kBK * 2, &map_w, &smem.full[stage], c0,
                      tap, n0 + kRows * part, 0);
        }
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1u;
        }
      }
    }
  } else {
    setmaxnreg_inc<232>();
    float acc[BN / 2];
    consume<BN>(acc, smem.ring, smem.full, smem.empty, wg, k_end - k_begin);

    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int r = (t / 32) * 16 + lane / 4;  // rows r and r + 8 of this warpgroup's 64
    if constexpr (SPLIT) {
      float* dst = partial + (long long)blockIdx.y * batch * height * width * co;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = 64 * wg + r + 8 * half;  // pixel (m / box_w, m % box_w) of the box
        const int px = x0 + m % box_w;
        const int py = y0 + m / box_w;
        if (px >= width || py >= height) continue;
        float* out = dst + (((long long)img * height + py) * width + px) * co;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int col = n0 + j * 8 + 2 * (lane % 4);
          if (col < co) {
            *reinterpret_cast<float2*>(out + col) =
                make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
          }
        }
      }
    } else {
      // this warpgroup's 64 pixels: half the box's columns (box_h = 1) or
      // half its rows
      const int sx = box_h == 1 ? x0 + 64 * wg : x0;
      const int sy = box_h == 1 ? y0 : y0 + wg * (box_h / 2);
      const bool stores = sx < width && sy < height;
      uint8_t* boxes = smem.epi + wg * 2 * kEpiTileBytes;
      // 64-channel boxes (128-byte swizzle), then at BN = 160 one of 32
      // channels (64-byte rows, no swizzle); two buffers in turn
#pragma unroll
      for (int q = 0; q < (BN + 63) / 64; ++q) {
        constexpr int kFull = BN / 64;
        uint8_t* out = boxes + (q % 2) * kEpiTileBytes;
        if (q >= 2) {
          if (t == 0) tma_store_wait_read<1>();  // box q - 2 has left this buffer
          named_barrier_sync(1 + wg, 128);
        }
#pragma unroll
        for (int jj = 0; jj < (q < kFull ? 8 : 4); ++jj) {
          const int j = q * 8 + jj;
          const int lo =
              q < kFull ? sw128_offset(r, jj, lane % 4) : r * 64 + jj * 16 + 4 * (lane % 4);
          const int hi = q < kFull ? sw128_offset(r + 8, jj, lane % 4) : lo + 8 * 64;
          *reinterpret_cast<uint32_t*>(out + lo) = pack_bf16x2(acc[4 * j], acc[4 * j + 1]);
          *reinterpret_cast<uint32_t*>(out + hi) = pack_bf16x2(acc[4 * j + 2], acc[4 * j + 3]);
        }
        fence_async_shared();
        named_barrier_sync(1 + wg, 128);
        if (t == 0 && stores && n0 + 64 * q < co) {
          tma_store_4d(q < kFull ? &map_y : &map_y32, out, n0 + 64 * q, sx, sy, img);
        }
        if (t == 0) tma_store_commit();
      }
      if (t == 0) tma_store_wait<0>();
    }
  }
}

// y = bf16(partial[0] + partial[1] + ...), the partials in split order.
__global__ void __launch_bounds__(256)
conv3x3_split_sum_kernel(const float4* __restrict__ partial, uint2* __restrict__ y,
                         long long quads, int splits) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < quads;
       i += (long long)gridDim.x * blockDim.x) {
    float4 sum = partial[i];
    for (int s = 1; s < splits; ++s) {
      const float4 p = partial[s * quads + i];
      sum.x += p.x;
      sum.y += p.y;
      sum.z += p.z;
      sum.w += p.w;
    }
    y[i] = make_uint2(pack_bf16x2(sum.x, sum.y), pack_bf16x2(sum.z, sum.w));
  }
}

template <int BN, bool SPLIT>
int launch(const CUtensorMap& map_x, const CUtensorMap& map_w, const CUtensorMap& map_y,
           const CUtensorMap& map_y32, float* partial, int batch, int height, int width, int c,
           int co, int box_w, int box_h, int splits, cudaStream_t stream) {
  constexpr int kBytes = smem_bytes<BN>();
  const int err = allow_dynamic_smem<conv3x3_kernel<BN, SPLIT>>(kBytes);
  if (err) return err;
  const int tiles_x = (width + box_w - 1) / box_w;
  const int tiles_y = (height + box_h - 1) / box_h;
  const long long blocks = (long long)batch * tiles_x * tiles_y * ((co + BN - 1) / BN);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks), splits);
  conv3x3_kernel<BN, SPLIT><<<grid, kThreads, kBytes, stream>>>(
      map_x, map_w, map_y, map_y32, partial, batch, height, width, c, co, box_w, box_h, tiles_x,
      tiles_y, splits);
  return static_cast<int>(cudaGetLastError());
}

// The weight's and y's tensor maps for BN-channel tiles, then the launch.
template <int BN>
int launch_bn(const CUtensorMap& map_x, const void* w, void* y, float* partial, int batch,
              int height, int width, int c, int co, int box_w, int box_h, int splits,
              cudaStream_t stream) {
  CUtensorMap map_w, map_y, map_y32;
  // the weight as 1 image of co rows x 9 taps: a box is w_box_rows output channels of one tap
  int err = make_map_nhwc(&map_w, w, 1, co, 9, c, 1, w_box_rows<BN>());
  // a consumer warpgroup's half of the pixel box, 64 and 32 channels
  const uint32_t half_w = box_h == 1 ? box_w / 2 : box_w;
  const uint32_t half_h = box_h == 1 ? 1 : box_h / 2;
  if (!err) err = make_map_nhwc(&map_y, y, batch, height, width, co, half_w, half_h);
  if (!err) err = make_map_nhwc(&map_y32, y, batch, height, width, co, half_w, half_h, 32);
  if (err) return err;
  if (splits == 1) {
    return launch<BN, false>(map_x, map_w, map_y, map_y32, nullptr, batch, height, width, c, co,
                             box_w, box_h, 1, stream);
  }
  return launch<BN, true>(map_x, map_w, map_y, map_y32, partial, batch, height, width, c, co,
                          box_w, box_h, splits, stream);
}

}  // namespace

// C entry, bound with ctypes. x (batch, height, width, c), w (co, 3, 3, c),
// y (batch, height, width, co): bf16, contiguous, 16-byte aligned. box_w is
// the pixel box's width (8, 16, 32, 64 or 128; its height 128 / box_w),
// tile_n the output channels a block (128, 160 or 256). splits >= 1 parts
// of K; with more than one, partial is fp32 (splits, batch, height, width,
// co). Launches on `stream` and returns the first error: of the tensor
// maps' encoding, of the shared-memory attribute, or cudaGetLastError()
// after each launch.
extern "C" int conv3x3_fwd(const void* x, const void* w, void* y, void* partial, int batch,
                           int height, int width, int c, int co, int box_w, int tile_n,
                           int splits, void* stream) {
  const long long pixels = (long long)batch * height * width;
  const bool box_ok = box_w == 8 || box_w == 16 || box_w == 32 || box_w == 64 || box_w == 128;
  if (pixels < 1 || c < 16 || c % 16 != 0 || co < 8 || co % 8 != 0 || !box_ok ||
      (tile_n != 128 && tile_n != 160 && tile_n != 256) || splits < 1 ||
      splits > 9 * ((c + kBK - 1) / kBK) || splits > 65535 || (splits > 1 && partial == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int box_h = 128 / box_w;
  CUtensorMap map_x;
  int err = make_map_nhwc(&map_x, x, batch, height, width, c, box_w, box_h);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* part = static_cast<float*>(partial);
  switch (tile_n) {
    case 256:
      err = launch_bn<256>(map_x, w, y, part, batch, height, width, c, co, box_w, box_h, splits, s);
      break;
    case 160:
      err = launch_bn<160>(map_x, w, y, part, batch, height, width, c, co, box_w, box_h, splits, s);
      break;
    default:
      err = launch_bn<128>(map_x, w, y, part, batch, height, width, c, co, box_w, box_h, splits, s);
  }
  if (err || splits == 1) return err;
  const long long quads = pixels * co / 4;
  const int blocks = (int)((quads + 255) / 256 < 1056 ? (quads + 255) / 256 : 1056);
  conv3x3_split_sum_kernel<<<blocks, 256, 0, s>>>(reinterpret_cast<const float4*>(part),
                                                  static_cast<uint2*>(y), quads, splits);
  return static_cast<int>(cudaGetLastError());
}
