// Fused gated MLP (GeGLU / SwiGLU feed-forward) for Hopper (sm_90a), CUDA C++:
// kernel F, two TMA + wgmma GEMMs.
//
// Replaces vision_ft_tpu/ops/pallas/fused_mlp.py::_gated_kernel (:63,
// launched by _gated_fwd_kernel_call, entries gated_mlp and geglu_mlp).
//
// Computes out = (act(x Wa^T + ba) * (x Wg^T + bg)) Wd^T + bd for x (M, C),
// Wa and Wg (inner, C), Wd (C, inner), all bf16 in torch (out, in) layout;
// biases fp32 or absent. Both up-projections accumulate in fp32, the gated
// product is rounded to bf16 before the down-projection (where the kernel
// it replaces rounds it, fused_mlp.py:84), the down-projection accumulates
// in fp32 and the output is bf16.
//
// What bounds it on an H100: operations, 6 M C inner (1.11 TFLOP at the
// NextDiT's main stack, M = 8704: 1.121 ms at 989 TFLOP/s).
//
// The TPU kernel keeps a (256, C) fp32 output accumulator in VMEM across
// its sequential inner-chunk axis. At C = 2304 a row tile big enough to
// reuse the weights (128 rows) needs 1.18 MB of accumulator, and an SM has
// 256 KB of registers and 227 KB of shared memory. So the gated product
// `a` (M, inner) makes one round trip through device memory, bf16 (321 MB
// written and read at the main stack, 0.096 ms at 3.35 TB/s, at most 9% of
// the bound), and the work is two TN GEMMs, both operands K-major:
//   - F-up (gated_up_kernel): a = bf16(act(x Wa^T + ba) * (x Wg^T + bg)).
//     A tile of 128 rows x 128 inner columns. A stage holds x's 128 rows and
//     the tile's 128 Wa rows stacked over the same 128 Wg rows (three TMA
//     boxes, 64 deep in C); one wgmma m64n256k16 a warpgroup computes both
//     projections, h in accumulator columns 0-127 and g in 128-255. Column
//     j and column j + 128 sit in the same thread, so the gate needs no
//     exchange: the epilogue adds the biases, applies the activation in fp32,
//     rounds to bf16 and stores through shared memory with TMA.
//   - F-down (gated_down_kernel): out = bf16(a Wd^T + bd), tiles of 128 x
//     256 (128 x 128 where C / 256 is not whole), K = inner.
//   - Both: the hopper_gemm.cuh main loop, a producer thread keeping a ring
//     of 4 stages of TMA loads (128-byte swizzle) in flight for two consumer
//     warpgroups (64 rows each), registers moved to them with setmaxnreg.
//     Ragged M: TMA reads rows past M as zeros and drops their stores.
//   - Few tiles (the context refiner's 512 rows: 36 F-down tiles on 132
//     SMs): F-down splits inner into `splits` parts; each writes an fp32
//     partial and gated_down_split_sum_kernel adds them in split order.
//   - No atomics and a fixed summation order: reruns are bit-identical.
// GeGLU's Wa and Wg are the two halves of one (2 inner, C) weight: their
// tensor maps start at the halves' row offsets inside it; nothing is copied.

#include "hopper_gemm.cuh"

#include <math.h>

namespace {

using namespace hopper;

constexpr int kUpN = 128;  // inner columns of an F-up tile
constexpr int kUpGroupM = 16;  // F-up row tiles that walk the inner tiles together (L2 reuse)
constexpr int kSmemBytes = 1024 + Ring<256>::kBytes + 2 * 2 * kEpiTileBytes +
                           2 * kStages * sizeof(uint64_t);

__device__ __forceinline__ float activate(float h, int act) {
  if (act == 0) return h / (1.f + expf(-h));  // silu
  if (act == 1) {                             // gelu, tanh approximation
    return 0.5f * h * (1.f + tanhf(0.7978845608028654f * (h + 0.044715f * h * h * h)));
  }
  return 0.5f * h * (1.f + erff(h * 0.7071067811865476f));  // gelu, exact
}

// Element i of an fp32 bias vector, or 0 where it is absent.
__device__ __forceinline__ float bias_at(const float* bias, int i) {
  return bias == nullptr ? 0.f : bias[i];
}

// The shared memory of both kernels: the ring (B tiles of up to 256 rows),
// two 64 x 64 output boxes per consumer warpgroup, the barriers.
struct Layout {
  uint8_t* ring;
  uint8_t* epi;  // warpgroup w's boxes: epi + w * 2 * kEpiTileBytes
  uint64_t* full;
  uint64_t* empty;
  __device__ __forceinline__ explicit Layout(uint8_t* raw) {
    ring = align_1024(raw);
    epi = ring + Ring<256>::kBytes;
    full = reinterpret_cast<uint64_t*>(epi + 2 * 2 * kEpiTileBytes);
    empty = full + kStages;
  }
};

// F-up: tile (m0, n0) of a = bf16(act(x Wa^T + ba) * (x Wg^T + bg)).
__global__ void __launch_bounds__(kThreads, 1)
gated_up_kernel(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_wa,
                const __grid_constant__ CUtensorMap map_wg, const __grid_constant__ CUtensorMap map_a,
                const float* __restrict__ ba, const float* __restrict__ bg, int m, int c,
                int inner, int act) {
  extern __shared__ uint8_t smem_raw[];
  const Layout smem(smem_raw);
  // tiles in groups of kUpGroupM row tiles: the group walks the inner tiles,
  // so its x rows and the current weight rows stay in L2
  const int num_m = (m + kBM - 1) / kBM;
  const int num_n = inner / kUpN;
  const int per_group = kUpGroupM * num_n;
  const int group = blockIdx.x / per_group;
  const int first_m = group * kUpGroupM;
  const int group_rows = min(num_m - first_m, kUpGroupM);
  const int in_group = blockIdx.x % per_group;
  const int m0 = (first_m + in_group % group_rows) * kBM;
  const int n0 = (in_group / group_rows) * kUpN;

  init_ring_barriers(smem.full, smem.empty);
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      produce<kUpN, kUpN>(smem.ring, smem.full, smem.empty, &map_x, m0, &map_wa, n0, &map_wg, n0,
                          0, c / kBK);
    }
  } else {
    setmaxnreg_inc<232>();
    float acc[128];
    consume<256>(acc, smem.ring, smem.full, smem.empty, wg, c / kBK);

    // epilogue: h in acc[0, 64), g in acc[64, 128), same (row, column)
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int r = (t / 32) * 16 + lane / 4;  // rows r and r + 8 of this warpgroup's 64
    uint8_t* boxes = smem.epi + wg * 2 * kEpiTileBytes;
#pragma unroll
    for (int q = 0; q < 2; ++q) {  // 64-column halves of the tile
      uint8_t* box = boxes + q * kEpiTileBytes;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int j = q * 8 + jj;
        const int col = n0 + j * 8 + 2 * (lane % 4);
        const float ba0 = bias_at(ba, col);
        const float ba1 = bias_at(ba, col + 1);
        const float bg0 = bias_at(bg, col);
        const float bg1 = bias_at(bg, col + 1);
        *reinterpret_cast<uint32_t*>(box + sw128_offset(r, jj, lane % 4)) =
            pack_bf16x2(activate(acc[4 * j] + ba0, act) * (acc[64 + 4 * j] + bg0),
                        activate(acc[4 * j + 1] + ba1, act) * (acc[64 + 4 * j + 1] + bg1));
        *reinterpret_cast<uint32_t*>(box + sw128_offset(r + 8, jj, lane % 4)) =
            pack_bf16x2(activate(acc[4 * j + 2] + ba0, act) * (acc[64 + 4 * j + 2] + bg0),
                        activate(acc[4 * j + 3] + ba1, act) * (acc[64 + 4 * j + 3] + bg1));
      }
      fence_async_shared();
      named_barrier_sync(1 + wg, 128);
      if (t == 0 && m0 + 64 * wg < m) {
        tma_store_2d(&map_a, box, n0 + 64 * q, m0 + 64 * wg);
        tma_store_commit();
      }
    }
    if (t == 0) tma_store_wait<0>();
  }
}

// F-down: tile (m0, n0) of out = bf16(a Wd^T + bd), or with SPLIT the fp32
// partial of inner slices [k_begin, k_end) for split blockIdx.y.
template <int BN, bool SPLIT>
__global__ void __launch_bounds__(kThreads, 1)
gated_down_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_wd,
                  const __grid_constant__ CUtensorMap map_out,
                  const float* __restrict__ bd,
                  float* __restrict__ partial, int m, int c, int inner, int splits) {
  extern __shared__ uint8_t smem_raw[];
  const Layout smem(smem_raw);
  // consecutive blocks share a's rows: the row tile's output tiles together
  const int num_n = c / BN;
  const int m0 = (blockIdx.x / num_n) * kBM;
  const int n0 = (blockIdx.x % num_n) * BN;
  const int slices = inner / kBK;
  const int k_begin = (int)((long long)blockIdx.y * slices / splits);
  const int k_end = (int)((long long)(blockIdx.y + 1) * slices / splits);

  init_ring_barriers(smem.full, smem.empty);
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      produce<BN, 0>(smem.ring, smem.full, smem.empty, &map_a, m0, &map_wd, n0, nullptr, 0,
                     k_begin, k_end);
    }
  } else {
    setmaxnreg_inc<232>();
    float acc[BN / 2];
    consume<BN>(acc, smem.ring, smem.full, smem.empty, wg, k_end - k_begin);

    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int r = (t / 32) * 16 + lane / 4;
    if constexpr (SPLIT) {
      float* dst = partial + (long long)blockIdx.y * m * c;
      const int row_lo = m0 + 64 * wg + r;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + j * 8 + 2 * (lane % 4);
        if (row_lo < m) {
          *reinterpret_cast<float2*>(dst + (long long)row_lo * c + col) =
              make_float2(acc[4 * j], acc[4 * j + 1]);
        }
        if (row_lo + 8 < m) {
          *reinterpret_cast<float2*>(dst + (long long)(row_lo + 8) * c + col) =
              make_float2(acc[4 * j + 2], acc[4 * j + 3]);
        }
      }
    } else {
      uint8_t* boxes = smem.epi + wg * 2 * kEpiTileBytes;
      const bool stores = m0 + 64 * wg < m;
#pragma unroll
      for (int q = 0; q < BN / 64; ++q) {  // 64-column boxes, two buffers in turn
        uint8_t* box = boxes + (q % 2) * kEpiTileBytes;
        if (q >= 2) {
          if (t == 0) tma_store_wait_read<1>();  // box q - 2 has left this buffer
          named_barrier_sync(1 + wg, 128);
        }
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int j = q * 8 + jj;
          const int col = n0 + j * 8 + 2 * (lane % 4);
          const float b0 = bias_at(bd, col);
          const float b1 = bias_at(bd, col + 1);
          *reinterpret_cast<uint32_t*>(box + sw128_offset(r, jj, lane % 4)) =
              pack_bf16x2(acc[4 * j] + b0, acc[4 * j + 1] + b1);
          *reinterpret_cast<uint32_t*>(box + sw128_offset(r + 8, jj, lane % 4)) =
              pack_bf16x2(acc[4 * j + 2] + b0, acc[4 * j + 3] + b1);
        }
        fence_async_shared();
        named_barrier_sync(1 + wg, 128);
        if (t == 0 && stores) {
          tma_store_2d(&map_out, box, n0 + 64 * q, m0 + 64 * wg);
          tma_store_commit();
        }
      }
      if (t == 0) tma_store_wait<0>();
    }
  }
}

// out = bf16(partial[0] + partial[1] + ... + bd), the partials in split order.
__global__ void __launch_bounds__(256)
gated_down_split_sum_kernel(const float4* __restrict__ partial, const float* __restrict__ bd,
                            uint2* __restrict__ out,
                            int m, int c, int splits) {
  const long long quads = (long long)m * c / 4;
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
    const int col = (int)((i * 4) % c);
    sum.x += bias_at(bd, col);
    sum.y += bias_at(bd, col + 1);
    sum.z += bias_at(bd, col + 2);
    sum.w += bias_at(bd, col + 3);
    out[i] = make_uint2(pack_bf16x2(sum.x, sum.y), pack_bf16x2(sum.z, sum.w));
  }
}

// Lets KERNEL use kSmemBytes of dynamic shared memory: once per device.
template <auto KERNEL>
int prepare() {
  static bool done[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess && (device >= 64 || !done[device])) {
    err = cudaFuncSetAttribute(KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err == cudaSuccess && device < 64) done[device] = true;
  }
  return static_cast<int>(err);
}

int launch_up(const void* x, const void* wa, const float* ba, const void* wg, const float* bg,
              void* a, int m, int c, int inner, int act, cudaStream_t stream) {
  CUtensorMap map_x, map_wa, map_wg, map_a;
  int err = make_map_2d(&map_x, x, m, c, kBM);
  if (!err) err = make_map_2d(&map_wa, wa, inner, c, kUpN);
  if (!err) err = make_map_2d(&map_wg, wg, inner, c, kUpN);
  if (!err) err = make_map_2d(&map_a, a, m, inner, 64);
  if (!err) err = prepare<gated_up_kernel>();
  if (err) return err;
  const int tiles = (m + kBM - 1) / kBM * (inner / kUpN);
  gated_up_kernel<<<tiles, kThreads, kSmemBytes, stream>>>(map_x, map_wa, map_wg, map_a, ba, bg,
                                                           m, c, inner, act);
  return static_cast<int>(cudaGetLastError());
}

template <int BN>
int launch_down_bn(const CUtensorMap& map_a, const void* wd, const float* bd, void* out,
                   float* partial, int m, int c, int inner, int splits, cudaStream_t stream) {
  CUtensorMap map_wd, map_out;
  int err = make_map_2d(&map_wd, wd, c, inner, BN);
  if (!err) err = make_map_2d(&map_out, out, m, c, 64);
  if (err) return err;
  const dim3 grid((m + kBM - 1) / kBM * (c / BN), splits);
  if (splits == 1) {
    if ((err = prepare<gated_down_kernel<BN, false>>())) return err;
    gated_down_kernel<BN, false><<<grid, kThreads, kSmemBytes, stream>>>(
        map_a, map_wd, map_out, bd, nullptr, m, c, inner, 1);
    return static_cast<int>(cudaGetLastError());
  }
  if ((err = prepare<gated_down_kernel<BN, true>>())) return err;
  gated_down_kernel<BN, true><<<grid, kThreads, kSmemBytes, stream>>>(
      map_a, map_wd, map_out, nullptr, partial, m, c, inner, splits);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  const long long quads = (long long)m * c / 4;
  const int blocks = (int)((quads + 255) / 256 < 1056 ? (quads + 255) / 256 : 1056);
  gated_down_split_sum_kernel<<<blocks, 256, 0, stream>>>(
      reinterpret_cast<const float4*>(partial), bd, static_cast<uint2*>(out), m, c, splits);
  return static_cast<int>(cudaGetLastError());
}

int launch_down(const void* a, const void* wd, const float* bd, void* out, float* partial, int m,
                int c, int inner, int splits, cudaStream_t stream) {
  CUtensorMap map_a;
  const int err = make_map_2d(&map_a, a, m, inner, kBM);
  if (err) return err;
  if (c % 256 == 0) return launch_down_bn<256>(map_a, wd, bd, out, partial, m, c, inner, splits, stream);
  return launch_down_bn<128>(map_a, wd, bd, out, partial, m, c, inner, splits, stream);
}

bool valid(int m, int c, int inner) {
  return m >= 1 && c >= 128 && c % 128 == 0 && inner >= 256 && inner % 256 == 0;
}

}  // namespace

// C entries, bound with ctypes. Tensors are contiguous bf16 with 16-byte
// aligned bases; biases are null or contiguous fp32: x (m, c), wa and wg
// (inner, c) (they may be the halves of one (2 inner, c) weight), a
// (m, inner), wd (c, inner), out (m, c); partial: (splits, m, c) fp32 when
// splits > 1, else unused. c % 128 == 0 and inner % 256 == 0 (the JAX
// package's rule; the wrapper checks). act: 0 silu, 1 gelu (tanh), 2 gelu
// (erf). Each launches on `stream` and returns the first error, or 0.

// F-up alone: a = bf16(act(x wa^T + ba) * (x wg^T + bg)).
extern "C" int fused_gated_mlp_up(const void* x, const void* wa, const void* ba, const void* wg,
                                  const void* bg, void* a, int m, int c, int inner, int act,
                                  void* stream) {
  if (!valid(m, c, inner) || act < 0 || act > 2) return static_cast<int>(cudaErrorInvalidValue);
  return launch_up(x, wa, static_cast<const float*>(ba), wg, static_cast<const float*>(bg), a, m,
                   c, inner, act, static_cast<cudaStream_t>(stream));
}

// F-down alone (and the split sum): out = bf16(a wd^T + bd).
extern "C" int fused_gated_mlp_down(const void* a, int m, int c, int inner, const void* wd,
                                    const void* bd, void* out, void* partial, int splits,
                                    void* stream) {
  if (!valid(m, c, inner) || splits < 1 || splits > inner / kBK || (splits > 1 && !partial)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_down(a, wd, static_cast<const float*>(bd), out, static_cast<float*>(partial), m, c,
                     inner, splits, static_cast<cudaStream_t>(stream));
}

// The whole feed-forward: F-up into a, then F-down (and the split sum). The
// arguments are F-up's, then F-down's past (a, m, c, inner).
extern "C" int fused_gated_mlp_fwd(const void* x, const void* wa, const void* ba, const void* wg,
                                   const void* bg, void* a, int m, int c, int inner, int act,
                                   const void* wd, const void* bd, void* out, void* partial,
                                   int splits, void* stream) {
  const int err = fused_gated_mlp_up(x, wa, ba, wg, bg, a, m, c, inner, act, stream);
  if (err) return err;
  return fused_gated_mlp_down(a, m, c, inner, wd, bd, out, partial, splits, stream);
}
