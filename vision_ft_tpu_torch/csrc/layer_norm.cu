// Fused LayerNorm forward for Hopper (sm_90a), CUDA C++: kernel A.
//
// Replaces vision_ft_tpu/ops/pallas/layer_norm.py::_ln_kernel and
// ::_ln_kernel_nobeta (called through _layer_norm_fwd_2d).
//
// Computes, for each row of bf16 x (..., C): the fp32 mean, the fp32
// variance of the centred row (a second pass over the row held in
// registers, as layer_norm_reference takes it; not E[x^2] - E[x]^2),
// rstd = rsqrt(var + eps), then ((x - mean) * rstd) * gamma (+ beta) in
// that order, rounded once to bf16. gamma and beta are bf16 or fp32.
//
// What bounds it on an H100: device memory. About 8 fp32 operations an
// element against the card's 295 bf16 operations a byte; a row is read
// once and written once. At the SDXL request's shapes (154 to 8192 rows)
// a call moves 0.5 to 21 MB, a few microseconds of the card, so what a
// call costs is its launch and the host's path to it: the wrapper
// (ops/layer_norm.py) is one check, one torch.empty and one ctypes call.
//
// Design:
//   - A row belongs to one warp (C <= 2048: the main path's 640, 768 and
//     1280) or to 2 or 4 warps of a block (wider rows, up to 8192). Each
//     lane holds VPL vectors of 8 bf16 of the row in registers, packed:
//     vector v of a row belongs to lane v % 32 of the row's warp
//     (v / 32) % wpr, so one load instruction of a warp covers 512
//     consecutive bytes, 16 bytes a lane.
//   - Sums: a lane adds its elements in order, a butterfly of shuffles adds
//     the lanes (every lane ends with the same bits), and where a row has
//     several warps their sums meet in shared memory and are added in warp
//     order. The order is fixed, so a rerun is bit-identical.
//   - A persistent grid of 128-thread blocks (ops.layer_norm.ln_plan sizes
//     it from the rows and the SM count; the C entry trims it to the blocks
//     the kernel's registers let reside at once), each block walking groups
//     of 4 / wpr rows with a grid stride. gamma and beta are read once a
//     thread, into registers, not once a row.
//   - Any C and any alignment: a C that is not a multiple of 8, or a
//     pointer or stride that is not 16-byte aligned, takes the scalar path
//     of the same kernel (element loads and stores, the same register
//     layout, bounds checks).
//   - Row r of x lies at (r / inner) * batch_stride + (r % inner) *
//     row_stride elements: a contiguous x, or a view whose leading axes fold
//     into a batch axis and a row axis. y is contiguous.
// Not carried over from the TPU kernel: the block of rows a grid step and
// the padding of C to the (8, 128) tiling.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;  // a block: 4 warps, 4 / wpr rows at a time
constexpr int kThreads = kWarps * 32;
constexpr int kMaxVpl = 8;  // vectors a lane holds (ptxas: no spill at 8 with bf16 gamma and beta)
constexpr int kMaxC = 8192;

__device__ __forceinline__ uint32_t word(const uint4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// Element j (0 to 7) of 8 packed bf16, as fp32 (exact).
__device__ __forceinline__ float bf16_at(const uint4& v, int j) {
  const uint32_t w = word(v, j / 2);
  return __uint_as_float(j % 2 ? (w & 0xffff0000u) : (w << 16));
}

// Element j of 8 packed bf16 as fp32, unpacked where it is used: volatile,
// so that ptxas does not hoist the unpacking of gamma and beta out of the
// row loop and hold their fp32 forms (8 registers a vector each, not 4:
// 122 registers a thread at 3 vectors a lane, 201 at 5, against 94 and
// 151; the packed form ran 2-10% faster on the card at the SDXL shapes).
__device__ __forceinline__ float unpack_in_loop(const uint4& v, int j) {
  uint32_t f;
  const uint32_t w = word(v, j / 2);
  if (j % 2) {
    asm volatile("and.b32 %0, %1, 0xffff0000;" : "=r"(f) : "r"(w));
  } else {
    asm volatile("shl.b32 %0, %1, 16;" : "=r"(f) : "r"(w));
  }
  return __uint_as_float(f);
}

// Eight bf16 from p: one 16-byte load where `vec`, else the first n (1 to
// 8) one by one and zeros past them.
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* p, bool vec, int n) {
  if (vec) return *reinterpret_cast<const uint4*>(p);
  const uint16_t* h = reinterpret_cast<const uint16_t*>(p);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j < n) w[j / 2] |= static_cast<uint32_t>(h[j]) << (16 * (j % 2));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Eight fp32 rounded to bf16 at p: one 16-byte store where `vec`, else the
// first n one by one.
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&o)[8], bool vec, int n) {
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const __nv_bfloat162 pair = __floats2bfloat162_rn(o[2 * k], o[2 * k + 1]);
    w[k] = *reinterpret_cast<const uint32_t*>(&pair);
  }
  if (vec) {
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    return;
  }
  uint16_t* h = reinterpret_cast<uint16_t*>(p);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j < n) h[j] = static_cast<uint16_t>(w[j / 2] >> (16 * (j % 2)));
  }
}

// Eight affine parameters of type P, as they sit in registers.
template <typename P>
struct Eight;

template <>
struct Eight<__nv_bfloat16> {
  uint4 raw = make_uint4(0u, 0u, 0u, 0u);
  __device__ void load(const __nv_bfloat16* p, bool vec, int n) { raw = load8(p, vec, n); }
  __device__ float operator[](int j) const { return unpack_in_loop(raw, j); }
};

template <>
struct Eight<float> {
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = make_float4(0.f, 0.f, 0.f, 0.f);
  __device__ void load(const float* p, bool vec, int n) {
    if (vec) {
      a = reinterpret_cast<const float4*>(p)[0];
      b = reinterpret_cast<const float4*>(p)[1];
      return;
    }
    float f[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) f[j] = j < n ? p[j] : 0.f;
    a = make_float4(f[0], f[1], f[2], f[3]);
    b = make_float4(f[4], f[5], f[6], f[7]);
  }
  __device__ float operator[](int j) const {
    const float4& h = j < 4 ? a : b;
    const int k = j % 4;
    return k == 0 ? h.x : k == 1 ? h.y : k == 2 ? h.z : h.w;
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset /= 2) v += __shfl_xor_sync(0xffffffffu, v, offset);
  return v;
}

// Element j of one of x's vectors. At 5 vectors a lane (C = 1280) x too is
// unpacked where it is used: 120 registers a thread against 154, so 4
// blocks reside on an SM against 3 (2048x1280: 4.53 us on the card against
// 5.15); at the other counts the registers drop by too little to add a
// block and the extra unpacking costs 0.1-0.4 us.
template <int VPL>
__device__ __forceinline__ float x_at(const uint4& v, int j) {
  if constexpr (VPL == 5) return unpack_in_loop(v, j);
  return bf16_at(v, j);
}

template <int VPL, typename P>
__global__ void __launch_bounds__(kThreads)
layer_norm_fwd_kernel(const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ y,
                      const P* __restrict__ gamma, const P* __restrict__ beta, long long rows,
                      int c, long long inner, long long batch_stride, long long row_stride,
                      int wpr, int vec, float eps) {
  __shared__ float partial[2][kWarps];  // per warp: its sum, then its sum of squares
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int part = warp % wpr;  // this warp's share of its row
  const int slot = warp / wpr;  // its row in the block's group
  const int rows_per_block = kWarps / wpr;
  const bool v16 = vec != 0;
  const bool has_beta = beta != nullptr;
  const float cf = static_cast<float>(c);

  // the lane's vectors, their valid elements, and gamma and beta over them
  int col[VPL], n[VPL];
  Eight<P> g[VPL], b[VPL];
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    col[i] = ((i * wpr + part) * 32 + lane) * 8;
    n[i] = max(0, min(8, c - col[i]));
    if (n[i] > 0) {
      g[i].load(gamma + col[i], v16, n[i]);
      if (has_beta) b[i].load(beta + col[i], v16, n[i]);
    }
  }

  const long long groups = (rows + rows_per_block - 1) / rows_per_block;
  for (long long group = blockIdx.x; group < groups; group += gridDim.x) {
    const long long row = group * rows_per_block + slot;
    const bool live = row < rows;
    // (a contiguous x is one batch of rows: no 64-bit division)
    const __nv_bfloat16* xr =
        x + (!live          ? 0
             : inner >= rows ? row * row_stride
                             : (row / inner) * batch_stride + (row % inner) * row_stride);

    uint4 xv[VPL];
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      xv[i] = live && n[i] > 0 ? load8(xr + col[i], v16, n[i]) : make_uint4(0u, 0u, 0u, 0u);
    }

    float sum = 0.f;  // zeros past the row add nothing
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) sum += x_at<VPL>(xv[i], j);
    }
    sum = warp_sum(sum);
    if (wpr > 1) {
      if (lane == 0) partial[0][warp] = sum;
      __syncthreads();
      sum = 0.f;
      for (int w = 0; w < wpr; ++w) sum += partial[0][slot * wpr + w];
    }
    const float mean = sum / cf;

    float squares = 0.f;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d = x_at<VPL>(xv[i], j) - mean;
        squares += j < n[i] ? d * d : 0.f;
      }
    }
    squares = warp_sum(squares);
    if (wpr > 1) {
      if (lane == 0) partial[1][warp] = squares;
      __syncthreads();
      squares = 0.f;
      for (int w = 0; w < wpr; ++w) squares += partial[1][slot * wpr + w];
    }
    const float rstd = rsqrtf(squares / cf + eps);

    if (!live) continue;
    __nv_bfloat16* yr = y + row * c;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      if (n[i] <= 0) continue;
      float o[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        // the reference's order and roundings: (x - mean) * rstd, * gamma, + beta
        const float t = __fmul_rn(__fmul_rn(x_at<VPL>(xv[i], j) - mean, rstd), g[i][j]);
        o[j] = has_beta ? __fadd_rn(t, b[i][j]) : t;
      }
      store8(yr + col[i], o, v16, n[i]);
    }
  }
}

// Blocks of the instantiation that one SM holds at once (once per
// instantiation), times the current card's SMs (once per card).
template <auto KERNEL>
int resident_blocks() {
  static int per_sm = 0;
  static int sms[64] = {};
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || device >= 64) return 0;
  if (per_sm == 0 &&
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, KERNEL, kThreads, 0) != cudaSuccess) {
    per_sm = 0;
  }
  if (sms[device] == 0) {
    cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount, device);
  }
  return per_sm * sms[device];
}

template <int VPL, typename P>
int launch(const void* x, void* y, const void* gamma, const void* beta, long long rows, int c,
           long long inner, long long batch_stride, long long row_stride, int wpr, int blocks,
           int vec, float eps, cudaStream_t stream) {
  const int resident = resident_blocks<layer_norm_fwd_kernel<VPL, P>>();
  if (resident < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  layer_norm_fwd_kernel<VPL, P><<<min(blocks, resident), kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y),
      static_cast<const P*>(gamma), static_cast<const P*>(beta), rows, c, inner, batch_stride,
      row_stride, wpr, vec, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entries, bound with ctypes. x: bf16 rows of C (1 to 8192) elements, row
// r at (r / inner) * batch_stride + (r % inner) * row_stride elements
// (layer_norm_fwd_strided; layer_norm_fwd takes contiguous rows, which
// saves the host three arguments, about 0.5 us of a call); y: (rows, C)
// bf16, contiguous; gamma and beta (C,) bf16, or fp32; beta may be null.
// `launch_word`, the plan in one argument: bit 0 `vec` (C % 8 == 0 and x,
// y, gamma, beta and both strides 16-byte aligned: 16-byte accesses, else
// the scalar path), bit 1 gamma and beta fp32, bits 2-4 wpr (1, 2 or 4
// warps a row), bits 5-8 vpl (vectors of 8 elements a lane, vpl * wpr *
// 256 >= C), bits 9 and up the most blocks of 128 threads
// (ops.layer_norm.ln_plan). Launch on `stream` and return a cudaError_t: a
// malformed plan, or cudaGetLastError().
extern "C" int layer_norm_fwd_strided(const void* x, void* y, const void* gamma,
                                      const void* beta, long long rows, int c, long long inner,
                                      long long batch_stride, long long row_stride,
                                      int launch_word, float eps, void* stream) {
  const int vec = launch_word & 1;
  const int params_fp32 = (launch_word >> 1) & 1;
  const int wpr = (launch_word >> 2) & 7;
  const int vpl = (launch_word >> 5) & 15;
  const int blocks = launch_word >> 9;
  if (rows < 1 || c < 1 || c > kMaxC || inner < 1 || vpl < 1 || vpl > kMaxVpl || blocks < 1 ||
      (wpr != 1 && wpr != 2 && wpr != 4) || static_cast<long long>(vpl) * wpr * 256 < c) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LN_LAUNCH(V)                                                                            \
  (params_fp32 ? launch<V, float>(x, y, gamma, beta, rows, c, inner, batch_stride, row_stride, \
                                  wpr, blocks, vec, eps, st)                                   \
               : launch<V, __nv_bfloat16>(x, y, gamma, beta, rows, c, inner, batch_stride,     \
                                          row_stride, wpr, blocks, vec, eps, st))
  switch (vpl) {
    case 1: return LN_LAUNCH(1);
    case 2: return LN_LAUNCH(2);
    case 3: return LN_LAUNCH(3);
    case 4: return LN_LAUNCH(4);
    case 5: return LN_LAUNCH(5);
    case 6: return LN_LAUNCH(6);
    case 7: return LN_LAUNCH(7);
    default: return LN_LAUNCH(8);
  }
#undef LN_LAUNCH
}

extern "C" int layer_norm_fwd(const void* x, void* y, const void* gamma, const void* beta,
                              long long rows, int c, int launch_word, float eps, void* stream) {
  return layer_norm_fwd_strided(x, y, gamma, beta, rows, c, rows, 0, c, launch_word, eps, stream);
}
