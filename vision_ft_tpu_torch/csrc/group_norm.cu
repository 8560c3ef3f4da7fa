// Fused GroupNorm (+ optional SiLU) forward for Hopper (sm_90a), CUDA C++:
// kernel J, one cooperative launch a call.
//
// Replaces vision_ft_tpu/ops/pallas/group_norm.py::_stats_kernel and
// ::_norm_kernel (launched by _gn_fwd_impl, entry group_norm_tpu), and the
// per-group combine that the JAX package runs in XLA between them.
//
// Computes, for x (B, S, C) bf16 or fp32 and G groups of C / G channels:
// fp32 sums and sums of squares over S and the group's channels, mean and
// var = E[x^2] - mean^2, rstd = rsqrt(var + eps), then ((x - mean) * rstd)
// * gamma + beta, optionally SiLU, cast to x's dtype.
//
// What bounds it on an H100: device memory. A few operations an element
// against the card's 295 bf16 operations a byte. x is read twice and y
// written once; where x is small enough to have fitted in the SMs' shared
// memory (about 30 MB) it also fits in L2 (50 MB), so the second read
// comes from L2.
//
// Design:
//   - One persistent grid of 512-thread blocks, one an SM (all resident:
//     cudaLaunchCooperativeKernel refuses a grid that cannot be, and the
//     wrapper raises). The work items are (batch entry, part of S), each a
//     contiguous run of `rows` rows (whose bytes are a multiple of 16, so
//     every run starts 16-byte aligned); items beyond the grid run in
//     rounds, and only where a batch entry is one item (parts == 1), so
//     that a round's barrier follows every partial a block combines.
//     ops.group_norm.gn_plan fixes blocks, parts, rows and chunks from the
//     shape and the SM count alone.
//   - Rows reach shared memory in chunks, each one 1-D bulk TMA copy issued
//     by thread 0 and completing its own mbarrier. Each pass streams the
//     item's chunks (about 32 KB) through a ring of 4, three loads ahead.
//     Threads read 16-byte vectors (8, 4 or 2 bytes where C's row is not a
//     multiple of 16).
//   - Statistics: each thread owns a column of vectors and sums it over its
//     lane of rows in fp32; the per-lane, per-channel sums meet in a shared
//     table; warp w folds them into groups w, w + 16, ... (a fixed order,
//     then a shuffle tree) and writes the item's (sum, sum of squares) per
//     group.
//   - Grid barrier (cooperative groups), then every block combines its
//     batch entry's partials of each group over the parts in order (no
//     float atomics: reruns are bit-identical; a group's partials lie side
//     by side, so a warp reads them in few lines), keeps mean and rstd per
//     group in shared memory and normalizes its own rows in the same
//     launch: affine, SiLU (its exponential and reciprocal on the special
//     function unit) and the cast, gamma and beta read once per column
//     into registers; the stores go straight to device memory.
// Not carried over from the TPU kernel: the sequential grid's revisited
// output block (blocks here run in parallel), the 8-sublane replication of
// the moments, the second launch and the combine outside the kernels.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_gemm.cuh"

namespace {

namespace cg = cooperative_groups;
using hopper::ex2_approx;
using hopper::fence_barrier_init;
using hopper::mbar_arrive_expect_tx;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::rcp_approx;
using hopper::smem_u32;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may use
constexpr int kStages = 4;          // the ring of chunks, a barrier each
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(float v) { return v; }
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}

// VEC elements of T in one access of VEC * sizeof(T) bytes (16, 8, 4 or 2).
template <int BYTES>
struct RawOf;
template <>
struct RawOf<16> { using type = uint4; };
template <>
struct RawOf<8> { using type = uint2; };
template <>
struct RawOf<4> { using type = uint32_t; };
template <>
struct RawOf<2> { using type = uint16_t; };

template <typename T, int VEC>
struct Vec {
  using Raw = typename RawOf<static_cast<int>(VEC * sizeof(T))>::type;
  __device__ static __forceinline__ void load(const T* p, float (&f)[VEC]) {
    const Raw r = *reinterpret_cast<const Raw*>(p);
    const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
    for (int j = 0; j < VEC; ++j) f[j] = to_float(e[j]);
  }
  __device__ static __forceinline__ void store(T* p, const float (&f)[VEC]) {
    Raw r;
    T* e = reinterpret_cast<T*>(&r);
#pragma unroll
    for (int j = 0; j < VEC; ++j) e[j] = from_float<T>(f[j]);
    *reinterpret_cast<Raw*>(p) = r;
  }
};

__device__ __forceinline__ float read_param(const void* p, int bf16, int i) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

// One 1-D bulk copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from device memory into shared memory; completes `bar`'s bytes.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// SiLU, v * sigmoid(v), with the exponential and the reciprocal on the
// special function unit: a few fp32 ulps, under the fp32 tolerance.
__device__ __forceinline__ float silu(float v) {
  return v * rcp_approx(1.f + ex2_approx(-v * kLog2e));
}

// Rows of lanes x columns of vectors: a thread owns column col0 (and col0 +
// kThreads where there are more columns than threads) and, in each chunk
// of rows, rows lane, lane + lanes, ...; threads with lane >= lanes idle.
struct Walk {
  int vecs, lanes, lane, col0;
  __device__ __forceinline__ Walk(int c, int vec) {
    vecs = c / vec;
    lanes = vecs >= kThreads ? 1 : kThreads / vecs;
    lane = vecs >= kThreads ? 0 : threadIdx.x / vecs;
    col0 = vecs >= kThreads ? threadIdx.x : threadIdx.x % vecs;
  }
  __device__ __forceinline__ bool active() const { return lane < lanes; }
  __device__ __forceinline__ bool has(int ci) const { return col0 + ci * kThreads < vecs; }
  __device__ __forceinline__ int col(int ci) const { return col0 + ci * kThreads; }
};

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, 1)
gn_fused_kernel(const T* __restrict__ x, T* __restrict__ y, const void* __restrict__ gamma,
                const void* __restrict__ beta, float2* partial, int s, int c, int groups,
                int parts, int rows, int chunk_rows, int items, int table_bytes, int silu_on,
                int gamma_bf16, int beta_bf16, float eps) {
  extern __shared__ __align__(16) uint8_t smem[];
  float2* table = reinterpret_cast<float2*>(smem);                // [lanes][c]
  float2* stats = reinterpret_cast<float2*>(smem + table_bytes);  // [groups]: mean, rstd
  uint64_t* bars = reinterpret_cast<uint64_t*>(stats + groups + (groups & 1));  // [kStages]
  T* data = reinterpret_cast<T*>(bars + kStages);  // the ring of chunks
  const Walk walk(c, VEC);
  const int cg_size = c / groups;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long chunk_elems = static_cast<long long>(chunk_rows) * c;
  cg::grid_group grid = cg::this_grid();

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(&bars[i], 1);
    fence_barrier_init();
  }
  __syncthreads();

  // chunks loaded so far: chunk g of the block's whole walk sits in ring
  // slot g % kStages and completes barrier g % kStages in phase g / kStages
  int loaded = 0;
  const int rounds = (items + gridDim.x - 1) / gridDim.x;
  for (int round = 0; round < rounds; ++round) {
    const int item = round * gridDim.x + blockIdx.x;
    const int bi = item / parts;
    const int row0 = (item % parts) * rows;
    const int n = item < items ? min(rows, s - row0) : 0;  // this item's rows
    const int chunks = (n + chunk_rows - 1) / chunk_rows;
    const T* xi = x + (static_cast<long long>(bi) * s + row0) * c;
    T* yi = y + (static_cast<long long>(bi) * s + row0) * c;

    // Walks this item's chunks in order through the ring, kStages - 1 loads
    // ahead: body(first row, rows, their copy in shared memory).
    auto walk_chunks = [&](auto&& body) {
      auto slot = [&](int k) { return data + (loaded + k) % kStages * chunk_elems; };
      auto issue = [&](int k) {
        const int b = (loaded + k) % kStages;
        const uint32_t bytes =
            static_cast<uint32_t>(min(chunk_rows, n - k * chunk_rows) * static_cast<long long>(c) *
                                  sizeof(T));
        mbar_arrive_expect_tx(&bars[b], bytes);
        bulk_load(slot(k), xi + k * chunk_elems, bytes, &bars[b]);
      };
      if (threadIdx.x == 0) {
        for (int k = 0; k < min(chunks, kStages); ++k) issue(k);
      }
      for (int k = 0; k < chunks; ++k) {
        const int g = loaded + k;
        mbar_wait(&bars[g % kStages], (g / kStages) & 1u);
        body(k * chunk_rows, min(chunk_rows, n - k * chunk_rows), slot(k));
        __syncthreads();  // every thread is done with the slot
        if (threadIdx.x == 0 && k + kStages < chunks) issue(k + kStages);
      }
      loaded += chunks;
    };

    if (n > 0) {
      // per-channel sums over this thread's rows, in fp32 registers
      float sum[2][VEC], sq[2][VEC];
#pragma unroll
      for (int ci = 0; ci < 2; ++ci) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) sum[ci][j] = sq[ci][j] = 0.f;
      }
      walk_chunks([&](int, int nr, const T* rows_k) {
        if (!walk.active()) return;
#pragma unroll
        for (int ci = 0; ci < 2; ++ci) {
          if (!walk.has(ci)) continue;
          float v[VEC];
#pragma unroll 4
          for (int r = walk.lane; r < nr; r += walk.lanes) {
            Vec<T, VEC>::load(rows_k + static_cast<long long>(r) * c + walk.col(ci) * VEC, v);
#pragma unroll
            for (int j = 0; j < VEC; ++j) {
              sum[ci][j] += v[j];
              sq[ci][j] += v[j] * v[j];
            }
          }
        }
      });
      if (walk.active()) {
#pragma unroll
        for (int ci = 0; ci < 2; ++ci) {
          if (!walk.has(ci)) continue;
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            table[walk.lane * c + walk.col(ci) * VEC + j] = make_float2(sum[ci][j], sq[ci][j]);
          }
        }
      }
      __syncthreads();
      // the item's per-group partials: warp w folds groups w, w + kWarps, ...
      const int entries = walk.lanes * cg_size;
      for (int g = warp; g < groups; g += kWarps) {
        float gs = 0.f, gq = 0.f;
        for (int e = lane; e < entries; e += 32) {
          const float2 t = table[(e / cg_size) * c + g * cg_size + e % cg_size];
          gs += t.x;
          gq += t.y;
        }
#pragma unroll
        for (int off = 16; off > 0; off /= 2) {
          gs += __shfl_xor_sync(0xffffffffu, gs, off);
          gq += __shfl_xor_sync(0xffffffffu, gq, off);
        }
        if (lane == 0) {
          partial[(static_cast<long long>(bi) * groups + g) * parts + item % parts] =
              make_float2(gs, gq);
        }
      }
    }

    grid.sync();  // every item's partials of this round are written

    if (n > 0) {
      // combine this batch entry's parts, in order, into mean and rstd per group
      const float count = static_cast<float>(s) * static_cast<float>(cg_size);
      for (int g = warp; g < groups; g += kWarps) {
        float gs = 0.f, gq = 0.f;
        for (int p = lane; p < parts; p += 32) {
          const float2 t = __ldcg(&partial[(static_cast<long long>(bi) * groups + g) * parts + p]);
          gs += t.x;
          gq += t.y;
        }
#pragma unroll
        for (int off = 16; off > 0; off /= 2) {
          gs += __shfl_xor_sync(0xffffffffu, gs, off);
          gq += __shfl_xor_sync(0xffffffffu, gq, off);
        }
        if (lane == 0) {
          const float mean = gs / count;
          const float var = gq / count - mean * mean;
          stats[g] = make_float2(mean, rsqrtf(var + eps));
        }
      }
      __syncthreads();
      // normalize this item's rows: ((x - mean) * rstd) * gamma + beta [, SiLU]
      float mean[2][VEC], rstd[2][VEC], gam[2][VEC], bet[2][VEC];
#pragma unroll
      for (int ci = 0; ci < 2; ++ci) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const int ch = min(walk.col(ci) * VEC + j, c - 1);
          const float2 st = stats[ch / cg_size];
          mean[ci][j] = st.x;
          rstd[ci][j] = st.y;
          gam[ci][j] = read_param(gamma, gamma_bf16, ch);
          bet[ci][j] = read_param(beta, beta_bf16, ch);
        }
      }
      walk_chunks([&](int first, int nr, const T* rows_k) {
        if (!walk.active()) return;
#pragma unroll
        for (int ci = 0; ci < 2; ++ci) {
          if (!walk.has(ci)) continue;
          float v[VEC];
#pragma unroll 4
          for (int r = walk.lane; r < nr; r += walk.lanes) {
            const long long off = static_cast<long long>(r) * c + walk.col(ci) * VEC;
            Vec<T, VEC>::load(rows_k + off, v);
#pragma unroll
            for (int j = 0; j < VEC; ++j) {
              const float out = (v[j] - mean[ci][j]) * rstd[ci][j] * gam[ci][j] + bet[ci][j];
              v[j] = silu_on ? silu(out) : out;
            }
            Vec<T, VEC>::store(yi + static_cast<long long>(first) * c + off, v);
          }
        }
      });
      __syncthreads();  // the table and stats are free for the next round
    }
  }
}

// Bytes of the per-lane, per-channel table: what the host plans with.
int table_bytes(int c, int vec) {
  const int vecs = c / vec;
  const int lanes = vecs >= kThreads ? 1 : kThreads / vecs;
  return (lanes * c * 8 + 15) / 16 * 16;
}

template <typename T, int VEC>
int launch(const void* x, void* y, const void* gamma, const void* beta, void* partial, int batch,
           int s, int c, int groups, int gamma_bf16, int beta_bf16, int blocks, int parts,
           int rows, int chunk_rows, int silu_on, float eps, cudaStream_t stream) {
  int items = batch * parts;
  int tb = table_bytes(c, VEC);
  const long long row_bytes = static_cast<long long>(c) * sizeof(T);
  const long long smem = tb + (groups + (groups & 1)) * 8LL + kStages * 8 +
                         static_cast<long long>(kStages) * chunk_rows * row_bytes;
  if (smem > kSmemLimit || c / VEC > 2 * kThreads || (chunk_rows * row_bytes) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = gn_fused_kernel<T, VEC>;
  cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  float2* pt = static_cast<float2*>(partial);
  void* args[] = {&xt, &yt, &gamma, &beta, &pt, &s, &c, &groups, &parts, &rows, &chunk_rows,
                  &items, &tb, &silu_on, &gamma_bf16, &beta_bf16, &eps};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(blocks),
                                    dim3(kThreads), args, static_cast<size_t>(smem), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry, bound with ctypes. x and y (B, S, C) contiguous, bf16 (itemsize
// 2) or fp32 (4), 16-byte aligned; S a multiple of 8; gamma and beta (C,)
// contiguous, bf16 where the flag is set, else fp32; partial (B, groups,
// parts) pairs of fp32. `blocks` blocks of 512 threads walk the B * parts
// items of `rows` rows in rounds (only where parts == 1), each pass
// streaming chunks of `chunk_rows` rows through a ring of 4 (both rows * C *
// itemsize a multiple of 16). At most 1024 vectors of a row. Launches
// cooperatively on `stream` and returns the first error: a plan that is
// malformed or does not fit shared memory, the attribute, the launch (a
// grid that cannot be resident at once: cudaErrorCooperativeLaunchTooLarge),
// or cudaGetLastError().
extern "C" int group_norm_fwd(const void* x, void* y, const void* gamma, const void* beta,
                              void* partial, int batch, int s, int c, int groups, int itemsize,
                              int gamma_bf16, int beta_bf16, int blocks, int parts, int rows,
                              int chunk_rows, int silu, float eps, void* stream) {
  // parts > 1 in rounds would combine partials of a later round, not yet written
  if (batch < 1 || s < 8 || s % 8 != 0 || groups < 1 || c % groups != 0 || blocks < 1 ||
      parts < 1 || rows < 1 || chunk_rows < 1 ||
      (static_cast<long long>(rows) * c * itemsize) % 16 != 0 ||
      static_cast<long long>(parts) * rows < s || static_cast<long long>(parts - 1) * rows >= s ||
      (parts > 1 && static_cast<long long>(blocks) < static_cast<long long>(batch) * parts)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int row_bytes = c * itemsize;
  const int vec_bytes = row_bytes % 16 == 0 ? 16 : row_bytes % 8 == 0 ? 8 : row_bytes % 4 == 0 ? 4 : 2;
#define GN_LAUNCH(T, VEC)                                                                 \
  launch<T, VEC>(x, y, gamma, beta, partial, batch, s, c, groups, gamma_bf16, beta_bf16, blocks, \
                 parts, rows, chunk_rows, silu, eps, st)
  if (itemsize == 2) {
    switch (vec_bytes) {
      case 16: return GN_LAUNCH(__nv_bfloat16, 8);
      case 8: return GN_LAUNCH(__nv_bfloat16, 4);
      case 4: return GN_LAUNCH(__nv_bfloat16, 2);
      default: return GN_LAUNCH(__nv_bfloat16, 1);
    }
  }
  if (itemsize == 4) {
    switch (vec_bytes) {
      case 16: return GN_LAUNCH(float, 4);
      case 8: return GN_LAUNCH(float, 2);
      default: return GN_LAUNCH(float, 1);
    }
  }
#undef GN_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
