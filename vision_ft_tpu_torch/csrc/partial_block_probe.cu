// The ragged-tile probe for Hopper (sm_90a), CUDA C++ (kernel L): two kernels
// whose grid's last block overhangs the array.
//
// Replaces tools/bench/partial_block_probe.py::_kernel (an exact copy of
// (S, C) rows in blocks of 512 rows that do not divide S) and
// ::_lastaxis_kernel (x * 2 + 1 over (8, S) in blocks of 512 columns that
// do not divide S). There the question was whether Mosaic takes grid
// blocks that do not divide the array. Here it is whether a tile that
// overhangs reads zeros and writes nothing past the end: cp.async with
// source size 0 for the elements past S, and stores guarded by S.
//
// What bounds it on an H100: device memory (a copy: every byte read once
// and written once). Each block stages its tile through shared memory in
// chunks, as a kernel that computes on the tile would.
//
//   - partial_block_copy_kernel: block i owns rows [i * block_rows,
//     (i + 1) * block_rows) of an (S, row_bytes) byte matrix and stages them
//     32 KB at a time with 16-byte cp.async; rows past S are zero-filled
//     loads. It stores rows below S and counts the nonzero 16-byte words
//     it staged for rows past S (__syncthreads_count, no atomics) into
//     overhang[i].
//   - partial_block_lastaxis_kernel: block i owns columns [i * block_cols,
//     (i + 1) * block_cols) of an (rows, S) fp32 matrix, stages them with
//     4-byte cp.async (element-granular: any S), zero past S, stores
//     x * 2 + 1 below S and counts the nonzero staged values past S.
//   - partial_block_tma_kernel: the question for TMA, which kernel F relies
//     on. Block (i, j) loads box (rows [128 i, 128 i + 128), columns
//     [64 j, 64 j + 64)) of an (S, C) bf16 matrix through a 2-D tensor map
//     with 128-byte swizzle (the mode of kernel F's operands), counts the
//     nonzero 16-byte words staged for rows past S and the valid elements
//     not where the swizzle formula of hopper_gemm.cuh puts them (read back
//     against x in device memory), and stores the box back with TMA through
//     a map of S rows over a longer buffer.
// Contract (the wrapper checks it): row_bytes % 16 == 0, row_bytes <= 32768,
// contiguous 16-byte aligned tensors; for the TMA case C % 64 == 0.

#include "hopper_gemm.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunkBytes = 32768;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int bytes) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int bytes) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

__global__ void __launch_bounds__(kThreads)
partial_block_copy_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ y, int rows,
                          int row_bytes, int block_rows, int* __restrict__ overhang) {
  __shared__ __align__(16) uint8_t tile[kChunkBytes];
  const int vecs_per_row = row_bytes / 16;
  const int chunk_rows = kChunkBytes / row_bytes;
  const long long block_row0 = (long long)blockIdx.x * block_rows;
  int nonzero = 0;
  for (int r0 = 0; r0 < block_rows; r0 += chunk_rows) {
    const int n_rows = min(chunk_rows, block_rows - r0);
    const int n_vecs = n_rows * vecs_per_row;
    for (int v = threadIdx.x; v < n_vecs; v += kThreads) {
      const long long row = block_row0 + r0 + v / vecs_per_row;
      const long long offset = row * row_bytes + (v % vecs_per_row) * 16;
      cp_async16(tile + v * 16, row < rows ? x + offset : x, row < rows ? 16 : 0);
    }
    cp_async_wait_all();
    __syncthreads();
    for (int v = threadIdx.x; v < n_vecs; v += kThreads) {
      const long long row = block_row0 + r0 + v / vecs_per_row;
      const uint4 val = *reinterpret_cast<const uint4*>(tile + v * 16);
      if (row < rows) {
        *reinterpret_cast<uint4*>(y + row * row_bytes + (v % vecs_per_row) * 16) = val;
      } else {
        nonzero += (val.x | val.y | val.z | val.w) != 0u;
      }
    }
    __syncthreads();  // the tile is read before the next chunk lands in it
  }
  const int total = __syncthreads_count(nonzero);
  if (threadIdx.x == 0) overhang[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kThreads)
partial_block_lastaxis_kernel(const float* __restrict__ x, float* __restrict__ y, int rows,
                              int cols, int block_cols, int* __restrict__ overhang) {
  extern __shared__ __align__(16) float stile[];
  const long long col0 = (long long)blockIdx.x * block_cols;
  const int n = rows * block_cols;
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const long long col = col0 + e % block_cols;
    const long long offset = (long long)(e / block_cols) * cols + col;
    cp_async4(stile + e, col < cols ? x + offset : x, col < cols ? 4 : 0);
  }
  cp_async_wait_all();
  __syncthreads();
  int nonzero = 0;
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const long long col = col0 + e % block_cols;
    const float v = stile[e];
    if (col < cols) {
      y[(long long)(e / block_cols) * cols + col] = v * 2.0f + 1.0f;
    } else {
      nonzero += v != 0.0f;
    }
  }
  const int total = __syncthreads_count(nonzero);
  if (threadIdx.x == 0) overhang[blockIdx.x] = total;
}

constexpr int kTmaRows = 128;
constexpr int kTmaCols = 64;
constexpr int kTmaBoxBytes = kTmaRows * kTmaCols * 2;

__global__ void __launch_bounds__(128)
partial_block_tma_kernel(const __grid_constant__ CUtensorMap map_x,
                         const __grid_constant__ CUtensorMap map_y,
                         const __nv_bfloat16* __restrict__ x, int rows, int cols,
                         int* __restrict__ counts) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* box = hopper::align_1024(smem_raw);
  uint64_t* bar = reinterpret_cast<uint64_t*>(box + kTmaBoxBytes);
  const int row0 = blockIdx.x * kTmaRows;
  const int col0 = blockIdx.y * kTmaCols;
  if (threadIdx.x == 0) {
    hopper::mbar_init(bar, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    hopper::mbar_arrive_expect_tx(bar, kTmaBoxBytes);
    hopper::tma_load_2d(box, &map_x, bar, col0, row0);
  }
  hopper::mbar_wait(bar, 0);
  int nonzero = 0;
  int misplaced = 0;
  for (int v = threadIdx.x; v < kTmaRows * (kTmaCols / 8); v += blockDim.x) {
    const int r = v / (kTmaCols / 8);
    const int chunk = v % (kTmaCols / 8);
    // a swizzled row keeps its 128 bytes: only the 16-byte chunks move
    const uint4 word = *reinterpret_cast<const uint4*>(box + r * 128 + chunk * 16);
    if (row0 + r >= rows) {
      nonzero += (word.x | word.y | word.z | word.w) != 0u;
    } else {
      const __nv_bfloat16* src = x + (long long)(row0 + r) * cols + col0 + chunk * 8;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const uint32_t staged =
            *reinterpret_cast<const uint32_t*>(box + hopper::sw128_offset(r, chunk, p));
        misplaced += staged != *reinterpret_cast<const uint32_t*>(src + 2 * p);
      }
    }
  }
  const int total_nonzero = __syncthreads_count(nonzero);
  const int total_misplaced = __syncthreads_count(misplaced);
  if (threadIdx.x == 0) {
    const int block = blockIdx.x * gridDim.y + blockIdx.y;
    counts[2 * block] = total_nonzero;
    counts[2 * block + 1] = total_misplaced;
    hopper::tma_store_2d(&map_y, box, col0, row0);  // the box as TMA wrote it: no fence needed
    hopper::tma_store_commit();
    hopper::tma_store_wait<0>();
  }
}

}  // namespace

// C entries, bound with ctypes. Launch on `stream`, return cudaGetLastError().
// x, y: (rows, row_bytes) bytes, contiguous, 16-byte aligned; overhang:
// ceil(rows / block_rows) int32.
extern "C" int partial_block_copy(const void* x, void* y, int rows, int row_bytes,
                                  int block_rows, void* overhang, void* stream) {
  if (rows < 1 || block_rows < 1 || row_bytes < 16 || row_bytes % 16 != 0 ||
      row_bytes > kChunkBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned blocks = (unsigned)((rows + (long long)block_rows - 1) / block_rows);
  partial_block_copy_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<uint8_t*>(y), rows, row_bytes, block_rows,
      static_cast<int*>(overhang));
  return static_cast<int>(cudaGetLastError());
}

// x, y: (rows, cols) fp32, contiguous; overhang: ceil(cols / block_cols) int32.
extern "C" int partial_block_lastaxis(const void* x, void* y, int rows, int cols, int block_cols,
                                      void* overhang, void* stream) {
  const long long smem = (long long)rows * block_cols * 4;
  if (rows < 1 || cols < 1 || block_cols < 1 || smem > 48 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned blocks = (unsigned)((cols + (long long)block_cols - 1) / block_cols);
  partial_block_lastaxis_kernel<<<blocks, kThreads, (size_t)smem,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), rows, cols, block_cols,
      static_cast<int*>(overhang));
  return static_cast<int>(cudaGetLastError());
}

// x: (rows, cols) bf16, cols % 64 == 0, contiguous, 16-byte aligned; y: a
// buffer of at least rows * cols bf16 whose first rows * cols are written;
// counts: 2 * ceil(rows / 128) * (cols / 64) int32 (per box: nonzero words
// past rows, valid pairs off the swizzle's place).
extern "C" int partial_block_tma(const void* x, void* y, int rows, int cols, void* counts,
                                 void* stream) {
  if (rows < 1 || cols < kTmaCols || cols % kTmaCols != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap map_x, map_y;
  int err = hopper::make_map_2d(&map_x, x, rows, cols, kTmaRows);
  if (!err) err = hopper::make_map_2d(&map_y, y, rows, cols, kTmaRows);
  if (err) return err;
  const dim3 grid((rows + kTmaRows - 1) / kTmaRows, cols / kTmaCols);
  const size_t smem = 1024 + kTmaBoxBytes + sizeof(uint64_t);
  partial_block_tma_kernel<<<grid, 128, smem, static_cast<cudaStream_t>(stream)>>>(
      map_x, map_y, static_cast<const __nv_bfloat16*>(x), rows, cols, static_cast<int*>(counts));
  return static_cast<int>(cudaGetLastError());
}
