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
// Contract (the wrapper checks it): row_bytes % 16 == 0, row_bytes <= 32768,
// contiguous 16-byte aligned tensors.

#include <cuda_runtime.h>
#include <stdint.h>

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
