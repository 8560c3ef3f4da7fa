// The ragged-tile probe for Hopper (sm_90a), CUDA C++ (kernel L): three
// kernels whose last tile overhangs the array.
//
// Replaces tools/bench/partial_block_probe.py::_kernel (an exact copy of
// (S, C) rows in blocks of 512 rows that do not divide S) and
// ::_lastaxis_kernel (x * 2 + 1 over (8, S) in blocks of 512 columns that
// do not divide S). There the question was whether Mosaic takes grid
// blocks that do not divide the array. Here it is whether a tile that
// overhangs reads zeros and writes nothing past the end: cp.async with
// source size 0 for the elements past S, and stores guarded by S.
//
// What bounds it on an H100: device memory (every byte read once and
// written once); at the probe's sizes (0.3 to 4.5 MB) a call is a few
// microseconds of the card, so the grid has to spread over the SMs and the
// host's path to a launch matters as much.
//
//   - partial_block_copy_kernel: tile i (rows [i * block_rows, (i + 1) *
//     block_rows) of an (S, row_bytes) byte matrix) is one thread-block
//     cluster of up to 16 CTAs (8, the portable size, where a CTA's ring
//     would pass 32 KB; the plan is tools.partial_block_probe.copy_plan),
//     CTA k owning the tile's rows [k * cta_rows, (k + 1) * cta_rows). A
//     CTA stages its rows in chunks through a ring of 4 cp.async stages
//     (commit_group / wait_group 3: the next three chunks' loads in flight
//     while a chunk is stored); rows past S are 16-byte cp.async with
//     source size 0, also in CTAs wholly past S. It stores the rows below S
//     and counts the nonzero 16-byte words staged for rows past S; the
//     cluster adds its CTAs' counts in rank order through distributed
//     shared memory into overhang[i] (no atomics: reruns are
//     bit-identical). At S = 4360 that is 9 clusters of 16, 144 CTAs, not 9.
//   - partial_block_lastaxis_kernel: tile i (columns [i * block_cols, (i +
//     1) * block_cols) of an (R, S) fp32 matrix) is a cluster whose CTAs own
//     the tile's rows; each stages its rows with 16-byte cp.async for every
//     4-column group wholly below or wholly past S (where the group is
//     16-byte aligned) and 4-byte cp.async for a group that straddles S,
//     stores x * 2 + 1 below S and counts the nonzero values staged past S,
//     summed over the cluster as above.
//   - partial_block_tma_kernel: the question for TMA, which kernel F relies
//     on. Block (i, j) loads box (rows [128 i, 128 i + 128), columns
//     [64 j, 64 j + 64)) of an (S, C) bf16 matrix through a 2-D tensor map
//     with 128-byte swizzle (the mode of kernel F's operands), stores it
//     back at once with TMA through a map of S rows over a longer buffer,
//     and while the store reads the box counts the nonzero 16-byte words
//     staged for rows past S and the valid elements not where the swizzle
//     formula of hopper_gemm.cuh puts them (against x, read from device
//     memory while the box loads). The C entry keeps the maps it encodes
//     in a small cache.
// Every thread reads back only the shared memory its own copies wrote, so
// the copy kernels need no barrier between a stage's load and its store.
// Contract (the wrapper checks it): row_bytes % 16 == 0, row_bytes <= 32768,
// contiguous 16-byte aligned tensors; for the TMA case C % 64 == 0.

#include <cooperative_groups.h>

#include <mutex>

#include "hopper_gemm.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 4;             // the copy kernel's ring
constexpr int kMaxRowBytes = 32768;
constexpr int kMaxCluster = 16;        // 8 is the portable size; 16 needs the non-portable attribute

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(hopper::smem_u32(smem)),
               "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(hopper::smem_u32(smem)),
               "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// At most N of this thread's committed groups still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The cluster's sum of its CTAs' counts, through distributed shared memory.
// Rank 0's shared memory holds one slot a CTA and an mbarrier armed for one
// 4-byte count a CTA; each CTA sends its count with st.async, whose landing
// completes the barrier's bytes, and rank 0 adds the slots in rank order
// once the barrier's phase completes. No CTA waits on another's stores: a
// cluster barrier with release semantics (arrive.release / wait.acquire)
// holds every CTA until its global stores are done (the copy took 4.2 us
// on the card that way, 3.7 this way).
struct ClusterCounts {
  uint64_t bar;
  int slots[kMaxCluster];
};

__device__ __forceinline__ uint32_t rank0_address(const void* p) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(hopper::smem_u32(p)), "r"(0u));
  return remote;
}

// At the kernel's start, every thread: rank 0 arms its barrier, then all
// arrive (relaxed) on the cluster barrier that cluster_sum_end waits on
// before its first write into rank 0, so that the wait for every CTA to
// have started overlaps the copies.
__device__ void cluster_sum_begin(ClusterCounts* counts) {
  cg::cluster_group cluster = cg::this_cluster();
  if (cluster.block_rank() == 0 && threadIdx.x == 0) {
    hopper::mbar_init(&counts->bar, 1);
    hopper::mbar_arrive_expect_tx(&counts->bar, 4 * cluster.num_blocks());
    hopper::fence_barrier_init();
  }
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}

// The CTA's sum of every thread's `count` (warp sums in warp order) into its
// slot of rank 0; rank 0 writes the cluster's sum to *out. Every thread of
// every CTA calls it, once, after cluster_sum_begin.
__device__ void cluster_sum_end(ClusterCounts* counts, int count, int* out) {
  __shared__ int warp_sums[kWarps];
  cg::cluster_group cluster = cg::this_cluster();
  count = __reduce_add_sync(0xffffffffu, count);
  if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = count;
  asm volatile("barrier.cluster.wait;\n" ::: "memory");  // rank 0's barrier is armed
  __syncthreads();
  if (threadIdx.x != 0) return;
  int sum = 0;
  for (int w = 0; w < kWarps; ++w) sum += warp_sums[w];
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.u32 [%0], %1, [%2];\n" ::"r"(
                   rank0_address(&counts->slots[cluster.block_rank()])),
               "r"(sum), "r"(rank0_address(&counts->bar))
               : "memory");
  if (cluster.block_rank() != 0) return;
  const uint32_t bar = hopper::smem_u32(&counts->bar);
  // as hopper::mbar_wait, at cluster scope: a count lost for seconds traps, not hangs
  for (uint32_t done = 0, polls = 0; !done; ++polls) {
    if (polls == (1u << 26)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar)
        : "memory");
  }
  int total = 0;
  for (unsigned r = 0; r < cluster.num_blocks(); ++r) total += counts->slots[r];
  *out = total;
}

__global__ void __launch_bounds__(kThreads)
partial_block_copy_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ y, int rows,
                          int row_bytes, int block_rows, int cta_rows, int chunk_rows,
                          int* __restrict__ overhang) {
  extern __shared__ __align__(16) uint8_t ring[];
  __shared__ ClusterCounts counts;
  cg::cluster_group cluster = cg::this_cluster();
  const int tile = blockIdx.x / cluster.num_blocks();
  const int first = min(static_cast<int>(cluster.block_rank()) * cta_rows, block_rows);
  const int n_rows = min(cta_rows, block_rows - first);  // 0 for an empty slice
  const long long row0 = static_cast<long long>(tile) * block_rows + first;
  const int vecs_per_row = row_bytes / 16;
  const int stage_bytes = chunk_rows * row_bytes;
  const int chunks = (n_rows + chunk_rows - 1) / chunk_rows;
  cluster_sum_begin(&counts);

  // chunk k's rows into stage k % kStages; vector v is always thread v % kThreads's
  auto issue = [&](int k) {
    if (k < chunks) {
      uint8_t* stage = ring + (k % kStages) * stage_bytes;
      const int n_vecs = min(chunk_rows, n_rows - k * chunk_rows) * vecs_per_row;
      for (int v = threadIdx.x; v < n_vecs; v += kThreads) {
        const long long row = row0 + static_cast<long long>(k) * chunk_rows + v / vecs_per_row;
        const uint8_t* src = row < rows ? x + row * row_bytes + (v % vecs_per_row) * 16 : x;
        cp_async16(stage + v * 16, src, row < rows ? 16 : 0);
      }
    }
    cp_async_commit();  // empty past the last chunk: the group count stays in step
  };

  int nonzero = 0;
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) issue(k);
  for (int k = 0; k < chunks; ++k) {
    issue(k + kStages - 1);  // into the stage of chunk k - 1, which this thread has stored
    cp_async_wait<kStages - 1>();  // this thread's copies of chunk k have landed
    const uint8_t* stage = ring + (k % kStages) * stage_bytes;
    const int n_vecs = min(chunk_rows, n_rows - k * chunk_rows) * vecs_per_row;
    for (int v = threadIdx.x; v < n_vecs; v += kThreads) {
      const long long row = row0 + static_cast<long long>(k) * chunk_rows + v / vecs_per_row;
      const uint4 val = *reinterpret_cast<const uint4*>(stage + v * 16);
      if (row < rows) {
        *reinterpret_cast<uint4*>(y + row * row_bytes + (v % vecs_per_row) * 16) = val;
      } else {
        nonzero += (val.x | val.y | val.z | val.w) != 0u;
      }
    }
  }
  cluster_sum_end(&counts, nonzero, overhang + tile);
}

__global__ void __launch_bounds__(kThreads)
partial_block_lastaxis_kernel(const float* __restrict__ x, float* __restrict__ y, int rows,
                              int cols, int block_cols, int cta_rows,
                              int* __restrict__ overhang) {
  extern __shared__ __align__(16) float stile[];
  __shared__ ClusterCounts counts;
  cg::cluster_group cluster = cg::this_cluster();
  const int tile = blockIdx.x / cluster.num_blocks();
  const int r0 = min(static_cast<int>(cluster.block_rank()) * cta_rows, rows);
  const int n_rows = min(cta_rows, rows - r0);
  const long long col0 = static_cast<long long>(tile) * block_cols;
  const int groups = (block_cols + 3) / 4;  // 4-column groups of a tile row
  const bool wide = block_cols % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  cluster_sum_begin(&counts);

  for (int e = threadIdx.x; e < n_rows * groups; e += kThreads) {
    const int r = e / groups;
    const int g = e % groups;
    const long long col = col0 + 4 * g;
    const long long offset = static_cast<long long>(r0 + r) * cols + col;
    float* dst = stile + r * block_cols + 4 * g;
    if (wide && offset % 4 == 0 && (col + 4 <= cols || col >= cols)) {
      cp_async16(dst, col < cols ? x + offset : x, col < cols ? 16 : 0);
    } else {  // the group that straddles S, or an unaligned one
      for (int j = 0; j < 4 && 4 * g + j < block_cols; ++j) {
        cp_async4(dst + j, col + j < cols ? x + offset + j : x, col + j < cols ? 4 : 0);
      }
    }
  }
  cp_async_commit();
  cp_async_wait<0>();

  int nonzero = 0;
  for (int e = threadIdx.x; e < n_rows * groups; e += kThreads) {
    const int r = e / groups;
    const int g = e % groups;
    const long long col = col0 + 4 * g;
    const float* src = stile + r * block_cols + 4 * g;
    for (int j = 0; j < 4 && 4 * g + j < block_cols; ++j) {
      if (col + j < cols) {
        y[static_cast<long long>(r0 + r) * cols + col + j] = src[j] * 2.0f + 1.0f;
      } else {
        nonzero += src[j] != 0.0f;
      }
    }
  }
  cluster_sum_end(&counts, nonzero, overhang + tile);
}

constexpr int kTmaRows = 128;
constexpr int kTmaCols = 64;
constexpr int kTmaBoxBytes = kTmaRows * kTmaCols * 2;
constexpr int kTmaThreads = 128;
constexpr int kTmaChunks = kTmaRows * (kTmaCols / 8) / kTmaThreads;  // 16-byte chunks a thread

__global__ void __launch_bounds__(kTmaThreads)
partial_block_tma_kernel(const __grid_constant__ CUtensorMap map_x,
                         const __grid_constant__ CUtensorMap map_y,
                         const __nv_bfloat16* __restrict__ x, int rows, int cols,
                         int* __restrict__ counts) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ int warp_sums[2][4];
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
  // this thread's 16-byte chunks of the box (row v / 8, chunk v % 8 of its 128 bytes),
  // read from x while TMA loads the box
  uint4 want[kTmaChunks];
#pragma unroll
  for (int k = 0; k < kTmaChunks; ++k) {
    const int v = threadIdx.x + k * kTmaThreads;
    const int r = row0 + v / (kTmaCols / 8);
    want[k] = r < rows ? *reinterpret_cast<const uint4*>(
                             x + static_cast<long long>(r) * cols + col0 + v % (kTmaCols / 8) * 8)
                       : make_uint4(0u, 0u, 0u, 0u);
  }
  hopper::mbar_wait(bar, 0);
  if (threadIdx.x == 0) {  // the box as TMA wrote it: no proxy fence needed
    hopper::tma_store_2d(&map_y, box, col0, row0);
    hopper::tma_store_commit();
  }
  // the checks read the box while the store does
  int nonzero = 0;
  int misplaced = 0;
#pragma unroll
  for (int k = 0; k < kTmaChunks; ++k) {
    const int v = threadIdx.x + k * kTmaThreads;
    const int r = v / (kTmaCols / 8);
    const int chunk = v % (kTmaCols / 8);
    if (row0 + r >= rows) {
      // a swizzled row keeps its 128 bytes: only the 16-byte chunks move
      const uint4 word = *reinterpret_cast<const uint4*>(box + r * 128 + chunk * 16);
      nonzero += (word.x | word.y | word.z | word.w) != 0u;
    } else {
      const uint32_t expect[4] = {want[k].x, want[k].y, want[k].z, want[k].w};
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const uint32_t staged =
            *reinterpret_cast<const uint32_t*>(box + hopper::sw128_offset(r, chunk, p));
        misplaced += staged != expect[p];
      }
    }
  }
  nonzero = __reduce_add_sync(0xffffffffu, nonzero);
  misplaced = __reduce_add_sync(0xffffffffu, misplaced);
  if (threadIdx.x % 32 == 0) {
    warp_sums[0][threadIdx.x / 32] = nonzero;
    warp_sums[1][threadIdx.x / 32] = misplaced;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const int block = blockIdx.x * gridDim.y + blockIdx.y;
    counts[2 * block] = warp_sums[0][0] + warp_sums[0][1] + warp_sums[0][2] + warp_sums[0][3];
    counts[2 * block + 1] = warp_sums[1][0] + warp_sums[1][1] + warp_sums[1][2] + warp_sums[1][3];
    hopper::tma_store_wait_read<0>();  // the box stays until the store has read it
  }
}

// Everything a CUtensorMap of the TMA case encodes that varies: the map is
// a pure function of it (and of the constants in encode()), so a cached map
// whose key matches is the map encode() would give.
struct MapKey {
  const void* base;
  uint64_t rows, cols, row_bytes;
  uint32_t box_rows, box_cols;
  CUtensorMapDataType dtype;
  CUtensorMapSwizzle swizzle;
  bool operator==(const MapKey& o) const {
    return base == o.base && rows == o.rows && cols == o.cols && row_bytes == o.row_bytes &&
           box_rows == o.box_rows && box_cols == o.box_cols && dtype == o.dtype &&
           swizzle == o.swizzle;
  }
};

int encode(const MapKey& k, CUtensorMap* map) {
  const hopper::EncodeTiledFn fn = hopper::encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {k.cols, k.rows};
  const cuuint64_t strides[1] = {k.row_bytes};
  const cuuint32_t box[2] = {k.box_cols, k.box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult res = fn(map, k.dtype, 2, const_cast<void*>(k.base), dims, strides, box,
                          elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, k.swizzle,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// The last kMaps maps encoded, replaced in turn; a hit copies the map.
constexpr int kMaps = 8;
struct MapCache {
  std::mutex mutex;
  MapKey keys[kMaps] = {};
  CUtensorMap maps[kMaps];
  int filled = 0, next = 0;
};

int cached_map(const MapKey& key, CUtensorMap* map) {
  static MapCache cache;
  std::lock_guard<std::mutex> lock(cache.mutex);
  for (int i = 0; i < cache.filled; ++i) {
    if (cache.keys[i] == key) {
      *map = cache.maps[i];
      return 0;
    }
  }
  const int err = encode(key, map);
  if (err) return err;
  cache.keys[cache.next] = key;
  cache.maps[cache.next] = *map;
  cache.next = (cache.next + 1) % kMaps;
  cache.filled = cache.filled < kMaps ? cache.filled + 1 : kMaps;
  return 0;
}

MapKey tma_key(const void* base, int rows, int cols) {
  return MapKey{base, static_cast<uint64_t>(rows), static_cast<uint64_t>(cols),
                static_cast<uint64_t>(cols) * 2, kTmaRows, kTmaCols,
                CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, CU_TENSOR_MAP_SWIZZLE_128B};
}

template <typename Kernel, typename... Args>
int launch_clusters(Kernel kernel, int tiles, int cluster, size_t smem, cudaStream_t stream,
                    Args... args) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(tiles) * cluster);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&config, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Lets KERNEL launch in clusters of more than 8 CTAs: once per device.
template <auto KERNEL>
int allow_wide_clusters() {
  static bool done[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess && (device >= 64 || !done[device])) {
    err = cudaFuncSetAttribute(KERNEL, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err == cudaSuccess && device < 64) done[device] = true;
  }
  return static_cast<int>(err);
}

bool cluster_ok(int cluster) {
  return cluster >= 1 && cluster <= kMaxCluster && (cluster & (cluster - 1)) == 0;
}

}  // namespace

// C entries, bound with ctypes. Launch on `stream`, return a cudaError_t.
// x, y: (rows, row_bytes) bytes, contiguous, 16-byte aligned; overhang:
// ceil(rows / block_rows) int32. A tile is a cluster of `cluster` CTAs (1,
// 2, 4 or 8) of `cta_rows` rows each (cluster * cta_rows >= block_rows),
// staged `chunk_rows` rows a stage (ring of 4); the plan is
// tools.partial_block_probe.copy_plan.
extern "C" int partial_block_copy(const void* x, void* y, int rows, int row_bytes, int block_rows,
                                  int cluster, int cta_rows, int chunk_rows, void* overhang,
                                  void* stream) {
  const long long stage = static_cast<long long>(chunk_rows) * row_bytes;
  if (rows < 1 || block_rows < 1 || row_bytes < 16 || row_bytes % 16 != 0 ||
      row_bytes > kMaxRowBytes || !cluster_ok(cluster) || cta_rows < 1 || chunk_rows < 1 ||
      static_cast<long long>(cluster) * cta_rows < block_rows || stage > kMaxRowBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = static_cast<int>(kStages * stage);
  int err = hopper::allow_dynamic_smem<partial_block_copy_kernel>(kStages * kMaxRowBytes);
  if (!err && cluster > 8) err = allow_wide_clusters<partial_block_copy_kernel>();
  if (err) return err;
  const int tiles = static_cast<int>((rows + static_cast<long long>(block_rows) - 1) / block_rows);
  return launch_clusters(partial_block_copy_kernel, tiles, cluster, smem,
                         static_cast<cudaStream_t>(stream), static_cast<const uint8_t*>(x),
                         static_cast<uint8_t*>(y), rows, row_bytes, block_rows, cta_rows,
                         chunk_rows, static_cast<int*>(overhang));
}

// x, y: (rows, cols) fp32, contiguous; overhang: ceil(cols / block_cols)
// int32. A tile of block_cols columns is a cluster of `cluster` CTAs of
// `cta_rows` rows (cluster * cta_rows >= rows; the plan is
// tools.partial_block_probe.lastaxis_plan).
extern "C" int partial_block_lastaxis(const void* x, void* y, int rows, int cols, int block_cols,
                                      int cluster, int cta_rows, void* overhang, void* stream) {
  const long long smem = static_cast<long long>(cta_rows) * block_cols * 4;
  if (rows < 1 || cols < 1 || block_cols < 1 || !cluster_ok(cluster) || cta_rows < 1 ||
      static_cast<long long>(cluster) * cta_rows < rows || smem > 48 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles = static_cast<int>((cols + static_cast<long long>(block_cols) - 1) / block_cols);
  return launch_clusters(partial_block_lastaxis_kernel, tiles, cluster, static_cast<size_t>(smem),
                         static_cast<cudaStream_t>(stream), static_cast<const float*>(x),
                         static_cast<float*>(y), rows, cols, block_cols, cta_rows,
                         static_cast<int*>(overhang));
}

// x: (rows, cols) bf16, cols % 64 == 0, contiguous, 16-byte aligned; y: a
// buffer of at least rows * cols bf16 whose first rows * cols are written;
// counts: 2 * ceil(rows / 128) * (cols / 64) int32 (per box: nonzero
// 16-byte words staged past rows, valid pairs off the swizzle's place).
// The two tensor maps come from a cache keyed by what they encode.
extern "C" int partial_block_tma(const void* x, void* y, int rows, int cols, void* counts,
                                 void* stream) {
  if (rows < 1 || cols < kTmaCols || cols % kTmaCols != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap map_x, map_y;
  int err = cached_map(tma_key(x, rows, cols), &map_x);
  if (!err) err = cached_map(tma_key(y, rows, cols), &map_y);
  if (err) return err;
  const dim3 grid((rows + kTmaRows - 1) / kTmaRows, cols / kTmaCols);
  const size_t smem = 1024 + kTmaBoxBytes + sizeof(uint64_t);
  partial_block_tma_kernel<<<grid, kTmaThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      map_x, map_y, static_cast<const __nv_bfloat16*>(x), rows, cols, static_cast<int*>(counts));
  return static_cast<int>(cudaGetLastError());
}
