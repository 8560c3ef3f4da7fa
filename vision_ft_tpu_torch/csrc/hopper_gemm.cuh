// Shared pieces of the port's Hopper (sm_90a) GEMM pipelines: TMA tensor maps
// (host; 2-D, 3-D for a batch of strided matrices, 4-D for a strided
// (B, H, S, C) view, 4-D for an NHWC image in boxes of pixels over two
// spatial axes), mbarriers, TMA loads and stores, wgmma descriptors
// (K-major, and MN-major for an operand read through the transpose bit)
// and instructions (A from shared memory at N = 64 to 256, either operand
// K-major or MN-major, or A from registers: an fp32 accumulator rounded into
// bf16 A fragments, at N = 64, 96 and 128), and a warp-specialized TN main
// loop. The attention kernels B, C, E and G (csrc/flash_attention_bshd.cu,
// _bshd_bwd.cu, _masked.cu, _masked_bwd.cu) use the 3-D or 4-D maps, the
// MN-major descriptor and the register-A forms; the 3x3 conv
// (csrc/conv3x3.cu) the image maps, the TN main loop's consumer and a 4-D
// TMA store; the short-K kernels (csrc/flash_attention_shortk.cu) the 4-D
// maps and TMA stores, the forward (kernel H) the shared-memory forms at
// N = 64, 80, 96, 128, 160 and 192 (one per padded key count) and the
// register-A forms, the backward (kernel I) the same shared-memory forms
// with both operands K-major, with both MN-major and, at N = 64, with B
// MN-major; csrc/flash_attention_bshd_bwd.cu holds each of those forms to
// one 64 x N product on the card (hopper_wgmma_forms_probe);
// csrc/nf4_matmul.cu uses the shared-memory-A form with an MN-major B
// (wgmma_m64n128k16_mn, held to one product by nf4_wgmma_mn_probe) and
// sw128_offset for B tiles written with st.shared.
//
// The main loop's shape (used by csrc/fused_mlp.cu):
//   - one block of 384 threads: warpgroups 0 and 1 consume (wgmma), one
//     thread of warpgroup 2 produces (TMA); setmaxnreg moves registers from
//     the producer's warpgroup to the consumers';
//   - a ring of kStages stages in shared memory, each an A tile of 128 rows
//     and a B tile of B_ROWS rows, both 64 bf16 (128 bytes) deep in K,
//     written by TMA with 128-byte swizzle; a full and an empty mbarrier per
//     stage;
//   - consumer warpgroup w multiplies A rows [64w, 64w + 64) by all B rows,
//     four wgmma m64nNk16 per stage, N = B_ROWS; the accumulator stays in
//     registers.
// Both operands are K-major (torch's (out, in) weights and row-major
// activations), so wgmma reads them with no transpose. Rows past a
// tensor's end are zero-filled by TMA and clipped from its stores.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

constexpr int kBM = 128;     // rows of an A tile
constexpr int kBK = 64;      // K depth of a stage: 64 bf16 = one 128-byte swizzle row
constexpr int kStages = 4;
constexpr int kThreads = 384;
constexpr int kConsumerWarps = 8;
constexpr int kATileBytes = kBM * kBK * 2;
constexpr int kEpiTileBytes = 64 * 64 * 2;  // a 64 x 64 bf16 output box

// ---------------------------------------------------------------- host

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver symbol: reached through the runtime,
// so the libraries need no -lcuda.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult status = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr,
                                                             12000, cudaEnableDefault, &status);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &status);
#endif
    if (err == cudaSuccess && status == cudaDriverEntryPointSuccess && ptr != nullptr) {
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
    }
  }
  return fn;
}

// A 2-D tensor map over a contiguous row-major bf16 matrix of `rows` x
// `cols`; boxes of box_rows x 64 (one 128-byte swizzle row), 128-byte
// swizzle, the layout wgmma's descriptors read. Loads read elements outside
// the matrix as zeros; stores drop them. Returns 0 or a cudaError_t.
inline int make_map_2d(CUtensorMap* map, const void* base, uint64_t rows, uint64_t cols,
                       uint32_t box_rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * 2};
  const cuuint32_t box[2] = {64, box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides, box,
      elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// A 3-D tensor map over `batches` matrices of `rows` x `cols` bf16, whose
// rows are `row_stride` and matrices `batch_stride` elements apart (both
// multiples of 8; columns contiguous), e.g. one (B, S, H*D) tensor or a
// strided view of a wider one. Boxes of 64 columns x box_rows rows of one
// matrix, 128-byte swizzle. A box that overhangs a matrix's last row reads
// zeros there, never the next matrix's rows; stores drop them. Returns 0 or
// a cudaError_t.
inline int make_map_3d(CUtensorMap* map, const void* base, uint64_t batches, uint64_t rows,
                       uint64_t cols, uint64_t batch_stride, uint64_t row_stride,
                       uint32_t box_rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[3] = {cols, rows, batches};
  const cuuint64_t strides[2] = {row_stride * 2, batch_stride * 2};
  const cuuint32_t box[3] = {64, box_rows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box,
      elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// A 4-D tensor map over a bf16 (B, H, S, C) tensor whose batches, heads and
// rows are `batch_stride`, `head_stride` and `row_stride` elements apart
// (multiples of 8, in any order; columns contiguous), e.g. one head-split
// view of a fused (B, S, 3, H, C) projection. Boxes of 64 columns x
// box_rows rows of one (batch, head) matrix, 128-byte swizzle. A box that
// overhangs the matrix's last row or column reads zeros there (at C = 96,
// the second box's last 32 columns), never the neighbours' elements; stores
// drop them. Coordinates: (column, row, head, batch). Returns 0 or a
// cudaError_t.
inline int make_map_4d(CUtensorMap* map, const void* base, uint64_t batches, uint64_t heads,
                       uint64_t rows, uint64_t cols, uint64_t batch_stride, uint64_t head_stride,
                       uint64_t row_stride, uint32_t box_rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {cols, rows, heads, batches};
  const cuuint64_t strides[3] = {row_stride * 2, head_stride * 2, batch_stride * 2};
  const cuuint32_t box[4] = {64, box_rows, 1, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
      elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// A 4-D tensor map over a contiguous bf16 NHWC tensor (n, h, w, c), c a
// multiple of 8. A box is 64 channels x box_w x box_h pixels of one image:
// box_w * box_h rows of 128 bytes, row (y, x) at y * box_w + x, 128-byte
// swizzle (with box_c = 32: rows of 64 bytes, no swizzle). Loads read zeros
// at coordinates outside the tensor, negative ones included (a 3x3 conv's
// padding) and channels at or past c; stores drop them. Coordinates:
// (channel, x, y, image). Returns 0 or a cudaError_t.
inline int make_map_nhwc(CUtensorMap* map, const void* base, uint64_t n, uint64_t h, uint64_t w,
                         uint64_t c, uint32_t box_w, uint32_t box_h, uint32_t box_c = 64) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {c, w, h, n};
  const cuuint64_t strides[3] = {c * 2, w * c * 2, h * w * c * 2};
  const cuuint32_t box[4] = {box_c, box_w, box_h, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
      elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      box_c == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// Lets KERNEL use `bytes` of dynamic shared memory: once per device.
template <auto KERNEL>
int allow_dynamic_smem(int bytes) {
  static bool done[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess && (device >= 64 || !done[device])) {
    err = cudaFuncSetAttribute(KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess && device < 64) done[device] = true;
  }
  return static_cast<int>(err);
}

// ---------------------------------------------------------------- device

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The dynamic shared memory rounded up to 1024 bytes (128-byte swizzle's
// period); the kernel asks for 1024 bytes more than it uses.
__device__ __forceinline__ uint8_t* align_1024(uint8_t* smem) {
  return smem + ((1024u - (smem_u32(smem) & 1023u)) & 1023u);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n"
      ".reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n"
      "}\n" ::"r"(smem_u32(bar))
      : "memory");
}

// Waits until the barrier's phase of parity `parity` has completed. A wait
// that outlasts 2^26 polls (seconds; a transfer takes microseconds) traps,
// so that a lost transaction ends the kernel with an error, not a hang.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  for (uint32_t polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 26)) __trap();
  }
}

// One box of a 2-D tensor map at (column c0, row c1) into shared memory;
// completes `bar`'s transaction bytes.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// One box of a 3-D tensor map at (column c0, row c1, matrix c2).
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// One box of a 4-D tensor map at (column c0, row c1, head c2, batch c3).
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// 2^x by the special function unit (ex2.approx, denormals flushed): exactly
// 1 at x = 0 and 0 at x = -inf.
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 1 / x and log2(x) by the special function unit (rcp.approx, lg2.approx,
// denormals flushed).
__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float lg2_approx(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One box from shared memory to (column c0, row c1) of a 2-D tensor map.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(smem_u32(src)), "r"(c0), "r"(c1)
               : "memory");
}

// One box from shared memory to (c0, c1, c2, c3) of a 4-D tensor map.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// At most N committed store groups still reading shared memory.
template <int N>
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

template <int N>
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// Makes this thread's ordinary shared-memory writes visible to TMA.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_barrier_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// wgmma descriptor of a K-major tile written by TMA with 128-byte swizzle:
// rows of 128 bytes, 8-row groups 1024 bytes apart. The K step of 16 bf16
// (32 bytes) inside the swizzle row adds 2 to the descriptor.
__device__ __forceinline__ uint64_t desc_sw128(const void* tile) {
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3FFFFull) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// wgmma descriptor of an MN-major tile (K rows x M or N columns, M or N
// contiguous) written with 128-byte swizzle as boxes of 64 columns, by TMA
// or by sw128_offset: a swizzle atom is 8 K rows x 64 columns (1024 bytes).
// SBO steps 8 K rows (1024 bytes); LBO steps 64 columns, i.e. to the next
// box, `box_bytes` apart (unused by an A operand, whose 64 rows are one
// box). The K step of 16 rows (2048 bytes) adds 128 to the descriptor.
__device__ __forceinline__ uint64_t desc_sw128_mn(const void* tile, uint32_t box_bytes) {
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3FFFFull) >> 4) | (static_cast<uint64_t>(box_bytes >> 4) << 16) |
         (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A 64 x N fp32 accumulator (wgmma's layout: d[4j + e] at row 16 warp +
// lane / 4 + 8 (e >= 2), column 8j + 2 (lane % 4) + (e & 1)) rounded to bf16
// as N / 16 A fragments of a following wgmma whose K runs over those N
// columns: fragment kk holds columns [16 kk, 16 kk + 16), as four registers
// (row, columns 2c..), (row + 8, 2c..), (row, 2c + 8..), (row + 8, 2c + 8..).
template <int N>
__device__ __forceinline__ void acc_to_a_fragments(uint32_t (&a)[N / 16][4],
                                                   const float (&d)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = pack_bf16x2(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1]);
  }
}

// Stores rows `row` and `row + 8` (those below `rows`) of a 64 x N fp32
// accumulator slice this thread holds (wgmma's layout), as bf16 pairs from
// column 2 (lane % 4) of `dst`.
template <int N>
__device__ __forceinline__ void store_acc_rows(__nv_bfloat16* dst, long long row_stride,
                                               const float (&acc)[N / 2], int row, int rows) {
  __nv_bfloat16* lo = dst + (long long)row * row_stride;
  __nv_bfloat16* hi = lo + 8 * row_stride;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    if (row < rows) {
      *reinterpret_cast<uint32_t*>(lo + 8 * j) = pack_bf16x2(acc[4 * j], acc[4 * j + 1]);
    }
    if (row + 8 < rows) {
      *reinterpret_cast<uint32_t*>(hi + 8 * j) = pack_bf16x2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator accesses across wgmma's
// asynchronous window.
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 256, fp32, wgmma's accumulator layout) = A (64 x 16) B^T (256 x 16) + (scale_d ? d : 0),
// A and B bf16, K-major in shared memory, read through descriptors.
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t desc_a, uint64_t desc_b,
                                                 int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87,"
      " %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103,"
      " %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119,"
      " %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 160, fp32, wgmma's accumulator layout) = A (64 x 16) B^T (160 x 16) + (scale_d ? d : 0),
// A and B bf16 in shared memory, read through descriptors: K-major, or
// MN-major through the transpose bit where TRANS_A / TRANS_B is 1.
template <int TRANS_A = 0, int TRANS_B = 0>
__device__ __forceinline__ void wgmma_m64n160k16(float (&d)[80], uint64_t desc_a, uint64_t desc_b,
                                                 int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79}, "
      "%80, %81, p, 1, 1, %83, %84;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_A), "n"(TRANS_B));
}

// d (64 x 128, fp32, wgmma's accumulator layout) = A (64 x 16) B^T (128 x 16) + (scale_d ? d : 0),
// A and B bf16 in shared memory, read through descriptors: K-major, or
// MN-major through the transpose bit where TRANS_A / TRANS_B is 1.
template <int TRANS_A = 0, int TRANS_B = 0>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                                 int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_A), "n"(TRANS_B));
}

// d (64 x 64, fp32, wgmma's accumulator layout) = A (64 x 16) B^T (64 x 16) + (scale_d ? d : 0),
// A and B bf16 in shared memory, read through descriptors: K-major, or
// MN-major through the transpose bit where TRANS_A / TRANS_B is 1.
template <int TRANS_A = 0, int TRANS_B = 0>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                                int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_A), "n"(TRANS_B));
}

// d (64 x 80, fp32, wgmma's accumulator layout) = A (64 x 16) B^T (80 x 16) + (scale_d ? d : 0),
// A and B bf16 in shared memory, read through descriptors: K-major, or
// MN-major through the transpose bit where TRANS_A / TRANS_B is 1.
template <int TRANS_A = 0, int TRANS_B = 0>
__device__ __forceinline__ void wgmma_m64n80k16(float (&d)[40], uint64_t desc_a, uint64_t desc_b,
                                                int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39}, "
      "%40, %41, p, 1, 1, %43, %44;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_A), "n"(TRANS_B));
}

// d (64 x 96, fp32, wgmma's accumulator layout) = A (64 x 16) B^T (96 x 16) + (scale_d ? d : 0),
// A and B bf16 in shared memory, read through descriptors: K-major, or
// MN-major through the transpose bit where TRANS_A / TRANS_B is 1.
template <int TRANS_A = 0, int TRANS_B = 0>
__device__ __forceinline__ void wgmma_m64n96k16(float (&d)[48], uint64_t desc_a, uint64_t desc_b,
                                                int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47}, "
      "%48, %49, p, 1, 1, %51, %52;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_A), "n"(TRANS_B));
}

// d (64 x 192, fp32, wgmma's accumulator layout) = A (64 x 16) B^T (192 x 16) + (scale_d ? d : 0),
// A and B bf16 in shared memory, read through descriptors: K-major, or
// MN-major through the transpose bit where TRANS_A / TRANS_B is 1.
template <int TRANS_A = 0, int TRANS_B = 0>
__device__ __forceinline__ void wgmma_m64n192k16(float (&d)[96], uint64_t desc_a, uint64_t desc_b,
                                                 int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87,"
      " %88, %89, %90, %91, %92, %93, %94, %95}, "
      "%96, %97, p, 1, 1, %99, %100;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_A), "n"(TRANS_B));
}

// d (64 x 64, fp32) = A (64 x 16) B (16 x 64) + (scale_d ? d : 0), A bf16 in
// four registers a thread (an A fragment, see acc_to_a_fragments), B bf16
// MN-major in shared memory through desc_sw128_mn (the transpose bit set).
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                    uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// d (64 x 128, fp32) = A (64 x 16) B (16 x 128) + (scale_d ? d : 0), A bf16 in
// four registers a thread (an A fragment, see acc_to_a_fragments), B bf16
// MN-major in shared memory through desc_sw128_mn (the transpose bit set).
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4],
                                                    uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// d (64 x 128, fp32) = A (64 x 16) B (16 x 128) + (scale_d ? d : 0), A bf16
// K-major in shared memory (desc_sw128), B bf16 MN-major in shared memory
// through desc_sw128_mn (the transpose bit set).
__device__ __forceinline__ void wgmma_m64n128k16_mn(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                                    int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 96, fp32) = A (64 x 16) B (16 x 96) + (scale_d ? d : 0), A bf16 in
// four registers a thread, B bf16 MN-major through desc_sw128_mn: columns
// 0-63 from the first 64-column box, 64-95 from the first half of the
// second (a head dim of 96 in two boxes whose last 32 columns TMA filled
// with zeros; they are never read).
__device__ __forceinline__ void wgmma_m64n96k16_rs(float (&d)[48], const uint32_t (&a)[4],
                                                   uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// wgmma_m64nNk16_rs at N = 64, 96 or 128.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc_b,
                                         int scale_d) {
  static_assert(N == 64 || N == 96 || N == 128, "register-A wgmma widths of the port: 64, 96, 128");
  if constexpr (N == 64) {
    wgmma_m64n64k16_rs(d, a, desc_b, scale_d);
  } else if constexpr (N == 96) {
    wgmma_m64n96k16_rs(d, a, desc_b, scale_d);
  } else {
    wgmma_m64n128k16_rs(d, a, desc_b, scale_d);
  }
}

// wgmma_m64nNk16 (both operands in shared memory) at N = 64, 80, 96, 128,
// 160 or 192 (kernels H's and I's padded key counts: scores over every key
// at once). Both operands K-major by default; TRANS_A / TRANS_B = 1 reads
// A / B MN-major (desc_sw128_mn): kernel I's dV^T = dO^T P and dK^T = Q^T dS
// read dO and Q as a transposed A and P and dS as a transposed B, its dQ =
// dS K reads K as a transposed B.
template <int N, int TRANS_A = 0, int TRANS_B = 0>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b,
                                         int scale_d) {
  static_assert(N == 64 || N == 80 || N == 96 || N == 128 || N == 160 || N == 192,
                "shared-memory wgmma widths of the attention kernels: 64, 80, 96, 128, 160, 192");
  if constexpr (N == 64) {
    wgmma_m64n64k16<TRANS_A, TRANS_B>(d, desc_a, desc_b, scale_d);
  } else if constexpr (N == 80) {
    wgmma_m64n80k16<TRANS_A, TRANS_B>(d, desc_a, desc_b, scale_d);
  } else if constexpr (N == 96) {
    wgmma_m64n96k16<TRANS_A, TRANS_B>(d, desc_a, desc_b, scale_d);
  } else if constexpr (N == 128) {
    wgmma_m64n128k16<TRANS_A, TRANS_B>(d, desc_a, desc_b, scale_d);
  } else if constexpr (N == 160) {
    wgmma_m64n160k16<TRANS_A, TRANS_B>(d, desc_a, desc_b, scale_d);
  } else {
    wgmma_m64n192k16<TRANS_A, TRANS_B>(d, desc_a, desc_b, scale_d);
  }
}

// The descriptor step of K step kk (16 bf16 columns) through a K-major tile
// of `rows` rows stored as 64-column boxes of rows x 128 bytes: 32 bytes
// within a box, then the next box.
template <int ROWS>
__device__ __forceinline__ uint64_t k_major_step(int kk) {
  return (kk / 4) * (ROWS * 128 >> 4) + 2 * (kk % 4);
}

// acc (64 x N) += A (64 x 16 KSTEPS, register fragments) times a bf16 tile
// of 16 KSTEPS rows x N columns read MN-major, stored as 64-column boxes of
// `box_bytes` (its rows x 128 bytes); one wgmma per K step of 16 rows.
template <int N, int KSTEPS>
__device__ __forceinline__ void mma_rs_mn(float (&acc)[N / 2], const uint32_t (&a)[KSTEPS][4],
                                          const uint8_t* tile, uint32_t box_bytes) {
  const uint64_t desc = desc_sw128_mn(tile, box_bytes);
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) wgmma_rs<N>(acc, a[kk], desc + 128 * kk, 1);
}

template <int N>
__device__ __forceinline__ void wgmma_k16(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b) {
  static_assert(N == 128 || N == 160 || N == 256, "wgmma widths of the port: 128, 160 and 256");
  if constexpr (N == 256) {
    wgmma_m64n256k16(d, desc_a, desc_b, 1);
  } else if constexpr (N == 160) {
    wgmma_m64n160k16(d, desc_a, desc_b, 1);
  } else {
    wgmma_m64n128k16(d, desc_a, desc_b, 1);
  }
}

// Byte offset of the 4-byte pair (row r, columns 2p, 2p + 1 of 16-byte
// chunk `chunk`) in a 64-column bf16 box written for a 128-byte swizzled
// TMA store: the chunk index is XORed with the row's index mod 8.
__device__ __forceinline__ int sw128_offset(int r, int chunk, int p) {
  return r * 128 + ((chunk ^ (r & 7)) << 4) + (p << 2);
}

// The ring of a TN main loop: stage s holds an A tile (128 rows) at
// ring + s * STAGE_BYTES and a B tile (B_ROWS rows) right after it.
template <int B_ROWS>
struct Ring {
  static constexpr int kBBytes = B_ROWS * kBK * 2;
  static constexpr int kStageBytes = kATileBytes + kBBytes;
  static constexpr int kBytes = kStages * kStageBytes;
};

// Producer (one thread): K slices [k_begin, k_end) of A rows [a_row,
// a_row + 128) and of B: rows [b0_row, b0_row + B0_ROWS) of map_b0, then,
// if B1_ROWS > 0, rows [b1_row, b1_row + B1_ROWS) of map_b1.
template <int B0_ROWS, int B1_ROWS>
__device__ __forceinline__ void produce(uint8_t* ring, uint64_t* full, uint64_t* empty,
                                        const CUtensorMap* map_a, int a_row,
                                        const CUtensorMap* map_b0, int b0_row,
                                        const CUtensorMap* map_b1, int b1_row, int k_begin,
                                        int k_end) {
  using R = Ring<B0_ROWS + B1_ROWS>;
  int stage = 0;
  uint32_t phase = 0;
  for (int k = k_begin; k < k_end; ++k) {
    mbar_wait(&empty[stage], phase ^ 1u);
    uint8_t* dst = ring + stage * R::kStageBytes;
    mbar_arrive_expect_tx(&full[stage], R::kStageBytes);
    tma_load_2d(dst, map_a, &full[stage], k * kBK, a_row);
    tma_load_2d(dst + kATileBytes, map_b0, &full[stage], k * kBK, b0_row);
    if constexpr (B1_ROWS > 0) {
      tma_load_2d(dst + kATileBytes + B0_ROWS * kBK * 2, map_b1, &full[stage], k * kBK, b1_row);
    }
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1u;
    }
  }
}

// Consumer warpgroup wg: acc (64 x N) = A rows [64 wg, 64 wg + 64) times B
// (N rows) over `slices` stages, in K order. One stage's wgmma stay in
// flight while the next stage's are issued; each warp releases a stage once
// its wgmma on it have completed.
template <int N>
__device__ __forceinline__ void consume(float (&acc)[N / 2], const uint8_t* ring,
                                        uint64_t* full, uint64_t* empty, int wg, int slices) {
  using R = Ring<N>;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  const bool lane0 = (threadIdx.x & 31) == 0;
  int stage = 0;
  int previous = 0;
  uint32_t phase = 0;
  for (int k = 0; k < slices; ++k) {
    mbar_wait(&full[stage], phase);
    const uint8_t* tile = ring + stage * R::kStageBytes;
    const uint64_t desc_a = desc_sw128(tile + wg * (kATileBytes / 2));
    const uint64_t desc_b = desc_sw128(tile + kATileBytes);
    fence_operands(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) wgmma_k16<N>(acc, desc_a + 2 * kk, desc_b + 2 * kk);
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's wgmma are done
    fence_operands(acc);
    if (k > 0 && lane0) mbar_arrive(&empty[previous]);
    previous = stage;
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1u;
    }
  }
  wgmma_wait<0>();
  fence_operands(acc);
}

// The ring's barriers, full[kStages] (one producer arrival plus the
// stage's TMA bytes) and empty[kStages] (one arrival per consumer warp).
// Thread 0 initializes them; the caller then syncs the block.
__device__ __forceinline__ void init_ring_barriers(uint64_t* full, uint64_t* empty) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    fence_barrier_init();
  }
}

}  // namespace hopper
