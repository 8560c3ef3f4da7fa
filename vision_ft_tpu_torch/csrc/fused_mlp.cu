// Fused gated MLP (GeGLU / SwiGLU feed-forward) for Hopper (sm_90a), CUDA C++.
//
// Replaces vision_ft_tpu/ops/pallas/fused_mlp.py::_gated_kernel (launched by
// _gated_fwd_kernel_call, entries gated_mlp and geglu_mlp).
//
// Computes out = (act(x Wa^T + ba) * (x Wg^T + bg)) Wd^T + bd for x (M, C),
// Wa and Wg (inner, C), Wd (C, inner), all bf16 in torch (out, in) layout;
// biases fp32 or absent. Both up-projections accumulate in fp32, the gated
// product is rounded to bf16 before the down-projection (as the kernel it
// replaces does), the down-projection accumulates in fp32 and the output is
// bf16. The (M, inner) intermediates never reach device memory.
//
// The TPU kernel keeps a (256, C) fp32 accumulator and the x tile in 16 MB
// of VMEM and walks the inner chunks in its sequential grid axis. An SM has
// 256 KB of registers and 227 KB of shared memory, so here:
//   - One block of 8 warps owns 16 rows of x and (up to) 2304 output columns.
//     Its 16 x C_blk fp32 accumulator lives in registers (warp w holds the
//     8-column tiles w, w + 8, w + 16, ...: 144 registers a thread at 2304),
//     its x tile (16 x C bf16) in shared memory for the whole kernel.
//   - A loop over 64-column chunks of inner replaces the sequential grid
//     axis. Per chunk: h and g (16 x 64 each; warp w computes columns
//     [8w, 8w + 8) of both, so the gate is warp-local) from x and the
//     chunk's rows of Wa and Wg; a = act(h + ba) * (g + bg) -> bf16 -> shared
//     memory; then acc += a Wd[:, chunk]^T.
//   - The weights stream through a 3-stage cp.async ring of ~36 KB slabs:
//     18 slabs of (64 Wa rows + 64 Wg rows) x 128 contraction columns, then
//     9 slabs of 256 Wd rows x 64 chunk columns (at C = 2304). One
//     __syncthreads a slab; bf16 mma.sync m16n8k16, fp32 accumulate.
//   - C wider than 2304 is split over blockIdx.y; each split recomputes the
//     up-projections. Ragged M is masked: rows at or past M are staged as
//     zeros and never written.
//   - No atomics and a fixed summation order: reruns are bit-identical.
//
// What bounds it on an H100: operations (6*M*C*inner against each weight
// read once). What this design pays: with 16 rows a block, every block
// streams all of Wa, Wg and Wd through L2 (M/16 times the weights' bytes),
// and each weight fragment feeds one mma, so L2 bandwidth, not the tensor
// cores, sets its speed. Sharing one weight stream between more rows needs
// the accumulator split over a thread-block cluster (distributed shared
// memory for the chunk's `a`), wgmma and TMA: later work.

#include "flash_attention_bshd.cuh"

namespace {

using bshd::lds32;
using bshd::mma_16816;
using bshd::pack_bf16x2;

constexpr int kRows = 16;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 64;    // inner columns a chunk
constexpr int kSlabK = 128;   // contraction columns of an up-projection slab
constexpr int kSlabN = 256;   // output columns of a down-projection slab
constexpr int kStages = 3;
constexpr int kPad = 8;       // bf16 elements of padding per shared row
constexpr int kLdUp = kSlabK + kPad;    // 68 words: conflict-free fragment loads
constexpr int kLdDown = kChunk + kPad;  // 36 words
constexpr int kLdA = kChunk + kPad;
constexpr int kUpElems = 2 * kChunk * kLdUp;
constexpr int kDownElems = kSlabN * kLdDown;
constexpr int kStageElems = kUpElems > kDownElems ? kUpElems : kDownElems;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float activate(float h, int act) {
  if (act == 0) return h / (1.f + expf(-h));  // silu
  if (act == 1) {                             // gelu, tanh approximation
    return 0.5f * h * (1.f + tanhf(0.7978845608028654f * (h + 0.044715f * h * h * h)));
  }
  return 0.5f * h * (1.f + erff(h * 0.7071067811865476f));  // gelu, exact
}

// The weight stream of one block: slab s of chunk j is up-projection slab s
// (s < up_slabs) or down-projection slab s - up_slabs. Every thread starts
// its share of the next slab's 16-byte copies into the ring.
struct Producer {
  const __nv_bfloat16* wa;
  const __nv_bfloat16* wg;
  const __nv_bfloat16* wd;
  __nv_bfloat16* ring;
  int c, inner, col0, col_end, up_slabs, slabs_per_chunk, num_chunks;
  int chunk, slab, started;

  __device__ __forceinline__ void load_next() {
    if (chunk < num_chunks) {
      __nv_bfloat16* dst = ring + (started % kStages) * kStageElems;
      if (slab < up_slabs) {
        // rows 0..63: Wa rows of the chunk, rows 64..127: Wg rows; 16 vectors a row
#pragma unroll
        for (int i = 0; i < 2 * kChunk * (kSlabK / 8) / kThreads; ++i) {
          const int idx = threadIdx.x + i * kThreads;
          const int row = idx / (kSlabK / 8);
          const int vec = idx % (kSlabK / 8);
          const __nv_bfloat16* w = row < kChunk ? wa : wg;
          const long long src_row = (long long)chunk * kChunk + (row % kChunk);
          cp_async16(dst + row * kLdUp + vec * 8, w + src_row * c + slab * kSlabK + vec * 8);
        }
      } else {
        const int n0 = col0 + (slab - up_slabs) * kSlabN;
#pragma unroll
        for (int i = 0; i < kSlabN * (kChunk / 8) / kThreads; ++i) {
          const int idx = threadIdx.x + i * kThreads;
          const int row = idx / (kChunk / 8);
          const int vec = idx % (kChunk / 8);
          if (n0 + row < col_end) {
            cp_async16(dst + row * kLdDown + vec * 8,
                       wd + (long long)(n0 + row) * inner + chunk * kChunk + vec * 8);
          }
        }
      }
      if (++slab == slabs_per_chunk) {
        slab = 0;
        ++chunk;
      }
    }
    cp_async_commit();  // an empty group past the end keeps the wait counts uniform
    ++started;
  }
};

// NT: 8-column output tiles a warp holds; the block covers up to NT * 64
// output columns, [col0, col_end).
template <int NT>
__global__ void __launch_bounds__(kThreads, 1)
fused_gated_mlp_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wa,
                       const float* __restrict__ ba, const __nv_bfloat16* __restrict__ wg,
                       const float* __restrict__ bg, const __nv_bfloat16* __restrict__ wd,
                       const float* __restrict__ bd, __nv_bfloat16* __restrict__ out, int m,
                       int c, int inner, int cols_per_block, int act) {
  static_assert(NT % 4 == 0, "a down-projection slab is four tiles a warp");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldx = c + kPad;
  __nv_bfloat16* sX = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sA = sX + kRows * ldx;
  __nv_bfloat16* ring = sA + kRows * kLdA;

  const int m0 = blockIdx.x * kRows;
  const int col0 = blockIdx.y * cols_per_block;
  const int col_end = min(c, col0 + cols_per_block);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;

  Producer producer;
  producer.wa = wa;
  producer.wg = wg;
  producer.wd = wd;
  producer.ring = ring;
  producer.c = c;
  producer.inner = inner;
  producer.col0 = col0;
  producer.col_end = col_end;
  producer.up_slabs = c / kSlabK;
  producer.slabs_per_chunk = producer.up_slabs + (col_end - col0 + kSlabN - 1) / kSlabN;
  producer.num_chunks = inner / kChunk;
  producer.chunk = producer.slab = producer.started = 0;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) producer.load_next();

  // x tile -> shared, rows at or past m as zeros
  const int vec_per_row = c / 8;
  for (int idx = threadIdx.x; idx < kRows * vec_per_row; idx += kThreads) {
    const int row = idx / vec_per_row;
    const int vec = idx % vec_per_row;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (m0 + row < m) {
      val = *reinterpret_cast<const uint4*>(x + (long long)(m0 + row) * c + vec * 8);
    }
    *reinterpret_cast<uint4*>(sX + row * ldx + vec * 8) = val;
  }

  float acc[NT][4];
#pragma unroll
  for (int a = 0; a < NT; ++a) acc[a][0] = acc[a][1] = acc[a][2] = acc[a][3] = 0.f;

  int consumed = 0;  // slabs computed so far: the next one sits in stage consumed % kStages
  const int up_slabs = producer.up_slabs;
  const int num_chunks = producer.num_chunks;
  for (int chunk = 0; chunk < num_chunks; ++chunk) {
    // up-projections: h = x Wa[chunk]^T and g = x Wg[chunk]^T, columns [8w, 8w + 8)
    float hacc[4] = {0.f, 0.f, 0.f, 0.f};
    float gacc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int ks = 0; ks < up_slabs; ++ks) {
      cp_async_wait<kStages - 2>();
      __syncthreads();  // the slab has landed; every warp is done with the stage refilled next
      producer.load_next();
      const __nv_bfloat16* sW = ring + (consumed % kStages) * kStageElems;
      ++consumed;
      const __nv_bfloat16* xa = sX + g * ldx + ks * kSlabK + 2 * t;
      const __nv_bfloat16* wa_s = sW + (warp * 8 + g) * kLdUp + 2 * t;
      const __nv_bfloat16* wg_s = wa_s + kChunk * kLdUp;
#pragma unroll
      for (int kk = 0; kk < kSlabK / 16; ++kk) {
        uint32_t a[4];
        a[0] = lds32(xa + kk * 16);
        a[1] = lds32(xa + 8 * ldx + kk * 16);
        a[2] = lds32(xa + kk * 16 + 8);
        a[3] = lds32(xa + 8 * ldx + kk * 16 + 8);
        mma_16816(hacc, a, lds32(wa_s + kk * 16), lds32(wa_s + kk * 16 + 8));
        mma_16816(gacc, a, lds32(wg_s + kk * 16), lds32(wg_s + kk * 16 + 8));
      }
    }

    // gate: a = act(h + ba) * (g + bg), rounded to bf16, into shared memory
    {
      const int col = chunk * kChunk + warp * 8 + 2 * t;
      const float ba0 = ba == nullptr ? 0.f : ba[col];
      const float ba1 = ba == nullptr ? 0.f : ba[col + 1];
      const float bg0 = bg == nullptr ? 0.f : bg[col];
      const float bg1 = bg == nullptr ? 0.f : bg[col + 1];
      __nv_bfloat16* dst = sA + g * kLdA + warp * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(dst) = pack_bf16x2(
          activate(hacc[0] + ba0, act) * (gacc[0] + bg0),
          activate(hacc[1] + ba1, act) * (gacc[1] + bg1));
      *reinterpret_cast<uint32_t*>(dst + 8 * kLdA) = pack_bf16x2(
          activate(hacc[2] + ba0, act) * (gacc[2] + bg0),
          activate(hacc[3] + ba1, act) * (gacc[3] + bg1));
    }

    // down-projection: acc += a Wd[:, chunk]^T, 256 output columns a slab;
    // tile i of slab ns (columns ns*256 + i*64 + 8w ...) is acc[ns*4 + i]
    uint32_t af[kChunk / 16][4];
#pragma unroll
    for (int ns = 0; ns < NT / 4; ++ns) {
      if (col0 + ns * kSlabN < col_end) {
        cp_async_wait<kStages - 2>();
        __syncthreads();  // for ns == 0 also: every warp's part of `a` is written
        producer.load_next();
        const __nv_bfloat16* sW = ring + (consumed % kStages) * kStageElems;
        ++consumed;
        if (ns == 0) {
          const __nv_bfloat16* ab = sA + g * kLdA + 2 * t;
#pragma unroll
          for (int kk = 0; kk < kChunk / 16; ++kk) {
            af[kk][0] = lds32(ab + kk * 16);
            af[kk][1] = lds32(ab + 8 * kLdA + kk * 16);
            af[kk][2] = lds32(ab + kk * 16 + 8);
            af[kk][3] = lds32(ab + 8 * kLdA + kk * 16 + 8);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (col0 + ns * kSlabN + i * 64 + warp * 8 < col_end) {
            const __nv_bfloat16* wb = sW + (i * 64 + warp * 8 + g) * kLdDown + 2 * t;
#pragma unroll
            for (int kk = 0; kk < kChunk / 16; ++kk) {
              mma_16816(acc[ns * 4 + i], af[kk], lds32(wb + kk * 16), lds32(wb + kk * 16 + 8));
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // out = acc + bd, bf16
  const int row_lo = m0 + g;
  const int row_hi = row_lo + 8;
#pragma unroll
  for (int a = 0; a < NT; ++a) {
    const int col = col0 + (a / 4) * kSlabN + (a % 4) * 64 + warp * 8 + 2 * t;
    if (col < col_end) {
      const float b0 = bd == nullptr ? 0.f : bd[col];
      const float b1 = bd == nullptr ? 0.f : bd[col + 1];
      if (row_lo < m) {
        *reinterpret_cast<uint32_t*>(out + (long long)row_lo * c + col) =
            pack_bf16x2(acc[a][0] + b0, acc[a][1] + b1);
      }
      if (row_hi < m) {
        *reinterpret_cast<uint32_t*>(out + (long long)row_hi * c + col) =
            pack_bf16x2(acc[a][2] + b0, acc[a][3] + b1);
      }
    }
  }
}

template <int NT>
int launch(const __nv_bfloat16* x, const __nv_bfloat16* wa, const float* ba,
           const __nv_bfloat16* wg, const float* bg, const __nv_bfloat16* wd, const float* bd,
           __nv_bfloat16* out, int m, int c, int inner, int act, cudaStream_t stream) {
  const int capacity = NT * 64;
  const int splits = (c + capacity - 1) / capacity;
  const int cols_per_block = ((c + splits - 1) / splits + 63) / 64 * 64;
  const size_t smem =
      sizeof(__nv_bfloat16) * (size_t)(kRows * (c + kPad) + kRows * kLdA + kStages * kStageElems);
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);  // 227 KB a block
  cudaError_t err = cudaFuncSetAttribute(fused_gated_mlp_kernel<NT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((m + kRows - 1) / kRows, splits);
  fused_gated_mlp_kernel<NT><<<grid, kThreads, smem, stream>>>(x, wa, ba, wg, bg, wd, bd, out, m,
                                                               c, inner, cols_per_block, act);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry, bound with ctypes. x (m, c), out (m, c), wa and wg (inner, c) and
// wd (c, inner) are contiguous bf16 with 16-byte aligned bases; wa and wg may
// point into one fused (2 * inner, c) weight. ba, bg (inner) and bd (c) are
// fp32 or null. c % 128 == 0, inner % 64 == 0, and the x tile must fit
// shared memory beside the ring (c <= 3712): the wrapper checks.
// act: 0 silu, 1 gelu (tanh), 2 gelu (erf). Launches on `stream` and returns
// cudaGetLastError().
extern "C" int fused_gated_mlp_fwd(const void* x, const void* wa, const void* ba, const void* wg,
                                   const void* bg, const void* wd, const void* bd, void* out,
                                   int m, int c, int inner, int act, void* stream) {
  if (m < 1 || c < kSlabK || c % kSlabK != 0 || inner < kChunk || inner % kChunk != 0 ||
      act < 0 || act > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wab = static_cast<const __nv_bfloat16*>(wa);
  const auto* wgb = static_cast<const __nv_bfloat16*>(wg);
  const auto* wdb = static_cast<const __nv_bfloat16*>(wd);
  const auto* bab = static_cast<const float*>(ba);
  const auto* bgb = static_cast<const float*>(bg);
  const auto* bdb = static_cast<const float*>(bd);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  if (c <= 20 * 64) {
    return launch<20>(xb, wab, bab, wgb, bgb, wdb, bdb, ob, m, c, inner, act, s);
  }
  return launch<36>(xb, wab, bab, wgb, bgb, wdb, bdb, ob, m, c, inner, act, s);
}
