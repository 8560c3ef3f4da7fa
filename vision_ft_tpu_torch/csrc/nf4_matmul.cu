// Packed 4-bit (NF4 / FP4) matmul for Hopper (sm_90a), CUDA C++: forward and dx,
// kernel D, a warp-specialized TMA + wgmma GEMM whose B operand is
// dequantized into shared memory by a warpgroup of its own.
//
// Replaces vision_ft_tpu/ops/pallas/nf4_matmul.py::_fwd_kernel (launched by
// _fwd_impl) and ::_dx_kernel (launched by _dx_impl; also the backward of
// ops/nf4_stream.py), entry nf4_matmul.
//
//   forward:  y  = x  @ dequant(W)^T   x  (M, K) bf16, y  (M, N) bf16
//   dx:       dx = dy @ dequant(W)     dy (M, N) bf16, dx (M, K) bf16
//
// W is (N, K), stored as (N, K/2) uint8 codes, one fp32 absmax per 64
// consecutive elements of the flattened row-major weight, and a 16-entry
// fp32 codebook that is an argument (NF4 and FP4 share the kernel). An
// element is codebook[code] * absmax in fp32, rounded once to bf16; the
// products accumulate in fp32; the output is rounded once to bf16. Two
// byte layouts: bnb (byte t of a row = columns 2t (high nibble), 2t+1) and
// split (byte j = columns j (high) and K/2+j (low)). absmax is indexed by
// the element's ORIGINAL flat position (row * K + column) / 64 in both.
//
// What bounds it on an H100: the tensor cores at the train step's M (4096
// to 16384 rows: 2*M*N*K operations against M*(K+N)*2 + N*K*0.5625 bytes,
// hundreds of operations a byte); the weight bytes only at the smallest M
// (154 rows of text keys). The weight stays packed in device memory (0.5625
// bytes an element with absmax, never a bf16 copy) and is dequantized next
// to the tensor cores, ceil(M / ROWS) times an element per call.
//
// Design: one persistent block of 384 threads per SM walks work items
// (a ROWS x 128 output tile, or one contraction part of it) in order.
// ROWS is 256 where such items make two waves or more (each W tile is then
// dequantized half as often), else 128. A stage is 64 packed bytes of 128
// W rows: forward, the rows of the item's output columns; dx, the stage's
// 128 rows of the contraction.
//   - Warpgroup 2 dequantizes, a W row a thread. Each thread keeps the next
//     kPrefetch stages of its row in flight by cp.async into a slot of its
//     own (the 64 bytes and the row's two box absmax). Per stage it builds
//     a register table of the 16 values bf16_rn(code[i] * absmax) for each
//     (row, box), as byte planes, looks the nibbles up four at a time with
//     prmt (no shared-memory lookups, one multiply and conversion per table
//     entry instead of per element), and writes two 64-column boxes with
//     st.shared in the 128-byte swizzled layout wgmma's descriptors read
//     (sw128_offset); then fence.proxy.async, and one arrival a warp on the
//     stage's full barrier. Its thread 0 also issues the stage's TMA of the
//     activation tile (x or dy, 128 rows, 128-byte swizzle; rows past M
//     read as zeros).
//   - 64 packed bytes of a row are 128 columns in both layouts: bnb, the
//     columns [2 b0, 2 b0 + 128); split, the two nibble planes' [b0, b0 +
//     64) and [K/2 + b0, K/2 + b0 + 64). Every packed byte is read once per
//     item, and a 64-column box never straddles the planes (K % 128 == 0),
//     so each (row, box) has one absmax.
//   - Both instances write the same B tile: 128 W rows, two boxes of 64
//     columns. Warpgroups 0 and 1 consume it: ROWS / 2 output rows each,
//     fp32 accumulators in registers, 8 k16 steps a stage of ROWS / 128
//     wgmma m64n128k16 each, A (the activation's two ROWS x 64 boxes)
//     K-major. Forward: A is x at the two
//     column ranges above, B is K-major (desc_sw128). dx: the contraction
//     runs over n, A is dy's columns [128 s, 128 s + 128), and B, N (= k)
//     contiguous, is MN-major, read through desc_sw128_mn with the
//     transpose bit (wgmma_m64n128k16_mn): no transposed copy is made. The
//     two boxes of a dx output tile are the same two column ranges, so a
//     tile may cover both nibble planes (K = 640, split: columns 256-319
//     and 576-639).
//   - A ring of 3 stages of 64 KB (2 of 96 KB at ROWS = 256), a full (4
//     warp arrivals + 1 with the TMA bytes) and an empty (8 consumer warps)
//     barrier each; the dequantizing warpgroup runs ahead into the next
//     item while the consumers store the last one.
//   - Few tiles (fewer than the SMs): the wrapper splits the contraction
//     into `splits` parts; each writes an fp32 partial and
//     nf4_split_sum_kernel adds them in split order. No atomics, a fixed
//     summation order: reruns are bit-identical.
//   - Stores straight from the accumulators, rows past M dropped: bf16,
//     each quad's 4 x 4 blocks of pairs transposed by shuffles so that a
//     thread stores whole 16-byte groups; fp32 pairs for partials.
// What holds it back (measured on an H100): the dequantizing arithmetic
// (about 3 instructions a weight element, ceil(M / ROWS) times an element)
// slows the wgmma beside it; a stage takes about the consumers' time plus
// the dequantization's, while its st.shared cost next to nothing.
// Shape contract (the wrapper checks it): K % 128 == 0, N % 128 == 0,
// blocksize 64, contiguous tensors, 16-byte aligned bases.
//
// nf4_wgmma_mn_probe (a test entry, on no model path) holds the
// shared-memory-A, MN-major-B wgmma form to one 64 x 128 product.

#include "hopper_gemm.cuh"

namespace {

using namespace hopper;

constexpr int kTileP = 128;         // output columns of a work item
constexpr int kDequantThreads = 128;
constexpr int kBoxRowBytes = 128;   // one swizzle row: 64 bf16
constexpr int kWRows = 128;         // W rows a stage dequantizes
constexpr int kBoxBytes = kWRows * kBoxRowBytes;  // one 64-column box of B
constexpr int kRingBytes = 3 * 65536;
constexpr int kMaxStages = 3;

// The ring for items of ROWS output rows (128, or 256 where items are
// many): a stage holds the activation's two ROWS x 64 boxes and B's two
// 128 x 64 boxes; 3 stages of 64 KB, or 2 of 96 KB.
template <int ROWS>
struct Ring {
  static constexpr int kABytes = 2 * ROWS * kBoxRowBytes;
  static constexpr int kStageBytes = kABytes + 2 * kBoxBytes;
  static constexpr int kStages = kRingBytes / kStageBytes;
  static_assert(kStages * kStageBytes == kRingBytes, "the ring fills its bytes");
};
// stages of packed bytes and absmax each dequantizing thread (one W row a
// stage) keeps in flight by cp.async, and one stage's slot: [4][128
// threads] 16-byte runs, then [2][128 threads] absmax
constexpr int kPrefetch = 3;
constexpr int kSlotBytes = kDequantThreads * (4 * 16 + 2 * 4);
constexpr int kSmemBytes =
    1024 + kRingBytes + kPrefetch * kSlotBytes + 2 * kMaxStages * sizeof(uint64_t);

// The walk over work items: item -> (split, row tile, column tile), the
// column tile fastest; a block takes items blockIdx.x, + gridDim.x, ...
struct Walk {
  int rows, tiles_p, tiles_m, stages, splits, items;
};

struct Cursor {
  int item, s, s_end;  // contraction stages [s, s_end) of this item
  int m0, pt, part;
  bool valid;
};

__device__ __forceinline__ Cursor start_item(const Walk& w, int item) {
  Cursor c;
  c.item = item;
  c.valid = item < w.items;
  c.pt = item % w.tiles_p;
  const int rest = item / w.tiles_p;
  c.m0 = (rest % w.tiles_m) * w.rows;
  c.part = rest / w.tiles_m;
  c.s = (int)((long long)c.part * w.stages / w.splits);
  c.s_end = (int)((long long)(c.part + 1) * w.stages / w.splits);
  return c;
}

__device__ __forceinline__ Cursor next_stage(const Walk& w, Cursor c) {
  if (++c.s < c.s_end) return c;
  return start_item(w, c.item + gridDim.x);
}

// The two 64-column ranges (first columns) that 64 packed bytes of a row
// from byte b0 = 64 * pair hold.
__device__ __forceinline__ int2 pair_columns(int pair, int k, int split) {
  return split ? make_int2(64 * pair, k / 2 + 64 * pair) : make_int2(128 * pair, 128 * pair + 64);
}

// The packed bytes a dequantizing thread takes per stage, the 64 of one W
// row, and the absmax of the row's two boxes.
struct Raw {
  uint4 v[4];
  float a0, a1;
};

// prmt.b32 (default mode): byte e of the result is byte (c >> 4e) & 7 of
// {b, a}, or with bit 3 of that nibble set its sign replicated.
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// The 16 values bf16_rn(code[i] * a) of one (row, box) as byte planes in
// registers: byte i % 4 of lo[i / 4] is value i's low byte, of hi[i / 4]
// its high byte.
struct Lut {
  uint32_t lo[4], hi[4];
};

__device__ __forceinline__ Lut make_lut(const float (&code)[16], float a) {
  Lut t;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint32_t p0 = pack_bf16x2(code[4 * q] * a, code[4 * q + 1] * a);
    const uint32_t p1 = pack_bf16x2(code[4 * q + 2] * a, code[4 * q + 3] * a);
    t.lo[q] = prmt(p0, p1, 0x6420);
    t.hi[q] = prmt(p0, p1, 0x7531);
  }
  return t;
}

// Four values at once: nibble e of `sel` (bits 4e..4e+2; bit 4e+3 clear)
// indexes the table's lower half, or its upper half where byte e of
// `upper` is 0xFF. Byte e of lo / hi is the low / high byte of that value.
__device__ __forceinline__ void lookup4(const Lut& t, uint32_t sel, uint32_t upper, uint32_t& lo,
                                        uint32_t& hi) {
  const uint32_t l0 = prmt(t.lo[0], t.lo[1], sel), l1 = prmt(t.lo[2], t.lo[3], sel);
  const uint32_t h0 = prmt(t.hi[0], t.hi[1], sel), h1 = prmt(t.hi[2], t.hi[3], sel);
  lo = (l0 & ~upper) | (l1 & upper);
  hi = (h0 & ~upper) | (h1 & upper);
}

// bnb: the 4 bytes of x are columns 2i (high nibble), 2i + 1 (low) of 8
// consecutive columns; returns them as 8 bf16, the lowest column first.
__device__ __forceinline__ uint4 dequant_bnb_word(const Lut& t, uint32_t x) {
  const uint32_t y = x << 4;  // each low nibble's bit 3 as its byte's sign bit
  uint32_t lo, hi;
  uint4 o;
  lookup4(t, x & 0x7777u, prmt(x, y, 0x9D8C), lo, hi);  // nibbles lo0 hi0 lo1 hi1
  o.x = prmt(lo, hi, 0x4051);
  o.y = prmt(lo, hi, 0x6273);
  lookup4(t, (x >> 16) & 0x7777u, prmt(x, y, 0xBFAE), lo, hi);  // lo2 hi2 lo3 hi3
  o.z = prmt(lo, hi, 0x4051);
  o.w = prmt(lo, hi, 0x6273);
  return o;
}

// split: the 4 bytes of x are 4 consecutive columns of both nibble planes;
// the high nibbles through t0 to h (bf16 pairs, lowest column first), the
// low nibbles through t1 to l.
__device__ __forceinline__ void dequant_split_word(const Lut& t0, const Lut& t1, uint32_t x,
                                                   uint32_t (&h)[2], uint32_t (&l)[2]) {
  uint32_t lo, hi;
  uint32_t s = (x >> 4) & 0x07070707u;
  lookup4(t0, s | (s >> 12), prmt(x, 0, 0xB9A8), lo, hi);  // nibbles of bytes 0, 2, 1, 3
  h[0] = prmt(lo, hi, 0x6240);
  h[1] = prmt(lo, hi, 0x7351);
  s = x & 0x07070707u;
  lookup4(t1, s | (s >> 12), prmt(x << 4, 0, 0xB9A8), lo, hi);
  l[0] = prmt(lo, hi, 0x6240);
  l[1] = prmt(lo, hi, 0x7351);
}

// Writes one W row's stage into row r of the swizzled boxes: each half of
// its 64 bytes gives, under bnb, the 8 chunks of box `half`; under split, 4
// chunks of each box (high nibbles to box 0, low to box 1).
__device__ __forceinline__ void dequant_row(const Raw& raw, const float (&code)[16], uint8_t* box0,
                                            uint8_t* box1, int r, int split) {
  if (!split) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const Lut t = make_lut(code, half ? raw.a1 : raw.a0);
      uint8_t* box = half ? box1 : box0;
      const uint32_t w[8] = {raw.v[2 * half].x, raw.v[2 * half].y, raw.v[2 * half].z,
                             raw.v[2 * half].w, raw.v[2 * half + 1].x, raw.v[2 * half + 1].y,
                             raw.v[2 * half + 1].z, raw.v[2 * half + 1].w};
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        *reinterpret_cast<uint4*>(box + sw128_offset(r, c, 0)) = dequant_bnb_word(t, w[c]);
      }
    }
  } else {
    const Lut t0 = make_lut(code, raw.a0), t1 = make_lut(code, raw.a1);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const uint32_t w[8] = {raw.v[2 * half].x, raw.v[2 * half].y, raw.v[2 * half].z,
                             raw.v[2 * half].w, raw.v[2 * half + 1].x, raw.v[2 * half + 1].y,
                             raw.v[2 * half + 1].z, raw.v[2 * half + 1].w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {  // bytes 8c .. 8c + 7: columns 32 half + 8c + j of each box
        uint32_t h0[2], h1[2], l0[2], l1[2];
        dequant_split_word(t0, t1, w[2 * c], h0, l0);
        dequant_split_word(t0, t1, w[2 * c + 1], h1, l1);
        *reinterpret_cast<uint4*>(box0 + sw128_offset(r, 4 * half + c, 0)) =
            make_uint4(h0[0], h0[1], h1[0], h1[1]);
        *reinterpret_cast<uint4*>(box1 + sw128_offset(r, 4 * half + c, 0)) =
            make_uint4(l0[0], l0[1], l1[0], l1[1]);
      }
    }
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// At most N of this thread's committed cp.async groups still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Thread t's share of a stage into its slot, by cp.async: bytes [b0, b0 +
// 64) of W row `row` and the row's two box absmax.
__device__ __forceinline__ void stage_raw(uint8_t* slot, int t, const uint8_t* packed,
                                          const float* absmax, int row, int b0, int k,
                                          int split) {
  uint4* dst = reinterpret_cast<uint4*>(slot);
  const uint8_t* src = packed + (long long)row * (k / 2) + b0;
#pragma unroll
  for (int i = 0; i < 4; ++i) cp_async16(dst + i * kDequantThreads + t, src + 16 * i);
  float* a = reinterpret_cast<float*>(slot + 4 * kDequantThreads * 16);
  const long long first = (long long)row * k + (split ? b0 : 2 * b0);  // box 0's first element
  cp_async4(a + t, absmax + (first >> 6));
  cp_async4(a + kDequantThreads + t, absmax + ((first + (split ? k / 2 : 64)) >> 6));
}

__device__ __forceinline__ Raw read_raw(const uint8_t* slot, int t) {
  Raw raw;
  const uint4* src = reinterpret_cast<const uint4*>(slot);
#pragma unroll
  for (int i = 0; i < 4; ++i) raw.v[i] = src[i * kDequantThreads + t];
  const float* a = reinterpret_cast<const float*>(slot + 4 * kDequantThreads * 16);
  raw.a0 = a[t];
  raw.a1 = a[kDequantThreads + t];
  return raw;
}

// Four threads of a quad (q = lane % 4) each hold a row of a 4 x 4 block
// of 32-bit words; afterwards thread q holds column q (v[i] = thread i's
// v[q]). Two rounds of exchanges across lanes q ^ 2, then q ^ 1.
__device__ __forceinline__ void quad_transpose(uint32_t (&v)[4], int q) {
  const bool b = q & 2;
  uint32_t r0 = __shfl_xor_sync(0xFFFFFFFFu, b ? v[0] : v[2], 2);
  uint32_t r1 = __shfl_xor_sync(0xFFFFFFFFu, b ? v[1] : v[3], 2);
  if (b) {
    v[0] = r0;
    v[1] = r1;
  } else {
    v[2] = r0;
    v[3] = r1;
  }
  const bool c = q & 1;
  r0 = __shfl_xor_sync(0xFFFFFFFFu, c ? v[0] : v[1], 1);
  r1 = __shfl_xor_sync(0xFFFFFFFFu, c ? v[2] : v[3], 1);
  if (c) {
    v[0] = r0;
    v[2] = r1;
  } else {
    v[1] = r0;
    v[3] = r1;
  }
}

// DX = false: out (m, n) = a (m, k) @ W^T.  DX = true: out (m, k) = a (m, n) @ W.
// Items of ROWS output rows: each consumer warpgroup owns ROWS / 2 of them,
// ROWS / 128 wgmma a k16 step on the same B. With splits > 1, part p of
// an item writes its fp32 sum to partial[p].
template <bool DX, int ROWS>
__global__ void __launch_bounds__(kThreads, 1)
nf4_matmul_kernel(const __grid_constant__ CUtensorMap map_a, const uint8_t* __restrict__ packed,
                  const float* __restrict__ absmax, const float* __restrict__ code,
                  __nv_bfloat16* __restrict__ out, float* __restrict__ partial, int m, int n, int k,
                  int split, int splits) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ float s_code[16];
  uint8_t* ring = align_1024(smem_raw);
  uint8_t* staging = ring + kRingBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + kPrefetch * kSlotBytes);
  uint64_t* empty = full + kMaxStages;
  using R = Ring<ROWS>;
  constexpr int kStages = R::kStages, kStageBytes = R::kStageBytes, kABytes = R::kABytes;
  constexpr int kBlocks = ROWS / 128;  // 64-row wgmma blocks a consumer warpgroup

  const int p_total = DX ? k : n;
  Walk walk;
  walk.rows = ROWS;
  walk.tiles_p = p_total / kTileP;
  walk.tiles_m = (m + ROWS - 1) / ROWS;
  walk.stages = (DX ? n : k) / 128;
  walk.splits = splits;
  walk.items = walk.tiles_p * walk.tiles_m * splits;

  if (threadIdx.x < 16) s_code[threadIdx.x] = code[threadIdx.x];
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], kDequantThreads / 32 + 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  int stage = 0;
  uint32_t phase = 0;
  if (wg == 2) {
    // ------------------------------------------------ dequantize (and TMA)
    const int t = threadIdx.x - 256;
    float code_r[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) code_r[i] = s_code[i];
    auto fetch = [&](const Cursor& c, int slot) {
      const int row = (DX ? c.s : c.pt) * kWRows + t;  // this thread's W row of the stage
      stage_raw(staging + slot * kSlotBytes, t, packed, absmax, row, 64 * (DX ? c.pt : c.s), k,
                split);
    };
    // cp.async runs kPrefetch stages ahead of the stage being dequantized
    Cursor cur = start_item(walk, blockIdx.x);
    Cursor ahead = cur;
    for (int slot = 0; slot < kPrefetch; ++slot) {
      if (ahead.valid) {
        fetch(ahead, slot);
        ahead = next_stage(walk, ahead);
      }
      cp_async_commit();
    }
    int slot = 0;
    while (cur.valid) {
      cp_async_wait<kPrefetch - 1>();  // this stage's group has landed
      const Raw raw = read_raw(staging + slot * kSlotBytes, t);
      mbar_wait(&empty[stage], phase ^ 1u);
      uint8_t* tile = ring + stage * kStageBytes;
      if (t == 0) {
        mbar_arrive_expect_tx(&full[stage], kABytes);
        // dx: dy's columns [128 s, 128 s + 128); forward: x's two column ranges
        const int2 cols = DX ? make_int2(128 * cur.s, 128 * cur.s + 64)
                             : pair_columns(cur.s, k, split);
        tma_load_2d(tile, &map_a, &full[stage], cols.x, cur.m0);
        tma_load_2d(tile + kABytes / 2, &map_a, &full[stage], cols.y, cur.m0);
      }
      uint8_t* box0 = tile + kABytes;
      dequant_row(raw, code_r, box0, box0 + kBoxBytes, t, split);
      fence_async_shared();  // this thread's st.shared before the consumers' wgmma reads
      __syncwarp();
      if (t % 32 == 0) mbar_arrive(&full[stage]);
      if (ahead.valid) {  // the slot's bytes are used: refill it
        fetch(ahead, slot);
        ahead = next_stage(walk, ahead);
      }
      cp_async_commit();
      if (++slot == kPrefetch) slot = 0;
      cur = next_stage(walk, cur);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1u;
      }
    }
    return;
  }

  // ---------------------------------------------------------------- consume
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const bool lane0 = lane == 0;
  const int r = (t / 32) * 16 + lane / 4;  // rows r and r + 8 of this warpgroup's 64
  float acc[kBlocks][64];
  for (Cursor cur = start_item(walk, blockIdx.x); cur.valid;
       cur = start_item(walk, cur.item + gridDim.x)) {
#pragma unroll
    for (int h = 0; h < kBlocks; ++h) {
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[h][i] = 0.f;
    }
    int previous = -1;
    for (int s = cur.s; s < cur.s_end; ++s) {
      mbar_wait(&full[stage], phase);
      const uint8_t* tile = ring + stage * kStageBytes;
      const uint8_t* b = tile + kABytes;
#pragma unroll
      for (int h = 0; h < kBlocks; ++h) fence_operands(acc[h]);
      wgmma_fence();
      // the stage's 8 k16 steps: 4 in each activation box; B's rows are W's
      // rows, read K-major forward and MN-major (16 rows a step) for dx
#pragma unroll
      for (int box = 0; box < 2; ++box) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t desc_b = DX ? desc_sw128_mn(b, kBoxBytes) + 128 * (4 * box + kk)
                                     : desc_sw128(b + box * kBoxBytes) + 2 * kk;
#pragma unroll
          for (int h = 0; h < kBlocks; ++h) {
            const uint64_t desc_a = desc_sw128(tile + box * (kABytes / 2) +
                                               (wg * kBlocks + h) * 64 * kBoxRowBytes) + 2 * kk;
            if constexpr (DX) {
              wgmma_m64n128k16_mn(acc[h], desc_a, desc_b, 1);
            } else {
              wgmma_k16<128>(acc[h], desc_a, desc_b);
            }
          }
        }
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's wgmma are done
#pragma unroll
      for (int h = 0; h < kBlocks; ++h) fence_operands(acc[h]);
      if (previous >= 0 && lane0) mbar_arrive(&empty[previous]);
      previous = stage;
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1u;
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int h = 0; h < kBlocks; ++h) fence_operands(acc[h]);
    if (lane0) mbar_arrive(&empty[previous]);

    // epilogue: accumulator columns 8j + 2 (lane % 4), + 1 of rows r, r + 8
    // of each 64-row block
    const int2 cols =
        DX ? pair_columns(cur.pt, k, split) : make_int2(cur.pt * kTileP, cur.pt * kTileP + 64);
#pragma unroll
    for (int h = 0; h < kBlocks; ++h) {
      const int row = cur.m0 + (wg * kBlocks + h) * 64 + r;
      if (splits > 1) {
        float* dst = partial + (long long)cur.part * m * p_total;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int col = (j < 8 ? cols.x : cols.y) + (j % 8) * 8 + 2 * (lane % 4);
          if (row < m) {
            *reinterpret_cast<float2*>(dst + (long long)row * p_total + col) =
                make_float2(acc[h][4 * j], acc[h][4 * j + 1]);
          }
          if (row + 8 < m) {
            *reinterpret_cast<float2*>(dst + (long long)(row + 8) * p_total + col) =
                make_float2(acc[h][4 * j + 2], acc[h][4 * j + 3]);
          }
        }
      } else {
        // a quad's four threads hold the four bf16 pairs of each 8-column
        // group; transposed within the quad, thread q stores whole 16-byte
        // groups 4 kb + q
        const int q = lane % 4;
#pragma unroll
        for (int e = 0; e < 2; ++e) {  // rows r, r + 8
#pragma unroll
          for (int kb = 0; kb < 4; ++kb) {
            uint32_t v[4];
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              const int j = 4 * kb + jj;
              v[jj] = pack_bf16x2(acc[h][4 * j + 2 * e], acc[h][4 * j + 2 * e + 1]);
            }
            quad_transpose(v, q);
            const int j = 4 * kb + q;
            const int col = (j < 8 ? cols.x : cols.y) + (j % 8) * 8;
            if (row + 8 * e < m) {
              *reinterpret_cast<uint4*>(out + (long long)(row + 8 * e) * p_total + col) =
                  make_uint4(v[0], v[1], v[2], v[3]);
            }
          }
        }
      }
    }
  }
}

// out = bf16(partial[0] + partial[1] + ...), the partials in split order.
__global__ void __launch_bounds__(256)
nf4_split_sum_kernel(const float4* __restrict__ partial, uint2* __restrict__ out, long long quads,
                     int splits) {
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
    out[i] = make_uint2(pack_bf16x2(sum.x, sum.y), pack_bf16x2(sum.z, sum.w));
  }
}

// The probe: one warpgroup, d (64 x 128, fp32) = a (64 x 64, K-major) b
// (64 x 128, row-major: an MN-major B), both by TMA with 128-byte swizzle,
// b as two 64-column boxes; four wgmma_m64n128k16_mn.
__global__ void __launch_bounds__(128)
nf4_wgmma_mn_probe_kernel(const __grid_constant__ CUtensorMap map_a,
                          const __grid_constant__ CUtensorMap map_b, float* __restrict__ d) {
  extern __shared__ uint8_t smem_raw[];
  constexpr int kBox = 64 * kBoxRowBytes;
  uint8_t* tile_a = align_1024(smem_raw);
  uint8_t* tile_b = tile_a + kBox;
  uint64_t* bar = reinterpret_cast<uint64_t*>(tile_b + 2 * kBox);
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(bar, 3 * kBox);
    tma_load_2d(tile_a, &map_a, bar, 0, 0);
    tma_load_2d(tile_b, &map_b, bar, 0, 0);
    tma_load_2d(tile_b + kBox, &map_b, bar, 64, 0);
  }
  mbar_wait(bar, 0);
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_m64n128k16_mn(acc, desc_sw128(tile_a) + 2 * kk, desc_sw128_mn(tile_b, kBox) + 128 * kk,
                        1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_operands(acc);
  const int lane = threadIdx.x % 32;
  const int row = 16 * (threadIdx.x / 32) + lane / 4;
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    d[(row + 8 * ((i % 4) / 2)) * 128 + 8 * (i / 4) + 2 * (lane % 4) + (i % 2)] = acc[i];
  }
}

// The SM count of the current device: once per device.
int sm_count(int* count) {
  static int counts[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 64 && counts[device] > 0) {
    *count = counts[device];
    return 0;
  }
  err = cudaDeviceGetAttribute(count, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess && device < 64) counts[device] = *count;
  return static_cast<int>(err);
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

// The main kernel over items of ROWS rows: persistent, a block an SM at most.
template <bool DX, int ROWS>
int launch_rows(const void* a, const void* packed, const void* absmax, const void* code,
                void* out, void* partial, int splits, int m, int n, int k, int split, int sms,
                cudaStream_t stream) {
  CUtensorMap map_a;
  int err = make_map_2d(&map_a, a, m, DX ? n : k, ROWS);
  if (!err) err = prepare<nf4_matmul_kernel<DX, ROWS>>();
  if (err) return err;
  const long long items = (long long)((m + ROWS - 1) / ROWS) * ((DX ? k : n) / kTileP) * splits;
  if (items > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = (int)(items < sms ? items : sms);
  nf4_matmul_kernel<DX, ROWS><<<grid, kThreads, kSmemBytes, stream>>>(
      map_a, static_cast<const uint8_t*>(packed), static_cast<const float*>(absmax),
      static_cast<const float*>(code), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(partial), m, n, k, split, splits);
  return static_cast<int>(cudaGetLastError());
}

template <bool DX>
int launch(const void* a, const void* packed, const void* absmax, const void* code, void* out,
           void* partial, int splits, int m, int n, int k, int split, cudaStream_t stream) {
  const int stages = (DX ? n : k) / 128;
  if (m < 1 || n < 128 || k < 128 || n % 128 != 0 || k % 128 != 0 || splits < 1 ||
      splits > stages || (splits > 1 && partial == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int p_total = DX ? k : n;
  int sms = 0;
  int err = sm_count(&sms);
  if (err) return err;
  // 256-row items dequantize each W tile half as often; where there are
  // fewer than two waves of them, 128-row items fill the card better
  const bool wide = splits == 1 && (long long)((m + 255) / 256) * (p_total / kTileP) >= 2LL * sms;
  err = wide ? launch_rows<DX, 256>(a, packed, absmax, code, out, partial, splits, m, n, k, split,
                                    sms, stream)
             : launch_rows<DX, 128>(a, packed, absmax, code, out, partial, splits, m, n, k, split,
                                    sms, stream);
  if (err || splits == 1) return err;
  const long long quads = (long long)m * p_total / 4;
  const int blocks = (int)((quads + 255) / 256 < 1056 ? (quads + 255) / 256 : 1056);
  nf4_split_sum_kernel<<<blocks, 256, 0, stream>>>(static_cast<const float4*>(partial),
                                                   static_cast<uint2*>(out), quads, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entries, bound with ctypes. x (m, k), y (m, n), dy (m, n), dx (m, k): bf16,
// contiguous, 16-byte aligned; packed (n, k/2) uint8; absmax (n*k/64) fp32;
// code 16 fp32. Launch on `stream` and return the first error: of the
// tensor map's encoding, of the shared-memory attribute, or
// cudaGetLastError() after a launch.
extern "C" int nf4_matmul_fwd(const void* x, const void* packed, const void* absmax,
                              const void* code, void* y, int m, int n, int k, int split,
                              void* stream) {
  return launch<false>(x, packed, absmax, code, y, nullptr, 1, m, n, k, split,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int nf4_matmul_dx(const void* dy, const void* packed, const void* absmax,
                             const void* code, void* dx, int m, int n, int k, int split,
                             void* stream) {
  return launch<true>(dy, packed, absmax, code, dx, nullptr, 1, m, n, k, split,
                      static_cast<cudaStream_t>(stream));
}

// The same with the contraction cut into `splits` parts (1 <= splits <= k /
// 128 forward, n / 128 dx): partial is (splits, m, n) fp32 forward, (splits,
// m, k) dx; a second launch sums the parts in order into the output.
extern "C" int nf4_matmul_fwd_split(const void* x, const void* packed, const void* absmax,
                                    const void* code, void* y, void* partial, int splits, int m,
                                    int n, int k, int split, void* stream) {
  return launch<false>(x, packed, absmax, code, y, partial, splits, m, n, k, split,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int nf4_matmul_dx_split(const void* dy, const void* packed, const void* absmax,
                                   const void* code, void* dx, void* partial, int splits, int m,
                                   int n, int k, int split, void* stream) {
  return launch<true>(dy, packed, absmax, code, dx, partial, splits, m, n, k, split,
                      static_cast<cudaStream_t>(stream));
}

// The probe (a test entry): a (64, 64) and b (64, 128) bf16, contiguous,
// 16-byte aligned; d (64, 128) fp32 = a b.
extern "C" int nf4_wgmma_mn_probe(const void* a, const void* b, void* d, void* stream) {
  CUtensorMap map_a, map_b;
  int err = make_map_2d(&map_a, a, 64, 64, 64);
  if (!err) err = make_map_2d(&map_b, b, 64, 128, 64);
  if (err) return err;
  const size_t smem = 1024 + 3 * 64 * kBoxRowBytes + sizeof(uint64_t);
  nf4_wgmma_mn_probe_kernel<<<1, 128, smem, static_cast<cudaStream_t>(stream)>>>(
      map_a, map_b, static_cast<float*>(d));
  return static_cast<int>(cudaGetLastError());
}
