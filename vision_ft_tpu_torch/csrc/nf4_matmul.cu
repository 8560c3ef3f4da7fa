// Packed 4-bit (NF4 / FP4) matmul for Hopper (sm_90a), CUDA C++: forward and dx.
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
// (154 rows of text keys). The design keeps the weight packed in device
// memory (0.5625 bytes an element with absmax, never a bf16 copy) and
// dequantizes tiles in shared memory next to the tensor cores.
//
// Design (one kernel template, two instances):
//   - out(M, P) = A(M, Q) @ Bt(P, Q)^T. Forward: A = x, P = N, Q = K,
//     Bt = W. dx: A = dy, P = K, Q = N, Bt = W^T. One thread block of 8
//     warps owns one 128 x 128 output tile and loops over Q in steps of 64
//     itself; the TPU kernel's sequential grid axis with its VMEM
//     accumulator becomes this loop with register accumulators. No atomics:
//     runs are bit-identical.
//   - Each step stages a 128 x 64 bf16 tile of A and dequantizes the
//     matching W tile ONCE into shared memory as bf16; all 8 warps (the
//     block's whole 128-row M extent) read it for mma.sync m16n8k16 with
//     fp32 accumulators. Per call, a weight element is dequantized
//     ceil(M / 128) times (once per block row), each time by one thread.
//   - A thread reads the fp32 absmax of its 16 elements directly, and looks
//     codes up in a 16-float table in shared memory; the TPU kernel's
//     iota-mask expansion matmul and 15-select chain are not carried over.
//   - The forward stores the dequantized tile row-major ([n][k], the mma's
//     "col" B operand as it is). The dx kernel needs W^T: a thread
//     dequantizes rows n and n+1 for 16 columns and stores the pairs as
//     32-bit words of the transposed tile [k][n].
//   - Under the split layout a 64-column step lies in one nibble plane
//     (K/2 % 64 == 0), so a thread reads 16 bytes and takes one nibble of
//     each; under the bnb layout it reads 8 bytes and takes both.
//   - Ragged M is masked here: rows at or past M are staged as zeros and
//     never written.
// Shape contract (the wrapper checks it): K % 128 == 0, N % 128 == 0,
// blocksize 64, contiguous tensors, 16-byte aligned bases.
// Left for later work: cp.async / TMA double buffering, wgmma, ldmatrix,
// a larger M extent per block (fewer dequantizations per element).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileM = 128;   // output rows per block
constexpr int kTileP = 128;   // output columns per block
constexpr int kStepQ = 64;    // contraction elements per step
constexpr int kWarps = 8;     // 2 along M x 4 along P: a warp owns 64 x 32
constexpr int kThreads = kWarps * 32;
constexpr int kLd = kStepQ + 8;  // bf16 elements per shared row (padded)

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a(16x16, row) * b(16x8, col), bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The 16 dequantized elements W[row][col .. col + 16), col % 16 == 0, in
// fp32 (code value x absmax, not yet rounded).
__device__ __forceinline__ void dequant16(float (&w)[16], const uint8_t* __restrict__ packed,
                                          const float* __restrict__ absmax, const float* s_code,
                                          int row, int col, int k, bool split) {
  const long long flat = (long long)row * k + col;
  const float scale = absmax[flat >> 6];
  const int half = k >> 1;
  const uint8_t* row_bytes = packed + (long long)row * half;
  if (!split) {
    const uint2 raw = *reinterpret_cast<const uint2*>(row_bytes + (col >> 1));
    const uint32_t words[2] = {raw.x, raw.y};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t byte = (words[j >> 2] >> (8 * (j & 3))) & 0xFFu;
      w[2 * j] = s_code[byte >> 4] * scale;
      w[2 * j + 1] = s_code[byte & 0xFu] * scale;
    }
  } else {
    const bool high = col < half;
    const uint4 raw = *reinterpret_cast<const uint4*>(row_bytes + (high ? col : col - half));
    const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
    const int shift = high ? 4 : 0;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const uint32_t byte = (words[j >> 2] >> (8 * (j & 3))) & 0xFFu;
      w[j] = s_code[(byte >> shift) & 0xFu] * scale;
    }
  }
}

// DX = false: out (m, n) = a (m, k) @ W^T.  DX = true: out (m, k) = a (m, n) @ W.
template <bool DX>
__global__ void __launch_bounds__(kThreads)
nf4_matmul_kernel(const __nv_bfloat16* __restrict__ a, const uint8_t* __restrict__ packed,
                  const float* __restrict__ absmax, const float* __restrict__ code,
                  __nv_bfloat16* __restrict__ out, int m, int n, int k, int split) {
  __shared__ __align__(16) __nv_bfloat16 sA[kTileM * kLd];  // [row][q]
  __shared__ __align__(16) __nv_bfloat16 sB[kTileP * kLd];  // [output column][q]
  __shared__ float s_code[16];

  const int p_total = DX ? k : n;  // output columns
  const int q_total = DX ? n : k;  // contraction length
  const int p0 = blockIdx.x * kTileP;
  const int m0 = blockIdx.y * kTileM;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;  // row within the 8-row mma group
  const int t = lane % 4;  // column pair within the quad
  const int warp_m = (warp / 4) * 64;
  const int warp_p = (warp % 4) * 32;

  if (tid < 16) s_code[tid] = code[tid];

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int pi = 0; pi < 4; ++pi)
      acc[mi][pi][0] = acc[mi][pi][1] = acc[mi][pi][2] = acc[mi][pi][3] = 0.f;

  for (int q0 = 0; q0 < q_total; q0 += kStepQ) {
    __syncthreads();  // every warp is done with the previous tiles (and s_code is written)

    // A tile: 128 rows x 64 bf16 = 1024 16-byte vectors, 4 a thread
#pragma unroll
    for (int i = 0; i < (kTileM * kStepQ / 8) / kThreads; ++i) {
      const int v = tid + i * kThreads;
      const int r = v / (kStepQ / 8);
      const int c = (v % (kStepQ / 8)) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < m) {
        val = *reinterpret_cast<const uint4*>(a + (long long)(m0 + r) * q_total + q0 + c);
      }
      *reinterpret_cast<uint4*>(sA + r * kLd + c) = val;
    }

    // W tile, dequantized once for the whole block
    if (!DX) {
      // rows n = p0 + r, columns k = q0 + c: 512 chunks of 16, 2 a thread
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int chunk = tid + i * kThreads;
        const int r = chunk / 4;
        const int c = (chunk % 4) * 16;
        float w[16];
        dequant16(w, packed, absmax, s_code, p0 + r, q0 + c, k, split != 0);
        uint4 lo, hi;
        lo.x = pack_bf16x2(w[0], w[1]);
        lo.y = pack_bf16x2(w[2], w[3]);
        lo.z = pack_bf16x2(w[4], w[5]);
        lo.w = pack_bf16x2(w[6], w[7]);
        hi.x = pack_bf16x2(w[8], w[9]);
        hi.y = pack_bf16x2(w[10], w[11]);
        hi.z = pack_bf16x2(w[12], w[13]);
        hi.w = pack_bf16x2(w[14], w[15]);
        *reinterpret_cast<uint4*>(sB + r * kLd + c) = lo;
        *reinterpret_cast<uint4*>(sB + r * kLd + c + 8) = hi;
      }
    } else {
      // rows n = q0 + 2 * pair (+1), columns k = p0 + c: stored transposed,
      // sB[k column][n], the two rows of a pair as one 32-bit word
      const int pair = tid % 32;
      const int c = (tid / 32) * 16;
      float w0[16], w1[16];
      dequant16(w0, packed, absmax, s_code, q0 + 2 * pair, p0 + c, k, split != 0);
      dequant16(w1, packed, absmax, s_code, q0 + 2 * pair + 1, p0 + c, k, split != 0);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        *reinterpret_cast<uint32_t*>(sB + (c + j) * kLd + 2 * pair) = pack_bf16x2(w0[j], w1[j]);
      }
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kStepQ / 16; ++kk) {
      uint32_t af[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const __nv_bfloat16* base = sA + (warp_m + mi * 16 + g) * kLd + kk * 16 + 2 * t;
        af[mi][0] = lds32(base);
        af[mi][1] = lds32(base + 8 * kLd);
        af[mi][2] = lds32(base + 8);
        af[mi][3] = lds32(base + 8 * kLd + 8);
      }
#pragma unroll
      for (int pi = 0; pi < 4; ++pi) {
        const __nv_bfloat16* bb = sB + (warp_p + pi * 8 + g) * kLd + kk * 16 + 2 * t;
        const uint32_t b0 = lds32(bb);
        const uint32_t b1 = lds32(bb + 8);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) mma_16816(acc[mi][pi], af[mi], b0, b1);
      }
    }
  }

#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
    const int row_lo = m0 + warp_m + mi * 16 + g;
    const int row_hi = row_lo + 8;
#pragma unroll
    for (int pi = 0; pi < 4; ++pi) {
      const int col = p0 + warp_p + pi * 8 + 2 * t;
      if (row_lo < m) {
        *reinterpret_cast<uint32_t*>(out + (long long)row_lo * p_total + col) =
            pack_bf16x2(acc[mi][pi][0], acc[mi][pi][1]);
      }
      if (row_hi < m) {
        *reinterpret_cast<uint32_t*>(out + (long long)row_hi * p_total + col) =
            pack_bf16x2(acc[mi][pi][2], acc[mi][pi][3]);
      }
    }
  }
}

template <bool DX>
int launch(const void* a, const void* packed, const void* absmax, const void* code, void* out,
           int m, int n, int k, int split, void* stream) {
  if (m < 1 || n < 1 || k < 1 || n % 128 != 0 || k % 128 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int p_total = DX ? k : n;
  const dim3 grid(p_total / kTileP, (m + kTileM - 1) / kTileM);
  if (grid.y > 65535u) return static_cast<int>(cudaErrorInvalidValue);
  nf4_matmul_kernel<DX><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const uint8_t*>(packed),
      static_cast<const float*>(absmax), static_cast<const float*>(code),
      static_cast<__nv_bfloat16*>(out), m, n, k, split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entries, bound with ctypes. x (m, k), y (m, n), dy (m, n), dx (m, k): bf16,
// contiguous, 16-byte aligned; packed (n, k/2) uint8; absmax (n*k/64) fp32;
// code 16 fp32. Launch on `stream` and return cudaGetLastError().
extern "C" int nf4_matmul_fwd(const void* x, const void* packed, const void* absmax,
                              const void* code, void* y, int m, int n, int k, int split,
                              void* stream) {
  return launch<false>(x, packed, absmax, code, y, m, n, k, split, stream);
}

extern "C" int nf4_matmul_dx(const void* dy, const void* packed, const void* absmax,
                             const void* code, void* dx, int m, int n, int k, int split,
                             void* stream) {
  return launch<true>(dy, packed, absmax, code, dx, m, n, k, split, stream);
}
