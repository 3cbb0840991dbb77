// K0: fused dequant + de-zigzag + EXACT 8x8 IDCT + output store, written
// straight into the [blocks_y*8, blocks_x*8] uint8 pixel plane.
//
// Replaces jpeg_decoder_tpu/ops/idct.py idct_exact (its double-float
// emulation in ops/df32.py, which exists because the TPU has no float64) and
// blocks_to_plane: XLA fused those into the JAX device stage. The arithmetic
// (idct8, store) is in idct_exact.cuh, shared with K03 (pixel_exact.cu),
// which runs the 3-component EXACT path; K0 serves gray, fancy and
// 4-component frames and any geometry K03 does not take.
//
// What bounds it on the H100: the float <-> double conversions. A block is
// about 500 float64 operations and 192 bytes (128 of int16 coefficients in,
// 64 of pixels out), which at 34 TFLOP/s and 3.35 TB/s would make the bytes
// the bound; but each statement of the chain converts its float32 operands
// to float64 and its result back, and those conversions issue at 16 a clock
// per SM, a quarter of the float64 rate. The chain spelled as the model
// spells it takes 1,087 of them a block; idct_exact.cuh halves in float32
// and stores in integers, exactly, which leaves 574 (17 in and 17 out of each of the 16
// passes, 30 for the pre-scale; 576 in the SASS) and puts the conversions'
// floor at 0.027 ms for a 4K request's 194,400 blocks.
//
// The design: one thread a block, its 64 values in registers (every
// index a compile-time constant, the zigzag order included), 128 blocks a
// CTA. The CTA's 16 KB of coefficients, contiguous in device memory, come in
// by 16-byte cp.async, coalesced, into rows of 144 bytes (so that a
// quarter-warp's 16-byte reads of eight rows fall in distinct banks); the
// table comes once. Where blocks_x is even, two neighbouring threads hold
// two neighbouring blocks of one block row, and they trade half rows by
// shuffles to store 16-byte rows; otherwise each stores 8-byte rows.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "idct_exact.cuh"

namespace {

using jdtc_common::cp_async16;
using jdtc_common::cp_async_wait_all;
using jdtc_exact::idct8;
using jdtc_exact::kIsqrt2;
using jdtc_exact::mul;
using jdtc_exact::st;

constexpr int kThreads = 128;   // coefficient blocks a CTA, one a thread
constexpr int kRowBytes = 144;  // a block's 128 bytes in shared memory, and 16 of padding

// The zigzag position of natural-order index n (T.81 Figure A.6), a
// compile-time constant wherever n is: on the 15 anti-diagonals d = r + c,
// odd ones run down (row increasing), even ones up.
__host__ __device__ constexpr int zigzag_of(int n) {
  const int r = n >> 3;
  const int c = n & 7;
  const int d = r + c;
  return d < 8 ? d * (d + 1) / 2 + ((d & 1) ? r : c)
               : 64 - (15 - d) * (16 - d) / 2 + ((d & 1) ? r - (d - 7) : c - (d - 7));
}

constexpr int kInvZigzagTable[64] = {
     0,  1,  5,  6, 14, 15, 27, 28,  2,  4,  7, 13, 16, 26, 29, 42,
     3,  8, 12, 17, 25, 30, 41, 43,  9, 11, 18, 24, 31, 40, 44, 53,
    10, 19, 23, 32, 39, 45, 52, 54, 20, 22, 33, 38, 46, 51, 55, 60,
    21, 34, 37, 47, 50, 56, 59, 61, 35, 36, 48, 49, 57, 58, 62, 63};

constexpr bool zigzag_holds() {
  for (int n = 0; n < 64; ++n)
    if (zigzag_of(n) != kInvZigzagTable[n]) return false;
  return true;
}
static_assert(zigzag_holds(), "zigzag_of disagrees with the zigzag table");

// The pre-scale, the row and the column passes over one block's natural
// order values, in place.
static __device__ __forceinline__ void idct_block(float* x) {
  // Row/column 1/sqrt(2) pre-scale (dct.c:164-167): row 0, then column 0,
  // so [0][0] is scaled twice.
#pragma unroll
  for (int c = 0; c < 8; ++c) x[c] = st(mul(kIsqrt2, x[c]));
#pragma unroll
  for (int r = 0; r < 8; ++r) x[r * 8] = st(mul(kIsqrt2, x[r * 8]));
#pragma unroll
  for (int r = 0; r < 8; ++r) idct8<1>(x + r * 8);  // row pass
#pragma unroll
  for (int c = 0; c < 8; ++c) idct8<8>(x + c);      // column pass
}

// The CTA's nb blocks from block b0 and the table into shared memory:
// 16-byte cp.async (2-byte copies where the coefficients are not 16-byte
// aligned), then a barrier.
static __device__ __forceinline__ void load_tile(const int16_t* __restrict__ coeffs,
                                                 const int32_t* __restrict__ qt, int64_t b0,
                                                 int nb, uint8_t* coef, int32_t* q) {
  const int tid = threadIdx.x;
  if ((reinterpret_cast<uintptr_t>(coeffs) & 15) == 0) {
    const uint8_t* src = reinterpret_cast<const uint8_t*>(coeffs + b0 * 64);
    for (int k = tid; k < nb * 8; k += kThreads)
      cp_async16(coef + (k >> 3) * kRowBytes + (k & 7) * 16, src + k * 16);
    cp_async_wait_all();
  } else {
    for (int k = tid; k < nb * 64; k += kThreads)
      reinterpret_cast<int16_t*>(coef + (k >> 6) * kRowBytes)[k & 63] = coeffs[b0 * 64 + k];
  }
  if (tid < 64) q[tid] = __ldg(qt + tid);
  __syncthreads();
}

// A block's 64 zigzag int16 coefficients from its shared row, as pairs:
// coefficient z in half z & 1 of zz[z >> 1].
static __device__ __forceinline__ void zigzag_words(const uint8_t* row, uint32_t* zz) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const uint4 v = *reinterpret_cast<const uint4*>(row + 16 * k);
    zz[4 * k] = v.x;
    zz[4 * k + 1] = v.y;
    zz[4 * k + 2] = v.z;
    zz[4 * k + 3] = v.w;
  }
}

// Natural-order coefficient n dequantised (an int32 product, as the
// reference's), before its float32 conversion.
static __device__ __forceinline__ int32_t dequant(const uint32_t* zz, const int32_t* q, int n) {
  const int z = zigzag_of(n);
  const int32_t c = (z & 1) ? static_cast<int32_t>(zz[z >> 1]) >> 16
                            : static_cast<int32_t>(static_cast<int16_t>(zz[z >> 1] & 0xFFFFu));
  return c * q[n];
}

// The block's row and column in the plane.
static __device__ __forceinline__ void block_at(int64_t b, int64_t n_blocks, int blocks_x,
                                                int64_t& by, int64_t& bx) {
  by = n_blocks <= 0x7FFFFFFF
           ? static_cast<int64_t>(static_cast<uint32_t>(b) / static_cast<uint32_t>(blocks_x))
           : b / blocks_x;
  bx = b - by * blocks_x;
}

__global__ void __launch_bounds__(kThreads)
idct_exact_kernel(const int16_t* __restrict__ coeffs, const int32_t* __restrict__ qt,
                  int64_t n_blocks, int blocks_x, int bits12, int pairs,
                  uint8_t* __restrict__ out) {
  __shared__ __align__(16) uint8_t coef[kThreads * kRowBytes];
  __shared__ int32_t q[64];
  const int tid = threadIdx.x;
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * kThreads;
  const int nb = static_cast<int>(n_blocks - b0 < kThreads ? n_blocks - b0 : kThreads);
  load_tile(coeffs, qt, b0, nb, coef, q);

  // Thread tid's block: dequant + de-zigzag into registers, the IDCT. (A
  // thread past the end computes on whatever its row holds and stores
  // nothing; it stays for the shuffles below.)
  uint32_t zz[32];
  zigzag_words(coef + tid * kRowBytes, zz);
  float x[64];
#pragma unroll
  for (int n = 0; n < 64; ++n) x[n] = static_cast<float>(dequant(zz, q, n));
  idct_block(x);

  // The output store: row r of the block as 8 bytes.
  uint2 row[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    uint32_t lo = 0, hi = 0;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      lo |= static_cast<uint32_t>(jdtc_exact::store(x[r * 8 + c], bits12)) << (8 * c);
      hi |= static_cast<uint32_t>(jdtc_exact::store(x[r * 8 + 4 + c], bits12)) << (8 * c);
    }
    row[r] = make_uint2(lo, hi);
  }
  const bool live = tid < nb;
  int64_t by, bx;
  block_at(b0 + tid, n_blocks, blocks_x, by, bx);
  const int64_t stride = static_cast<int64_t>(blocks_x) * 8;
  uint8_t* dst = out + by * 8 * stride + bx * 8;
  if (pairs) {
    // blocks_x even: threads 2k and 2k + 1 hold blocks bx and bx + 1 of one
    // block row (both live or neither). Rows r and r + 1 of the pair: the
    // even thread stores row r (its half, then its partner's), the odd one
    // row r + 1 (its partner's half, then its own), each 16 aligned bytes.
    const bool odd = tid & 1;
#pragma unroll
    for (int r = 0; r < 8; r += 2) {
      const uint2 send = odd ? row[r] : row[r + 1];
      const uint32_t gx = __shfl_xor_sync(0xFFFFFFFFu, send.x, 1);
      const uint32_t gy = __shfl_xor_sync(0xFFFFFFFFu, send.y, 1);
      if (live) {
        if (odd)
          *reinterpret_cast<uint4*>(dst + (r + 1) * stride - 8) =
              make_uint4(gx, gy, row[r + 1].x, row[r + 1].y);
        else
          *reinterpret_cast<uint4*>(dst + r * stride) = make_uint4(row[r].x, row[r].y, gx, gy);
      }
    }
  } else if (live) {
#pragma unroll
    for (int r = 0; r < 8; ++r) *reinterpret_cast<uint2*>(dst + r * stride) = row[r];
  }
}

}  // namespace

extern "C" int jdtc_idct_exact(const void* coeffs, const void* qt,
                               int64_t n_blocks, int blocks_x, int bits12,
                               void* out, void* cuda_stream) {
  const unsigned grid = static_cast<unsigned>((n_blocks + kThreads - 1) / kThreads);
  const int pairs = blocks_x % 2 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  idct_exact_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<const int16_t*>(coeffs), static_cast<const int32_t*>(qt), n_blocks, blocks_x,
      bits12, pairs, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
