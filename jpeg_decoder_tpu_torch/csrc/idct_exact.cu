// K0: fused dequant + de-zigzag + EXACT 8x8 IDCT + output store, written
// straight into the [blocks_y*8, blocks_x*8] uint8 pixel plane.
//
// Replaces jpeg_decoder_tpu/ops/idct.py idct_exact (its double-float
// emulation in ops/df32.py, which exists because the TPU has no float64) and
// blocks_to_plane: XLA fused those into the JAX device stage. The arithmetic
// (idct8, store) is in idct_exact.cuh, shared with K03 (pixel_exact.cu),
// which runs the 3-component EXACT path; K0 serves gray frames and any
// geometry K03 does not take.
//
// What bounds it on the H100: on paper, memory. A block is ~700 float64
// operations (no FMAs, by design) against 192 bytes moved (128 of int16
// coefficients in, 64 of pixels out); at 34 TFLOP/s float64 and 3.35 TB/s
// the bytes take about three times as long. One thread per block keeps the
// 64 values in registers (the natural-order index of every access is a
// compile-time constant). Its reads are 128-byte rows per thread, not
// coalesced across a warp, and its stores are 8-byte rows; K03 stages its
// blocks through shared memory instead.

#include <cuda_runtime.h>
#include <stdint.h>

#include "idct_exact.cuh"

namespace {

using jdtc_exact::idct8;
using jdtc_exact::kInvZigzag;
using jdtc_exact::kIsqrt2;
using jdtc_exact::mul;
using jdtc_exact::st;

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
idct_exact_kernel(const int16_t* __restrict__ coeffs,
                  const int32_t* __restrict__ qt, int64_t n_blocks,
                  int blocks_x, int bits12, uint8_t* __restrict__ out) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= n_blocks) return;
  const int16_t* src = coeffs + b * 64;
  float x[64];
#pragma unroll
  for (int n = 0; n < 64; ++n)
    x[n] = static_cast<float>(static_cast<int32_t>(src[kInvZigzag[n]]) * __ldg(qt + n));
  // Row/column 1/sqrt(2) pre-scale (dct.c:164-167): row 0, then column 0,
  // so [0][0] is scaled twice.
#pragma unroll
  for (int c = 0; c < 8; ++c) x[c] = st(mul(kIsqrt2, x[c]));
#pragma unroll
  for (int r = 0; r < 8; ++r) x[r * 8] = st(mul(kIsqrt2, x[r * 8]));
#pragma unroll
  for (int r = 0; r < 8; ++r) idct8<1>(x + r * 8);   // row pass
#pragma unroll
  for (int c = 0; c < 8; ++c) idct8<8>(x + c);       // column pass

  const int64_t by = b / blocks_x;
  const int64_t bx = b % blocks_x;
  const int64_t stride = static_cast<int64_t>(blocks_x) * 8;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    uint64_t row = 0;
#pragma unroll
    for (int c = 0; c < 8; ++c)
      row |= static_cast<uint64_t>(jdtc_exact::store(x[r * 8 + c], bits12)) << (8 * c);
    *reinterpret_cast<uint64_t*>(out + (by * 8 + r) * stride + bx * 8) = row;
  }
}

}  // namespace

extern "C" int jdtc_idct_exact(const void* coeffs, const void* qt,
                               int64_t n_blocks, int blocks_x, int bits12,
                               void* out, void* cuda_stream) {
  const unsigned blocks = static_cast<unsigned>((n_blocks + kThreads - 1) / kThreads);
  idct_exact_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<const int16_t*>(coeffs), static_cast<const int32_t*>(qt),
      n_blocks, blocks_x, bits12, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
