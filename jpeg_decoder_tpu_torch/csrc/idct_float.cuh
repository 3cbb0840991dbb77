// The FLOAT32 IDCT's arithmetic, shared by K1 (idct_float.cu) and K13
// (pixel_float.cu) so that the two cannot drift: the pixels of a block are
// bitwise the same whichever kernel computes them.
//
// The contract (ops/idct.idct_float, after idct_pallas): x =
// float32(coeff_zz) * float32(qt_zz), one float32 product (exact for
// |coeff| <= 2^15 and qt <= 255; __fmul_rn keeps it a rounding of its own,
// as the plain version's multiply); y[p] = sum over z of x[z] * K[z][p]
// with K the [64, 64] float32 matrix of ops/idct.idct_matrix_zz, formed as
// fmaf in order z = 0..63 from 0 (an explicit fmaf is never reassociated,
// whatever the compiler's flags; no TF32, whose 10 mantissa bits the
// contract cannot afford); then `store`.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace jdtc_float {

// Natural-order index of each zigzag position (T.81 Figure A.6;
// core/types.ZIGZAG): qt_zz[z] = qt_natural[kZigzag[z]]. Static: each file
// that includes this has its own copy, so two objects of one library do not
// define the symbol twice.
static __constant__ int kZigzag[64] = {
     0,  1,  8, 16,  9,  2,  3, 10, 17, 24, 32, 25, 18, 11,  4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13,  6,  7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// A dequantised coefficient.
static __device__ __forceinline__ float dequant(int16_t coeff, float qt_zz) {
  return __fmul_rn(static_cast<float>(coeff), qt_zz);
}

// Four steps of a pixel's dot product: x[z..z+3] against K[z..z+3][p], in
// that order.
static __device__ __forceinline__ float dot4(float acc, float4 x, float k0, float k1, float k2,
                                             float k3) {
  acc = fmaf(x.x, k0, acc);
  acc = fmaf(x.y, k1, acc);
  acc = fmaf(x.z, k2, acc);
  return fmaf(x.w, k3, acc);
}

// The FLOAT32 contract's store (ops/idct._quantize_output_float): float32
// ops only, and a clamp before every float -> integer conversion.
static __device__ __forceinline__ uint8_t store(float y, int bits12) {
  const float base = floorf(y);
  if (!bits12) {
    float q = __fadd_rn(base, 128.0f);
    q = q > 255.0f ? 255.0f : (q < 0.0f ? 0.0f : q);
    return static_cast<uint8_t>(static_cast<int>(q));
  }
  float r = __fadd_rn(base, 2048.0f);
  r = r > 65535.0f ? 65535.0f : (r < 0.0f ? 0.0f : r);
  int v = static_cast<int>(r) & 0xFFFF;  // CLAMP_16, then the int16 wrap
  v = (v ^ 0x8000) - 0x8000;
  // 255/4096 is exact in float32, and so is the product (15 x 8 bits).
  const float q = truncf(__fmul_rn(static_cast<float>(v), 255.0f / 4096.0f));
  return static_cast<uint8_t>(static_cast<int>(q) & 0xFF);
}

}  // namespace jdtc_float
