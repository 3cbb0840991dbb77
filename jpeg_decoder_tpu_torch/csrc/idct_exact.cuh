// The EXACT IDCT's arithmetic, shared by K0 (idct_exact.cu) and K03
// (pixel_exact.cu) so that the two cannot drift.
//
// The model is core/numerics._idct8_rows_exact / idct_2d_exact, which
// replicates the reference C decoder (dct.c fast_2didct + fast_idct_new):
// every statement is a float64 expression of float32 values stored to
// float32, and the float32 sums inside them are float32 operations. Each
// statement below rounds exactly where the model rounds: float64 products
// and sums through __dmul_rn / __dadd_rn (so nvcc's default --fmad=true
// cannot contract them into FMAs), float32 sums through __fadd_rn /
// __fsub_rn, and every store through __double2float_rn.
//
// On the H100 a conversion to or from a 64-bit type issues at 16 a clock
// per SM, a quarter of the float64 arithmetic's rate, so the statements'
// float <-> double conversions (F2F), not their float64 products, set K0's
// time. Two statements are therefore written in a form that gives the same
// bits with fewer of them: the halvings in float32 and the store in
// integers. Each has its proof beside it and a CPU test
// (tests/test_torch_idct.py).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace jdtc_exact {

// Zigzag position of each natural-order coefficient (T.81 Figure A.6;
// core/types.INV_ZIGZAG). Static: each file that includes this has its own
// copy, so two objects of one library do not define the symbol twice.
static __constant__ int kInvZigzag[64] = {
     0,  1,  5,  6, 14, 15, 27, 28,  2,  4,  7, 13, 16, 26, 29, 42,
     3,  8, 12, 17, 25, 30, 41, 43,  9, 11, 18, 24, 31, 40, 44, 53,
    10, 19, 23, 32, 39, 45, 52, 54, 20, 22, 33, 38, 46, 51, 55, 60,
    21, 34, 37, 47, 50, 56, 59, 61, 35, 36, 48, 49, 57, 58, 62, 63};

// The row/column 1/sqrt(2) pre-scale (dct.c:164-167).
constexpr double kIsqrt2 = 0.707106781;

static __device__ __forceinline__ float st(double x) { return __double2float_rn(x); }
static __device__ __forceinline__ double mul(double c, float x) {
  return __dmul_rn(c, static_cast<double>(x));
}
static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }

// The model's st(0.5 * x) of a float32 x. Proof that the float32 product
// is the same value: 0.5 * x is exact in float64 (float32's exponents lie
// far inside float64's), so the statement rounds the exact half of x to
// float32 once; __fmul_rn(0.5f, x) rounds the same exact half to float32
// once, so the two agree for every x, subnormal halves included (where
// both round the one exact value to the same neighbour). It saves a
// conversion in and one out (tests: test_halving_in_float32_is_exact).
static __device__ __forceinline__ float half(float x) { return __fmul_rn(0.5f, x); }

// One fast_idct_new pass over v[0], v[S], ..., v[7*S], in place
// (core/numerics._idct8_rows_exact, statement by statement).
template <int S>
static __device__ __forceinline__ void idct8(float* v) {
  const float t0 = st(mul(1.414213562, v[0 * S]));
  const float t1 = v[4 * S];
  const float t2 = v[2 * S];
  const float t3 = v[6 * S];
  const float t4 = half(__fsub_rn(v[1 * S], v[7 * S]));
  const float t5 = st(mul(0.707106781, v[3 * S]));
  const float t6 = st(mul(0.707106781, v[5 * S]));
  const float t7 = half(__fadd_rn(v[1 * S], v[7 * S]));

  const float u0 = half(__fadd_rn(t0, t1));
  const float u1 = half(__fsub_rn(t0, t1));
  const float u2 = st(__dmul_rn(0.707106781,
                                add(mul(0.38268343236, t2), mul(-0.92387953251, t3))));
  const float u3 = st(__dmul_rn(0.707106781,
                                add(mul(0.92387953251, t2), mul(0.38268343236, t3))));
  const float u4 = half(__fadd_rn(t4, t6));
  const float u5 = half(__fadd_rn(-t5, t7));
  const float u6 = half(__fsub_rn(t4, t6));
  const float u7 = half(__fadd_rn(t5, t7));

  const float w0 = half(__fadd_rn(u0, u3));
  const float w1 = half(__fadd_rn(u1, u2));
  const float w2 = half(__fsub_rn(u1, u2));
  const float w3 = half(__fsub_rn(u0, u3));
  const float w4 = st(add(mul(0.8314696123, u4), mul(-0.55557023302, u7)));
  const float w5 = st(add(mul(0.9807852804, u5), mul(-0.19509032201, u6)));
  const float w6 = st(add(mul(0.19509032201, u5), mul(0.9807852804, u6)));
  const float w7 = st(add(mul(0.55557023302, u4), mul(0.8314696123, u7)));

  const double s = 1.414213562 * 2;  // exact doubling, as the model's literal
  v[0 * S] = st(mul(s, __fadd_rn(w0, w7)));
  v[1 * S] = st(mul(s, __fadd_rn(w1, w6)));
  v[2 * S] = st(mul(s, __fadd_rn(w2, w5)));
  v[3 * S] = st(mul(s, __fadd_rn(w3, w4)));
  v[4 * S] = st(mul(s, __fsub_rn(w3, w4)));
  v[5 * S] = st(mul(s, __fsub_rn(w2, w5)));
  v[6 * S] = st(mul(s, __fsub_rn(w1, w6)));
  v[7 * S] = st(mul(s, __fsub_rn(w0, w7)));
}

// floor(0.25 * y) of a float32 y with |0.25 y| < 2^22, without a
// conversion: the fma rounded down gives the largest float32 at or below
// 1.5 * 2^23 + 0.25 y, and in [2^23, 2^24) the float32 values are the
// integers, so it is 1.5 * 2^23 + floor(0.25 y) exactly (the product is
// exact inside the fma); its bits less those of 1.5 * 2^23 (0x4B400000)
// are floor(0.25 y).
static __device__ __forceinline__ int floor_quarter(float y) {
  return __float_as_int(__fmaf_rd(y, 0.25f, 12582912.0f)) - 0x4B400000;
}

// The reference's output store (dct.c:186-203; core/numerics.idct_2d_exact
// and rescale_12bit), which the model spells in float64: 0.25 * x + 128
// (2048 for 12-bit), clamped, truncated; 12-bit then wraps to int16 and
// takes trunc(v / 4096 * 255). Here in float32 and integers, bitwise the
// float64 form for every float32 x (tests:
// test_integer_store_is_the_float64_store). Proof, 8-bit (12-bit: 2048 for
// 128, 65535 for 255, the bound 2^-41 for 2^-45):
// - Where 128 + 0.25 x is exact in float64, trunc(clamp(128 + 0.25 x)) =
//   clamp(128 + floor(0.25 x)): trunc is floor on [0, 255], and floor
//   commutes with clamping to integer bounds. Clamping x itself to
//   [-1024, 1024] first changes no result (beyond it the output is 0 or
//   255 either way) and keeps floor_quarter in range.
// - The float64 sum is inexact only where |x| lies below 2^-20 (2^-16
//   for 12-bit): two addends whose last bits lie at or above L sum exactly
//   below 2^53 L, and 0.25 x's last bit lies 25 binades below x's top.
//   There the only integer in reach is 128: for x >= 0 both forms give
//   128; for x < 0 the exact sum lies just below 128, floor gives 127,
//   and float64 rounds it up to 128 where 0.25 |x| <= 2^-47 (half the
//   ulp below 128, the tie going to 128's even significand), that is
//   where -2^-45 <= x < 0. That case is taken apart. (The chain can make
//   such an x: w4 - w7 cancel in float64.)
// - 12-bit: after the clamp and the int16 wrap, v / 4096 * 255 is exact
//   in float64 (|v| < 2^15), so its trunc is C's (v * 255) / 4096, which
//   truncates toward zero.
// The clamps compare floats (no conversion), NaN goes to the lower bound
// as in the float64 form, and no F2F, F2I or FRND is left.
static __device__ __forceinline__ uint8_t store(float x, int bits12) {
  if (!bits12) {
    int v = floor_quarter(fminf(fmaxf(x, -1024.0f), 1024.0f)) + 128;
    v = min(max(v, 0), 255);
    if (x < 0.0f && x >= -0x1p-45f) v = 128;
    return static_cast<uint8_t>(v);
  }
  int r = floor_quarter(fminf(fmaxf(x, -8200.0f), 262144.0f)) + 2048;
  r = min(max(r, 0), 65535);
  if (x < 0.0f && x >= -0x1p-41f) r = 2048;
  const int v = ((r & 0xFFFF) ^ 0x8000) - 0x8000;
  return static_cast<uint8_t>(((v * 255) / 4096) & 0xFF);
}

}  // namespace jdtc_exact
