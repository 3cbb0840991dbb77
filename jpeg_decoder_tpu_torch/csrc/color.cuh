// The colour stage's arithmetic, shared by K3 and K3f (color.cu) and,
// through the strip skeleton (strip.cuh), K03 (pixel_exact.cu) and K13
// (pixel_float.cu) so that they cannot drift.
//
// The chroma index is (uint32)(i * ratio) with a float32 multiply and
// ratio = float32(sf) / float32(max_sf) (core/numerics._nn_index_f32).
// YCbCr -> RGB is plain float32 in the JAX package's order of operations
// (ops/color._ycbcr_channels_f32), spelled with __fmul_rn / __fadd_rn /
// __fsub_rn so no FMA is contracted -- not needed for the bytes (that path
// is proven byte-exact under every FMA choice, ops/color.py ycbcr_to_rgb)
// but it keeps the kernels bitwise equal to their plain PyTorch versions.
// The store truncates (REFERENCE) or rounds half up (CORRECT), then
// saturates.
//
// The 4-component transforms (K3 on 4 planes, K3f): YCCK under EXACT is the
// reference's chain of float64 statements, each stored to float32
// (core/numerics.ycck_channels_to_rgb), spelled with __dadd_rn / __dsub_rn /
// __dmul_rn / __ddiv_rn so that nvcc contracts no FMA (a contracted
// a*b+c rounds once where the chain rounds twice, and the stores to float32
// then differ); under FLOAT32 the JAX package's float32 order
// (ops/color.py ycck_to_rgb) with __f*_rn, __fdiv_rn included (a plain `/`
// may be compiled to a product by the reciprocal). Raw Adobe CMYK is
// (c * k + 127) / 255 in int32.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace colour {

// The nearest-neighbour source index of output index i.
static __device__ __forceinline__ uint32_t nn_index(int i, float ratio) {
  return static_cast<uint32_t>(__fmul_rn(static_cast<float>(i), ratio));
}

// The source row, among the launch's plane rows, of the launch's output row
// i. Whole frames (stripe_h == 0, row0 == 0): nn_index(i). Striped and
// streamed decode (jpeg_decoder_tpu/parallel/stripes.py make_chunk_stage,
// make_shard_fn): the launch starts at row row0 of the padded frame, a
// multiple of the stripe height stripe_h, and each stripe of stripe_h output
// rows owns local_rows plane rows. The rule runs on the padded frame's row g
// (the float32 product depends on the absolute index), its source is made
// local to g's stripe and clamped into it, then placed among the launch's
// stripes.
static __device__ __forceinline__ int nn_row(int i, float ratio, int row0, int stripe_h,
                                             int local_rows) {
  const int g = row0 + i;
  const int src = static_cast<int>(nn_index(g, ratio));
  if (stripe_h <= 0) return src;
  const int st = g / stripe_h;
  const int r = min(max(src - st * local_rows, 0), local_rows - 1);
  return r + (st - row0 / stripe_h) * local_rows;
}

static __device__ __forceinline__ uint8_t store(float v, int correct) {
  float q = correct ? floorf(__fadd_rn(v, 0.5f)) : truncf(v);
  q = q > 255.0f ? 255.0f : (q < 0.0f ? 0.0f : q);
  return static_cast<uint8_t>(static_cast<int>(q));
}

// One pixel's Y, Cb, Cr samples -> its three RGB bytes at o[0..2].
static __device__ __forceinline__ void ycbcr_to_rgb(uint8_t y8, uint8_t cb8, uint8_t cr8,
                                                    int correct, uint8_t* o) {
  const float y = static_cast<float>(y8);
  const float cb = __fsub_rn(static_cast<float>(cb8), 128.0f);
  const float cr = __fsub_rn(static_cast<float>(cr8), 128.0f);
  // float32(double literal), as np.float32(1.402) rounds it
  const float k_rv = static_cast<float>(1.402);
  const float k_gu = static_cast<float>(0.34414);
  const float k_gv = static_cast<float>(0.71414);
  const float k_bu = static_cast<float>(1.772);
  const float r = __fadd_rn(y, __fmul_rn(k_rv, cr));
  const float g = __fsub_rn(__fsub_rn(y, __fmul_rn(k_gu, cb)), __fmul_rn(k_gv, cr));
  const float b = __fadd_rn(y, __fmul_rn(k_bu, cb));
  o[0] = store(r, correct);
  o[1] = store(g, correct);
  o[2] = store(b, correct);
}

// The colour transforms of jpeg_decoder_tpu_torch/ops/color.py colour_mode.
enum Mode { kYCbCr = 0, kYcckExact = 1, kYcckFloat = 2, kCmyk = 3, kGray = 4 };

// YCCK under EXACT: C/M/Y as float64 expressions stored to float32, then
// 255 * (1 - X/255) * (K/255) in float64, stored to float32.
static __device__ __forceinline__ void ycck_exact(uint8_t y8, uint8_t cb8, uint8_t cr8,
                                                  uint8_t k8, int correct, uint8_t* o) {
  const double y = static_cast<double>(y8);
  const double cb = __dsub_rn(static_cast<double>(cb8), 128.0);
  const double cr = __dsub_rn(static_cast<double>(cr8), 128.0);
  const float cmy[3] = {
      __double2float_rn(__dadd_rn(y, __dmul_rn(1.402, cr))),
      __double2float_rn(__dsub_rn(__dsub_rn(y, __dmul_rn(0.34414, cb)), __dmul_rn(0.71414, cr))),
      __double2float_rn(__dadd_rn(y, __dmul_rn(1.772, cb)))};
  const double kk = __ddiv_rn(static_cast<double>(k8), 255.0);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const double x = static_cast<double>(cmy[c]);
    const double v = __dmul_rn(__dmul_rn(255.0, __dsub_rn(1.0, __ddiv_rn(x, 255.0))), kk);
    o[c] = store(__double2float_rn(v), correct);
  }
}

// YCCK under FLOAT32: the YCbCr chain of ycbcr_to_rgb, then the composite,
// every operation a float32 rounding of its own.
static __device__ __forceinline__ void ycck_float(uint8_t y8, uint8_t cb8, uint8_t cr8,
                                                  uint8_t k8, int correct, uint8_t* o) {
  const float y = static_cast<float>(y8);
  const float cb = __fsub_rn(static_cast<float>(cb8), 128.0f);
  const float cr = __fsub_rn(static_cast<float>(cr8), 128.0f);
  const float k_rv = static_cast<float>(1.402);
  const float k_gu = static_cast<float>(0.34414);
  const float k_gv = static_cast<float>(0.71414);
  const float k_bu = static_cast<float>(1.772);
  const float cmy[3] = {
      __fadd_rn(y, __fmul_rn(k_rv, cr)),
      __fsub_rn(__fsub_rn(y, __fmul_rn(k_gu, cb)), __fmul_rn(k_gv, cr)),
      __fadd_rn(y, __fmul_rn(k_bu, cb))};
  const float kk = __fdiv_rn(static_cast<float>(k8), 255.0f);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float v =
        __fmul_rn(__fmul_rn(255.0f, __fsub_rn(1.0f, __fdiv_rn(cmy[c], 255.0f))), kk);
    o[c] = store(v, correct);
  }
}

// Raw Adobe CMYK: integer-exact, no store quirk.
static __device__ __forceinline__ void cmyk(uint8_t c8, uint8_t m8, uint8_t y8, uint8_t k8,
                                            uint8_t* o) {
  const int k = k8;
  o[0] = static_cast<uint8_t>((c8 * k + 127) / 255);
  o[1] = static_cast<uint8_t>((m8 * k + 127) / 255);
  o[2] = static_cast<uint8_t>((y8 * k + 127) / 255);
}

// One pixel's samples s[0..n) -> its three RGB bytes at o[0..2], by `mode`.
static __device__ __forceinline__ void convert(int mode, const uint8_t* s, int correct,
                                               uint8_t* o) {
  switch (mode) {
    case kYCbCr: ycbcr_to_rgb(s[0], s[1], s[2], correct, o); break;
    case kYcckExact: ycck_exact(s[0], s[1], s[2], s[3], correct, o); break;
    case kYcckFloat: ycck_float(s[0], s[1], s[2], s[3], correct, o); break;
    case kCmyk: cmyk(s[0], s[1], s[2], s[3], o); break;
    default: o[0] = o[1] = o[2] = s[0]; break;
  }
}

}  // namespace colour
