// The colour stage's arithmetic, shared by K3 (color.cu) and, through the
// strip skeleton (strip.cuh), K03 (pixel_exact.cu) and K13 (pixel_float.cu)
// so that they cannot drift.
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

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace colour {

// The nearest-neighbour source index of output index i.
static __device__ __forceinline__ uint32_t nn_index(int i, float ratio) {
  return static_cast<uint32_t>(__fmul_rn(static_cast<float>(i), ratio));
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

}  // namespace colour
