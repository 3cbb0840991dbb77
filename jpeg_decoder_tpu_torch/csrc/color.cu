// K3: nearest-neighbour chroma upsample + colour conversion + RGB store, one
// thread per output pixel, reading the uint8 pixel planes K0 wrote.
//
// Replaces the XLA half of jpeg_decoder_tpu/models/decoder.py build_stage_raw
// after the IDCT: ops/color.py nn_upsample, ycbcr_to_rgb, _store_rgb and
// gray_to_rgb, plus the REFERENCE gray width-stride shear. XLA fused them
// into one program; in plain PyTorch they are a dozen launches with float32
// temporaries in device memory.
//
// Numerics: the chroma index is (uint32)(i * ratio) with a float32 multiply
// and ratio = float32(sf) / float32(max_sf) (core/numerics._nn_index_f32).
// YCbCr -> RGB is plain float32 in the JAX package's order of operations
// (ops/color._ycbcr_channels_f32), spelled with __fmul_rn / __fadd_rn /
// __fsub_rn so no FMA is contracted -- not needed for the bytes (that path
// is proven byte-exact under every FMA choice, ops/color.py ycbcr_to_rgb)
// but it keeps the kernel bitwise equal to its plain PyTorch version. The
// store truncates (REFERENCE) or rounds half up (CORRECT), then saturates.
//
// What bounds it on the H100: memory. Per pixel it reads three bytes (the
// chroma ones shared by up to four neighbours, so mostly from cache) and
// writes three; the arithmetic is a few float32 operations. Neighbouring
// threads touch neighbouring bytes, so reads and writes coalesce; the
// 3-byte RGB stores are not vectorised, which is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Geometry {
  const uint8_t* plane[3];
  int stride[3];
  float hratio[3];
  float vratio[3];
};

__device__ __forceinline__ uint8_t store(float v, int correct) {
  float q = correct ? floorf(__fadd_rn(v, 0.5f)) : truncf(v);
  q = q > 255.0f ? 255.0f : (q < 0.0f ? 0.0f : q);
  return static_cast<uint8_t>(static_cast<int>(q));
}

__device__ __forceinline__ uint8_t sample(const Geometry& g, int c, int i, int j) {
  const uint32_t r = static_cast<uint32_t>(__fmul_rn(static_cast<float>(i), g.vratio[c]));
  const uint32_t col = static_cast<uint32_t>(__fmul_rn(static_cast<float>(j), g.hratio[c]));
  return g.plane[c][static_cast<int64_t>(r) * g.stride[c] + col];
}

__global__ void __launch_bounds__(kThreads)
color_kernel(Geometry g, int n_comps, int h, int w, int correct,
             uint8_t* __restrict__ out) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= static_cast<int64_t>(h) * w) return;
  const int i = static_cast<int>(p / w);
  const int j = static_cast<int>(p % w);
  uint8_t* o = out + p * 3;
  if (n_comps == 1) {
    // stride[0] is the image width under REFERENCE (the y_rgb shear,
    // colour_conversion.c:20) and the padded plane stride under CORRECT.
    const uint8_t y = g.plane[0][static_cast<int64_t>(i) * g.stride[0] + j];
    o[0] = y;
    o[1] = y;
    o[2] = y;
    return;
  }
  const float y = static_cast<float>(sample(g, 0, i, j));
  const float cb = __fsub_rn(static_cast<float>(sample(g, 1, i, j)), 128.0f);
  const float cr = __fsub_rn(static_cast<float>(sample(g, 2, i, j)), 128.0f);
  // float32(double literal), as np.float32(1.402) rounds it
  const float k_rv = static_cast<float>(1.402);
  const float k_gu = static_cast<float>(0.34414);
  const float k_gv = static_cast<float>(0.71414);
  const float k_bu = static_cast<float>(1.772);
  const float r = __fadd_rn(y, __fmul_rn(k_rv, cr));
  const float gg = __fsub_rn(__fsub_rn(y, __fmul_rn(k_gu, cb)), __fmul_rn(k_gv, cr));
  const float b = __fadd_rn(y, __fmul_rn(k_bu, cb));
  o[0] = store(r, correct);
  o[1] = store(gg, correct);
  o[2] = store(b, correct);
}

}  // namespace

extern "C" int jdtc_color(const void* plane0, const void* plane1,
                          const void* plane2, int n_comps, int h, int w,
                          int stride0, int stride1, int stride2, float hratio0,
                          float hratio1, float hratio2, float vratio0,
                          float vratio1, float vratio2, int correct, void* out,
                          void* cuda_stream) {
  Geometry g{{static_cast<const uint8_t*>(plane0), static_cast<const uint8_t*>(plane1),
              static_cast<const uint8_t*>(plane2)},
             {stride0, stride1, stride2},
             {hratio0, hratio1, hratio2},
             {vratio0, vratio1, vratio2}};
  const int64_t n = static_cast<int64_t>(h) * w;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  color_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(cuda_stream)>>>(
      g, n_comps, h, w, correct, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
