// K3: nearest-neighbour chroma upsample + colour conversion + RGB store, one
// thread per output pixel, reading the uint8 pixel planes K0 or K1 wrote.
// One launch covers a batch of same-geometry images (blockIdx.y is the
// image): the counterpart of jax.vmap over the stage in
// jpeg_decoder_tpu/parallel/batch.py _batched_stage.
//
// Replaces the XLA half of jpeg_decoder_tpu/models/decoder.py build_stage_raw
// after the IDCT: ops/color.py nn_upsample, ycbcr_to_rgb, _store_rgb and
// gray_to_rgb, plus the REFERENCE gray width-stride shear. XLA fused them
// into one program; in plain PyTorch they are a dozen launches with float32
// temporaries in device memory.
//
// Numerics (the index rule, YCbCr -> RGB in float32 without FMAs, the
// REFERENCE / CORRECT store): color.cuh, shared with K03 (pixel_exact.cu)
// and K13 (pixel_float.cu), which run the 3-component EXACT and FLOAT32
// paths in one kernel each with the IDCT; K3 serves gray frames and any
// geometry they do not take.
//
// What bounds it on the H100: memory. Per pixel it reads three bytes (the
// chroma ones shared by up to four neighbours, so mostly from cache) and
// writes three; the arithmetic is a few float32 operations. Neighbouring
// threads touch neighbouring bytes, so reads and writes coalesce; the
// 3-byte RGB stores are not vectorised, which is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "color.cuh"

namespace {

constexpr int kThreads = 256;

struct Geometry {
  const uint8_t* plane[3];
  int64_t img_stride[3];  // elements between one image's plane and the next
  int stride[3];
  float hratio[3];
  float vratio[3];
};

__device__ __forceinline__ uint8_t sample(const Geometry& g, int64_t img, int c,
                                          int i, int j) {
  const uint32_t r = colour::nn_index(i, g.vratio[c]);
  const uint32_t col = colour::nn_index(j, g.hratio[c]);
  return g.plane[c][img * g.img_stride[c] + static_cast<int64_t>(r) * g.stride[c] + col];
}

__global__ void __launch_bounds__(kThreads)
color_kernel(Geometry g, int n_comps, int h, int w, int correct,
             uint8_t* __restrict__ out) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t hw = static_cast<int64_t>(h) * w;
  if (p >= hw) return;
  const int64_t img = blockIdx.y;
  const int i = static_cast<int>(p / w);
  const int j = static_cast<int>(p % w);
  uint8_t* o = out + (img * hw + p) * 3;
  if (n_comps == 1) {
    // stride[0] is the image width under REFERENCE (the y_rgb shear,
    // colour_conversion.c:20) and the padded plane stride under CORRECT.
    const uint8_t y =
        g.plane[0][img * g.img_stride[0] + static_cast<int64_t>(i) * g.stride[0] + j];
    o[0] = y;
    o[1] = y;
    o[2] = y;
    return;
  }
  colour::ycbcr_to_rgb(sample(g, img, 0, i, j), sample(g, img, 1, i, j),
                           sample(g, img, 2, i, j), correct, o);
}

}  // namespace

extern "C" int jdtc_color(const void* plane0, const void* plane1,
                          const void* plane2, int n_images,
                          int64_t img_stride0, int64_t img_stride1,
                          int64_t img_stride2, int n_comps, int h, int w,
                          int stride0, int stride1, int stride2, float hratio0,
                          float hratio1, float hratio2, float vratio0,
                          float vratio1, float vratio2, int correct, void* out,
                          void* cuda_stream) {
  Geometry g{{static_cast<const uint8_t*>(plane0), static_cast<const uint8_t*>(plane1),
              static_cast<const uint8_t*>(plane2)},
             {img_stride0, img_stride1, img_stride2},
             {stride0, stride1, stride2},
             {hratio0, hratio1, hratio2},
             {vratio0, vratio1, vratio2}};
  const int64_t n = static_cast<int64_t>(h) * w;
  const dim3 blocks(static_cast<unsigned>((n + kThreads - 1) / kThreads),
                    static_cast<unsigned>(n_images));
  color_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(cuda_stream)>>>(
      g, n_comps, h, w, correct, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
