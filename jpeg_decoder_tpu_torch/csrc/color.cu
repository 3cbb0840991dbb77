// K3: nearest-neighbour chroma upsample + colour conversion + RGB store, 1,
// 3 or 4 components (gray, YCbCr, YCCK, raw Adobe CMYK); K3f: the same with
// fancy (triangular 2x) chroma upsampling, 3 or 4 components. One template,
// one thread per output pixel, one launch per request or batch (blockIdx.y
// is the image: the counterpart of jax.vmap over the stage in
// jpeg_decoder_tpu/parallel/batch.py _batched_stage), reading the uint8
// pixel planes K0, K1 or K5 wrote.
//
// K3 replaces the XLA half of jpeg_decoder_tpu/models/decoder.py
// build_stage_raw after the IDCT: ops/color.py nn_upsample (:44), then
// ycbcr_to_rgb (:138), ycck_to_rgb (:181), cmyk_to_rgb (:167) or
// gray_to_rgb, with _store_rgb and the REFERENCE gray width-stride shear.
// On 4 planes it is named K3c in the records (the 4-component branch,
// :146-160). K3f replaces build_stage_raw with upsample="fancy" (:94-96,
// :115-120): ops/color.py fancy_upsample (:73; fancy_h2x :53, fancy_v2x
// :64) of every component, then the colour transform. XLA fused each into
// one program; in plain PyTorch they are a dozen launches with float32
// temporaries in device memory. The colour arithmetic lives in color.cuh,
// shared with K03 (pixel_exact.cu) and K13 (pixel_float.cu), which run the
// 3-component nearest-neighbour EXACT and FLOAT32 paths in one kernel each
// with the IDCT; K3 serves every frame and geometry they do not take.
//
// Fancy upsampling is integer-exact. The JAX package computes in float32:
// a horizontal pass gives H = (3x + n + b) * 0.25 for source sample x and
// its left (even output, b = 1) or right (odd output, b = 2) neighbour n;
// the vertical pass the same over rows. Write A = 3x + n + b, an integer of
// at most 3*255 + 255 + 2 = 1022: H = A/4 is exact in float32, so one pass
// floors to A >> 2. After both passes the value is (3*H + H' + b') * 0.25
// = (3A + A' + 4b') / 16, with A and A' the horizontal sums of the source
// row and of its upper (even output row, b' = 1) or lower (odd, b' = 2)
// neighbour row: every intermediate is a multiple of 1/16 below 2^12,
// exact in float32's 24-bit significand, so the floor is (3A + A' + 4b')
// >> 4 in int32, bitwise the JAX function's. Its largest value, 4096/16 =
// 256 in an all-255 neighbourhood, is clamped to 255 before the store
// (ops/color.py:86-90).
//
// The neighbours: JAX rolls over the whole padded [rows, stride] plane and
// replicates the plane's first and last row and column, so the edges here
// are the PADDED plane's (rows - 1, stride - 1), not the image's or the
// component's x and y; a batch's images each have their own. A ratio that
// is not 2x (4:1:1's 4x) takes no pass on that axis, and the passes'
// output is then indexed by the reference's nearest-neighbour rule with
// the factors after the passes (eh / max_hsf, ev / max_vsf): `kNN` in a
// component's flags. A component at the full factors is read in place (no
// flag: the rule's index at ratio 1 is the pixel's own). A gray plane's
// stride is the image width under REFERENCE (the y_rgb shear,
// colour_conversion.c:20) and the padded plane's under CORRECT.
//
// Striped and streamed decode (K6n and K6f in the records; the XLA
// programs of jpeg_decoder_tpu/parallel/stripes.py make_chunk_stage :322
// and make_shard_fn :86) launch both over a chunk of MCU rows or over the
// whole padded frame, with the launch's first row of the padded frame and
// the stripe height: the nearest-neighbour rows then follow colour::nn_row.
// K3f there takes the triangular passes only for a component whose factors
// reach the maximum after them (stripes.py:139-144), and the
// nearest-neighbour rule at its own ratios for every other component (the
// host sets its flags so); on one card every stripe is resident, so the
// vertical pass over the padded plane's rows is the stripes' one-row halo
// exchange, the padded plane's last row its outer edge.
//
// What bounds it on the H100: memory. A pixel reads each component's
// sample (for fancy, at most three neighbours more: a 2x2 quad of sources
// shared by the pixel's neighbours, so mostly from cache) and writes three
// bytes; the arithmetic is a few integer or float32 operations, and YCCK
// EXACT's dozen float64 ones. Neighbouring threads touch neighbouring
// bytes, so reads and writes coalesce; the 3-byte RGB stores are not
// vectorised, and a strip with a halo on K03's skeleton, so that fancy
// EXACT runs as one launch as nearest-neighbour does, is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "color.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxComps = 4;
// A component's flags (ops/color.py upsample_geometry).
constexpr int kH2x = 1;  // a horizontal 2x pass
constexpr int kV2x = 2;  // a vertical 2x pass
constexpr int kNN = 4;   // then the nearest-neighbour rule (else read in place)

struct Geometry {
  const uint8_t* plane[kMaxComps];
  int64_t img_stride[kMaxComps];  // elements between one image's plane and the next
  int rows[kMaxComps];
  int stride[kMaxComps];
  int flags[kMaxComps];
  int local_rows[kMaxComps];  // plane rows a stripe (striped decode)
  float hratio[kMaxComps];
  float vratio[kMaxComps];
  int row0, stripe_h;  // striped decode: colour::nn_row; 0, 0 for whole frames
};

// The horizontal pass's integer sum A = 3x + n + b at output column q of a
// source row (before the >> 2).
__device__ __forceinline__ int hsum(const uint8_t* row, int q, int cols) {
  const int s = q >> 1;
  const int n = (q & 1) ? min(s + 1, cols - 1) : max(s - 1, 0);
  return 3 * row[s] + row[n] + ((q & 1) ? 2 : 1);
}

// The sample of component c at output pixel (i, j).
template <bool kFancy>
__device__ __forceinline__ uint8_t sample(const Geometry& g, int64_t img, int c, int i,
                                          int j) {
  const uint8_t* p = g.plane[c] + img * g.img_stride[c];
  const int cols = g.stride[c];
  const int flags = g.flags[c];
  int r = i, q = j;
  if (flags & kNN) {
    r = colour::nn_row(i, g.vratio[c], g.row0, g.stripe_h, g.local_rows[c]);
    q = static_cast<int>(colour::nn_index(j, g.hratio[c]));
  }
  if (!kFancy || !(flags & (kH2x | kV2x))) return p[static_cast<int64_t>(r) * cols + q];
  if (!(flags & kV2x)) return static_cast<uint8_t>(hsum(p + static_cast<int64_t>(r) * cols, q, cols) >> 2);
  const int t = r >> 1;
  const int tn = (r & 1) ? min(t + 1, g.rows[c] - 1) : max(t - 1, 0);
  const int bv = (r & 1) ? 2 : 1;
  const uint8_t* row = p + static_cast<int64_t>(t) * cols;
  const uint8_t* nrow = p + static_cast<int64_t>(tn) * cols;
  if (!(flags & kH2x)) return static_cast<uint8_t>((3 * row[q] + nrow[q] + bv) >> 2);
  const int v = (3 * hsum(row, q, cols) + hsum(nrow, q, cols) + 4 * bv) >> 4;
  return static_cast<uint8_t>(min(v, 255));
}

// One kernel per (upsampling, colour mode): a mode fixed at compile time
// keeps YCCK EXACT's float64 registers out of the YCbCr and gray kernels
// (a runtime switch cost K3 9% on 4K 4:2:0 planes, PERF.md).
template <bool kFancy, int kMode>
__global__ void __launch_bounds__(kThreads)
colour_kernel(Geometry g, int h, int w, int correct, uint8_t* __restrict__ out) {
  constexpr int kComps = kMode == colour::kGray ? 1 : (kMode == colour::kYCbCr ? 3 : 4);
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t hw = static_cast<int64_t>(h) * w;
  if (p >= hw) return;
  const int64_t img = blockIdx.y;
  const int i = static_cast<int>(p / w);
  const int j = static_cast<int>(p % w);
  uint8_t s[kMaxComps] = {};
#pragma unroll
  for (int c = 0; c < kComps; ++c) s[c] = sample<kFancy>(g, img, c, i, j);
  colour::convert(kMode, s, correct, out + (img * hw + p) * 3);
}

template <bool kFancy, int kMode>
void run(const Geometry& g, int n_images, int h, int w, int correct, void* out,
         void* cuda_stream) {
  const int64_t n = static_cast<int64_t>(h) * w;
  const dim3 blocks(static_cast<unsigned>((n + kThreads - 1) / kThreads),
                    static_cast<unsigned>(n_images));
  colour_kernel<kFancy, kMode><<<blocks, kThreads, 0, static_cast<cudaStream_t>(cuda_stream)>>>(
      g, h, w, correct, static_cast<uint8_t*>(out));
}

template <bool kFancy>
int launch(const void* plane0, const void* plane1, const void* plane2, const void* plane3,
           int n_images, int n_comps, int h, int w, const void* geom, const void* ratios,
           int row0, int stripe_h, int mode, int correct, void* out, void* cuda_stream) {
  // geom: host int64 [4][5], per component (image stride, rows, stride,
  // flags, plane rows a stripe); ratios: host float [4][2], per component
  // (hratio, vratio).
  const auto* gm = static_cast<const int64_t*>(geom);
  const auto* rt = static_cast<const float*>(ratios);
  Geometry g{{static_cast<const uint8_t*>(plane0), static_cast<const uint8_t*>(plane1),
              static_cast<const uint8_t*>(plane2), static_cast<const uint8_t*>(plane3)}};
  for (int c = 0; c < kMaxComps; ++c) {
    g.img_stride[c] = gm[5 * c];
    g.rows[c] = static_cast<int>(gm[5 * c + 1]);
    g.stride[c] = static_cast<int>(gm[5 * c + 2]);
    g.flags[c] = static_cast<int>(gm[5 * c + 3]);
    g.local_rows[c] = static_cast<int>(gm[5 * c + 4]);
    g.hratio[c] = rt[2 * c];
    g.vratio[c] = rt[2 * c + 1];
  }
  g.row0 = row0;
  g.stripe_h = stripe_h;
  // the mode fixes the component count
  const int comps = mode == colour::kGray ? 1 : (mode == colour::kYCbCr ? 3 : 4);
  if (n_comps != comps) return static_cast<int>(cudaErrorInvalidValue);
  switch (mode) {
    case colour::kYCbCr: run<kFancy, colour::kYCbCr>(g, n_images, h, w, correct, out, cuda_stream); break;
    case colour::kYcckExact: run<kFancy, colour::kYcckExact>(g, n_images, h, w, correct, out, cuda_stream); break;
    case colour::kYcckFloat: run<kFancy, colour::kYcckFloat>(g, n_images, h, w, correct, out, cuda_stream); break;
    case colour::kCmyk: run<kFancy, colour::kCmyk>(g, n_images, h, w, correct, out, cuda_stream); break;
    case colour::kGray: run<kFancy, colour::kGray>(g, n_images, h, w, correct, out, cuda_stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K3 (K3c on 4 planes): nearest-neighbour upsampling, 1, 3 or 4 components.
extern "C" int jdtc_color(const void* plane0, const void* plane1, const void* plane2,
                          const void* plane3, int n_images, int n_comps, int h, int w,
                          const void* geom, const void* ratios, int row0, int stripe_h,
                          int mode, int correct, void* out, void* cuda_stream) {
  return launch<false>(plane0, plane1, plane2, plane3, n_images, n_comps, h, w, geom, ratios,
                       row0, stripe_h, mode, correct, out, cuda_stream);
}

// K3f: fancy upsampling, 3 or 4 components.
extern "C" int jdtc_fancy(const void* plane0, const void* plane1, const void* plane2,
                          const void* plane3, int n_images, int n_comps, int h, int w,
                          const void* geom, const void* ratios, int row0, int stripe_h,
                          int mode, int correct, void* out, void* cuda_stream) {
  return launch<true>(plane0, plane1, plane2, plane3, n_images, n_comps, h, w, geom, ratios,
                       row0, stripe_h, mode, correct, out, cuda_stream);
}
