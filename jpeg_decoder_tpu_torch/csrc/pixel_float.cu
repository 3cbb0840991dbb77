// K13: the whole FLOAT32 pixel stage of a 3-component frame in one kernel:
// dequant + the FLOAT32 8x8 IDCT (a 64-term float32 dot product a pixel) +
// output store of every block, the nearest-neighbour chroma upsample,
// YCbCr -> RGB and the RGB store.
//
// Replaces, under IdctPrecision.FLOAT32, jpeg_decoder_tpu/models/decoder.py
// build_stage_raw (:72): the Pallas kernel of ops/pallas_kernels.py
// (idct_pallas :126, pallas_call :103) per component, then the XLA colour
// program (ops/color.py nn_upsample :44, ycbcr_to_rgb :138, _store_rgb
// :97) -- on this card the launches K1 x 3 + K3. The arithmetic is K1's
// (idct_float.cuh) and K3's (color.cuh), so the bytes are bitwise theirs:
// a pixel's dot product runs in K1's order whatever block of threads or
// strip computes it.
//
// What bounds it on the H100: operations, then the strip's own steps. At
// 3840x2160 4:2:0, 194,400 blocks x 4096 FMAs are 1.59 G float32
// operations, 0.0238 ms at 67 TFLOP/s; the bytes (24.9 MB of coefficients
// in, 24.9 MB of RGB and 12.4 MB of planes out) take 0.0186 ms at 3.35
// TB/s. K1 x 3 + K3 also moved the planes out and back in, stored pixels a
// byte at a time and fed each 32 FMAs with 12 shared-memory loads. Here:
//  - The strip skeleton of strip.cuh, shared with K03 (the EXACT stage):
//    a strip's coefficient runs by cp.async, the pixel tiles in shared
//    memory, the colour stage from them and RGB and the planes stored in
//    aligned 16-byte windows. Without the product it alone takes two
//    thirds of K13's time (PERF.md).
//  - A persistent grid: one resident wave of blocks of threads walks the
//    strips (image, MCU row, strip in that order), so that K (16 KB) is
//    loaded into shared memory once a block of threads and not once a
//    strip (a 4K frame has thousands of strips: 133 MB of L2 reads at 8,100
//    strips); and the next strip's coefficients are in flight while the
//    current one is computed (its cp.async copies are issued once the
//    current coefficients are dequantised).
//  - The product from registers: the strip's blocks are dequantised into a
//    float tile (zigzag order, kXStride floats a block); a thread owns four
//    pixels of one pixel row (a float4 of K's row) of kBlocksPerThread
//    blocks, so each 4-step of z loads 4 float4 of K and 4 of x for 64 FMAs:
//    8 FMAs a shared-memory load (the register tile of idct_float.cuh,
//    `product`, which K1 and K4 share). Each pixel keeps K1's order, z =
//    0..63 with fmaf from 0. The sixteen threads of a block's
//    pixels read one row of K, 256 contiguous bytes, a load; a thread's
//    blocks are g, g + groups, ... (kXStride = 68 puts neighbouring blocks
//    on other banks). The variants measured on the card (eight pixels a
//    thread, two or eight blocks, K read through L1, more threads for the
//    colour step) were slower: PERF.md.
// The wrapper routes a frame here only where ops/pixel.fits holds, as for
// K03; the last strip of an MCU row holds fewer blocks, padded with zero
// blocks whose pixels are not stored.

#include <cuda_runtime.h>
#include <stdint.h>

#include "idct_float.cuh"
#include "strip.cuh"

namespace {

using jdtc_float::dequant;
using jdtc_float::kZigzag;
using jdtc_strip::kCoefStride;
using jdtc_strip::Params;
using jdtc_strip::Strip;

constexpr int kThreads = 512;         // at most
constexpr int kMinThreads = 64;       // at least, for the strip's other steps
constexpr int kBlocksPerThread = 4;   // blocks a thread forms at once
constexpr int kXStride = 68;          // floats a block in the float tile: 64 + 4 of skew

// Strip i of the walk: image, MCU row, strip of the row, in that order.
__device__ __forceinline__ Strip strip_at(const Params& p, int64_t i, int strips_x) {
  const int64_t row = i / strips_x;  // image * mcus_y + MCU row
  return jdtc_strip::locate(p, row / p.mcus_y, static_cast<int>(row % p.mcus_y),
                            static_cast<int>(i - row * strips_x));
}

__global__ void __launch_bounds__(kThreads)
pixel_float_kernel(const Params p, int64_t n_strips, int strips_x) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  int16_t* coef = reinterpret_cast<int16_t*>(smem);
  float* qf = reinterpret_cast<float*>(smem + p.sm_qt);   // [3][64] zigzag order
  float* ks = reinterpret_cast<float*>(smem + p.sm_k);    // [64][64] K
  float* xt = reinterpret_cast<float*>(smem + p.sm_work); // [blocks][kXStride]

  // K and the tables, once a block of threads; the first strip's
  // coefficients.
  for (int k = tid; k < 64 * 16; k += nt) jdtc_strip::cp_async16(ks + 4 * k, p.kmat + 4 * k);
  for (int k = tid; k < 3 * 64; k += nt)
    qf[k] = static_cast<float>(p.qt[k >> 6][kZigzag[k & 63]]);
  int64_t i = blockIdx.x;
  if (i < n_strips) jdtc_strip::load_coefficients(p, strip_at(p, i, strips_x), coef, tid, nt);

  for (; i < n_strips; i += gridDim.x) {
    const Strip s = strip_at(p, i, strips_x);
    const int n_blocks = s.first[3];
    const int groups = (n_blocks + kBlocksPerThread - 1) / kBlocksPerThread;
    const int padded = groups * kBlocksPerThread;
    jdtc_strip::index_tables(p, s, smem, tid, nt);
    jdtc_strip::cp_async_wait_all();
    __syncthreads();

    // 2. Dequantise into the float tile; zero blocks pad it to whole groups.
    for (int t = tid; t < padded * 16; t += nt) {
      const int b = t >> 4;
      const int z = (t & 15) * 4;
      float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (b < n_blocks) {
        const float* q = qf + jdtc_strip::component(s, b) * 64 + z;
        const short4 v = *reinterpret_cast<const short4*>(coef + b * kCoefStride + z);
        x = make_float4(dequant(v.x, q[0]), dequant(v.y, q[1]), dequant(v.z, q[2]),
                        dequant(v.w, q[3]));
      }
      *reinterpret_cast<float4*>(xt + b * kXStride + z) = x;
    }
    __syncthreads();
    // The next strip's coefficients travel while this one is computed.
    if (i + gridDim.x < n_strips)
      jdtc_strip::load_coefficients(p, strip_at(p, i + gridDim.x, strips_x), coef, tid, nt);

    // 3. The product: thread (g, q) forms pixels 4q..4q+3 (half of pixel
    // row q / 2) of blocks g, g + groups, ... and stores them into their
    // components' tiles.
    for (int t = tid; t < 16 * groups; t += nt) {
      const int q = t & 15;
      const int g = t >> 4;
      const float* kq = ks + 4 * q;
      float acc[kBlocksPerThread][4];
      jdtc_float::product<kBlocksPerThread, 4>(kq, xt + g * kXStride, groups * kXStride, acc);
#pragma unroll
      for (int j = 0; j < kBlocksPerThread; ++j) {
        const int b = g + j * groups;
        if (b < n_blocks) {
          uint8_t* dst = jdtc_strip::tile_block_row(p, s, smem, b, jdtc_strip::component(s, b),
                                                    q >> 1) + (q & 1) * 4;
#pragma unroll
          for (int px = 0; px < 4; ++px) dst[px] = jdtc_float::store(acc[j][px], p.bits12);
        }
      }
    }
    __syncthreads();

    // 4-6. The planes when asked, colour from the tiles, the RGB rows.
    jdtc_strip::store_planes(p, s, smem, tid, nt);
    jdtc_strip::colour_tiles(p, s, smem, tid, nt);
    __syncthreads();
    jdtc_strip::store_rgb(p, s, smem, tid, nt);
    __syncthreads();  // the next strip rewrites the index tables and the tiles
  }
}

}  // namespace

extern "C" int jdtc_pixel_float(
    const void* coeff0, const void* coeff1, const void* coeff2, const void* qt0,
    const void* qt1, const void* qt2, const void* kmat, int n_images, int h, int w, int hsf0,
    int hsf1, int hsf2, int vsf0, int vsf1, int vsf2, float hratio0, float hratio1,
    float hratio2, float vratio0, float vratio1, float vratio2, int mcus_x, int mcus_y,
    int strip, int bits12, int correct, int row0, int stripe_h, void* rgb, void* plane0,
    void* plane1, void* plane2, void* cuda_stream) {
  const void* coeff[3] = {coeff0, coeff1, coeff2};
  const void* qt[3] = {qt0, qt1, qt2};
  void* plane[3] = {plane0, plane1, plane2};
  const int hsf[3] = {hsf0, hsf1, hsf2};
  const int vsf[3] = {vsf0, vsf1, vsf2};
  const float hr[3] = {hratio0, hratio1, hratio2};
  const float vr[3] = {vratio0, vratio1, vratio2};
  Params p = jdtc_strip::make_params(coeff, qt, plane, rgb, h, w, hsf, vsf, hr, vr, mcus_x,
                                     mcus_y, strip, bits12, correct, row0, stripe_h);
  p.kmat = static_cast<const float*>(kmat);
  const int groups = (p.blocks + kBlocksPerThread - 1) / kBlocksPerThread;
  // Shared memory: coefficients | tables (float, zigzag order) | K | the
  // index tables | float tile, later the staged RGB rows | the three uint8
  // tiles.
  p.sm_qt = p.blocks * kCoefStride * 2;
  p.sm_k = p.sm_qt + 3 * 64 * 4;
  const int end = jdtc_strip::finish_layout(p, p.sm_k + 64 * 64 * 4,
                                            groups * kBlocksPerThread * kXStride * 4);
  const int items = 16 * groups;
  const int threads =
      items > kThreads ? kThreads : (items < kMinThreads ? kMinThreads : (items + 31) & ~31);
  const int strips_x = (mcus_x + strip - 1) / strip;
  const int64_t n_strips = static_cast<int64_t>(strips_x) * mcus_y * n_images;
  if (n_strips == 0) return 0;

  // One resident wave of blocks of threads, each walking strips.
  int dev = 0;
  int sms = 0;
  int per_sm = 0;
  cudaError_t e = cudaFuncSetAttribute(pixel_float_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, end);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pixel_float_kernel, threads, end);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t wave = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const unsigned grid = static_cast<unsigned>(n_strips < wave ? n_strips : wave);
  pixel_float_kernel<<<grid, threads, end, static_cast<cudaStream_t>(cuda_stream)>>>(
      p, n_strips, strips_x);
  return static_cast<int>(cudaGetLastError());
}
