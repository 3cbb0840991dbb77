// K03: the whole EXACT pixel stage of a 3-component frame in one kernel:
// dequant + de-zigzag + EXACT 8x8 IDCT + output store of every block, the
// nearest-neighbour chroma upsample, YCbCr -> RGB and the RGB store, one
// block of threads (CTA) per strip of G consecutive MCUs of one MCU row of
// one image (blockIdx = strip, MCU row, image).
//
// Replaces jpeg_decoder_tpu/models/decoder.py build_stage_raw (:72), the
// XLA program that fuses ops/idct.py idct_exact (:189) and blocks_to_plane
// (:288) with ops/color.py nn_upsample (:44), ycbcr_to_rgb (:138) and
// _store_rgb (:97) -- on this card the launches K0 x 3 + K3. The arithmetic
// is K0's and K3's, statement for statement, from the headers they share
// (idct_exact.cuh, color.cuh), so the bytes are bitwise theirs.
//
// What bounds it on the H100: memory. At 3840x2160 4:2:0 the coefficients
// are 24.9 MB in and RGB 24.9 MB out (and 12.4 MB of pixel planes when the
// caller asks for them); the ~700 float64 operations a block come to a
// fifth of the bytes' time. K0 + K3 moved the planes out and back in, read
// 128 bytes a thread (a warp's load touched 32 lines) and stored RGB a byte
// at a time. Here the strip skeleton of strip.cuh (shared with K13, the
// FLOAT32 stage) keeps the pixel tiles in shared memory, loads the strip's
// coefficient runs (1 KB for luma at 4:2:0, where G = 4:
// ops/pixel.default_strip) by cp.async and stores RGB and the planes in
// aligned 16-byte windows (TMA would need a tensor map per plane and a
// barrier for runs of 1-2 KB). The quantisation tables come along once a
// CTA. Its own part is the IDCT, with 8 threads a block: thread r
// dequantises and de-zigzags row r and runs the row pass into a padded
// [8][9] float tile (no bank conflicts across a warp's four blocks); after a
// barrier thread c runs the column pass of column c and stores into the
// component's uint8 tile.

#include <cuda_runtime.h>
#include <stdint.h>

#include "idct_exact.cuh"
#include "strip.cuh"

namespace {

using jdtc_exact::idct8;
using jdtc_exact::kInvZigzag;
using jdtc_exact::kIsqrt2;
using jdtc_exact::mul;
using jdtc_exact::st;
using jdtc_strip::kCoefStride;
using jdtc_strip::kMaxThreads;
using jdtc_strip::Params;

constexpr int kFloatStride = 72;  // floats a block in the [8][9] tile

__global__ void __launch_bounds__(kMaxThreads)
pixel_exact_kernel(const Params p) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const jdtc_strip::Strip s = jdtc_strip::locate(p, blockIdx.z, blockIdx.y, blockIdx.x);
  int16_t* coef = reinterpret_cast<int16_t*>(smem);
  int32_t* qt = reinterpret_cast<int32_t*>(smem + p.sm_qt);
  uint8_t* inv = smem + p.sm_inv;
  float* ftile = reinterpret_cast<float*>(smem + p.sm_work);
  const int n_blocks = s.first[3];

  // 1. Coefficients and tables into shared memory; the index tables.
  jdtc_strip::load_coefficients(p, s, coef, tid, nt);
  for (int k = tid; k < 48; k += nt)
    jdtc_strip::cp_async16(qt + 4 * k, p.qt[k >> 4] + 4 * (k & 15));
  for (int k = tid; k < 64; k += nt) inv[k] = static_cast<uint8_t>(kInvZigzag[k]);
  jdtc_strip::index_tables(p, s, smem, tid, nt);
  jdtc_strip::cp_async_wait_all();
  __syncthreads();

  // 2. Row pass: thread (b, r) dequantises and de-zigzags row r of block b.
  for (int t = tid; t < n_blocks * 8; t += nt) {
    const int b = t >> 3;
    const int r = t & 7;
    const int c = jdtc_strip::component(s, b);
    const int16_t* zz = coef + b * kCoefStride;
    const int32_t* q = qt + c * 64 + r * 8;
    const uint8_t* iz = inv + r * 8;
    float x[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      x[k] = static_cast<float>(static_cast<int32_t>(zz[iz[k]]) * q[k]);
    // Row/column 1/sqrt(2) pre-scale (dct.c:164-167): row 0, then column 0,
    // so [0][0] is scaled twice, in K0's order.
    if (r == 0) {
#pragma unroll
      for (int k = 0; k < 8; ++k) x[k] = st(mul(kIsqrt2, x[k]));
    }
    x[0] = st(mul(kIsqrt2, x[0]));
    idct8<1>(x);
    float* out = ftile + b * kFloatStride + r * 9;
#pragma unroll
    for (int k = 0; k < 8; ++k) out[k] = x[k];
  }
  __syncthreads();

  // 3. Column pass: thread (b, col) finishes column col of block b and
  // stores its eight pixels into the component's tile.
  for (int t = tid; t < n_blocks * 8; t += nt) {
    const int b = t >> 3;
    const int col = t & 7;
    const int c = jdtc_strip::component(s, b);
    const float* in = ftile + b * kFloatStride + col;
    float x[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) x[k] = in[k * 9];
    idct8<1>(x);
#pragma unroll
    for (int k = 0; k < 8; ++k)
      jdtc_strip::tile_block_row(p, s, smem, b, c, k)[col] = jdtc_exact::store(x[k], p.bits12);
  }
  __syncthreads();

  // 4-6. The planes when asked, colour from the tiles, the RGB rows.
  jdtc_strip::store_planes(p, s, smem, tid, nt);
  jdtc_strip::colour_tiles(p, s, smem, tid, nt);
  __syncthreads();
  jdtc_strip::store_rgb(p, s, smem, tid, nt);
}

}  // namespace

extern "C" int jdtc_pixel_exact(
    const void* coeff0, const void* coeff1, const void* coeff2, const void* qt0,
    const void* qt1, const void* qt2, int n_images, int h, int w, int hsf0, int hsf1,
    int hsf2, int vsf0, int vsf1, int vsf2, float hratio0, float hratio1, float hratio2,
    float vratio0, float vratio1, float vratio2, int mcus_x, int mcus_y, int strip,
    int bits12, int correct, int row0, int stripe_h, void* rgb, void* plane0, void* plane1,
    void* plane2, void* cuda_stream) {
  const void* coeff[3] = {coeff0, coeff1, coeff2};
  const void* qt[3] = {qt0, qt1, qt2};
  void* plane[3] = {plane0, plane1, plane2};
  const int hsf[3] = {hsf0, hsf1, hsf2};
  const int vsf[3] = {vsf0, vsf1, vsf2};
  const float hr[3] = {hratio0, hratio1, hratio2};
  const float vr[3] = {vratio0, vratio1, vratio2};
  Params p = jdtc_strip::make_params(coeff, qt, plane, rgb, h, w, hsf, vsf, hr, vr, mcus_x,
                                     mcus_y, strip, bits12, correct, row0, stripe_h);
  // Shared memory: coefficients | tables | zigzag | the index tables | float
  // tile, later the staged RGB rows | the three uint8 tiles.
  p.sm_qt = p.blocks * kCoefStride * 2;
  p.sm_inv = p.sm_qt + 3 * 64 * 4;
  const int end = jdtc_strip::finish_layout(p, p.sm_inv + 64, p.blocks * kFloatStride * 4);
  const int threads =
      p.blocks * 8 > kMaxThreads ? kMaxThreads : ((p.blocks * 8 + 31) & ~31);
  cudaError_t e = cudaFuncSetAttribute(pixel_exact_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, end);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>((mcus_x + strip - 1) / strip),
                  static_cast<unsigned>(mcus_y), static_cast<unsigned>(n_images));
  pixel_exact_kernel<<<grid, threads, end, static_cast<cudaStream_t>(cuda_stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
