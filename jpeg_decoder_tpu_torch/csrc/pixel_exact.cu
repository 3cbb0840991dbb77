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
// at a time. Here:
//  - Locality. With nearest-neighbour upsampling every output pixel's
//    chroma sample lies in its own MCU (the host checks this for the
//    geometry, ops/pixel.tile_local, before it routes a frame here), so a
//    strip's pixels depend on the strip's coefficient blocks alone and the
//    pixel tile never leaves shared memory.
//  - Loads. A strip's blocks of one component are vsf runs of hsf * G
//    contiguous blocks of the [by, bx, 64] plane (1 KB for luma at 4:2:0,
//    where G = 4: ops/pixel.default_strip). They go to shared memory by cp.async, 16 bytes a thread,
//    neighbouring threads on neighbouring addresses: the copies skip the
//    registers and every copy of a thread is in flight at once, which hides
//    the load latency without unrolling (TMA would need a tensor map per
//    plane and a barrier for runs of 1-2 KB). The quantisation tables come
//    along once a CTA.
//  - IDCT with 8 threads a block: thread r dequantises and de-zigzags row r
//    and runs the row pass into a padded [8][9] float tile (no bank
//    conflicts across a warp's four blocks); after a barrier thread c runs
//    the column pass of column c and stores into the component's uint8
//    tile.
//  - Colour from the tiles, by K3's index rule on the GLOBAL row and column
//    (the float32 product depends on the absolute index), offset into the
//    tile. The rule is computed once a row and once a column of the strip
//    (its float multiply and two conversions a component would otherwise
//    cost every pixel, and conversions issue at a quarter of the float32
//    rate); the RGB bytes are staged in shared memory.
//  - Stores. Each row of RGB (3 * 16 * G bytes at 4:2:0) and, when asked,
//    of each plane tile leaves in 16-byte windows aligned in device memory:
//    the staged row sits at the same address modulo 16 in shared memory, so
//    a whole window is one 16-byte store and only the two ragged ends go a
//    byte at a time (a 1000-pixel row is 3000 bytes, not a multiple of 16).
// The last strip of an MCU row holds fewer MCUs and masks its own edge;
// rows and columns past the image are not stored.

#include <cuda_runtime.h>
#include <stdint.h>

#include "color.cuh"
#include "idct_exact.cuh"

namespace {

using jdtc_exact::idct8;
using jdtc_exact::kInvZigzag;
using jdtc_exact::kIsqrt2;
using jdtc_exact::mul;
using jdtc_exact::st;

constexpr int kMaxThreads = 1024;
constexpr int kCoefStride = 72;  // int16 a block in shared memory: 128 bytes + 16 of skew
constexpr int kFloatStride = 72; // floats a block in the [8][9] tile

struct Params {
  const int16_t* coeff[3];  // int16 [n_images, by, bx, 64] zigzag
  const int32_t* qt[3];     // int32 [64] natural order
  uint8_t* plane[3];        // uint8 [n_images, by*8, bx*8], or null: not stored
  uint8_t* rgb;             // uint8 [n_images, h, w, 3]
  int hsf[3], vsf[3], bx[3], by[3];
  float hratio[3], vratio[3];
  int h, w, mcus_x, hmax, vmax, strip;  // strip: G, MCUs a CTA
  int bits12, correct;
  // dynamic shared memory layout, in bytes
  int sm_qt, sm_inv, sm_rows, sm_work, sm_tile[3], pitch[3], rgb_pitch;
};

// Shared offset of byte 0 of row y of component c's tile: the row sits at
// its device row's address modulo 16 when the planes are stored (`head`).
__device__ __forceinline__ int tile_row(const Params& p, int c, int y, int64_t img, int mr,
                                        int m0) {
  int head = 0;
  if (p.plane[c] != nullptr) {
    const int64_t prow = (img * p.by[c] + static_cast<int64_t>(mr) * p.vsf[c]) * 8 + y;
    head = static_cast<int>(reinterpret_cast<uintptr_t>(
        p.plane[c] + prow * p.bx[c] * 8 + static_cast<int64_t>(m0) * p.hsf[c] * 8) & 15);
  }
  return p.sm_tile[c] + y * p.pitch[c] + head;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Window q of a row of n bytes whose first byte lies at `head` = its device
// address modulo 16: the device bytes [16q, 16q + 16) counted from the
// aligned address at or below the row's start (`dst`), taken from the same
// offsets of the 16-byte aligned shared buffer `src` (which holds the row's
// byte k at src[head + k]). A full window is one 16-byte store.
__device__ __forceinline__ void store_window(uint8_t* dst, const uint8_t* src,
                                             int head, int n, int q) {
  const int lo = max(16 * q, head);
  const int hi = min(16 * q + 16, head + n);
  if (lo >= hi) return;
  if (hi - lo == 16) {
    *reinterpret_cast<uint4*>(dst + 16 * q) = *reinterpret_cast<const uint4*>(src + 16 * q);
    return;
  }
  for (int k = lo; k < hi; ++k) dst[k] = src[k];
}

__global__ void __launch_bounds__(kMaxThreads)
pixel_exact_kernel(const Params p) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int mr = blockIdx.y;                      // MCU row
  const int64_t img = blockIdx.z;
  const int m0 = blockIdx.x * p.strip;            // first MCU column
  const int gm = min(p.strip, p.mcus_x - m0);     // MCUs in this strip
  const int R = 8 * p.vmax;                       // pixel rows of the strip
  const int CG = 8 * p.hmax * p.strip;            // pixel columns of a full strip
  const int C = 8 * p.hmax * gm;                  // pixel columns of this strip
  const int i0 = mr * R;
  const int j0 = 8 * p.hmax * m0;

  int16_t* coef = reinterpret_cast<int16_t*>(smem);
  int32_t* qt = reinterpret_cast<int32_t*>(smem + p.sm_qt);
  uint8_t* inv = smem + p.sm_inv;
  // [3][R] shared offsets of each tile row's byte 0, then [R] of each
  // staged RGB row's byte 0 (each already shifted by its row's head);
  // then the colour stage's sources, by K3's index rule on the global row
  // and column, computed once a row and once a column rather than once a
  // pixel: [3][R] the offset of the tile row that output row i0 + ti
  // samples, [3][CG] the column that output column j0 + tj samples.
  int* row_off = reinterpret_cast<int*>(smem + p.sm_rows);
  int* src_row = row_off + 4 * R;
  int* src_col = src_row + 3 * R;
  float* ftile = reinterpret_cast<float*>(smem + p.sm_work);

  // The strip's blocks: component c, block row v < vsf, column u < nb[c],
  // at index first[c] + v * nb[c] + u.
  int nb[3], first[4];
  first[0] = 0;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    nb[c] = gm * p.hsf[c];
    first[c + 1] = first[c] + p.vsf[c] * nb[c];
  }
  const int n_blocks = first[3];

  // 1. Coefficients and tables into shared memory.
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int n16 = nb[c] * 8;  // 16-byte chunks of one run
    for (int v = 0; v < p.vsf[c]; ++v) {
      const int64_t row = img * p.by[c] + static_cast<int64_t>(mr) * p.vsf[c] + v;
      const int16_t* src = p.coeff[c] + (row * p.bx[c] + static_cast<int64_t>(m0) * p.hsf[c]) * 64;
      int16_t* dst = coef + (first[c] + v * nb[c]) * kCoefStride;
      for (int k = tid; k < n16; k += nt)
        cp_async16(dst + (k >> 3) * kCoefStride + (k & 7) * 8, src + k * 8);
    }
  }
  for (int k = tid; k < 48; k += nt) cp_async16(qt + 4 * k, p.qt[k >> 4] + 4 * (k & 15));
  for (int k = tid; k < 64; k += nt) inv[k] = static_cast<uint8_t>(kInvZigzag[k]);
  for (int k = tid; k < 4 * R; k += nt) {
    const int c = k / R;
    const int y = k - c * R;
    if (c < 3) {
      row_off[k] = tile_row(p, c, y, img, mr, m0);
      const int sr = static_cast<int>(colour::nn_index(i0 + y, p.vratio[c])) - 8 * p.vsf[c] * mr;
      src_row[k] = tile_row(p, c, sr, img, mr, m0);
    } else {
      const int64_t pix = (img * p.h + i0 + y) * p.w + j0;
      const int head = static_cast<int>(reinterpret_cast<uintptr_t>(p.rgb + pix * 3) & 15);
      row_off[k] = p.sm_work + y * p.rgb_pitch + head;
    }
  }
  for (int k = tid; k < 3 * CG; k += nt) {
    const int c = k / CG;
    const int x = k - c * CG;
    src_col[k] = static_cast<int>(colour::nn_index(j0 + x, p.hratio[c])) - 8 * p.hsf[c] * m0;
  }
  cp_async_wait_all();
  __syncthreads();

  // 2. Row pass: thread (b, r) dequantises and de-zigzags row r of block b.
  for (int t = tid; t < n_blocks * 8; t += nt) {
    const int b = t >> 3;
    const int r = t & 7;
    const int c = b < first[1] ? 0 : (b < first[2] ? 1 : 2);
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
    const int c = b < first[1] ? 0 : (b < first[2] ? 1 : 2);
    const int local = b - first[c];
    const int v = local / nb[c];
    const int u = local - v * nb[c];
    const float* in = ftile + b * kFloatStride + col;
    float x[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) x[k] = in[k * 9];
    idct8<1>(x);
#pragma unroll
    for (int k = 0; k < 8; ++k)
      smem[row_off[c * R + v * 8 + k] + u * 8 + col] = jdtc_exact::store(x[k], p.bits12);
  }
  __syncthreads();

  // 4. The pixel planes, when asked: each tile row in 16-byte windows.
  if (p.plane[0] != nullptr) {
    int items[3], wins[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      wins[c] = p.pitch[c] / 16;
      items[c] = 8 * p.vsf[c] * wins[c];
    }
    for (int t = tid; t < items[0] + items[1] + items[2]; t += nt) {
      int c = 0;
      int k = t;
      while (k >= items[c]) k -= items[c++];
      const int y = k / wins[c];
      const int q = k - y * wins[c];
      const int64_t prow = (img * p.by[c] + static_cast<int64_t>(mr) * p.vsf[c]) * 8 + y;
      uint8_t* dst = p.plane[c] + prow * p.bx[c] * 8 + static_cast<int64_t>(m0) * p.hsf[c] * 8;
      const int head = static_cast<int>(reinterpret_cast<uintptr_t>(dst) & 15);
      store_window(dst - head, smem + row_off[c * R + y] - head, head, nb[c] * 8, q);
    }
  }

  // 5. Colour: every pixel of the strip inside the image, from the tiles.
  // A thread keeps one column tj of a full strip's width and walks the
  // rows `per` apart.
  const int rows = min(R, p.h - i0);
  const int cols = min(C, p.w - j0);
  const int per = max(1, nt / CG);
  if (tid < per * CG) {
    for (int ti = tid / CG; ti < rows; ti += per) {
      for (int tj = tid % CG; tj < cols; tj += nt) {
        uint8_t s[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) s[c] = smem[src_row[c * R + ti] + src_col[c * CG + tj]];
        colour::ycbcr_to_rgb(s[0], s[1], s[2], p.correct, smem + row_off[3 * R + ti] + 3 * tj);
      }
    }
  }
  __syncthreads();

  // 6. RGB rows in 16-byte windows.
  const int wins = p.rgb_pitch / 16;
  for (int t = tid; t < rows * wins; t += nt) {
    const int y = t / wins;
    const int q = t - y * wins;
    uint8_t* dst = p.rgb + ((img * p.h + i0 + y) * p.w + j0) * 3;
    const int head = static_cast<int>(reinterpret_cast<uintptr_t>(dst) & 15);
    store_window(dst - head, smem + row_off[3 * R + y] - head, head, 3 * cols, q);
  }
}

int round16(int n) { return (n + 15) & ~15; }

}  // namespace

extern "C" int jdtc_pixel_exact(
    const void* coeff0, const void* coeff1, const void* coeff2, const void* qt0,
    const void* qt1, const void* qt2, int n_images, int h, int w, int hsf0, int hsf1,
    int hsf2, int vsf0, int vsf1, int vsf2, float hratio0, float hratio1, float hratio2,
    float vratio0, float vratio1, float vratio2, int mcus_x, int mcus_y, int strip,
    int bits12, int correct, void* rgb, void* plane0, void* plane1, void* plane2,
    void* cuda_stream) {
  Params p{};
  const void* coeff[3] = {coeff0, coeff1, coeff2};
  const void* qt[3] = {qt0, qt1, qt2};
  void* plane[3] = {plane0, plane1, plane2};
  const int hsf[3] = {hsf0, hsf1, hsf2};
  const int vsf[3] = {vsf0, vsf1, vsf2};
  const float hr[3] = {hratio0, hratio1, hratio2};
  const float vr[3] = {vratio0, vratio1, vratio2};
  int per_mcu = 0;
  for (int c = 0; c < 3; ++c) {
    p.coeff[c] = static_cast<const int16_t*>(coeff[c]);
    p.qt[c] = static_cast<const int32_t*>(qt[c]);
    p.plane[c] = static_cast<uint8_t*>(plane[c]);
    p.hsf[c] = hsf[c];
    p.vsf[c] = vsf[c];
    p.bx[c] = mcus_x * hsf[c];
    p.by[c] = mcus_y * vsf[c];
    p.hratio[c] = hr[c];
    p.vratio[c] = vr[c];
    p.hmax = hsf[c] > p.hmax ? hsf[c] : p.hmax;
    p.vmax = vsf[c] > p.vmax ? vsf[c] : p.vmax;
    per_mcu += hsf[c] * vsf[c];
  }
  p.rgb = static_cast<uint8_t*>(rgb);
  p.h = h;
  p.w = w;
  p.mcus_x = mcus_x;
  p.strip = strip;
  p.bits12 = bits12;
  p.correct = correct;
  // Shared memory: coefficients | tables | zigzag | row offsets and the
  // colour stage's sources | float tile, later the staged RGB rows | the
  // three uint8 tiles.
  const int blocks = strip * per_mcu;
  const int R = 8 * p.vmax;
  p.rgb_pitch = round16(3 * 8 * p.hmax * strip) + 16;
  p.sm_qt = blocks * kCoefStride * 2;
  p.sm_inv = p.sm_qt + 3 * 64 * 4;
  p.sm_rows = p.sm_inv + 64;
  p.sm_work = round16(p.sm_rows + (7 * R + 3 * 8 * p.hmax * strip) * 4);
  const int work = blocks * kFloatStride * 4 > R * p.rgb_pitch ? blocks * kFloatStride * 4
                                                                : R * p.rgb_pitch;
  int end = p.sm_work + round16(work);
  for (int c = 0; c < 3; ++c) {
    p.pitch[c] = round16(8 * hsf[c] * strip) + 16;
    p.sm_tile[c] = end;
    end += 8 * vsf[c] * p.pitch[c];
  }
  const int threads = blocks * 8 > kMaxThreads ? kMaxThreads : ((blocks * 8 + 31) & ~31);
  cudaError_t e = cudaFuncSetAttribute(pixel_exact_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, end);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>((mcus_x + strip - 1) / strip),
                  static_cast<unsigned>(mcus_y), static_cast<unsigned>(n_images));
  pixel_exact_kernel<<<grid, threads, end, static_cast<cudaStream_t>(cuda_stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
