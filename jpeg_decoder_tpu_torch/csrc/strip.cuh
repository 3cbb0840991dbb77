// The MCU-strip skeleton shared by K03 (pixel_exact.cu, the EXACT pixel
// stage of a 3-component frame) and K13 (pixel_float.cu, the FLOAT32 one),
// so that the two lay a strip out and move it the same way. A block of
// threads (CTA) takes a strip of G consecutive MCUs of one MCU row of one
// image; the kernels differ only in the IDCT that turns the strip's
// coefficients in shared memory into its three uint8 tiles.
//
// A strip's steps, as the kernels call them:
//  1. load_coefficients: the strip's blocks of one component are vsf runs
//     of hsf * G contiguous blocks of the [by, bx, 64] plane; they go to
//     shared memory by cp.async, 16 bytes a thread, neighbouring threads on
//     neighbouring addresses (the copies skip the registers and every copy
//     of a thread is in flight at once, which hides the load latency without
//     unrolling). index_tables: the shared offset of each tile row and each
//     staged RGB row, and the colour stage's sources by K3's index rule on
//     the GLOBAL row and column (the float32 product depends on the absolute
//     index; in striped and streamed decode the padded frame's row, the
//     source made local to its stripe: colour::nn_row), computed once a row
//     and once a column of the strip rather than once a pixel (a float
//     multiply and two conversions a component, and conversions issue at a
//     quarter of the float32 rate).
//  2-3. the kernel's IDCT: coefficients -> the three uint8 tiles.
//  4. store_planes, when the caller asks for the planes: each tile row in
//     16-byte windows.
//  5. colour: every pixel of the strip inside the image, from the tiles, its
//     RGB bytes staged in shared memory.
//  6. store_rgb: each staged row in 16-byte windows.
// A staged row sits at its device row's address modulo 16 (`head`), so a
// whole window is one 16-byte store and only the row's two ragged ends go a
// byte at a time (a 1000-pixel row is 3000 bytes, not a multiple of 16). The
// last strip of an MCU row holds fewer MCUs and masks its own edge; rows and
// columns past the image are not stored.
//
// Locality: with nearest-neighbour upsampling every output pixel's chroma
// sample lies in its own MCU (the host checks this for the geometry,
// ops/pixel.tile_local, before it routes a frame to either kernel; for a
// stripe or a chunk, on the rows of the padded frame up to its end), so a
// strip's pixels depend on the strip's coefficient blocks alone and the
// pixel tiles never leave shared memory.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "color.cuh"

namespace jdtc_strip {

constexpr int kMaxThreads = 1024;
constexpr int kCoefStride = 72;  // int16 a block in shared memory: 128 bytes + 16 of skew

struct Params {
  const int16_t* coeff[3];  // int16 [n_images, by, bx, 64] zigzag
  const int32_t* qt[3];     // int32 [64] natural order
  const float* kmat;        // K13: float32 [64, 64] K (ops/idct.idct_matrix_zz); K03: null
  uint8_t* plane[3];        // uint8 [n_images, by*8, bx*8], or null: not stored
  uint8_t* rgb;             // uint8 [n_images, h, w, 3]
  int hsf[3], vsf[3], bx[3], by[3];
  float hratio[3], vratio[3];
  int h, w, mcus_x, mcus_y, hmax, vmax, strip;  // strip: G, MCUs a CTA
  int blocks;                                   // coefficient blocks of a full strip
  int bits12, correct;
  // striped and streamed decode (colour::nn_row): the padded frame's row of
  // the launch's row 0 and the output rows of a stripe (0: a whole frame),
  // and each component's plane rows a stripe
  int row0, stripe_h, local_rows[3];
  // dynamic shared memory layout, in bytes: the coefficients at 0, then the
  // kernel's own tables (sm_qt, sm_inv, sm_k), then what finish_layout sets
  int sm_qt, sm_inv, sm_k, sm_rows, sm_work, sm_tile[3], pitch[3], rgb_pitch;
};

// One strip: image, MCU row and first MCU column, its size in pixels, and
// where its blocks sit among the strip's blocks in shared memory (component
// c, block row v < vsf, column u < nb[c], at index first[c] + v * nb[c] + u).
struct Strip {
  int64_t img;
  int mr, m0, gm;  // MCU row, first MCU column, MCUs in this strip
  int R, CG, C;    // pixel rows, pixel columns of a full strip and of this one
  int i0, j0;      // the strip's first pixel row and column
  int nb[3], first[4];
};

static __device__ __forceinline__ Strip locate(const Params& p, int64_t img, int mr, int sx) {
  Strip s;
  s.img = img;
  s.mr = mr;
  s.m0 = sx * p.strip;
  s.gm = min(p.strip, p.mcus_x - s.m0);
  s.R = 8 * p.vmax;
  s.CG = 8 * p.hmax * p.strip;
  s.C = 8 * p.hmax * s.gm;
  s.i0 = mr * s.R;
  s.j0 = 8 * p.hmax * s.m0;
  s.first[0] = 0;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    s.nb[c] = s.gm * p.hsf[c];
    s.first[c + 1] = s.first[c] + p.vsf[c] * s.nb[c];
  }
  return s;
}

// The component of the strip's block b.
static __device__ __forceinline__ int component(const Strip& s, int b) {
  return b < s.first[1] ? 0 : (b < s.first[2] ? 1 : 2);
}

// Shared offset of byte 0 of row y of component c's tile: the row sits at
// its device row's address modulo 16 when the planes are stored (`head`).
static __device__ __forceinline__ int tile_row(const Params& p, const Strip& s, int c, int y) {
  int head = 0;
  if (p.plane[c] != nullptr) {
    const int64_t prow = (s.img * p.by[c] + static_cast<int64_t>(s.mr) * p.vsf[c]) * 8 + y;
    head = static_cast<int>(reinterpret_cast<uintptr_t>(
        p.plane[c] + prow * p.bx[c] * 8 + static_cast<int64_t>(s.m0) * p.hsf[c] * 8) & 15);
  }
  return p.sm_tile[c] + y * p.pitch[c] + head;
}

static __device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

static __device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Window q of a row of n bytes whose first byte lies at `head` = its device
// address modulo 16: the device bytes [16q, 16q + 16) counted from the
// aligned address at or below the row's start (`dst`), taken from the same
// offsets of the 16-byte aligned shared buffer `src` (which holds the row's
// byte k at src[head + k]). A full window is one 16-byte store.
static __device__ __forceinline__ void store_window(uint8_t* dst, const uint8_t* src, int head,
                                                    int n, int q) {
  const int lo = max(16 * q, head);
  const int hi = min(16 * q + 16, head + n);
  if (lo >= hi) return;
  if (hi - lo == 16) {
    *reinterpret_cast<uint4*>(dst + 16 * q) = *reinterpret_cast<const uint4*>(src + 16 * q);
    return;
  }
  for (int k = lo; k < hi; ++k) dst[k] = src[k];
}

// 1a. Issue the cp.async copies of the strip's coefficient runs into `coef`
// (kCoefStride int16 a block); the caller waits (cp_async_wait_all) and
// synchronises before reading them.
static __device__ __forceinline__ void load_coefficients(const Params& p, const Strip& s,
                                                         int16_t* coef, int tid, int nt) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int n16 = s.nb[c] * 8;  // 16-byte chunks of one run
    for (int v = 0; v < p.vsf[c]; ++v) {
      const int64_t row = s.img * p.by[c] + static_cast<int64_t>(s.mr) * p.vsf[c] + v;
      const int16_t* src =
          p.coeff[c] + (row * p.bx[c] + static_cast<int64_t>(s.m0) * p.hsf[c]) * 64;
      int16_t* dst = coef + (s.first[c] + v * s.nb[c]) * kCoefStride;
      for (int k = tid; k < n16; k += nt)
        cp_async16(dst + (k >> 3) * kCoefStride + (k & 7) * 8, src + k * 8);
    }
  }
}

// The index tables at p.sm_rows: [3][R] shared offsets of each tile row's
// byte 0, then [R] of each staged RGB row's byte 0 (each already shifted by
// its row's head); then the colour stage's sources, by K3's index rule on
// the global row and column: [3][R] the offset of the tile row that output
// row i0 + ti samples, [3][CG] the column that output column j0 + tj
// samples.
static __device__ __forceinline__ int* row_offsets(const Params& p, uint8_t* smem) {
  return reinterpret_cast<int*>(smem + p.sm_rows);
}

// 1b. Fill the index tables for strip s.
static __device__ __forceinline__ void index_tables(const Params& p, const Strip& s,
                                                    uint8_t* smem, int tid, int nt) {
  int* row_off = row_offsets(p, smem);
  int* src_row = row_off + 4 * s.R;
  int* src_col = src_row + 3 * s.R;
  for (int k = tid; k < 4 * s.R; k += nt) {
    const int c = k / s.R;
    const int y = k - c * s.R;
    if (c < 3) {
      row_off[k] = tile_row(p, s, c, y);
      const int sr =
          colour::nn_row(s.i0 + y, p.vratio[c], p.row0, p.stripe_h, p.local_rows[c]) -
          8 * p.vsf[c] * s.mr;
      src_row[k] = tile_row(p, s, c, sr);
    } else {
      const int64_t pix = (s.img * p.h + s.i0 + y) * p.w + s.j0;
      const int head = static_cast<int>(reinterpret_cast<uintptr_t>(p.rgb + pix * 3) & 15);
      row_off[k] = p.sm_work + y * p.rgb_pitch + head;
    }
  }
  for (int k = tid; k < 3 * s.CG; k += nt) {
    const int c = k / s.CG;
    const int x = k - c * s.CG;
    src_col[k] = static_cast<int>(colour::nn_index(s.j0 + x, p.hratio[c])) - 8 * p.hsf[c] * s.m0;
  }
}

// The shared address of pixel (row k, column col) of block b's 8x8 tile
// block, block b being the strip's block of component c at local index
// b - first[c].
static __device__ __forceinline__ uint8_t* tile_block_row(const Params& p, const Strip& s,
                                                          uint8_t* smem, int b, int c, int k) {
  const int local = b - s.first[c];
  const int v = local / s.nb[c];
  const int u = local - v * s.nb[c];
  return smem + row_offsets(p, smem)[c * s.R + v * 8 + k] + u * 8;
}

// 4. The pixel planes, when asked: each tile row in 16-byte windows.
static __device__ __forceinline__ void store_planes(const Params& p, const Strip& s,
                                                    uint8_t* smem, int tid, int nt) {
  if (p.plane[0] == nullptr) return;
  const int* row_off = row_offsets(p, smem);
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
    const int64_t prow = (s.img * p.by[c] + static_cast<int64_t>(s.mr) * p.vsf[c]) * 8 + y;
    uint8_t* dst = p.plane[c] + prow * p.bx[c] * 8 + static_cast<int64_t>(s.m0) * p.hsf[c] * 8;
    const int head = static_cast<int>(reinterpret_cast<uintptr_t>(dst) & 15);
    store_window(dst - head, smem + row_off[c * s.R + y] - head, head, s.nb[c] * 8, q);
  }
}

// 5. Colour: every pixel of the strip inside the image, from the tiles. A
// thread keeps one column tj of a full strip's width and walks the rows
// `per` apart.
static __device__ __forceinline__ void colour_tiles(const Params& p, const Strip& s,
                                                    uint8_t* smem, int tid, int nt) {
  const int* row_off = row_offsets(p, smem);
  const int* src_row = row_off + 4 * s.R;
  const int* src_col = src_row + 3 * s.R;
  const int rows = min(s.R, p.h - s.i0);
  const int cols = min(s.C, p.w - s.j0);
  const int per = max(1, nt / s.CG);
  if (tid >= per * s.CG) return;
  for (int ti = tid / s.CG; ti < rows; ti += per) {
    for (int tj = tid % s.CG; tj < cols; tj += nt) {
      uint8_t y[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) y[c] = smem[src_row[c * s.R + ti] + src_col[c * s.CG + tj]];
      colour::ycbcr_to_rgb(y[0], y[1], y[2], p.correct, smem + row_off[3 * s.R + ti] + 3 * tj);
    }
  }
}

// 6. RGB rows in 16-byte windows.
static __device__ __forceinline__ void store_rgb(const Params& p, const Strip& s, uint8_t* smem,
                                                 int tid, int nt) {
  const int* row_off = row_offsets(p, smem);
  const int rows = min(s.R, p.h - s.i0);
  const int cols = min(s.C, p.w - s.j0);
  const int wins = p.rgb_pitch / 16;
  for (int t = tid; t < rows * wins; t += nt) {
    const int y = t / wins;
    const int q = t - y * wins;
    uint8_t* dst = p.rgb + ((s.img * p.h + s.i0 + y) * p.w + s.j0) * 3;
    const int head = static_cast<int>(reinterpret_cast<uintptr_t>(dst) & 15);
    store_window(dst - head, smem + row_off[3 * s.R + y] - head, head, 3 * cols, q);
  }
}

static inline int round16(int n) { return (n + 15) & ~15; }

// The geometry of a frame from the entry points' common arguments.
static inline Params make_params(const void* const coeff[3], const void* const qt[3],
                                 void* const plane[3], void* rgb, int h, int w,
                                 const int hsf[3], const int vsf[3], const float hratio[3],
                                 const float vratio[3], int mcus_x, int mcus_y, int strip,
                                 int bits12, int correct, int row0, int stripe_h) {
  Params p{};
  int per_mcu = 0;
  for (int c = 0; c < 3; ++c) {
    p.coeff[c] = static_cast<const int16_t*>(coeff[c]);
    p.qt[c] = static_cast<const int32_t*>(qt[c]);
    p.plane[c] = static_cast<uint8_t*>(plane[c]);
    p.hsf[c] = hsf[c];
    p.vsf[c] = vsf[c];
    p.bx[c] = mcus_x * hsf[c];
    p.by[c] = mcus_y * vsf[c];
    p.hratio[c] = hratio[c];
    p.vratio[c] = vratio[c];
    p.hmax = hsf[c] > p.hmax ? hsf[c] : p.hmax;
    p.vmax = vsf[c] > p.vmax ? vsf[c] : p.vmax;
    per_mcu += hsf[c] * vsf[c];
  }
  p.rgb = static_cast<uint8_t*>(rgb);
  p.h = h;
  p.w = w;
  p.mcus_x = mcus_x;
  p.mcus_y = mcus_y;
  p.strip = strip;
  p.blocks = strip * per_mcu;
  p.bits12 = bits12;
  p.correct = correct;
  p.row0 = row0;
  p.stripe_h = stripe_h;
  for (int c = 0; c < 3; ++c) p.local_rows[c] = stripe_h / p.vmax * vsf[c];
  return p;
}

// The layout after the kernel's own part, which ends at `rows_at`: the
// index tables, the work area (the IDCT's float tile of `tile_bytes`, later
// the staged RGB rows), then the three uint8 tiles. Returns the dynamic
// shared memory's bytes.
static inline int finish_layout(Params& p, int rows_at, int tile_bytes) {
  const int R = 8 * p.vmax;
  p.rgb_pitch = round16(3 * 8 * p.hmax * p.strip) + 16;
  p.sm_rows = rows_at;
  p.sm_work = round16(p.sm_rows + (7 * R + 3 * 8 * p.hmax * p.strip) * 4);
  const int work = tile_bytes > R * p.rgb_pitch ? tile_bytes : R * p.rgb_pitch;
  int end = p.sm_work + round16(work);
  for (int c = 0; c < 3; ++c) {
    p.pitch[c] = round16(8 * p.hsf[c] * p.strip) + 16;
    p.sm_tile[c] = end;
    end += 8 * p.vsf[c] * p.pitch[c];
  }
  return end;
}

}  // namespace jdtc_strip
