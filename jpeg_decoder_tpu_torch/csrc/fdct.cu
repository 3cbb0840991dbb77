// K4: the encoder's device stage in one kernel -- colour conversion, edge
// pad, box subsample, level shift, forward DCT and quantization, every
// component of an image in one launch, int16 zigzag [by, bx, 64] out.
//
// Replaces the XLA program of jpeg_decoder_tpu/models/encoder.py
// (_build_device_stage: rgb_to_ycbcr, pad_edge, box_subsample,
// plane_to_blocks and fdct_quantize of jpeg_decoder_tpu/ops/fdct.py). It
// computes what that program computes on the CPU, bit for bit, not its
// schedule: the orders are pinned in ops/fdct.py's docstring, and every
// float operation here is an _rn intrinsic or an explicit fmaf, so nvcc
// contracts nothing the pinned order does not name.
//   colour  y = fma(KB, b, fma(KR, r, KG * g)); cb = fma(b - y, CB, 128);
//           cr = fma(r - y, CR, 128) (constants from the host, float32);
//   pad     source coordinates clamped to [0, h-1] x [0, w-1];
//   box     each box row summed left to right, the rows top to bottom
//           (by_rows), or the box in one raster chain, as the JAX stage
//           does for the plane's width (ops/fdct.box_by_rows); times
//           1 / (box_h * box_v), a power of two;
//   FDCT    per zigzag coefficient z: acc = fma(x_i, Kq[i][z], acc) for the
//           raster index i = 0..63 in order, x_i = sample - 128, then
//           sign(acc) * floor(|acc| + 0.5). A component of one block sums
//           as XLA's matrix-vector product does: eight chains over
//           i = r, r + 8, ... added in a tree.
// Tensor cores cannot give that chain (TF32 drops bits; a tiled product
// sums in another order), so the product runs on the CUDA cores.
//
// What bounds it on the H100: the chain is 4096 FMAs a block against 192
// bytes of RGB read (4:2:0) and 128 of int16 written; at 67 TFLOP/s float32
// and 3.35 TB/s the FMAs take about 1.6 times as long as the bytes. So the
// design keeps the FMA pipe fed and reads each byte of RGB once:
//  - One resident wave of blocks of threads walks runs of MCUs (an MCU row,
//    run_mcus MCUs of it at a time, kRunBlocks blocks at most; image
//    row-major), each block holding the Kq tables (16 KB each) in shared
//    memory from its start, not once a tile.
//  - A run's pixel rows (vmax * 8, clamped to the image) come into shared
//    memory by 16-byte cp.async from the 16-byte boundary at or below each
//    row's first byte (a chunk that would reach outside the image is copied
//    byte by byte); the next run's rows are issued once this run's samples
//    are formed, so they travel while its product runs.
//  - A thread takes a region of an MCU, hmax x vmax pixels (at most 4),
//    forms the colour step once a pixel in registers, and from them every
//    component's samples of the region, each box in its component's pinned
//    order, level-shifted, into a float tile (68 floats a block; the run's
//    blocks component after component, each component's padded to whole
//    groups of kBlocksPerThread). Each sampling the encoder takes is an instance of
//    the kernel (`factor`), so the region and the boxes are compile-time
//    constants and the samples come from registers by constant indices.
//  - The product from registers, K1's and K13's tile (idct_float.cuh
//    `product`): thread (c, g, q) forms zigzag coefficients 4q..4q+3 of
//    blocks g, g + G, g + 2G, g + 3G of component c (G = its blocks / 4),
//    Kq[i][4q..4q+3] one float4 and x[b][i..i+3] another: 8 shared loads of
//    16 bytes for 64 FMAs (a thread a coefficient would take 12 for 32). A
//    warp holds 8 groups x 4 q, so its 8 loads move 64 to 128 bytes of Kq
//    and 128 of x each. Each coefficient keeps the chain's order. A thread's 4
//    coefficients of a block go out as one 8-byte store.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "idct_float.cuh"

namespace {

using jdtc_common::cp_async16;
using jdtc_common::cp_async_wait_all;
using jdtc_common::wave;

constexpr int kMaxComps = 3;

// sign(a) * floor(|a| + 0.5) as int16
__device__ __forceinline__ int16_t quantize(float a) {
  const float m = floorf(__fadd_rn(fabsf(a), 0.5f));
  return static_cast<int16_t>(static_cast<int>(a < 0.0f ? -m : m));
}

// ---------------------------------------------------------------------------
// K4: runs of MCUs, the colour step once a pixel, the register tile
// ---------------------------------------------------------------------------

constexpr int kMaxThreads = 512;
constexpr int kMinBlocksPerSm = 2;  // blocks of threads an SM holds: caps the registers
constexpr int kXStride = 68;        // floats a block in the tile: 64 + 4 of skew
constexpr int kBlocksPerThread = 4;  // the register tile: kBlocksPerThread blocks x kCols
constexpr int kCols = 4;             // coefficients
constexpr int kQuads = 64 / kCols;   // items of a group
constexpr int kSamplings = 7;
constexpr int kRunBlocks = 96;      // blocks of a full run's tile (ops/fdct.RUN_BLOCKS)
static_assert(kCols == 4 || kCols == 8, "a thread stores 8 or 16 bytes of a block");

// The samplings K4 takes, each its own instance of the kernel, so that the
// region's pixels and every box are known to the compiler: the encoder's
// (ops/fdct.K4_SAMPLINGS, in this order) and one component (gray, or an
// RGB image's luma). The factor (fh: axis 0, fv: axis 1) of component c
// under sampling s, 0 where it has no component c; component 0 holds the
// largest factors (hmax, vmax).
__host__ __device__ constexpr int factor(int s, int c, int axis) {
  constexpr int f[kSamplings][kMaxComps][2] = {
      {{1, 1}, {1, 1}, {1, 1}},  // 4:4:4
      {{2, 1}, {1, 1}, {1, 1}},  // 4:2:2
      {{2, 2}, {1, 1}, {1, 1}},  // 4:2:0
      {{4, 1}, {1, 1}, {1, 1}},  // 4:1:1
      {{1, 2}, {1, 1}, {1, 1}},  // 4:4:0
      {{2, 2}, {2, 1}, {1, 2}},  // mixed
      {{1, 1}, {0, 0}, {0, 0}},  // one component
  };
  return f[s][c][axis];
}

__host__ __device__ constexpr int comps_of(int s) { return factor(s, 1, 0) ? 3 : 1; }

// MCUs of a run under sampling s (ops/fdct.run_mcus): as many as kRunBlocks
// holds, rounded down to a multiple of four, at least one.
constexpr int run_mcus(int s) {
  int per_mcu = 0;
  for (int c = 0; c < kMaxComps; ++c) per_mcu += factor(s, c, 0) * factor(s, c, 1);
  const int run = kRunBlocks / per_mcu > 1 ? kRunBlocks / per_mcu : 1;
  return run >= 4 ? run - run % 4 : run;
}

struct RunParams {
  const uint8_t* img;
  int64_t img_bytes;
  int h, w, channels;
  int16_t* out[kMaxComps];
  int blocks_x[kMaxComps];
  int by_rows[kMaxComps];
  int table[kMaxComps];
  int one_block[kMaxComps];  // the plane is one block: the matrix-vector order
  const float* kq;           // [n_tables][64 (raster i)][64 (zigzag z)]
  int n_tables;
  float kr, kg, kb, cb_scale, cr_scale;
  int mcus_x, run, runs_x;
  int64_t n_runs;
  int pitch;                 // bytes of a staged pixel row, a multiple of 16
  int sm_rgb, sm_tile;       // offsets of the staged rows and the tile in shared memory
};

// One run: MCU row my, MCUs mx0 .. mx0 + mcus - 1.
struct Run {
  int my, mx0, mcus;
};

__device__ __forceinline__ Run locate(const RunParams& p, int64_t i) {
  Run r;
  r.my = static_cast<int>(i / p.runs_x);  // once a run
  r.mx0 = static_cast<int>(i - static_cast<int64_t>(r.my) * p.runs_x) * p.run;
  r.mcus = min(p.run, p.mcus_x - r.mx0);
  return r;
}

// Component c's groups of kBlocksPerThread blocks in run r (its blocks
// padded to a multiple of kBlocksPerThread).
template <int S, int C>
__device__ __forceinline__ int run_groups(const Run& r) {
  return C < comps_of(S)
             ? (r.mcus * factor(S, C, 0) * factor(S, C, 1) + kBlocksPerThread - 1) /
                   kBlocksPerThread
             : 0;
}

// The address of run r's first source byte in its pixel row `row`.
template <int S>
__device__ __forceinline__ uintptr_t row_start(const RunParams& p, const Run& r, int row) {
  constexpr int kV = factor(S, 0, 1);
  constexpr int kH = factor(S, 0, 0);
  const int y = min(r.my * kV * 8 + row, p.h - 1);
  return reinterpret_cast<uintptr_t>(p.img) +
         static_cast<uintptr_t>((static_cast<int64_t>(y) * p.w + r.mx0 * kH * 8) * p.channels);
}

// The last source column of run r, counted from its first: r.mcus * hmax *
// 8 columns, fewer where the image's edge clamps them.
template <int S>
__device__ __forceinline__ int run_last(const RunParams& p, const Run& r) {
  constexpr int kH = factor(S, 0, 0);
  return min(r.mcus * kH * 8, p.w - r.mx0 * kH * 8) - 1;
}

// Run r's pixel rows into `rgb` (p.pitch bytes a row): each row's source
// bytes, from the 16-byte boundary at or below its first byte, by 16-byte
// cp.async; a chunk that would reach outside the image byte by byte.
template <int S>
__device__ __forceinline__ void stage_rows(const RunParams& p, const Run& r, uint8_t* rgb,
                                           int tid, int nt) {
  const int chunks = p.pitch >> 4;
  const uintptr_t lo = reinterpret_cast<uintptr_t>(p.img);
  const uintptr_t hi = lo + static_cast<uintptr_t>(p.img_bytes);
  const uintptr_t len = static_cast<uintptr_t>((run_last<S>(p, r) + 1) * p.channels);
  for (int t = tid; t < factor(S, 0, 1) * 8 * chunks; t += nt) {
    const int row = t / chunks;
    const int k = t - row * chunks;
    const uintptr_t first = row_start<S>(p, r, row);
    const uintptr_t a = (first & ~static_cast<uintptr_t>(15)) + 16 * static_cast<uintptr_t>(k);
    if (a >= first + len) continue;  // past the row's bytes
    uint8_t* dst = rgb + row * p.pitch + 16 * k;
    if (a >= lo && a + 16 <= hi) {
      cp_async16(dst, reinterpret_cast<const void*>(a));
    } else {
      for (int b = 0; b < 16; ++b)
        if (a + b >= lo && a + b < hi) dst[b] = *reinterpret_cast<const uint8_t*>(a + b);
    }
  }
}

// Component C's level-shifted samples of region (ry, gx) from the region's
// values vc (raster order, hmax a row), each box in the component's pinned
// order, into its part of the tile (from block `base`).
template <int S, int C, int NP>
__device__ __forceinline__ void put_samples(const RunParams& p, const Run& r,
                                            const float (&vc)[NP], float* tile, int ry, int gx,
                                            int base) {
  constexpr int kH = factor(S, 0, 0);
  constexpr int kV = factor(S, 0, 1);
  constexpr int kFh = factor(S, C, 0);
  constexpr int kFv = factor(S, C, 1);
  constexpr int kBh = kH / kFh;  // the box
  constexpr int kBv = kV / kFv;
  const int cols = r.mcus * kFh;
#pragma unroll
  for (int sy = 0; sy < kFv; ++sy) {
#pragma unroll
    for (int sx = 0; sx < kFh; ++sx) {
      float x;
      if (kBh * kBv == 1) {
        x = vc[sy * kH + sx];
      } else {
        const bool by_rows = p.by_rows[C];
        float total = 0.0f;
#pragma unroll
        for (int j = 0; j < kBv; ++j) {
          const int at = (sy * kBv + j) * kH + sx * kBh;
          float row = vc[at];
          if (j > 0 && !by_rows) row = __fadd_rn(total, row);
#pragma unroll
          for (int k = 1; k < kBh; ++k) row = __fadd_rn(row, vc[at + k]);
          total = (j == 0 || !by_rows) ? row : __fadd_rn(total, row);
        }
        x = __fmul_rn(total, 1.0f / static_cast<float>(kBh * kBv));
      }
      const int py = ry * kFv + sy;  // in the run's part of the component's plane
      const int px = gx * kFh + sx;
      tile[(base + (py >> 3) * cols + (px >> 3)) * kXStride + (py & 7) * 8 + (px & 7)] =
          __fsub_rn(x, 128.0f);
    }
  }
}

// Every component's level-shifted samples of run r into the tile: a thread
// a region of hmax x vmax pixels, the colour step once a pixel.
template <int S>
__device__ __forceinline__ void form_samples(const RunParams& p, const Run& r,
                                             const uint8_t* rgb, float* tile, int tid,
                                             int nt) {
  constexpr int kH = factor(S, 0, 0);
  constexpr int kV = factor(S, 0, 1);
  constexpr int kN = comps_of(S);
  const int per_row = r.mcus * 8;  // regions a region row of the run
  const int xlast = run_last<S>(p, r);
  // the chroma components' first blocks
  const int b1 = kBlocksPerThread * run_groups<S, 0>(r);
  const int b2 = b1 + kBlocksPerThread * run_groups<S, 1>(r);
  for (int t = tid; t < 8 * per_row; t += nt) {
    const int ry = t / per_row;
    const int gx = t - ry * per_row;
    float v[kMaxComps][kH * kV];
#pragma unroll
    for (int pj = 0; pj < kV; ++pj) {
      const int row = ry * kV + pj;
      const uint8_t* src = rgb + row * p.pitch + static_cast<int>(row_start<S>(p, r, row) & 15);
#pragma unroll
      for (int pk = 0; pk < kH; ++pk) {
        const int k = pj * kH + pk;
        const uint8_t* px = src + min(gx * kH + pk, xlast) * p.channels;
        if (p.channels == 1) {
          v[0][k] = static_cast<float>(px[0]);
        } else {
          const float cr = px[0];
          const float cg = px[1];
          const float cb = px[2];
          const float y = __fmaf_rn(p.kb, cb, __fmaf_rn(p.kr, cr, __fmul_rn(p.kg, cg)));
          v[0][k] = y;
          if constexpr (kN > 1) {
            v[1][k] = __fmaf_rn(__fsub_rn(cb, y), p.cb_scale, 128.0f);
            v[2][k] = __fmaf_rn(__fsub_rn(cr, y), p.cr_scale, 128.0f);
          }
        }
      }
    }
    put_samples<S, 0>(p, r, v[0], tile, ry, gx, 0);
    if constexpr (kN > 1) {
      put_samples<S, 1>(p, r, v[1], tile, ry, gx, b1);
      put_samples<S, 2>(p, r, v[2], tile, ry, gx, b2);
    }
  }
}

__device__ __forceinline__ uint32_t pack(int16_t a, int16_t b) {
  return static_cast<uint32_t>(static_cast<uint16_t>(a)) |
         (static_cast<uint32_t>(static_cast<uint16_t>(b)) << 16);
}

// One of three values by c, known only at run time, without a local copy.
template <typename T>
__device__ __forceinline__ T sel3(int c, T a, T b, T d) {
  return c == 0 ? a : (c == 1 ? b : d);
}

// A thread's kCols quantized coefficients of a block as one store.
__device__ __forceinline__ void store_coefficients(int16_t* dst, const int16_t (&z)[kCols]) {
  if constexpr (kCols == 4) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(pack(z[0], z[1]), pack(z[2], z[3]));
  } else {
    *reinterpret_cast<uint4*>(dst) =
        make_uint4(pack(z[0], z[1]), pack(z[2], z[3]), pack(z[4], z[5]), pack(z[6], z[7]));
  }
}

// The products of run r. Item (c, g, q) forms coefficients kCols q ..
// kCols q + kCols - 1 of component c's blocks g, g + G, g + 2G, ... of the
// run (G its groups, kBlocksPerThread blocks) and stores each block's as
// one word. A warp holds
// 8 groups (counted over the components together) x 4 q, so that its
// loads of Kq are at most 2 x 4 float4 and its loads of x 8 (on distinct
// banks).
template <int S>
__device__ __forceinline__ void products(const RunParams& p, const Run& r, const float* s_k,
                                         const float* tile, int tid, int nt) {
  const int g0 = run_groups<S, 0>(r);
  const int g1 = run_groups<S, 1>(r);
  const int groups_all = g0 + g1 + run_groups<S, 2>(r);
  const int items = 8 * kQuads * ((groups_all + 7) >> 3);
  for (int t = tid; t < items; t += nt) {
    const int k = t >> 5;  // a warp's 8 groups x 4 q
    const int lane = t & 31;
    const int q = 4 * (k % (kQuads / 4)) + (lane >> 3);
    int g = 8 * (k / (kQuads / 4)) + (lane & 7);  // counted from the tile's first group
    if (g >= groups_all) continue;
    const int c = g < g0 ? 0 : (g < g0 + g1 ? 1 : 2);
    const int first = c == 0 ? 0 : (c == 1 ? g0 : g0 + g1);  // c's first group
    g -= first;
    const int fh = sel3(c, factor(S, 0, 0), factor(S, 1, 0), factor(S, 2, 0));
    const int fv = sel3(c, factor(S, 0, 1), factor(S, 1, 1), factor(S, 2, 1));
    const int blocks_x = sel3(c, p.blocks_x[0], p.blocks_x[1], p.blocks_x[2]);
    const int cols = r.mcus * fh;
    const int n = cols * fv;
    const int groups = (n + kBlocksPerThread - 1) / kBlocksPerThread;
    // Where each of the thread's blocks goes, from the run's first block.
    int16_t* dst = sel3(c, p.out[0], p.out[1], p.out[2]) +
                   (static_cast<int64_t>(r.my) * fv * blocks_x +
                    static_cast<int64_t>(r.mx0) * fh) * 64 + kCols * q;
    int at[kBlocksPerThread];
#pragma unroll
    for (int j = 0; j < kBlocksPerThread; ++j) {
      const int blk = g + j * groups;
      const int bry = blk / cols;
      at[j] = blk < n ? (bry * blocks_x + blk - bry * cols) * 64 : -1;
    }
    const float* kq = s_k + sel3(c, p.table[0], p.table[1], p.table[2]) * 64 * 64 + kCols * q;
    const float* x = tile + (kBlocksPerThread * first + g) * kXStride;
    int16_t zq[kCols];
    if (sel3(c, p.one_block[0], p.one_block[1], p.one_block[2])) {
      // the matrix-vector order; g is 0
#pragma unroll
      for (int d = 0; d < kCols; ++d) {
        float ch[8];
#pragma unroll
        for (int row = 0; row < 8; ++row) {
          ch[row] = 0.0f;
          for (int i = row; i < 64; i += 8) ch[row] = __fmaf_rn(x[i], kq[i * 64 + d], ch[row]);
        }
        zq[d] = quantize(__fadd_rn(__fadd_rn(__fadd_rn(ch[0], ch[1]), __fadd_rn(ch[2], ch[3])),
                                   __fadd_rn(__fadd_rn(ch[4], ch[5]), __fadd_rn(ch[6], ch[7]))));
      }
      store_coefficients(dst, zq);
      continue;
    }
    float acc[kBlocksPerThread][kCols];
    jdtc_float::product<kBlocksPerThread, kCols>(kq, x, groups * kXStride, acc);
#pragma unroll
    for (int j = 0; j < kBlocksPerThread; ++j) {
      if (at[j] < 0) continue;
#pragma unroll
      for (int d = 0; d < kCols; ++d) zq[d] = quantize(acc[j][d]);
      store_coefficients(dst + at[j], zq);
    }
  }
}

template <int S>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocksPerSm) fdct_kernel(const RunParams p) {
  extern __shared__ __align__(16) uint8_t smem[];
  float* s_k = reinterpret_cast<float*>(smem);  // the tables
  uint8_t* rgb = smem + p.sm_rgb;               // the run's pixel rows
  float* tile = reinterpret_cast<float*>(smem + p.sm_tile);
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  if ((reinterpret_cast<uintptr_t>(p.kq) & 15) == 0) {
    for (int k = tid; k < p.n_tables * 64 * 16; k += nt) cp_async16(s_k + 4 * k, p.kq + 4 * k);
  } else {
    for (int k = tid; k < p.n_tables * 64 * 64; k += nt) s_k[k] = p.kq[k];
  }
  int64_t i = blockIdx.x;
  if (i < p.n_runs) stage_rows<S>(p, locate(p, i), rgb, tid, nt);
  for (; i < p.n_runs; i += gridDim.x) {
    const Run r = locate(p, i);
    cp_async_wait_all();
    __syncthreads();  // the rows have landed; the last run's products are done
    form_samples<S>(p, r, rgb, tile, tid, nt);
    __syncthreads();
    // The next run's rows travel while this run's products run.
    if (i + gridDim.x < p.n_runs) stage_rows<S>(p, locate(p, i + gridDim.x), rgb, tid, nt);
    products<S>(p, r, s_k, tile, tid, nt);
  }
}

// The kernel of each sampling, by its index.
template <int S>
struct Kernels {
  static void at(int s, void (**k)(RunParams)) {
    if (s == S) *k = fdct_kernel<S>;
    Kernels<S + 1>::at(s, k);
  }
};

template <>
struct Kernels<kSamplings> {
  static void at(int, void (**)(RunParams)) {}
};

}  // namespace

// img: uint8 [h, w, channels]; comps: host int64 [3][9] (output address,
// blocks_y, blocks_x, box_h, box_v, by_rows, table, fh, fv) for n_comps
// components; kq: float32 [n_tables, 64, 64] on the card; consts: host
// float32 [5] (KR, KG, KB, CB, CR).
// The factors must be one of the samplings K4 takes (`factor`), the
// outputs 8-byte aligned; anything else is refused.
extern "C" int jdtc_fdct(const void* img, int h, int w, int channels, int n_comps,
                         const void* comps, const void* kq, const void* consts,
                         void* cuda_stream) {
  if (n_comps < 1 || n_comps > kMaxComps || (channels != 1 && channels != 3) || h < 1 ||
      w < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t* c = static_cast<const int64_t*>(comps);
  int s = 0;  // the sampling
  for (; s < kSamplings; ++s) {
    bool same = comps_of(s) == n_comps;
    for (int i = 0; i < n_comps; ++i)
      same = same && c[i * 9 + 7] == factor(s, i, 0) && c[i * 9 + 8] == factor(s, i, 1);
    if (same) break;
  }
  if (s == kSamplings) return static_cast<int>(cudaErrorInvalidValue);
  const int hmax = factor(s, 0, 0);
  const int vmax = factor(s, 0, 1);
  const int run = run_mcus(s);
  const float* k = static_cast<const float*>(consts);
  RunParams p{};
  p.img = static_cast<const uint8_t*>(img);
  p.img_bytes = static_cast<int64_t>(h) * w * channels;
  p.h = h;
  p.w = w;
  p.channels = channels;
  p.kq = static_cast<const float*>(kq);
  p.kr = k[0];
  p.kg = k[1];
  p.kb = k[2];
  p.cb_scale = k[3];
  p.cr_scale = k[4];
  p.mcus_x = static_cast<int>(c[2] / c[7]);
  const int64_t mcus_y = c[1] / c[8];
  int groups = 0;  // of a full run
  for (int i = 0; i < n_comps; ++i) {
    const int64_t* r = c + i * 9;
    p.out[i] = reinterpret_cast<int16_t*>(r[0]);
    p.blocks_x[i] = static_cast<int>(r[2]);
    p.by_rows[i] = static_cast<int>(r[5]);
    p.table[i] = static_cast<int>(r[6]);
    p.one_block[i] = r[1] * r[2] == 1;
    if (r[3] * r[7] != hmax || r[4] * r[8] != vmax || r[1] != mcus_y * r[8] ||
        r[2] != p.mcus_x * r[7] || (reinterpret_cast<uintptr_t>(p.out[i]) & 7) != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    p.n_tables = p.table[i] + 1 > p.n_tables ? p.table[i] + 1 : p.n_tables;
    groups += static_cast<int>((run * r[7] * r[8] + kBlocksPerThread - 1) /
                               kBlocksPerThread);
  }
  p.run = run;
  p.runs_x = (p.mcus_x + run - 1) / run;
  p.n_runs = static_cast<int64_t>(p.runs_x) * mcus_y;
  if (p.n_runs == 0) return 0;
  // Shared memory: the tables | the run's pixel rows | the tile.
  p.pitch = (15 + run * hmax * 8 * channels + 15) / 16 * 16;
  p.sm_rgb = p.n_tables * 64 * 64 * 4;
  p.sm_tile = p.sm_rgb + vmax * 8 * p.pitch;
  const int bytes = p.sm_tile + kBlocksPerThread * groups * kXStride * 4;
  const int items = 8 * kQuads * ((groups + 7) / 8);
  const int threads = items > kMaxThreads ? kMaxThreads : items;

  void (*kernel)(RunParams) = nullptr;
  Kernels<0>::at(s, &kernel);
  unsigned grid = 0;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) e = wave(kernel, threads, p.n_runs, bytes, &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, threads, bytes, static_cast<cudaStream_t>(cuda_stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
