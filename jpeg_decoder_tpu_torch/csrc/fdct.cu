// K4: the encoder's device stage in one kernel -- colour conversion, edge
// pad, box subsample, level shift, forward DCT and quantization, every
// component of an image in one launch, int16 zigzag [by, bx, 64] out.
//
// Replaces the XLA program of jpeg_decoder_tpu/models/encoder.py
// (_build_device_stage: rgb_to_ycbcr, pad_edge, box_subsample,
// plane_to_blocks and fdct_quantize of jpeg_decoder_tpu/ops/fdct.py). It
// computes what that program computes on the CPU, bit for bit, not its
// schedule: the orders are pinned in ops/fdct.py's docstring, and every
// float operation here is an _rn intrinsic, so nvcc contracts nothing the
// pinned order does not name.
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
// Design: a block of 256 threads takes tiles of 32 consecutive coefficient
// blocks (raster order) of one component and holds that component's Kq
// (16 KB) in shared memory for the tiles it takes. Per tile it forms the 32
// blocks' level-shifted samples in shared memory -- thread t takes pixel
// column t of the tile's 256 columns in each of the 8 rows, so a warp reads
// 32 neighbouring pixels -- then each thread owns coefficient z of 8 of the
// tile's blocks and runs their 64-step chains, a float4 of samples a load.
// A block's coefficients do not depend on the tile it lies in.
//
// What bounds it on the H100: the chain is 4096 FMAs a block against 192
// bytes of RGB read (4:2:0) and 128 of int16 written; at 67 TFLOP/s float32
// and 3.35 TB/s the FMAs take about 1.6 times as long as the bytes, and the
// shared-memory loads that feed them are the next limit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;                   // coefficient blocks per tile
constexpr int kTilesPerCta = 2;             // tiles per block of threads
constexpr int kGroups = kThreads / 64;      // thread groups, one block each
constexpr int kPer = kTile / kGroups;       // blocks per thread
constexpr int kStride = 72;                 // floats per block in s_x: spreads banks
constexpr int kMaxComps = 3;

struct Comp {
  int16_t* out;
  int64_t n_blocks;
  int blocks_x;
  int box_h, box_v;
  int by_rows;
  int table;
  int64_t cta0;  // the component's first block of threads
};

struct Params {
  const uint8_t* img;
  int h, w, channels, n_comps;
  Comp comp[kMaxComps];
  const float* kq;  // [n_tables][64 (raster i)][64 (zigzag z)]
  float kr, kg, kb, cb_scale, cr_scale;
};

// One full-resolution sample of component `comp` at (y, x), clamped to the
// image (the edge pad). A 1-channel image is its gray value.
__device__ __forceinline__ float sample(const Params& p, int comp, int y, int x) {
  y = min(max(y, 0), p.h - 1);
  x = min(max(x, 0), p.w - 1);
  const int64_t i = static_cast<int64_t>(y) * p.w + x;
  if (p.channels == 1) return static_cast<float>(p.img[i]);
  const uint8_t* px = p.img + i * 3;
  const float r = px[0];
  const float g = px[1];
  const float b = px[2];
  const float yv = __fmaf_rn(p.kb, b, __fmaf_rn(p.kr, r, __fmul_rn(p.kg, g)));
  if (comp == 0) return yv;
  if (comp == 1) return __fmaf_rn(__fsub_rn(b, yv), p.cb_scale, 128.0f);
  return __fmaf_rn(__fsub_rn(r, yv), p.cr_scale, 128.0f);
}

// sign(a) * floor(|a| + 0.5) as int16
__device__ __forceinline__ int16_t quantize(float a) {
  const float m = floorf(__fadd_rn(fabsf(a), 0.5f));
  return static_cast<int16_t>(static_cast<int>(a < 0.0f ? -m : m));
}

__global__ void __launch_bounds__(kThreads) fdct_kernel(const Params p) {
  __shared__ float s_k[64 * 64];
  __shared__ __align__(16) float s_x[kTile * kStride];

  // this block's component (an absent one starts at INT64_MAX)
  const int64_t cta = blockIdx.x;
  const int ci = cta >= p.comp[2].cta0 ? 2 : cta >= p.comp[1].cta0 ? 1 : 0;
  Comp cp = p.comp[0];
  if (ci == 1) cp = p.comp[1];
  if (ci == 2) cp = p.comp[2];

  const float* kq = p.kq + static_cast<int64_t>(cp.table) * 64 * 64;
  for (int i = threadIdx.x; i < 64 * 64; i += kThreads) s_k[i] = kq[i];

  const int z = threadIdx.x & 63;   // this thread's coefficient, zigzag order
  const int g = threadIdx.x >> 6;   // its blocks: g, g + 4, ...
  const int box = cp.box_h * cp.box_v;
  const float scale = 1.0f / static_cast<float>(box);
  const int64_t first = (static_cast<int64_t>(blockIdx.x) - cp.cta0) * kTilesPerCta;
  for (int t = 0; t < kTilesPerCta; ++t) {
    const int64_t b0 = (first + t) * kTile;
    if (b0 >= cp.n_blocks) break;
    __syncthreads();  // s_k written; the last tile's s_x read
    // samples: row r of the tile's 8, column col of its 256
    for (int r = 0; r < 8; ++r) {
      const int col = threadIdx.x;
      const int blk = col >> 3;
      const int64_t b = b0 + blk;
      float v = 0.0f;
      if (b < cp.n_blocks) {
        const int64_t by = b / cp.blocks_x;
        const int64_t bx = b % cp.blocks_x;
        const int oy = static_cast<int>(by * 8 + r);
        const int ox = static_cast<int>(bx * 8 + (col & 7));
        if (box == 1) {
          v = sample(p, ci, oy, ox);
        } else {
          float total = 0.0f;
          for (int j = 0; j < cp.box_v; ++j) {
            const int y = oy * cp.box_v + j;
            float row = sample(p, ci, y, ox * cp.box_h);
            if (j > 0 && !cp.by_rows) row = __fadd_rn(total, row);
            for (int k = 1; k < cp.box_h; ++k)
              row = __fadd_rn(row, sample(p, ci, y, ox * cp.box_h + k));
            total = (j == 0 || !cp.by_rows) ? row : __fadd_rn(total, row);
          }
          v = __fmul_rn(total, scale);
        }
        v = __fsub_rn(v, 128.0f);
      }
      s_x[blk * kStride + r * 8 + (col & 7)] = v;
    }
    __syncthreads();

    if (cp.n_blocks == 1) {  // the matrix-vector order
      if (threadIdx.x < 64) {
        float c[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          c[r] = 0.0f;
          for (int i = r; i < 64; i += 8) c[r] = __fmaf_rn(s_x[i], s_k[i * 64 + z], c[r]);
        }
        const float a = __fadd_rn(__fadd_rn(__fadd_rn(c[0], c[1]), __fadd_rn(c[2], c[3])),
                                  __fadd_rn(__fadd_rn(c[4], c[5]), __fadd_rn(c[6], c[7])));
        cp.out[z] = quantize(a);
      }
      break;
    }

    float acc[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) acc[j] = 0.0f;
#pragma unroll 2
    for (int i = 0; i < 64; i += 4) {
      const float k0 = s_k[(i + 0) * 64 + z];
      const float k1 = s_k[(i + 1) * 64 + z];
      const float k2 = s_k[(i + 2) * 64 + z];
      const float k3 = s_k[(i + 3) * 64 + z];
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const float4 x =
            *reinterpret_cast<const float4*>(&s_x[(g + j * kGroups) * kStride + i]);
        float a = acc[j];
        a = __fmaf_rn(x.x, k0, a);
        a = __fmaf_rn(x.y, k1, a);
        a = __fmaf_rn(x.z, k2, a);
        a = __fmaf_rn(x.w, k3, a);
        acc[j] = a;
      }
    }

#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int64_t b = b0 + g + j * kGroups;
      if (b < cp.n_blocks) cp.out[b * 64 + z] = quantize(acc[j]);
    }
  }
}

}  // namespace

// img: uint8 [h, w, channels]; comps: host int64 [3][7] (output address,
// blocks_y, blocks_x, box_h, box_v, by_rows, table) for n_comps components; kq:
// float32 [n_tables, 64, 64] on the card; consts: host float32 [5] (KR, KG,
// KB, CB, CR).
extern "C" int jdtc_fdct(const void* img, int h, int w, int channels, int n_comps,
                         const void* comps, const void* kq, const void* consts,
                         void* cuda_stream) {
  if (n_comps < 1 || n_comps > kMaxComps || (channels != 1 && channels != 3))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t* c = static_cast<const int64_t*>(comps);
  const float* k = static_cast<const float*>(consts);
  Params p{};
  p.img = static_cast<const uint8_t*>(img);
  p.h = h;
  p.w = w;
  p.channels = channels;
  p.n_comps = n_comps;
  p.kq = static_cast<const float*>(kq);
  p.kr = k[0];
  p.kg = k[1];
  p.kb = k[2];
  p.cb_scale = k[3];
  p.cr_scale = k[4];
  int64_t ctas = 0;
  for (int i = 0; i < n_comps; ++i) {
    const int64_t* r = c + i * 7;
    Comp& cp = p.comp[i];
    cp.out = reinterpret_cast<int16_t*>(r[0]);
    cp.n_blocks = r[1] * r[2];
    cp.blocks_x = static_cast<int>(r[2]);
    cp.box_h = static_cast<int>(r[3]);
    cp.box_v = static_cast<int>(r[4]);
    cp.by_rows = static_cast<int>(r[5]);
    cp.table = static_cast<int>(r[6]);
    cp.cta0 = ctas;
    const int64_t tiles = (cp.n_blocks + kTile - 1) / kTile;
    ctas += (tiles + kTilesPerCta - 1) / kTilesPerCta;
  }
  for (int i = n_comps; i < kMaxComps; ++i) p.comp[i].cta0 = INT64_MAX;
  if (ctas == 0) return 0;
  if (ctas > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  fdct_kernel<<<static_cast<unsigned>(ctas), kThreads, 0,
                static_cast<cudaStream_t>(cuda_stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
