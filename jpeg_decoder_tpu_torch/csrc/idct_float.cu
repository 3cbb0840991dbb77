// K1: fused dequant + FLOAT32 8x8 IDCT + output store, written straight into
// the [rows*8, blocks_x*8] uint8 pixel plane.
//
// Replaces the Pallas kernel of jpeg_decoder_tpu/ops/pallas_kernels.py
// (idct_pallas; _kernel, pallas_call in _idct_pallas_padded). It computes what
// that kernel computes -- x = float32(coeff_zz) * float32(qt_zz), y = x @ K
// with K the [64, 64] float32 matrix of idct_matrix_zz, floor, +128, clamp,
// uint8 -- plus the 12-bit store of ops/idct._quantize_output and the block
// scatter of blocks_to_plane, as K0 fuses it. None of its TPU layout is kept:
// the 128-lane block pairing, blockdiag(K, K) and the TILE=512 grid exist to
// fill the MXU's 128x128 tiles.
//
// What bounds it on the H100: the 64x64 product is 4096 FMAs per block
// against 192 bytes moved (128 of int16 coefficients in, 64 of pixels out),
// about 21 FMAs per byte: at 67 TFLOP/s float32 and 3.35 TB/s the FMAs take
// about twice as long as the bytes. Tensor cores in TF32 would lose the low
// bits the contract needs (up to 229 LSB on the TPU's bf16 passes,
// pallas_kernels.py:81-83), and a tiled MMA sums in another order, so the
// FMAs stay on the CUDA cores; the lever is how their operands arrive.
//
// Design: one resident wave of blocks of 128 threads, each holding K (16
// KB) in shared memory and walking tiles of 64 coefficient blocks. A tile's
// 8 KB of int16 coefficients, contiguous in device memory, come by 16-byte
// cp.async (2-byte loads where the coefficients are not 16-byte aligned)
// into a staging buffer; the next tile's copies are issued once this tile
// is dequantised out of it, so the two buffers hold two tiles and the copy
// travels while this one multiplies. Dequantised into a float tile (68
// floats a block: neighbouring blocks on other banks), the product runs
// from registers (`product` of idct_float.cuh, K13's register tile):
// thread (g, q) forms pixels 4q..4q+3 -- half of pixel row q / 2 -- of the
// 8 blocks g, g + 8, ..., g + 56, each step of four z loading 8 float4 of x
// and 4 of K for 128 FMAs, 0.094 shared loads an FMA (a thread a pixel
// would take 0.375). A warp holds 8 groups x 4 q, so its loads of K are 4
// float4 (64 bytes) and those of x 8 float4 on distinct banks. Each pixel
// keeps the order of the contract's chain, z = 0..63 with fmaf from 0, so
// the pixels are bitwise the plain version's and K13's. A thread stores
// its 4 pixels of a block row as one 4-byte word; a store instruction of a
// warp writes two pixel rows of 8 neighbouring blocks, 64 contiguous bytes
// each, which is what staging them through shared memory for 16-byte
// stores would write. The tile shape was chosen on the card
// (benchmarks/pixel_sweep.py --k1: 256 threads of 4 or 2 blocks, 8 x 8
// tiles were slower). The arithmetic (dequant, the chain, the store) lives
// in idct_float.cuh, shared with K13 (pixel_float.cu), which runs the
// FLOAT32 stage of a 3-component frame in one kernel; K1 serves gray,
// fancy and 4-component frames and the geometries K13's guard refuses.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "idct_float.cuh"

namespace {

using jdtc_common::cp_async16;
using jdtc_common::cp_async_wait_all;
using jdtc_common::wave;
using jdtc_float::dequant;
using jdtc_float::dot4;
using jdtc_float::kZigzag;
using jdtc_float::store;

constexpr int kThreads = 128;
constexpr int kBlocksPerThread = 8;  // the register tile: kBlocksPerThread blocks x kCols pixels
constexpr int kCols = 4;
constexpr int kQuads = 64 / kCols;                // threads of a block group
constexpr int kGroups = kThreads / kQuads;        // block groups
constexpr int kTile = kGroups * kBlocksPerThread; // coefficient blocks per tile
constexpr int kXStride = 68;                      // floats a block in the float tile
static_assert(kCols == 4 || kCols == 8, "a thread's pixels lie in one pixel row");
static_assert(kGroups % 8 == 0, "a warp holds 8 groups x 4 column sets");
// Shared memory: K | the float tile | the tile's coefficients | the table.
constexpr int kSmemX = 64 * 64 * 4;
constexpr int kSmemC = kSmemX + kTile * kXStride * 4;
constexpr int kSmemQ = kSmemC + kTile * 64 * 2;
constexpr int kSmem = kSmemQ + 64 * 4;

// The blocks of the tile that starts at block b0.
static __device__ __forceinline__ int tile_blocks(int64_t n_blocks, int64_t b0) {
  return n_blocks - b0 < kTile ? static_cast<int>(n_blocks - b0) : kTile;
}

// The tile's nb blocks from block b0 into s_c: 16-byte cp.async where the
// coefficients are 16-byte aligned, else 2-byte loads.
static __device__ __forceinline__ void load_tile(const int16_t* __restrict__ coeffs, int64_t b0,
                                                 int nb, bool aligned, int16_t* s_c) {
  if (aligned) {
    const int16_t* src = coeffs + b0 * 64;
    for (int k = threadIdx.x; k < nb * 8; k += kThreads) cp_async16(s_c + 8 * k, src + 8 * k);
  } else {
    for (int k = threadIdx.x; k < nb * 64; k += kThreads) s_c[k] = coeffs[b0 * 64 + k];
  }
}

// kCols stored pixels as one word of kCols bytes at dst (or byte by byte).
static __device__ __forceinline__ void store_pixels(uint8_t* dst, const float (&y)[kCols],
                                                    int bits12, bool words) {
  uint32_t w[kCols / 4];
#pragma unroll
  for (int e = 0; e < kCols / 4; ++e) {
    w[e] = 0;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      w[e] |= static_cast<uint32_t>(store(y[4 * e + c], bits12)) << (8 * c);
  }
  if (words) {
    if constexpr (kCols == 4) {
      *reinterpret_cast<uint32_t*>(dst) = w[0];
    } else {
#pragma unroll
      for (int e = 0; e < kCols / 8; ++e)
        reinterpret_cast<uint2*>(dst)[e] = make_uint2(w[2 * e], w[2 * e + 1]);
    }
  } else {
#pragma unroll
    for (int c = 0; c < kCols; ++c) dst[c] = static_cast<uint8_t>(w[c >> 2] >> (8 * (c & 3)));
  }
}

__global__ void __launch_bounds__(kThreads)
idct_float_kernel(const int16_t* __restrict__ coeffs, const int32_t* __restrict__ qt,
                  const float* __restrict__ kmat, int64_t n_blocks, int blocks_x, int bits12,
                  uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  float* s_k = reinterpret_cast<float*>(smem);
  float* s_x = reinterpret_cast<float*>(smem + kSmemX);
  int16_t* s_c = reinterpret_cast<int16_t*>(smem + kSmemC);
  float* s_q = reinterpret_cast<float*>(smem + kSmemQ);
  const int tid = threadIdx.x;
  if ((reinterpret_cast<uintptr_t>(kmat) & 15) == 0) {
    for (int k = tid; k < 64 * 16; k += kThreads) cp_async16(s_k + 4 * k, kmat + 4 * k);
  } else {
    for (int k = tid; k < 64 * 64; k += kThreads) s_k[k] = kmat[k];
  }
  if (tid < 64) s_q[tid] = static_cast<float>(qt[kZigzag[tid]]);
  const bool aligned = (reinterpret_cast<uintptr_t>(coeffs) & 15) == 0;
  const bool words = (reinterpret_cast<uintptr_t>(out) & (kCols - 1)) == 0;
  const int64_t n_tiles = (n_blocks + kTile - 1) / kTile;
  const int64_t stride = static_cast<int64_t>(blocks_x) * 8;
  // Thread (g, q): pixels kCols q .. kCols q + kCols - 1 of blocks g, g +
  // kGroups, ... A warp holds 8 groups x 4 q: its loads of K are 4 float4
  // (64 bytes), its loads of x 8 (on distinct banks), and a store
  // instruction writes pixel rows of 8 neighbouring blocks, 64 contiguous
  // bytes each.
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q = 4 * (warp % (kQuads / 4)) + (lane >> 3);
  const int g = 8 * (warp / (kQuads / 4)) + (lane & 7);
  const int row = (kCols * q) >> 3;  // the thread's pixel row and first column in a block
  const int col = (kCols * q) & 7;
  int64_t tile = blockIdx.x;
  if (tile < n_tiles)
    load_tile(coeffs, tile * kTile, tile_blocks(n_blocks, tile * kTile), aligned, s_c);

  for (; tile < n_tiles; tile += gridDim.x) {
    const int64_t b0 = tile * kTile;
    const int nb = tile_blocks(n_blocks, b0);
    cp_async_wait_all();
    __syncthreads();  // the tile has landed; the last tile's products are read
    // Dequantise into the float tile; blocks past the end are zero.
    for (int t = tid; t < kTile * 16; t += kThreads) {
      const int b = t >> 4;
      const int z = (t & 15) * 4;
      float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (b < nb) {
        const short4 v = *reinterpret_cast<const short4*>(s_c + b * 64 + z);
        x = make_float4(dequant(v.x, s_q[z]), dequant(v.y, s_q[z + 1]),
                        dequant(v.z, s_q[z + 2]), dequant(v.w, s_q[z + 3]));
      }
      *reinterpret_cast<float4*>(s_x + b * kXStride + z) = x;
    }
    __syncthreads();
    // The next tile's coefficients travel while this one multiplies.
    const int64_t next = tile + gridDim.x;
    if (next < n_tiles)
      load_tile(coeffs, next * kTile, tile_blocks(n_blocks, next * kTile), aligned, s_c);

    float acc[kBlocksPerThread][kCols];
    jdtc_float::product<kBlocksPerThread, kCols>(s_k + kCols * q, s_x + g * kXStride,
                                                 kGroups * kXStride, acc);
    // The thread's first block's place, one division a tile; then kGroups
    // blocks on a step.
    int64_t by = n_blocks <= 0x7FFFFFFF
        ? static_cast<int64_t>(static_cast<uint32_t>(b0 + g) / static_cast<uint32_t>(blocks_x))
        : (b0 + g) / blocks_x;
    int64_t bx = b0 + g - by * blocks_x;
#pragma unroll
    for (int j = 0; j < kBlocksPerThread; ++j) {
      if (j > 0) {
        bx += kGroups;
        while (bx >= blocks_x) {
          bx -= blocks_x;
          ++by;
        }
      }
      if (g + j * kGroups < nb)
        store_pixels(out + (by * 8 + row) * stride + bx * 8 + col, acc[j], bits12, words);
    }
  }
}

}  // namespace

extern "C" int jdtc_idct_float(const void* coeffs, const void* qt,
                               const void* kmat, int64_t n_blocks,
                               int blocks_x, int bits12, void* out,
                               void* cuda_stream) {
  // One resident wave of blocks, each walking tiles, so that K is loaded
  // into shared memory once per block rather than once per tile.
  if (n_blocks <= 0) return 0;
  unsigned blocks = 0;
  cudaError_t err =
      cudaFuncSetAttribute(idct_float_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err == cudaSuccess)
    err = wave(idct_float_kernel, kThreads, (n_blocks + kTile - 1) / kTile, kSmem, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  idct_float_kernel<<<blocks, kThreads, kSmem, static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<const int16_t*>(coeffs), static_cast<const int32_t*>(qt),
      static_cast<const float*>(kmat), n_blocks, blocks_x, bits12,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
