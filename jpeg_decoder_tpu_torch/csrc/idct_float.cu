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
// Design: a CUDA block holds K (16 KB) in shared memory and walks tiles of
// 32 coefficient blocks (grid-stride, one resident wave). Per tile it
// dequantizes the 32x64 coefficients into shared memory, then each of its
// 256 threads owns one pixel position p of 8 of the tile's blocks and forms
// each as a 64-term float32 dot product, z = 0..63 in order with fmaf. The
// dot product of a block does not depend on where the block sits in a tile,
// so a plane gives the same pixels alone or stacked in a batch. The
// arithmetic (dequant, the fmaf chain, the store) lives in idct_float.cuh,
// shared with K13 (pixel_float.cu), which runs the FLOAT32 stage of a
// 3-component frame in one kernel; K1 serves gray frames and the geometries
// K13's guard refuses.
//
// What bounds it on the H100: the 64x64 product is 4096 FMAs per block
// against 192 bytes moved (128 of int16 coefficients in, 64 of pixels out),
// about 21 FMAs per byte: at 67 TFLOP/s float32 and 3.35 TB/s the FMAs take
// about twice as long as the bytes, and the shared-memory loads that feed
// them (one float4 of coefficients per 4 FMAs) are the next limit. Tensor
// cores in TF32 would lose the low bits the contract needs (up to 229 LSB on
// the TPU's bf16 passes, pallas_kernels.py:81-83); a 3xTF32 split on wgmma
// is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "idct_float.cuh"

namespace {

using jdtc_float::dequant;
using jdtc_float::dot4;
using jdtc_float::kZigzag;
using jdtc_float::store;

constexpr int kThreads = 256;
constexpr int kTile = 32;                  // coefficient blocks per tile
constexpr int kGroups = kThreads / 64;     // thread groups, one block each
constexpr int kPer = kTile / kGroups;      // blocks per thread

__global__ void __launch_bounds__(kThreads)
idct_float_kernel(const int16_t* __restrict__ coeffs,
                  const int32_t* __restrict__ qt,
                  const float* __restrict__ kmat, int64_t n_blocks,
                  int blocks_x, int bits12, uint8_t* __restrict__ out) {
  __shared__ float s_k[64 * 64];
  __shared__ __align__(16) float s_x[kTile * 64];
  __shared__ float s_q[64];
  for (int i = threadIdx.x; i < 64 * 64; i += kThreads) s_k[i] = kmat[i];
  if (threadIdx.x < 64)
    s_q[threadIdx.x] = static_cast<float>(qt[kZigzag[threadIdx.x]]);

  const int p = threadIdx.x & 63;   // pixel position, raster order
  const int g = threadIdx.x >> 6;   // this thread's blocks: g, g+4, ...
  const int64_t stride = static_cast<int64_t>(blocks_x) * 8;
  const int64_t n_tiles = (n_blocks + kTile - 1) / kTile;
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t b0 = tile * kTile;
    __syncthreads();  // s_k and s_q written; the last tile's s_x read
    for (int i = threadIdx.x; i < kTile * 64; i += kThreads) {
      const int64_t b = b0 + i / 64;
      s_x[i] = b < n_blocks ? dequant(coeffs[b0 * 64 + i], s_q[i & 63]) : 0.0f;
    }
    __syncthreads();

    float acc[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) acc[j] = 0.0f;
#pragma unroll 2
    for (int z = 0; z < 64; z += 4) {
      const float k0 = s_k[(z + 0) * 64 + p];
      const float k1 = s_k[(z + 1) * 64 + p];
      const float k2 = s_k[(z + 2) * 64 + p];
      const float k3 = s_k[(z + 3) * 64 + p];
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const float4 x =
            *reinterpret_cast<const float4*>(&s_x[(g + j * kGroups) * 64 + z]);
        acc[j] = dot4(acc[j], x, k0, k1, k2, k3);
      }
    }

#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int64_t b = b0 + g + j * kGroups;
      if (b < n_blocks) {
        const int64_t by = b / blocks_x;
        const int64_t bx = b % blocks_x;
        out[(by * 8 + (p >> 3)) * stride + bx * 8 + (p & 7)] = store(acc[j], bits12);
      }
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
  int dev = 0;
  int sms = 0;
  int per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, idct_float_kernel,
                                                        kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n_tiles = (n_blocks + kTile - 1) / kTile;
  const int64_t wave = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const unsigned blocks = static_cast<unsigned>(n_tiles < wave ? n_tiles : wave);
  idct_float_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<const int16_t*>(coeffs), static_cast<const int32_t*>(qt),
      static_cast<const float*>(kmat), n_blocks, blocks_x, bits12,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
