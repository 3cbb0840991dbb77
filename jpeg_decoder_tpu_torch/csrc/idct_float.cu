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
// so a plane gives the same pixels alone or stacked in a batch.
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

namespace {

// Natural-order index of each zigzag position (T.81 Figure A.6;
// core/types.ZIGZAG): qt_zz[z] = qt_natural[kZigzag[z]].
__constant__ int kZigzag[64] = {
     0,  1,  8, 16,  9,  2,  3, 10, 17, 24, 32, 25, 18, 11,  4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13,  6,  7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

constexpr int kThreads = 256;
constexpr int kTile = 32;                  // coefficient blocks per tile
constexpr int kGroups = kThreads / 64;     // thread groups, one block each
constexpr int kPer = kTile / kGroups;      // blocks per thread

// The FLOAT32 contract's store (ops/idct._quantize_output_float): float32
// ops only, and a clamp before every float -> integer conversion.
__device__ __forceinline__ uint8_t store(float y, int bits12) {
  const float base = floorf(y);
  if (!bits12) {
    float q = __fadd_rn(base, 128.0f);
    q = q > 255.0f ? 255.0f : (q < 0.0f ? 0.0f : q);
    return static_cast<uint8_t>(static_cast<int>(q));
  }
  float r = __fadd_rn(base, 2048.0f);
  r = r > 65535.0f ? 65535.0f : (r < 0.0f ? 0.0f : r);
  int v = static_cast<int>(r) & 0xFFFF;  // CLAMP_16, then the int16 wrap
  v = (v ^ 0x8000) - 0x8000;
  // 255/4096 is exact in float32, and so is the product (15 x 8 bits).
  const float q = truncf(__fmul_rn(static_cast<float>(v), 255.0f / 4096.0f));
  return static_cast<uint8_t>(static_cast<int>(q) & 0xFF);
}

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
      // exact for |coeff| <= 2^15 and qt <= 255; __fmul_rn keeps it a
      // separate rounding, as the plain version's multiply
      s_x[i] = b < n_blocks
                   ? __fmul_rn(static_cast<float>(coeffs[b0 * 64 + i]), s_q[i & 63])
                   : 0.0f;
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
        acc[j] = fmaf(x.x, k0, acc[j]);
        acc[j] = fmaf(x.y, k1, acc[j]);
        acc[j] = fmaf(x.z, k2, acc[j]);
        acc[j] = fmaf(x.w, k3, acc[j]);
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
