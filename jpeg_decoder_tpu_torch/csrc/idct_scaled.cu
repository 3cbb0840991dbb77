// K5: the scaled decode's pixel step for scale k in {1, 2, 4}: dequant +
// truncated k-point IDCT + output store + k x k tile scatter, written
// straight into the [rows*k, blocks_x*k] uint8 plane. One thread per
// coefficient block makes the block's k x k tile.
//
// Replaces jpeg_decoder_tpu/ops/idct.py idct_matmul_scaled (:261) and
// blocks_to_plane(..., tile=k) (:288), which build_stage_raw runs at scale
// < 8 under either IDCT contract (models/decoder.py:84-92; EXACT is ignored
// there, a reference defect the port keeps). That is one XLA dot of the
// [N, 64] coefficients by M_k * qt_zz, where M_k is the [64, k*k] matrix of
// idct_matrix_zz_scaled (:221) and qt_zz the table in zigzag order, then the
// FLOAT32 store of ops/idct._quantize_output (8- and 12-bit) and the tile
// scatter; in PyTorch six launches (fold, product, store, reshape and
// transpose). Only the k*k zigzag rows of M_k whose natural position
// (v, u) has v < k and u < k are nonzero: the band (band_z).
//
// Arithmetic (held against ops/idct.idct_matmul_scaled): the folded matrix
// entry m = M_k[z][p] * float32(qt_zz[z]) is one float32 product, as the JAX
// fold's; the pixel's sum is fmaf(float32(coeff_z), m, acc) over the band
// in order of z from 0 (an explicit fmaf is never reassociated, and nothing
// runs in TF32); then the store of idct_float.cuh (floor, level shift,
// clamp; the 12-bit wrap and rescale). The plain version's product sums in
// another order, so a floor may flip: within 1 on at most 1e-3 of the
// pixels, as K1; at k = 1 the sum has one term and the two are bitwise
// equal.
//
// What bounds it on the H100: memory. A block's band lies in its first 50
// bytes (z <= 24 at k = 4, z <= 4 at k = 2), which a thread reads in 16-byte
// loads (four at k = 4, one at k = 2; at k = 1 the DC term alone); it writes
// its tile as k rows of k bytes, one store a row, neighbouring threads on
// neighbouring tiles of a block row. The folded band (k^4 floats) sits in
// shared memory, every thread of a warp reading the same entry. The first
// version, one thread per output pixel walking all 64 zigzag rows, took
// 0.2077 ms at k = 4 for a 4K request's planes, four times torch.matmul's
// product alone (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

#include "idct_float.cuh"

namespace {

using jdtc_float::kZigzag;
using jdtc_float::store;

constexpr int kThreads = 256;

// The band of scale K: the zigzag positions z whose natural position (v, u)
// has v < K and u < K, in increasing z (core/types.ZIGZAG;
// tests/test_torch_idct.py holds these lists against it).
template <int K>
__device__ __forceinline__ constexpr int band_z(int j) {
  constexpr int kBand2[4] = {0, 1, 2, 4};
  constexpr int kBand4[16] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 11, 12, 13, 17, 18, 24};
  if constexpr (K == 1) return 0;
  if constexpr (K == 2) return kBand2[j];
  return kBand4[j];
}

template <int K>
__global__ void __launch_bounds__(kThreads)
idct_scaled_kernel(const int16_t* __restrict__ coeffs, const int32_t* __restrict__ qt,
                   const float* __restrict__ mat, int64_t n_blocks, int blocks_x, int bits12,
                   uint8_t* __restrict__ out) {
  constexpr int K2 = K * K;
  // s_m[j * K2 + p]: the folded entry of band row j and pixel p
  __shared__ float s_m[K2 * K2];
  for (int i = threadIdx.x; i < K2 * K2; i += blockDim.x) {
    const int z = band_z<K>(i / K2);
    s_m[i] = __fmul_rn(mat[z * K2 + i % K2], static_cast<float>(qt[kZigzag[z]]));
  }
  __syncthreads();
  const int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= n_blocks) return;

  float x[K2];
  if constexpr (K == 1) {
    x[0] = static_cast<float>(coeffs[b * 64]);
  } else {
    constexpr int kVecs = K == 2 ? 1 : 4;  // 16-byte loads covering the band
    int4 raw[kVecs];
    const int4* src = reinterpret_cast<const int4*>(coeffs + b * 64);
#pragma unroll
    for (int i = 0; i < kVecs; ++i) raw[i] = __ldg(src + i);
    const int16_t* h = reinterpret_cast<const int16_t*>(raw);
#pragma unroll
    for (int j = 0; j < K2; ++j) x[j] = static_cast<float>(h[band_z<K>(j)]);
  }

  const int64_t by = b / blocks_x;
  const int64_t bx = b % blocks_x;
  const int64_t stride = static_cast<int64_t>(blocks_x) * K;
  uint8_t* o = out + by * K * stride + bx * K;
#pragma unroll
  for (int r = 0; r < K; ++r) {
    uint32_t row = 0;
#pragma unroll
    for (int c = 0; c < K; ++c) {
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < K2; ++j) acc = fmaf(x[j], s_m[j * K2 + r * K + c], acc);
      row |= static_cast<uint32_t>(store(acc, bits12)) << (8 * c);
    }
    // one store a tile row: k bytes at an offset that is a multiple of k
    if constexpr (K == 1) o[r * stride] = static_cast<uint8_t>(row);
    if constexpr (K == 2) *reinterpret_cast<uint16_t*>(o + r * stride) = static_cast<uint16_t>(row);
    if constexpr (K == 4) *reinterpret_cast<uint32_t*>(o + r * stride) = row;
  }
}

template <int K>
int launch(const void* coeffs, const void* qt, const void* kmat, int64_t n_blocks,
           int blocks_x, int bits12, void* out, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((n_blocks + kThreads - 1) / kThreads);
  idct_scaled_kernel<K><<<blocks, kThreads, 0, stream>>>(
      static_cast<const int16_t*>(coeffs), static_cast<const int32_t*>(qt),
      static_cast<const float*>(kmat), n_blocks, blocks_x, bits12,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int jdtc_idct_scaled(const void* coeffs, const void* qt, const void* kmat,
                                int64_t n_blocks, int blocks_x, int k, int bits12, void* out,
                                void* cuda_stream) {
  const auto stream = static_cast<cudaStream_t>(cuda_stream);
  switch (k) {
    case 1: return launch<1>(coeffs, qt, kmat, n_blocks, blocks_x, bits12, out, stream);
    case 2: return launch<2>(coeffs, qt, kmat, n_blocks, blocks_x, bits12, out, stream);
    case 4: return launch<4>(coeffs, qt, kmat, n_blocks, blocks_x, bits12, out, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
