// K5: the scaled decode's pixel step for scale k in {1, 2, 4}: dequant +
// truncated k-point IDCT + output store + k x k tile scatter, written
// straight into each component's [rows*k, blocks_x*k] uint8 plane. One
// launch covers every component of a pixel-stage call (1, 3 or 4, with a
// batch's leading dimensions as block rows); one thread per coefficient
// block makes the block's k x k tile.
//
// Replaces jpeg_decoder_tpu/ops/idct.py idct_matmul_scaled (:261) and
// blocks_to_plane(..., tile=k) (:288), which build_stage_raw runs at scale
// < 8 under either IDCT contract (models/decoder.py:84-92; EXACT is ignored
// there, a reference defect the port keeps). That is one XLA dot of the
// [N, 64] coefficients by M_k * qt_zz, where M_k is the [64, k*k] matrix of
// idct_matrix_zz_scaled (:221) and qt_zz the table in zigzag order, then the
// FLOAT32 store of ops/idct._quantize_output (8- and 12-bit) and the tile
// scatter; in PyTorch six launches a component (fold, product, store,
// reshape and transpose). Only the k*k zigzag rows of M_k whose natural
// position (v, u) has v < k and u < k are nonzero: the band (band_z).
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
// What bounds it on the H100: memory, 4.6 / 2.1 / 1.9 us for a 4K request's
// three planes at k = 4 / 2 / 1 (PERF.md), which is the size of a launch's
// own overhead. So the design spends nothing per launch or per block of
// threads that it can spend once:
// - one launch per pixel-stage call (jdtc_idct_scaled): a descriptor in the
//   kernel's parameters gives each component's pointers, rows, width, table
//   and first block of threads; components start on block-of-threads
//   boundaries, so a block of threads finds its component by three compares
//   of blockIdx.x. The 4K request's chroma planes alone are 127 blocks of
//   threads each, fewer than the 132 SMs: as three launches (the earlier design,
//   jdtc_idct_scaled_percomp) two of them could not fill the card;
// - the folded band M_k[band] * qt_zz[band], for each distinct table, comes
//   folded from the host (ops/idct.folded_band, a float32 product in NumPy:
//   the round to nearest of __fmul_rn) in the kernel's parameters, so the
//   FMAs read it from the constant bank as operands: no shared-memory fill,
//   no barrier, no load instruction (the table index is uniform in a block
//   of threads, and a switch gives each table its own unrolled body);
// - the coefficient loads come first: nothing but the parameters stands
//   before the 16-byte band loads (four at k = 4, one at k = 2; at k = 1 the
//   DC term alone).
// A block's band lies in its first 50 bytes (z <= 24 at k = 4, z <= 4 at
// k = 2); the tile goes out as k rows of k bytes, one store a row,
// neighbouring threads on neighbouring tiles of a block row.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "idct_float.cuh"

namespace {

using jdtc_float::kZigzag;
using jdtc_float::store;

constexpr int kThreads = 256;
constexpr int kMaxComps = 4;
// the columns of a component's row of the host descriptor (int64):
// coefficients, output, rows, blocks_x, table, first block of threads
constexpr int kDescCols = 6;

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

// A block's band as float32, in band order: the 16-byte loads of its first
// bytes (at k = 1 the DC term alone).
template <int K>
__device__ __forceinline__ void load_band(const int16_t* block, float (&x)[K * K]) {
  if constexpr (K == 1) {
    x[0] = static_cast<float>(__ldg(block));
  } else {
    constexpr int kVecs = K == 2 ? 1 : 4;  // 16-byte loads covering the band
    int4 raw[kVecs];
    const int4* src = reinterpret_cast<const int4*>(block);
#pragma unroll
    for (int i = 0; i < kVecs; ++i) raw[i] = __ldg(src + i);
    const int16_t* h = reinterpret_cast<const int16_t*>(raw);
#pragma unroll
    for (int j = 0; j < K * K; ++j) x[j] = static_cast<float>(h[band_z<K>(j)]);
  }
}

// The k x k tile of one block: pixel (r, c) is the fmaf chain of x against
// column r * K + c of the folded band m (row j at m + j * K * K), in band
// order from 0, then the store; one store a tile row of k bytes at an
// offset that is a multiple of k.
template <int K>
__device__ __forceinline__ void store_tile(const float (&x)[K * K], const float* m, int bits12,
                                           uint8_t* o, int64_t stride) {
  constexpr int K2 = K * K;
#pragma unroll
  for (int r = 0; r < K; ++r) {
    uint32_t row = 0;
#pragma unroll
    for (int c = 0; c < K; ++c) {
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < K2; ++j) acc = fmaf(x[j], m[j * K2 + r * K + c], acc);
      row |= static_cast<uint32_t>(store(acc, bits12)) << (8 * c);
    }
    if constexpr (K == 1) o[r * stride] = static_cast<uint8_t>(row);
    if constexpr (K == 2) *reinterpret_cast<uint16_t*>(o + r * stride) = static_cast<uint16_t>(row);
    if constexpr (K == 4) *reinterpret_cast<uint32_t*>(o + r * stride) = row;
  }
}

struct Comp {
  const int16_t* coeffs;  // [rows, blocks_x, 64], 16-byte aligned
  uint8_t* out;           // [rows * K, blocks_x * K]
  int64_t rows;           // block rows, a batch's images stacked
  int blocks_x;
  int table;              // index into Params::m
};

// The kernel's parameters: read through the constant bank (__grid_constant__,
// so that indexing them by the component does not copy them to local
// memory). At k = 4 with four tables 4,244 bytes, above the 4 KB that
// kernel parameters were held to before CUDA 12.1; sm_90 takes 32,764.
template <int K>
struct Params {
  Comp comp[kMaxComps];
  int first_cta[kMaxComps];  // INT_MAX past the last component
  int bits12;
  float m[kMaxComps][K * K * K * K];  // m[t][j * K2 + p]: band row j, pixel p
};
static_assert(sizeof(Params<4>) <= 32764, "kernel parameters above sm_90's limit");

template <int K>
__global__ void __launch_bounds__(kThreads)
idct_scaled_kernel(const __grid_constant__ Params<K> p) {
  const int cta = static_cast<int>(blockIdx.x);
  const int ci = (cta >= p.first_cta[1]) + (cta >= p.first_cta[2]) + (cta >= p.first_cta[3]);
  const Comp& d = p.comp[ci];
  const int64_t b = static_cast<int64_t>(cta - p.first_cta[ci]) * kThreads + threadIdx.x;
  if (b >= d.rows * d.blocks_x) return;
  float x[K * K];
  load_band<K>(d.coeffs + b * 64, x);

  const int64_t by = b / d.blocks_x;
  const int64_t bx = b % d.blocks_x;
  const int64_t stride = static_cast<int64_t>(d.blocks_x) * K;
  uint8_t* o = d.out + by * K * stride + bx * K;
  // one unrolled body a table, so that each reads its entries at constant
  // offsets of the parameter bank (FFMA operands); d.table is uniform in a
  // block of threads
  switch (d.table) {
    case 0: store_tile<K>(x, p.m[0], p.bits12, o, stride); break;
    case 1: store_tile<K>(x, p.m[1], p.bits12, o, stride); break;
    case 2: store_tile<K>(x, p.m[2], p.bits12, o, stride); break;
    default: store_tile<K>(x, p.m[3], p.bits12, o, stride); break;
  }
}

template <int K>
int launch(const int64_t* desc, const float* folded, int n_comps, int n_tables, int bits12,
           cudaStream_t stream) {
  Params<K> p{};
  unsigned blocks = 0;
  for (int c = 0; c < kMaxComps; ++c) {
    if (c >= n_comps) {
      p.first_cta[c] = INT_MAX;
      continue;
    }
    const int64_t* r = desc + c * kDescCols;
    p.comp[c] = Comp{reinterpret_cast<const int16_t*>(r[0]), reinterpret_cast<uint8_t*>(r[1]),
                     r[2], static_cast<int>(r[3]), static_cast<int>(r[4])};
    p.first_cta[c] = static_cast<int>(r[5]);
    if (p.comp[c].table < 0 || p.comp[c].table >= n_tables) return cudaErrorInvalidValue;
    blocks = static_cast<unsigned>(r[5] + (r[2] * r[3] + kThreads - 1) / kThreads);
  }
  constexpr int kBand = K * K * K * K;
  for (int t = 0; t < n_tables; ++t)
    for (int i = 0; i < kBand; ++i) p.m[t][i] = folded[t * kBand + i];
  p.bits12 = bits12;
  if (blocks == 0) return cudaSuccess;
  idct_scaled_kernel<K><<<blocks, kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The earlier design, for measurement (benchmarks/pixel_sweep.py --k5): one
// launch per component, every block of threads folding the band into shared
// memory behind a barrier before it loads its coefficients; with
// kLoadsFirst the loads are issued before the fold and the barrier. Bitwise
// the design above.
// ---------------------------------------------------------------------------

template <int K, bool kLoadsFirst>
__global__ void __launch_bounds__(kThreads)
idct_scaled_percomp_kernel(const int16_t* __restrict__ coeffs, const int32_t* __restrict__ qt,
                           const float* __restrict__ mat, int64_t n_blocks, int blocks_x,
                           int bits12, uint8_t* __restrict__ out) {
  constexpr int K2 = K * K;
  // s_m[j * K2 + p]: the folded entry of band row j and pixel p
  __shared__ float s_m[K2 * K2];
  const int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool live = b < n_blocks;
  float x[K2];
  if (kLoadsFirst && live) load_band<K>(coeffs + b * 64, x);
  for (int i = threadIdx.x; i < K2 * K2; i += blockDim.x) {
    const int z = band_z<K>(i / K2);
    s_m[i] = __fmul_rn(mat[z * K2 + i % K2], static_cast<float>(qt[kZigzag[z]]));
  }
  __syncthreads();
  if (!live) return;
  if (!kLoadsFirst) load_band<K>(coeffs + b * 64, x);
  const int64_t stride = static_cast<int64_t>(blocks_x) * K;
  store_tile<K>(x, s_m, bits12, out + (b / blocks_x) * K * stride + (b % blocks_x) * K, stride);
}

template <int K, bool kLoadsFirst>
int launch_percomp(const void* coeffs, const void* qt, const void* kmat, int64_t n_blocks,
                   int blocks_x, int bits12, void* out, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((n_blocks + kThreads - 1) / kThreads);
  idct_scaled_percomp_kernel<K, kLoadsFirst><<<blocks, kThreads, 0, stream>>>(
      static_cast<const int16_t*>(coeffs), static_cast<const int32_t*>(qt),
      static_cast<const float*>(kmat), n_blocks, blocks_x, bits12, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <int K>
int launch_percomp(const void* coeffs, const void* qt, const void* kmat, int64_t n_blocks,
                   int blocks_x, int bits12, int loads_first, void* out, cudaStream_t stream) {
  return loads_first
             ? launch_percomp<K, true>(coeffs, qt, kmat, n_blocks, blocks_x, bits12, out, stream)
             : launch_percomp<K, false>(coeffs, qt, kmat, n_blocks, blocks_x, bits12, out, stream);
}

// A block of threads that does nothing: the launch floor, for measurement.
__global__ void __launch_bounds__(kThreads) idct_scaled_empty_kernel() {}

}  // namespace

// desc: host int64 [n_comps][6] (coefficients, output, rows, blocks_x,
// table, first block of threads; components in order, each starting where
// the one before ends, rounded up to a block of threads); folded: host
// float32 [n_tables][k^4] (ops/idct.folded_band).
extern "C" int jdtc_idct_scaled(const void* desc, const void* folded, int n_comps, int n_tables,
                                int k, int bits12, void* cuda_stream) {
  const auto stream = static_cast<cudaStream_t>(cuda_stream);
  const auto* d = static_cast<const int64_t*>(desc);
  const auto* f = static_cast<const float*>(folded);
  if (n_comps < 1 || n_comps > kMaxComps || n_tables < 1 || n_tables > kMaxComps)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (k) {
    case 1: return launch<1>(d, f, n_comps, n_tables, bits12, stream);
    case 2: return launch<2>(d, f, n_comps, n_tables, bits12, stream);
    case 4: return launch<4>(d, f, n_comps, n_tables, bits12, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int jdtc_idct_scaled_percomp(const void* coeffs, const void* qt, const void* kmat,
                                        int64_t n_blocks, int blocks_x, int k, int bits12,
                                        int loads_first, void* out, void* cuda_stream) {
  const auto stream = static_cast<cudaStream_t>(cuda_stream);
  switch (k) {
    case 1:
      return launch_percomp<1>(coeffs, qt, kmat, n_blocks, blocks_x, bits12, loads_first, out,
                               stream);
    case 2:
      return launch_percomp<2>(coeffs, qt, kmat, n_blocks, blocks_x, bits12, loads_first, out,
                               stream);
    case 4:
      return launch_percomp<4>(coeffs, qt, kmat, n_blocks, blocks_x, bits12, loads_first, out,
                               stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int jdtc_idct_scaled_empty(int64_t n_ctas, void* cuda_stream) {
  if (n_ctas > 0)
    idct_scaled_empty_kernel<<<static_cast<unsigned>(n_ctas), kThreads, 0,
                               static_cast<cudaStream_t>(cuda_stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
