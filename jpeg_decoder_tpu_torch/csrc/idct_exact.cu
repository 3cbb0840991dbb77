// K0: fused dequant + de-zigzag + EXACT 8x8 IDCT + output store, written
// straight into the [blocks_y*8, blocks_x*8] uint8 pixel plane.
//
// Replaces jpeg_decoder_tpu/ops/idct.py idct_exact (its double-float
// emulation in ops/df32.py, which exists because the TPU has no float64) and
// blocks_to_plane: XLA fused those into the JAX device stage. The arithmetic
// model is core/numerics._idct8_rows_exact / idct_2d_exact, which replicates
// the reference C decoder (dct.c fast_2didct + fast_idct_new): every
// statement is a float64 expression of float32 values stored to float32,
// and the float32 sums inside them are float32 operations. Each statement
// below rounds exactly where the model rounds: float64 products and sums
// through __dmul_rn / __dadd_rn (so nvcc's default --fmad=true cannot
// contract them into FMAs), float32 sums through __fadd_rn / __fsub_rn, and
// every store through __double2float_rn.
//
// What bounds it on the H100: on paper, memory. A block is ~700 float64
// operations (no FMAs, by design) against 192 bytes moved (128 of int16
// coefficients in, 64 of pixels out); at 34 TFLOP/s float64 and 3.35 TB/s
// the bytes take about three times as long. One thread per block keeps the
// 64 values in registers (the natural-order index of every access is a
// compile-time constant). Its reads are 128-byte rows per thread, not
// coalesced across a warp, and its stores are 8-byte rows: staging through
// shared memory so a warp reads and writes contiguous bytes is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Zigzag position of each natural-order coefficient (T.81 Figure A.6;
// core/types.INV_ZIGZAG). Indexed by a compile-time natural index, so the
// register array x below is never indexed dynamically.
__constant__ int kInvZigzag[64] = {
     0,  1,  5,  6, 14, 15, 27, 28,  2,  4,  7, 13, 16, 26, 29, 42,
     3,  8, 12, 17, 25, 30, 41, 43,  9, 11, 18, 24, 31, 40, 44, 53,
    10, 19, 23, 32, 39, 45, 52, 54, 20, 22, 33, 38, 46, 51, 55, 60,
    21, 34, 37, 47, 50, 56, 59, 61, 35, 36, 48, 49, 57, 58, 62, 63};

constexpr int kThreads = 128;

__device__ __forceinline__ float st(double x) { return __double2float_rn(x); }
__device__ __forceinline__ double mul(double c, float x) {
  return __dmul_rn(c, static_cast<double>(x));
}
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }

// One fast_idct_new pass over v[0], v[S], ..., v[7*S], in place
// (core/numerics._idct8_rows_exact, statement by statement).
template <int S>
__device__ __forceinline__ void idct8(float* v) {
  const float t0 = st(mul(1.414213562, v[0 * S]));
  const float t1 = v[4 * S];
  const float t2 = v[2 * S];
  const float t3 = v[6 * S];
  const float t4 = st(mul(0.5, __fsub_rn(v[1 * S], v[7 * S])));
  const float t5 = st(mul(0.707106781, v[3 * S]));
  const float t6 = st(mul(0.707106781, v[5 * S]));
  const float t7 = st(mul(0.5, __fadd_rn(v[1 * S], v[7 * S])));

  const float u0 = st(mul(0.5, __fadd_rn(t0, t1)));
  const float u1 = st(mul(0.5, __fsub_rn(t0, t1)));
  const float u2 = st(__dmul_rn(0.707106781,
                                add(mul(0.38268343236, t2), mul(-0.92387953251, t3))));
  const float u3 = st(__dmul_rn(0.707106781,
                                add(mul(0.92387953251, t2), mul(0.38268343236, t3))));
  const float u4 = st(mul(0.5, __fadd_rn(t4, t6)));
  const float u5 = st(mul(0.5, __fadd_rn(-t5, t7)));
  const float u6 = st(mul(0.5, __fsub_rn(t4, t6)));
  const float u7 = st(mul(0.5, __fadd_rn(t5, t7)));

  const float w0 = st(mul(0.5, __fadd_rn(u0, u3)));
  const float w1 = st(mul(0.5, __fadd_rn(u1, u2)));
  const float w2 = st(mul(0.5, __fsub_rn(u1, u2)));
  const float w3 = st(mul(0.5, __fsub_rn(u0, u3)));
  const float w4 = st(add(mul(0.8314696123, u4), mul(-0.55557023302, u7)));
  const float w5 = st(add(mul(0.9807852804, u5), mul(-0.19509032201, u6)));
  const float w6 = st(add(mul(0.19509032201, u5), mul(0.9807852804, u6)));
  const float w7 = st(add(mul(0.55557023302, u4), mul(0.8314696123, u7)));

  const double s = 1.414213562 * 2;  // exact doubling, as the model's literal
  v[0 * S] = st(mul(s, __fadd_rn(w0, w7)));
  v[1 * S] = st(mul(s, __fadd_rn(w1, w6)));
  v[2 * S] = st(mul(s, __fadd_rn(w2, w5)));
  v[3 * S] = st(mul(s, __fadd_rn(w3, w4)));
  v[4 * S] = st(mul(s, __fsub_rn(w3, w4)));
  v[5 * S] = st(mul(s, __fsub_rn(w2, w5)));
  v[6 * S] = st(mul(s, __fsub_rn(w1, w6)));
  v[7 * S] = st(mul(s, __fsub_rn(w0, w7)));
}

// The reference's output store (dct.c:186-203; core/numerics.idct_2d_exact
// and rescale_12bit). Clamps before any float -> integer conversion.
__device__ __forceinline__ uint8_t store(float x, int bits12) {
  if (!bits12) {
    double r = add(mul(0.25, x), 128.0);
    r = r > 255.0 ? 255.0 : (r < 0.0 ? 0.0 : r);
    return static_cast<uint8_t>(static_cast<int>(r));
  }
  double r = add(mul(0.25, x), 2048.0);
  r = r > 65535.0 ? 65535.0 : (r < 0.0 ? 0.0 : r);
  int v = static_cast<int>(r) & 0xFFFF;  // CLAMP_16, then the int16 wrap
  v = (v ^ 0x8000) - 0x8000;
  const double q = __dmul_rn(__ddiv_rn(static_cast<double>(v), 4096.0), 255.0);
  return static_cast<uint8_t>(static_cast<int>(q) & 0xFF);
}

__global__ void __launch_bounds__(kThreads)
idct_exact_kernel(const int16_t* __restrict__ coeffs,
                  const int32_t* __restrict__ qt, int64_t n_blocks,
                  int blocks_x, int bits12, uint8_t* __restrict__ out) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= n_blocks) return;
  const int16_t* src = coeffs + b * 64;
  float x[64];
#pragma unroll
  for (int n = 0; n < 64; ++n)
    x[n] = static_cast<float>(static_cast<int32_t>(src[kInvZigzag[n]]) * __ldg(qt + n));
  // Row/column 1/sqrt(2) pre-scale (dct.c:164-167): row 0, then column 0,
  // so [0][0] is scaled twice.
#pragma unroll
  for (int c = 0; c < 8; ++c) x[c] = st(mul(0.707106781, x[c]));
#pragma unroll
  for (int r = 0; r < 8; ++r) x[r * 8] = st(mul(0.707106781, x[r * 8]));
#pragma unroll
  for (int r = 0; r < 8; ++r) idct8<1>(x + r * 8);   // row pass
#pragma unroll
  for (int c = 0; c < 8; ++c) idct8<8>(x + c);       // column pass

  const int64_t by = b / blocks_x;
  const int64_t bx = b % blocks_x;
  const int64_t stride = static_cast<int64_t>(blocks_x) * 8;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    uint64_t row = 0;
#pragma unroll
    for (int c = 0; c < 8; ++c)
      row |= static_cast<uint64_t>(store(x[r * 8 + c], bits12)) << (8 * c);
    *reinterpret_cast<uint64_t*>(out + (by * 8 + r) * stride + bx * 8) = row;
  }
}

}  // namespace

extern "C" int jdtc_idct_exact(const void* coeffs, const void* qt,
                               int64_t n_blocks, int blocks_x, int bits12,
                               void* out, void* cuda_stream) {
  const unsigned blocks = static_cast<unsigned>((n_blocks + kThreads - 1) / kThreads);
  idct_exact_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<const int16_t*>(coeffs), static_cast<const int32_t*>(qt),
      n_blocks, blocks_x, bits12, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
