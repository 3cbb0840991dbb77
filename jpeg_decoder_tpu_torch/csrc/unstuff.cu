// K2u: byte unstuffing of restart segments on the card.
//
// Replaces the unstuffing that the JAX backend does on the host before its
// entropy kernel runs (jpeg_decoder_tpu/ops/entropy_pallas.py, _pack_group:
// one io/bitstream.unstuff call per restart segment, then a concatenation).
// Input: the raw entropy-coded bytes of the scans of a group and the raw
// bounds [lo, hi) of every restart segment, in stream order (the parser
// finds them; the RSTn markers lie between the bounds). Output: what the
// host built before -- the unstuffed segments back to back, 8 zero bytes of
// tail, and seg_off[n_segs + 1] with segment s at [seg_off[s], seg_off[s+1]).
//
// A byte is kept iff it lies inside a segment and is not the 0x00 that
// follows a 0xFF of the same segment. Segments are in order, so the place
// of a kept byte is the number of kept bytes before it, whatever its
// segment: one stream compaction over all raw bytes, and seg_off[s] is the
// place of byte lo[s].
//
// What bounds it on the H100: bytes. Every raw byte is read and every kept
// byte written once; the work per byte is a compare or two. The design
// reads 16 bytes a thread with one aligned load (neighbouring threads,
// neighbouring addresses) plus the one byte before them, so a stuffed pair
// that straddles two threads or two blocks is seen from both sides, and
// takes three small kernels instead of a scan with look-back: (1) each
// block of 4096 bytes counts its kept bytes, (2) one block forms the
// exclusive prefix sum of the counts, (3) each block forms its threads'
// prefix sums and scatters. A thread finds its segment by binary search
// over `lo` and walks on from there.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 16;  // bytes a thread

struct Chunk {
  uint32_t bytes[kChunk / 4];  // little-endian words
  uint32_t keep;               // bit t: byte t of the chunk is kept
  __device__ __forceinline__ uint32_t byte(int t) const {
    return (bytes[t >> 2] >> (8 * (t & 3))) & 0xFF;
  }
};

// The chunk at raw[j0, j0 + 16) and its keep mask.
__device__ Chunk load_chunk(const uint8_t* __restrict__ raw, int64_t n_raw,
                            const int64_t* __restrict__ lo, const int64_t* __restrict__ hi,
                            int64_t n_segs, int64_t j0) {
  Chunk c;
  c.keep = 0;
#pragma unroll
  for (int i = 0; i < kChunk / 4; ++i) c.bytes[i] = 0;
  if (j0 >= n_raw) return c;
  if (j0 + kChunk <= n_raw) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(raw + j0));
    c.bytes[0] = v.x;
    c.bytes[1] = v.y;
    c.bytes[2] = v.z;
    c.bytes[3] = v.w;
  } else {
    for (int t = 0; j0 + t < n_raw; ++t)
      c.bytes[t >> 2] |= static_cast<uint32_t>(raw[j0 + t]) << (8 * (t & 3));
  }
  // the last segment that starts at or before j0 (-1: none)
  int64_t a = 0, b = n_segs;
  while (a < b) {
    const int64_t mid = (a + b) >> 1;
    if (__ldg(lo + mid) <= j0) a = mid + 1; else b = mid;
  }
  int64_t s = a - 1;
  uint32_t prev = j0 > 0 ? raw[j0 - 1] : 0;
  for (int t = 0; t < kChunk && j0 + t < n_raw; ++t) {
    const int64_t j = j0 + t;
    while (s + 1 < n_segs && __ldg(lo + s + 1) <= j) ++s;
    const uint32_t v = c.byte(t);
    if (s >= 0 && j < __ldg(hi + s)) {
      const bool stuffed = v == 0x00 && prev == 0xFF && j - 1 >= __ldg(lo + s);
      if (!stuffed) c.keep |= 1u << t;
    }
    prev = v;
  }
  return c;
}

// Exclusive prefix sum of `v` over the block; *total receives the sum.
__device__ uint32_t block_exclusive(uint32_t v, uint32_t* warp_sum, uint32_t* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t y = __shfl_up_sync(0xFFFFFFFFu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  uint32_t before = 0, all = 0;
  for (int w = 0; w < kThreads / 32; ++w) {
    const uint32_t ws = warp_sum[w];
    if (w < warp) before += ws;
    all += ws;
  }
  __syncthreads();
  *total = all;
  return before + x - v;
}

__global__ void __launch_bounds__(kThreads)
count_kernel(const uint8_t* __restrict__ raw, int64_t n_raw, const int64_t* __restrict__ lo,
             const int64_t* __restrict__ hi, int64_t n_segs, int64_t* block_sum) {
  __shared__ uint32_t warp_sum[kThreads / 32];
  const int64_t j0 = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * kChunk;
  const Chunk c = load_chunk(raw, n_raw, lo, hi, n_segs, j0);
  uint32_t total;
  block_exclusive(__popc(c.keep), warp_sum, &total);
  if (threadIdx.x == 0) block_sum[blockIdx.x] = total;
}

// block_sum[0 .. n_blocks) -> its exclusive prefix sum, in place, by one block.
__global__ void __launch_bounds__(kThreads)
block_scan_kernel(int64_t* block_sum, int64_t n_blocks) {
  __shared__ uint32_t warp_sum[kThreads / 32];
  int64_t carry = 0;
  for (int64_t at = 0; at < n_blocks; at += kThreads) {
    const int64_t i = at + threadIdx.x;
    const uint32_t v = i < n_blocks ? static_cast<uint32_t>(block_sum[i]) : 0;
    uint32_t total;
    const uint32_t before = block_exclusive(v, warp_sum, &total);
    if (i < n_blocks) block_sum[i] = carry + before;
    carry += total;
  }
}

__global__ void __launch_bounds__(kThreads)
scatter_kernel(const uint8_t* __restrict__ raw, int64_t n_raw, const int64_t* __restrict__ lo,
               const int64_t* __restrict__ hi, int64_t n_segs,
               const int64_t* __restrict__ block_off, uint8_t* __restrict__ out,
               int64_t* __restrict__ seg_off) {
  __shared__ uint32_t warp_sum[kThreads / 32];
  const int64_t j0 = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * kChunk;
  const Chunk c = load_chunk(raw, n_raw, lo, hi, n_segs, j0);
  uint32_t total;
  const uint32_t before = block_exclusive(__popc(c.keep), warp_sum, &total);
  if (j0 > n_raw) return;
  int64_t at = block_off[blockIdx.x] + before;
  // the segments that start in this chunk (an empty last segment starts at
  // n_raw, which the last chunk covers)
  int64_t a = 0, b = n_segs;
  while (a < b) {
    const int64_t mid = (a + b) >> 1;
    if (__ldg(lo + mid) < j0) a = mid + 1; else b = mid;
  }
  for (; a < n_segs && __ldg(lo + a) < j0 + kChunk; ++a) {
    const int t = static_cast<int>(__ldg(lo + a) - j0);
    seg_off[a] = at + __popc(c.keep & ((1u << t) - 1));
  }
  for (int t = 0; t < kChunk; ++t)
    if (c.keep >> t & 1) out[at++] = static_cast<uint8_t>(c.byte(t));
  if (n_raw < j0 + kChunk) {  // the chunk that holds the end
    seg_off[n_segs] = at;
    for (int t = 0; t < 8; ++t) out[at + t] = 0;
  }
}

}  // namespace

// raw[n_raw], lo[n_segs], hi[n_segs] -> out[<= n_raw + 8], seg_off[n_segs + 1];
// block_sum is scratch of (n_raw + 1 + 4095) / 4096 int64.
extern "C" int jdtc_unstuff(const void* raw, int64_t n_raw, const void* lo, const void* hi,
                            int64_t n_segs, void* block_sum, void* out, void* seg_off,
                            void* cuda_stream) {
  cudaStream_t st = static_cast<cudaStream_t>(cuda_stream);
  const int64_t per_block = static_cast<int64_t>(kThreads) * kChunk;
  const int64_t n_blocks = (n_raw + 1 + per_block - 1) / per_block;
  const unsigned blocks = static_cast<unsigned>(n_blocks);
  count_kernel<<<blocks, kThreads, 0, st>>>(
      static_cast<const uint8_t*>(raw), n_raw, static_cast<const int64_t*>(lo),
      static_cast<const int64_t*>(hi), n_segs, static_cast<int64_t*>(block_sum));
  block_scan_kernel<<<1, kThreads, 0, st>>>(static_cast<int64_t*>(block_sum), n_blocks);
  scatter_kernel<<<blocks, kThreads, 0, st>>>(
      static_cast<const uint8_t*>(raw), n_raw, static_cast<const int64_t*>(lo),
      static_cast<const int64_t*>(hi), n_segs, static_cast<const int64_t*>(block_sum),
      static_cast<uint8_t*>(out), static_cast<int64_t*>(seg_off));
  return static_cast<int>(cudaGetLastError());
}
