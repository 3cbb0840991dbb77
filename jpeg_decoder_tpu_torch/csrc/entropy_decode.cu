// K2: Huffman decode of sequential scans, one CUDA thread per restart segment.
//
// Replaces the Mosaic lockstep kernel of jpeg_decoder_tpu/ops/entropy_pallas.py
// (_build_pallas_decode, pallas_call in _build_decode_fn). It computes what
// that kernel computes -- per segment: DC prediction per scan component,
// EXTEND, run/size, int16 zigzag data units, the consumed-bit position and a
// bad-code flag -- and none of its schedule. The 128-lane lockstep, the
// balanced compare tree over scalar thresholds, the one-hot [64,128]
// accumulate and the per-lane DMA windows exist because Mosaic has no
// per-lane scatter; a CUDA thread has one, so each thread walks its segment
// like decode_segment_sequential in native/src/jdt_entropy.cpp and stores
// every data unit straight into its plane through the UnitLayout math.
//
// What bounds it on the H100: a segment is one serial bit chain (each code's
// length says where the next one starts), so the time is one thread's latency
// per symbol -- byte loads into the bit buffer, the 16-compare ladder in
// shared memory, the symbol load -- times the symbols of the longest segment.
// The parallelism is the number of restart segments: 135 threads for one 4K
// image, one warp on each of five SMs, so the card is mostly idle and
// threads of a warp diverge with their data. The design keeps the chain
// short and local: the tables are copied to shared memory once per block,
// the bit buffer is a 64-bit register topped up a byte at a time (one top-up
// covers a code and its extra bits), and stores go straight to the plane.
//
// Batching (entropy_pallas.entropy_decode_batch's counterpart): a launch
// takes every segment of a group of images that share (ri, P, unit
// schedule, Huffman tables), with no cap on their number; eight 4K images
// are 1080 threads. Each thread's segment carries its image and its index
// within that image, and the thread reads that image's unit layout
// (wrap, bw and bh depend on the geometry), total MCU count and plane
// addresses. The per-image unit tables grow with the batch, so they stay in
// global memory and are read through __ldg (L1-cached); only the shared
// Huffman tables (<= 8 x 4 KB) go to shared memory. A single scan is the
// one-image case. Filling the card further (a warp cooperating on a
// segment, split points inside segments) is later work.
//
// Tables: the per-spec canonical "ladder" (thr[16], base[16], symbols[1024])
// that the TPU kernel reads (entropy_pallas._ladder_tables): 4 KB per table,
// so up to 8 tables fit shared memory, where the native runtime's flat LUTs
// (lut16 alone is 128 KB per table) would not.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kUnitCols = 11;   // plane, scomp, dc, ac, h, v, j, k, wrap, bw, bh
constexpr int kTabInts = 16 + 16 + 1024;
constexpr int kInvalid = 0x1FF;
constexpr int kThreads = 32;

struct BitReader {
  const uint8_t* data;
  int64_t nbytes;
  int64_t next;   // bytes loaded so far, including the zeros past the end
  uint64_t buf;   // MSB-aligned bit buffer
  int nbits;

  // At least 57 valid bits afterwards: a code (<= 16) and its extra bits
  // (<= 15) always fit. Bits past the segment's end read as zero.
  __device__ __forceinline__ void fill() {
    while (nbits <= 56) {
      uint64_t b = next < nbytes ? data[next] : 0;
      buf |= b << (56 - nbits);
      nbits += 8;
      ++next;
    }
  }
  __device__ __forceinline__ int peek(int n) const {
    return n ? static_cast<int>(buf >> (64 - n)) : 0;
  }
  __device__ __forceinline__ void consume(int n) {
    buf <<= n;
    nbits -= n;
  }
  __device__ __forceinline__ int64_t consumed() const {
    return next * 8 - nbits;
  }
};

// Canonical decode from the 16-bit peek: len = 1 + #(code16 >= thr[j])
// (capped at 16), index = (code16 >> (16 - len)) + base[len - 1]; an index
// outside the symbol table, or a slot past the last code, is invalid.
__device__ __forceinline__ int decode_sym(BitReader& br, const int32_t* tab) {
  const int code16 = static_cast<int>(br.buf >> 48);
  int len = 1;
#pragma unroll
  for (int j = 0; j < 16; ++j) len += code16 >= tab[j];
  len = len > 16 ? 16 : len;
  const int idx = (code16 >> (16 - len)) + tab[16 + len - 1];
  br.consume(len);
  return (idx < 0 || idx > 1023) ? kInvalid : tab[32 + idx];
}

__device__ __forceinline__ int extend(int v, int size) {
  return size == 0 ? 0 : (v < (1 << (size - 1)) ? v - (1 << size) + 1 : v);
}

// One data unit; du == nullptr for blocks outside the plane. Returns 1 on a
// bad code (invalid prefix, DC size > 15, or a coefficient run past 63).
__device__ int decode_du(BitReader& br, const int32_t* dc, const int32_t* ac,
                         int32_t* pred, int16_t* du) {
  if (du != nullptr) {
    uint4* d = reinterpret_cast<uint4*>(du);
#pragma unroll
    for (int i = 0; i < 8; ++i) d[i] = make_uint4(0, 0, 0, 0);
  }
  br.fill();
  int sym = decode_sym(br, dc);
  if (sym > 15) return 1;
  const int v = br.peek(sym);
  br.consume(sym);
  // int32 wrap, as the TPU kernel's int32 predictor
  *pred = static_cast<int32_t>(static_cast<uint32_t>(*pred) +
                               static_cast<uint32_t>(extend(v, sym)));
  if (du != nullptr) du[0] = static_cast<int16_t>(static_cast<uint16_t>(*pred));

  int k = 1;
  while (k <= 63) {
    br.fill();
    sym = decode_sym(br, ac);
    if (sym == kInvalid) return 1;
    if (sym == 0x00) break;  // EOB
    if (sym == 0xF0) {       // ZRL
      k += 16;
      continue;
    }
    k += sym >> 4;
    if (k > 63) return 1;
    const int size = sym & 15;
    if (size) {
      const int a = br.peek(size);
      br.consume(size);
      if (du != nullptr) du[k] = static_cast<int16_t>(extend(a, size));
    }
    ++k;
  }
  return 0;
}

__global__ void __launch_bounds__(kThreads)
entropy_decode_kernel(const uint8_t* __restrict__ stream,
                      const int64_t* __restrict__ seg_off,
                      const int32_t* __restrict__ seg_img,
                      const int32_t* __restrict__ seg_idx, int64_t n_segs,
                      int64_t ri, const int64_t* __restrict__ total_mcus,
                      const int32_t* __restrict__ units, int n_units,
                      const int32_t* __restrict__ tables, int n_specs,
                      const unsigned long long* __restrict__ plane_ptrs,
                      int64_t* __restrict__ status) {
  extern __shared__ int32_t s_tab[];
  for (int i = threadIdx.x; i < n_specs * kTabInts; i += blockDim.x)
    s_tab[i] = tables[i];
  __syncthreads();

  const int64_t s = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (s >= n_segs) return;
  const int64_t img = seg_img[s];
  const int32_t* img_units = units + img * n_units * kUnitCols;
  const unsigned long long* img_planes = plane_ptrs + img * 4;
  BitReader br{stream + seg_off[s], seg_off[s + 1] - seg_off[s], 0, 0, 0};
  int32_t preds[4] = {0, 0, 0, 0};
  const int64_t total = total_mcus[img];
  const int64_t m_lo = static_cast<int64_t>(seg_idx[s]) * ri;
  const int64_t m_hi = m_lo + ri < total ? m_lo + ri : total;
  int bad = 0;
  for (int64_t m = m_lo; m < m_hi && !bad; ++m) {
    for (int u = 0; u < n_units && !bad; ++u) {
      // plane, scomp, dc, ac, h, v, j, k, wrap, bw, bh
      const int32_t* ul = img_units + u * kUnitCols;
      const int64_t wrap = __ldg(ul + 8);
      const int64_t bw = __ldg(ul + 9);
      const int64_t base = m * __ldg(ul + 4) + __ldg(ul + 7);
      const int64_t bx = base % wrap;
      const int64_t by = (base / wrap) * __ldg(ul + 5) + __ldg(ul + 6);
      int16_t* du =
          (by < __ldg(ul + 10) && bx < bw)
              ? reinterpret_cast<int16_t*>(__ldg(img_planes + __ldg(ul))) + (by * bw + bx) * 64
              : nullptr;
      bad = decode_du(br, s_tab + __ldg(ul + 2) * kTabInts,
                      s_tab + __ldg(ul + 3) * kTabInts, &preds[__ldg(ul + 1)], du);
    }
  }
  status[2 * s] = bad;
  status[2 * s + 1] = br.consumed();
}

}  // namespace

extern "C" int jdtc_entropy_decode(const void* stream, const void* seg_off,
                                   const void* seg_img, const void* seg_idx,
                                   int64_t n_segs, int64_t ri,
                                   const void* total_mcus, const void* units,
                                   int n_units, const void* tables,
                                   int n_specs, const void* plane_ptrs,
                                   void* status, void* cuda_stream) {
  const size_t smem = sizeof(int32_t) * static_cast<size_t>(n_specs) * kTabInts;
  const unsigned blocks = static_cast<unsigned>((n_segs + kThreads - 1) / kThreads);
  entropy_decode_kernel<<<blocks, kThreads, smem,
                          static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<const uint8_t*>(stream), static_cast<const int64_t*>(seg_off),
      static_cast<const int32_t*>(seg_img), static_cast<const int32_t*>(seg_idx),
      n_segs, ri, static_cast<const int64_t*>(total_mcus),
      static_cast<const int32_t*>(units), n_units,
      static_cast<const int32_t*>(tables), n_specs,
      static_cast<const unsigned long long*>(plane_ptrs),
      static_cast<int64_t*>(status));
  return static_cast<int>(cudaGetLastError());
}

// Shared by every entry point's wrapper to name a failed launch.
extern "C" const char* jdtc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
