// K2u: byte unstuffing of restart segments on the card, in one pass.
//
// Replaces the unstuffing that the JAX backend does on the host before its
// entropy kernel runs (jpeg_decoder_tpu/ops/entropy_pallas.py, _pack_group:
// one io/bitstream.unstuff call per restart segment, then a concatenation).
// Input: the raw entropy-coded bytes of the scans of a group and the raw
// bounds [lo, hi) of every restart segment, in stream order (the parser
// finds them; the RSTn markers lie between the bounds). Output: what the
// host built before -- the unstuffed segments back to back, 8 zero bytes of
// tail, and seg_off[n_segs + 1] with segment s at [seg_off[s], seg_off[s+1])
// -- and K2's record layout, sub_base[n_segs + 1]: the index of each
// segment's first subsequence of sub_bytes bytes (at least one a segment),
// so that K2 can follow without the host reading anything back.
//
// A byte is kept iff it lies inside a segment and is not the 0x00 that
// follows a 0xFF of the same segment. Segments are in order, so the place
// of a kept byte is the number of kept bytes before it, whatever its
// segment: one stream compaction over all raw bytes, and seg_off[s] is the
// place of byte lo[s].
//
// What bounds it on the H100: bytes. Every raw byte is read and every kept
// byte written once; the work per byte is a compare or two. The design
// reads each raw byte once and writes each kept byte once, in one kernel:
//   tiles    a block of threads takes a tile of kTile bytes (4096), two
//            aligned 16-byte loads a thread, each thread its own 32 bytes;
//            tile ids come from an atomic counter, so tiles start in order
//            and the look-back below cannot wait on a tile that has not
//            started.
//   bounds   one warp finds, by a 32-way search over `lo`, the segments
//            that touch the tile. A tile that no bound cuts (nearly all:
//            a 4K request has 135 segments over 8 MB) lies inside one
//            segment and tests no bound per byte; the others keep their
//            few bounds in shared memory.
//   mask     on 32-bit words (SWAR): a byte is dropped if it is 0x00, its
//            predecessor 0xFF (the neighbouring thread's last byte, by
//            shuffle) and it does not start its segment.
//   offsets  a block-wide prefix sum of the kept counts, then the tile's
//            output offset by decoupled look-back (Merrill & Garland,
//            "Single-pass Parallel Prefix Scan with Decoupled Look-back",
//            2016): every tile publishes its count at once and its
//            inclusive prefix once known, each as one 64-bit flag-and-value
//            word, and a warp sums its predecessors' words 32 at a time
//            back to the first prefix.
//   stores   the kept bytes are compacted in shared memory at the output
//            offset modulo 16 and written with aligned 16-byte stores; only
//            the first and last 16-byte window of a tile, which it shares
//            with its neighbours, is written byte by byte.
// The tile that holds lo[s] writes seg_off[s]; the tile that holds byte
// n_raw (an empty last segment starts there) writes seg_off[n_segs] and the
// tail. A second, one-block kernel then forms sub_base from seg_off (done
// inside this kernel by its last block instead, it cost more for a batch
// of eight 4K images on an H100).
//
// Without bounds (lo and hi null, n_segs at least 1; one scan, the bytes
// from its first entropy byte to the end of the file) the kernel finds the segments
// itself, by the host's rule (io/bitstream.scan_entropy_span): a 0xFF
// followed by 0x00 is stuffing, by D0-D7 a restart marker (both bytes
// dropped; a segment starts after them), by 0xFF a fill byte (kept, as the
// host's bounds keep it); any other 0xFF, or one in the last byte, ends
// the scan, and nothing from there on is kept. Each 0xFF is judged by the
// byte after it alone, so a tile needs one byte past its end. The
// look-back word then carries the kept bytes, the markers and whether the
// scan ended; the tile of the k-th marker writes seg_off[k + 1] while
// k + 1 < n_segs (the count the header implies), and the tile where the
// scan ends (or the last) writes seg_off[n_segs], the tail, the segments
// found and the byte where the scan ended, in seg_off[n_segs + 1] and
// seg_off[n_segs + 2]. The host reads those back and keeps the result only
// when the count is the header's and the scan ended at EOI.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;

// Exclusive prefix sum of `v` over a block of kT threads; *total receives
// the sum. warp_sum holds kT / 32 values.
template <int kT, typename T>
__device__ T block_exclusive(T v, T* warp_sum, T* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  T before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < kT / 32; ++w) {
    const T ws = warp_sum[w];
    if (w < warp) before += ws;
    all += ws;
  }
  __syncthreads();
  *total = all;
  return before + x - v;
}

// ---------------------------------------------------------------------------
// The single pass
// ---------------------------------------------------------------------------

constexpr int kThreads = 128;               // threads of a block
constexpr int kVecs = 2;                    // 16-byte loads a thread
constexpr int kChunk = 16 * kVecs;          // bytes a thread
constexpr int kTile = kThreads * kChunk;    // bytes a block
constexpr int kSegCap = 64;                 // bounds a tile keeps in shared memory
static_assert(kChunk <= 32, "a thread's masks are 32-bit words");
constexpr uint32_t kAll = kChunk == 32 ? kFull : (1u << kChunk) - 1;

// A tile's look-back word: the top two bits say what the rest holds.
constexpr unsigned long long kAggregate = 1ull << 62;  // the tile's kept count
constexpr unsigned long long kPrefix = 2ull << 62;     // the kept count up to its end
constexpr unsigned long long kValue = (1ull << 62) - 1;
// Without bounds the value has three fields: bit 61 set where the scan
// ended in or before the tile, the kept bytes in bits 30..60 and the
// markers in bits 0..29 (the wrapper takes fewer than 2^31 raw bytes).
constexpr unsigned long long kEnded = 1ull << 61;
constexpr int kKeptShift = 30;
constexpr unsigned long long kMarkers = (1ull << kKeptShift) - 1;
constexpr unsigned long long kCounts = kEnded - 1;

struct Args {
  const uint8_t* raw;
  int64_t n_raw;
  const int64_t* lo;
  const int64_t* hi;
  int64_t n_segs;
  int64_t n_tiles;
  unsigned long long* state;    // [n_tiles], zeroed
  unsigned long long* counter;  // the next tile id, zeroed
  uint8_t* out;
  int64_t* seg_off;
};

__device__ __forceinline__ unsigned long long load_state(const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ void store_state(unsigned long long* p, unsigned long long v) {
  *reinterpret_cast<volatile unsigned long long*>(p) = v;
}

// The first i in [0, n) with v[i] >= x (n if none), by the 32 lanes of a
// warp together: each step probes 32 evenly spaced entries.
__device__ int64_t warp_lower_bound(const int64_t* __restrict__ v, int64_t n, int64_t x,
                                    int lane) {
  int64_t a = 0, b = n;  // the answer lies in [a, b]
  while (a < b) {
    const int64_t step = (b - a + 31) >> 5;
    const int64_t first = a + lane * step;
    const int64_t last = (first + step < b ? first + step : b) - 1;
    const uint32_t ge = __ballot_sync(kFull, first < b && __ldg(v + last) >= x);
    if (ge == 0) return b;
    const int64_t na = a + (__ffs(ge) - 1) * step;
    b = (na + step < b ? na + step : b) - 1;
    a = na;
  }
  return a;
}

// The first i in [0, n) with v[i] >= x (n if none), one thread.
__device__ __forceinline__ int lower_bound(const int64_t* v, int n, int64_t x) {
  int a = 0, b = n;
  while (a < b) {
    const int mid = (a + b) >> 1;
    if (v[mid] < x) a = mid + 1; else b = mid;
  }
  return a;
}

// Bits 0..3: which bytes of m have their top bit set (m's other bits clear).
__device__ __forceinline__ uint32_t top_bits(uint32_t m) {
  return (((m >> 7) * 0x00204081u) >> 21) & 0xF;
}

// Bits a..b-1 (0 <= a < b <= 32).
__device__ __forceinline__ uint32_t bit_range(int a, int b) {
  return (b == 32 ? kFull : (1u << b) - 1) & ~((1u << a) - 1);
}

// kFind: no bounds; the kernel finds the segments (see the top).
template <bool kFind>
__global__ void __launch_bounds__(kThreads) unstuff_kernel(Args g) {
  __shared__ __align__(16) uint8_t buf[kTile + 32];  // the kept bytes, at their offset mod 16
  __shared__ int64_t seg_lo[kSegCap], seg_hi[kSegCap];
  __shared__ uint32_t warp_sum[kThreads / 32];
  __shared__ int64_t s_tile, s_first, s_offset;
  __shared__ int s_count, s_cut;
  // Without bounds: s_count is the tile's first byte that ends the scan
  // (kTile if none), s_first the markers before the tile, s_cut whether
  // the scan ended before the tile.

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_tile = static_cast<int64_t>(atomicAdd(g.counter, 1ull));
  if constexpr (kFind) {
    if (tid == 0) s_count = kTile;
  }
  __syncthreads();
  const int64_t tile = s_tile;
  const int64_t t0 = tile * kTile, t1 = t0 + kTile;
  const int64_t j0 = t0 + static_cast<int64_t>(tid) * kChunk;

  // the chunk's bytes, as little-endian words (zero past the data)
  uint32_t w[kChunk / 4];
  if (j0 + kChunk <= g.n_raw) {
#pragma unroll
    for (int v = 0; v < kVecs; ++v) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(g.raw + j0) + v);
      w[4 * v] = q.x;
      w[4 * v + 1] = q.y;
      w[4 * v + 2] = q.z;
      w[4 * v + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kChunk / 4; ++i) w[i] = 0;
    for (int t = 0; j0 + t < g.n_raw && t < kChunk; ++t)
      w[t >> 2] |= static_cast<uint32_t>(__ldg(g.raw + j0 + t)) << (8 * (t & 3));
  }

  if constexpr (!kFind) {
    // the segments that touch the tile: the one before the first that starts
    // in it, and those that start in it
    if (warp == 0) {
      const int64_t sb = warp_lower_bound(g.lo, g.n_segs, t0, lane);
      const bool none_starts = sb == g.n_segs || __ldg(g.lo + sb) >= t1;
      const bool inside_one = none_starts && sb > 0 && __ldg(g.hi + sb - 1) >= t1;
      int64_t first = sb, count = 0;
      if (!inside_one) {
        const int64_t se = none_starts ? sb : warp_lower_bound(g.lo, g.n_segs, t1, lane);
        first = sb > 0 ? sb - 1 : 0;
        count = se - first;
        if (count <= kSegCap)
          for (int64_t k = lane; k < count; k += 32) {
            seg_lo[k] = __ldg(g.lo + first + k);
            seg_hi[k] = __ldg(g.hi + first + k);
          }
      }
      if (lane == 0) {
        s_cut = !inside_one;
        s_first = first;
        s_count = static_cast<int>(count < 0x7FFFFFFF ? count : 0x7FFFFFFF);
      }
    }
  }

  // SWAR: which bytes are 0x00 and which 0xFF
  uint32_t zero = 0, ff = 0;
#pragma unroll
  for (int i = 0; i < kChunk / 4; ++i) {
    zero |= top_bits(__vcmpeq4(w[i], 0u) & 0x80808080u) << (4 * i);
    ff |= top_bits(__vcmpeq4(w[i], kFull) & 0x80808080u) << (4 * i);
  }
  // whether the byte before the chunk is 0xFF: the lane before's last byte,
  // or a load for a warp's first lane
  const uint32_t left = __shfl_up_sync(kFull, (ff >> (kChunk - 1)) & 1, 1);
  uint32_t prev_ff = left;
  if (lane == 0) prev_ff = j0 > 0 && j0 - 1 < g.n_raw && __ldg(g.raw + j0 - 1) == 0xFF;
  // without bounds: the bytes kept and the markers' 0xFF, before the cut at
  // the end of the scan
  uint32_t kept = 0, marker = 0;
  if constexpr (kFind) {
    constexpr uint32_t kTop = 1u << (kChunk - 1);
    uint32_t dn = 0;  // which bytes are D0-D7
#pragma unroll
    for (int i = 0; i < kChunk / 4; ++i)
      dn |= top_bits(__vcmpeq4(w[i] & 0xF8F8F8F8u, 0xD0D0D0D0u) & 0x80808080u) << (4 * i);
    // the byte after the chunk: the lane after's first byte, or a load for
    // a warp's last lane
    uint32_t after = __shfl_down_sync(kFull, w[0] & 0xFF, 1);
    if (lane == 31) after = j0 + kChunk < g.n_raw ? __ldg(g.raw + j0 + kChunk) : 0;
    const int64_t avail = g.n_raw - j0;  // bytes of the chunk that exist
    const uint32_t valid =
        avail >= kChunk ? kAll : avail <= 0 ? 0u : (1u << static_cast<int>(avail)) - 1;
    const uint32_t has_next = valid >> 1 | (avail > kChunk ? kTop : 0u);
    const uint32_t next_zero = (zero >> 1 | (after == 0x00 ? kTop : 0u)) & has_next;
    const uint32_t next_ff = (ff >> 1 | (after == 0xFF ? kTop : 0u)) & has_next;
    const uint32_t next_dn = (dn >> 1 | ((after & 0xF8) == 0xD0 ? kTop : 0u)) & has_next;
    marker = ff & valid & next_dn;
    const uint32_t ends = ff & valid & ~(next_zero | next_ff | next_dn);
    // dropped: the 0x00 or D0-D7 after a 0xFF, and a marker's 0xFF
    kept = valid & ~(((zero | dn) & ((ff << 1) | prev_ff)) | marker);
    if (ends) atomicMin(&s_count, tid * kChunk + __ffs(ends) - 1);
  }
  __syncthreads();  // the tile's segments

  uint32_t inside = kAll, starts = 0;
  const bool cut = !kFind && s_cut;
  int count = 0;
  const int64_t* slo = seg_lo;
  const int64_t* shi = seg_hi;
  if (cut) {
    count = s_count;
    if (count > kSegCap) {
      slo = g.lo + s_first;
      shi = g.hi + s_first;
    }
    inside = 0;
    // from the last segment that starts before the chunk (it may reach
    // into it) to the last that starts in it
    int k = lower_bound(slo, count, j0);
    for (k = k > 0 ? k - 1 : 0; k < count && slo[k] < j0 + kChunk; ++k) {
      const int64_t l = slo[k], h = shi[k];
      if (l >= j0) starts |= 1u << (l - j0);
      const int a = static_cast<int>((l > j0 ? l : j0) - j0);
      const int64_t e = h < j0 + kChunk ? h : j0 + kChunk;
      if (e > j0 + a) inside |= bit_range(a, static_cast<int>(e - j0));
    }
  }
  const uint32_t stuffed = zero & ((ff << 1) | prev_ff) & ~starts;
  uint32_t keep = inside & ~stuffed;
  uint32_t tally = 0;
  if constexpr (kFind) {
    const int live = s_count - tid * kChunk;  // the chunk's bytes before the end
    const uint32_t before_end =
        live >= kChunk ? kAll : live <= 0 ? 0u : (1u << live) - 1;
    keep = kept & before_end;
    marker &= before_end;
    tally = static_cast<uint32_t>(__popc(marker)) << 16;
  }

  uint32_t total;
  uint32_t before = block_exclusive<kThreads>(static_cast<uint32_t>(__popc(keep)) | tally,
                                              warp_sum, &total);
  // without bounds: the markers before the chunk and in the tile
  uint32_t marks_before = 0, marks = 0;
  if constexpr (kFind) {
    marks_before = before >> 16;
    marks = total >> 16;
    before &= 0xFFFF;
    total &= 0xFFFF;
  }

  // the tile's output offset: decoupled look-back; without bounds the
  // words combine as the scan reads: nothing counts past the end
  if constexpr (kFind) {
    if (warp == 0) {
      const unsigned long long own = (s_count < kTile ? kEnded : 0ull) |
                                     static_cast<unsigned long long>(total) << kKeptShift | marks;
      if (lane == 0) store_state(g.state + tile, (tile == 0 ? kPrefix : kAggregate) | own);
      unsigned long long acc = 0;  // the words before the tile, combined
      if (tile > 0) {
        for (int64_t end = tile;; end -= 32) {
          const int64_t i = end - 1 - lane;
          unsigned long long s = kPrefix;  // before tile 0: an empty prefix
          if (i >= 0) {
            do {
              s = load_state(g.state + i);
            } while ((s >> 62) == 0);
          }
          const uint32_t p = __ballot_sync(kFull, (s >> 62) == 2);
          const int stop = p ? __ffs(p) - 1 : 31;  // the nearest prefix
          // the earliest word up to it where the scan ended (the highest lane)
          const uint32_t e = __ballot_sync(kFull, lane <= stop && (s & kEnded) != 0);
          const int from = e ? 31 - __clz(e) : 0;
          unsigned long long v = lane >= from && lane <= stop ? (s & kCounts) : 0;
#pragma unroll
          for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
          acc = e ? (v | kEnded) : v + acc;
          if (p) break;
        }
        if (lane == 0) store_state(g.state + tile, kPrefix | ((acc & kEnded) ? acc : acc + own));
      }
      if (lane == 0) {
        s_offset = static_cast<int64_t>((acc & kCounts) >> kKeptShift);
        s_first = static_cast<int64_t>(acc & kMarkers);
        s_cut = (acc & kEnded) != 0;
      }
    }
  } else if (warp == 0) {
    if (lane == 0)
      store_state(g.state + tile, (tile == 0 ? kPrefix : kAggregate) | total);
    unsigned long long offset = 0;
    if (tile > 0) {
      for (int64_t end = tile;; end -= 32) {
        const int64_t i = end - 1 - lane;
        unsigned long long s = kPrefix;  // before tile 0: a prefix of 0
        if (i >= 0) {
          do {
            s = load_state(g.state + i);
          } while ((s >> 62) == 0);
        }
        const uint32_t p = __ballot_sync(kFull, (s >> 62) == 2);
        const int stop = p ? __ffs(p) - 1 : 31;  // the nearest prefix
        unsigned long long v = lane <= stop ? (s & kValue) : 0;
#pragma unroll
        for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
        offset += v;
        if (p) break;
      }
      if (lane == 0) store_state(g.state + tile, kPrefix | (offset + total));
    }
    if (lane == 0) s_offset = static_cast<int64_t>(offset);
  }
  __syncthreads();
  const int64_t offset = s_offset;
  const int shift = static_cast<int>(offset & 15);
  const bool last = tile == g.n_tiles - 1;
  if constexpr (kFind) {
    if (s_cut) return;  // the scan ended before the tile: nothing to keep
  }

  // compaction into shared memory, and the offsets of the segments that
  // start in the chunk
  int at = shift + static_cast<int>(before);
#pragma unroll
  for (int t = 0; t < kChunk; ++t)
    if (keep >> t & 1) buf[at++] = static_cast<uint8_t>(w[t >> 2] >> (8 * (t & 3)));
  if (cut && starts) {
    for (int k = lower_bound(slo, count, j0); k < count && slo[k] < j0 + kChunk; ++k) {
      const int t = static_cast<int>(slo[k] - j0);
      g.seg_off[s_first + k] = offset + before + __popc(keep & ((1u << t) - 1));
    }
  }
  if constexpr (kFind) {
    // a segment starts after each marker, at the bytes kept before it
    const int64_t m0 = s_first + marks_before;
    int k = 0;
    for (uint32_t m = marker; m; m &= m - 1, ++k) {
      const int t = __ffs(m) - 1;
      if (m0 + k + 1 < g.n_segs)
        g.seg_off[m0 + k + 1] = offset + before + __popc(keep & ((1u << t) - 1));
    }
    if (tile == 0 && tid == 0) g.seg_off[0] = 0;
  }
  int len = static_cast<int>(total);
  if constexpr (kFind) {
    const bool ended = s_count < kTile;
    if (ended || last) {
      if (tid < 8) buf[shift + total + tid] = 0;
      if (tid == 0) {
        g.seg_off[g.n_segs] = offset + total;
        g.seg_off[g.n_segs + 1] = s_first + marks + 1;                 // segments found
        g.seg_off[g.n_segs + 2] = ended ? t0 + s_count : g.n_raw;     // where the scan ended
      }
      len += 8;
    }
  } else if (last) {
    if (tid < 8) buf[shift + total + tid] = 0;
    if (tid == 0) g.seg_off[g.n_segs] = offset + total;
    len += 8;
  }
  __syncthreads();

  // aligned 16-byte stores; the tile's first and last window byte by byte
  uint8_t* dst = g.out + (offset - shift);
  const int end = shift + len;
  for (int q = 16 * tid; q < end; q += 16 * kThreads) {
    if (q >= shift && q + 16 <= end) {
      *reinterpret_cast<uint4*>(dst + q) = *reinterpret_cast<const uint4*>(buf + q);
    } else {
      for (int t = q > shift ? q : shift; t < q + 16 && t < end; ++t) dst[t] = buf[t];
    }
  }
}

// sub_base[s] = the sum over segments before s of max(1, ceil(len / sub_bytes)),
// s = 0 .. n_segs; one block.
constexpr int kScanThreads = 1024;

__global__ void __launch_bounds__(kScanThreads)
sub_base_kernel(const int64_t* __restrict__ seg_off, int64_t n_segs, int sub_bytes,
                int64_t* __restrict__ sub_base) {
  __shared__ long long warp_sum[kScanThreads / 32];
  long long carry = 0;
  for (int64_t at = 0; at < n_segs; at += kScanThreads) {
    const int64_t i = at + threadIdx.x;
    long long n = 0;
    if (i < n_segs) {
      const long long len = seg_off[i + 1] - seg_off[i];
      n = len > sub_bytes ? (len + sub_bytes - 1) / sub_bytes : 1;
    }
    long long total;
    const long long before = block_exclusive<kScanThreads>(n, warp_sum, &total);
    if (i < n_segs) sub_base[i] = carry + before;
    carry += total;
  }
  if (threadIdx.x == 0) sub_base[n_segs] = carry;
}

}  // namespace

// The bytes of a tile: the wrapper sizes the look-back scratch by it.
extern "C" int jdtc_unstuff_tile_bytes() { return kTile; }

// raw[n_raw], lo[n_segs], hi[n_segs] -> out[n_raw + 8] (the first
// seg_off[n_segs] + 8 bytes defined), seg_off[n_segs + 1],
// sub_base[n_segs + 1]; scratch holds n_raw / kTile + 2 int64 (a word per
// tile and the tile counter), cleared here. With lo and hi null and n_segs
// at least 1 (bounds of no segment may be null too) the kernel finds the
// segments of one scan (see the top): n_segs is the count its header
// implies, n_raw below 2^31, and seg_off holds n_segs + 3 int64: the
// offsets, the segments found, where the scan ended.
extern "C" int jdtc_unstuff(const void* raw, int64_t n_raw, const void* lo, const void* hi,
                            int64_t n_segs, void* scratch, void* out, void* seg_off,
                            void* sub_base, int sub_bytes, void* cuda_stream) {
  if (n_raw < 0 || n_segs < 0 || sub_bytes < 1) return static_cast<int>(cudaErrorInvalidValue);
  const bool find = lo == nullptr && hi == nullptr && n_segs > 0;
  if (find && n_raw >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(cuda_stream);
  Args g;
  g.raw = static_cast<const uint8_t*>(raw);
  g.n_raw = n_raw;
  g.lo = static_cast<const int64_t*>(lo);
  g.hi = static_cast<const int64_t*>(hi);
  g.n_segs = n_segs;
  g.n_tiles = n_raw / kTile + 1;  // byte n_raw belongs to the last tile
  g.state = static_cast<unsigned long long*>(scratch);
  g.counter = g.state + g.n_tiles;
  g.out = static_cast<uint8_t*>(out);
  g.seg_off = static_cast<int64_t*>(seg_off);
  cudaError_t err = cudaMemsetAsync(scratch, 0, sizeof(unsigned long long) * (g.n_tiles + 1), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (find)
    unstuff_kernel<true><<<static_cast<unsigned>(g.n_tiles), kThreads, 0, st>>>(g);
  else
    unstuff_kernel<false><<<static_cast<unsigned>(g.n_tiles), kThreads, 0, st>>>(g);
  sub_base_kernel<<<1, kScanThreads, 0, st>>>(g.seg_off, n_segs, sub_bytes,
                                              static_cast<int64_t*>(sub_base));
  return static_cast<int>(cudaGetLastError());
}
