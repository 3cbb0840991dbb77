// K2: Huffman decode of sequential scans, one CUDA thread per subsequence of
// a restart segment (self-synchronising subsequences, after "Accelerating
// JPEG Decompression on GPUs", arXiv 2111.09219, and the two-pass engine of
// native/src/jdt_entropy.cpp).
//
// Replaces the Mosaic lockstep kernel of jpeg_decoder_tpu/ops/entropy_pallas.py
// (_build_pallas_decode, pallas_call in _build_decode_fn). It computes what
// that kernel computes -- per segment: DC prediction per scan component,
// EXTEND, run/size, int16 zigzag data units, the consumed-bit position and a
// bad-code flag -- and none of its schedule.
//
// What bounds it on the H100: a segment is one serial bit chain (each code's
// length says where the next one starts), so a thread per segment leaves the
// card idle and pays one thread's latency for every symbol of the longest
// segment. Huffman streams resynchronise, though: a decoder started at a
// wrong bit soon falls into step with the right one. So every segment is cut
// into subsequences of kSubBytes bytes, one thread each, and the chain a
// thread walks is a subsequence, not a segment:
//
//   state    (p, u, k): bit position in the segment, unit within the MCU,
//            zigzag position (0: a DC code is next). Two decoders that agree
//            on it decode the same symbols from there on.
//   pass 1   every thread decodes its subsequence from a guessed state
//            (u = 0, k = 0; a segment's first subsequence from the true one),
//            stores nothing, and records the state at which it leaves the
//            subsequence and the data units it completed.
//   pass 2   a thread takes its predecessor's end state and decodes its
//            subsequence again whenever that state is not the one it last
//            started from. A block repeats this among its own threads until
//            none of its records changes; the host repeats the launch until
//            no record of any block changed. A chain from a wrong start may
//            die on a bad code (its record is invalid, and its successor
//            keeps its own chain until a valid state arrives) or run a
//            coefficient past 63 (the data unit ends there, so that the
//            chain lives on and can fall into step). Correctness does not rest on
//            the resynchronisation: the first record of a segment is true
//            and the records form a chain, so the loop runs to the one fixed
//            point, at worst in as many steps as a segment has subsequences.
//   scan     an exclusive prefix sum of the data-unit counts per segment
//            gives every subsequence the index of its first data unit.
//            A segment of at most kScanChunk records takes one block that
//            walks them kThreads at a time; a longer one (a restart-free
//            scan is one segment) a block a chunk of kScanChunk records,
//            the chunks chained by decoupled look-back, as csrc/unstuff.cu
//            does over bytes. The choice is by length: on a 4K request with
//            a marker per MCU row (some 470 records a segment) the chunked
//            pass's staging cost more than the walk.
//   write    every thread decodes its subsequence once more from its true
//            start state and stores coefficients into the zeroed planes
//            through the unit layout; the DC differences go to a compact
//            array per segment, because a block outside the plane stores
//            nothing yet moves the predictor. Only here is a bad code a bad
//            code, and only up to the segment's MCU count: the thread that
//            completes the segment's last data unit reports the consumed
//            bits, and whatever lies beyond is never looked at.
//   dc       the running sum of the differences per scan component, in
//            data-unit order, stored as int16(pred): a block takes a chunk
//            of kDcChunk data units of a segment, a thread a run of kDcRun
//            of them, and the chunks of a segment chain their sums by
//            decoupled look-back, a chain per scan component; the serial
//            design's int32 predictor wrapped and kept its low 16 bits, so
//            the sum is taken modulo 2^16. A segment with a marker per MCU
//            row of a 4K frame (1,440 data units) is one chunk and looks
//            back at nothing; a restart-free 4K 4:2:0 scan (194,400) is 48
//            chunks, where a warp per component walked it alone before.
//
// The symbol step: a first-level table in shared memory, indexed by the
// next kLutBits bits (symbol and length in 16 bits, 2 KB a table), built once
// per call from the ladder tables; codes longer than that walk the ladder
// (thr[16], base[16], symbols[1024], entropy_pallas._ladder_tables) through
// __ldg. The bit buffer is a 64-bit register refilled by aligned 32-bit
// words; threads of a warp own neighbouring subsequences, so their words
// share cache lines, and the word for the next refill is loaded one refill
// ahead. Bits past a segment's end read as zero.
//
// What bounds the design itself: pass 2. Its time is the longest chain that
// has to be walked before it falls into step, a subsequence a step, at a
// lone thread's pace (some 200 ns a symbol: every instruction of the symbol
// step waits for the one before). Dense blocks with few EOBs resynchronise
// slowly; sparse ones, as photographs give, within a subsequence or two.
// The subsequence size trades the steps against the length of each (64,
// 128 and 256 bytes come within a fifth of each other on a 4K request;
// benchmarks/k2_sweep.py); 128 bytes are fixed here.
//
// The DEVICE route (jpeg_decoder_tpu/ops/entropy_device.py's lane-per-segment
// while_loop) runs these same kernels: nothing here depends on the length
// of a segment beyond 2^28 bytes (a record's 32-bit bit position) and 2^32
// data units, so a restart-free scan of any size is one segment cut into
// as many subsequences, scan chunks and dc chunks as it needs.
//
// Batching (entropy_pallas.entropy_decode_batch's counterpart): a launch
// takes every segment of a group of images that share (ri, P, unit
// schedule, Huffman tables). A block serves one segment (blockIdx.x) and a
// run of kThreads of its subsequences (blockIdx.y), so the segment's image,
// unit layout and bounds are loaded once per block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kUnitCols = 11;   // plane, scomp, dc, ac, h, v, j, k, wrap, bw, bh
constexpr int kTabInts = 16 + 16 + 1024;
constexpr int kInvalid = 0x1FF;
constexpr int kThreads = 256;
constexpr int kSubBytes = 128;  // bytes of a subsequence
constexpr int kLutBits = 10;
constexpr int kLutSize = 1 << kLutBits;
constexpr int kMaxSpecs = 8;
constexpr int kMaxUnits = 10;
constexpr int kScanRun = 8;                      // records a thread of the scan pass
constexpr int kScanChunk = kThreads * kScanRun;  // records a block of the scan pass
constexpr int kDcRun = 16;                       // data units a thread of the dc pass
constexpr int kDcChunk = kThreads * kDcRun;      // data units a block of the dc pass
constexpr unsigned kFull = 0xFFFFFFFFu;

// A chunk's look-back word (scan and dc passes): the top two bits say what
// the rest holds.
constexpr unsigned long long kAggregate = 1ull << 62;  // the chunk's own sum
constexpr unsigned long long kPrefix = 2ull << 62;     // the sum up to its end
constexpr unsigned long long kValue = (1ull << 62) - 1;

// A record, one 64-bit word so that it is read and written whole:
// bits 63..32 p, 31..16 data units completed, 15..12 u, 11..6 k, 0 invalid.
// A state is a record with the count cleared.
constexpr uint64_t kCountMask = 0x00000000FFFF0000ull;
constexpr uint64_t kInvalidRec = 1ull;

__device__ __forceinline__ uint64_t pack_rec(uint32_t p, uint32_t count, int u, int k) {
  return (static_cast<uint64_t>(p) << 32) | (static_cast<uint64_t>(count & 0xFFFF) << 16) |
         (static_cast<uint64_t>(u) << 12) | (static_cast<uint64_t>(k) << 6);
}
__device__ __forceinline__ uint64_t state_of(uint64_t rec) { return rec & ~kCountMask; }
__device__ __forceinline__ uint32_t count_of(uint64_t rec) {
  return static_cast<uint32_t>(rec >> 16) & 0xFFFF;
}

// MSB-first reader over bytes [begin, end) of the stream, by aligned words.
// A dependent symbol costs a lone thread some 4 to 5 cycles an instruction,
// so the reader keeps the common path short: 32-bit peeks from the buffer's
// high half, one compare before a load, pointers instead of 64-bit indices.
struct BitReader {
  const uint32_t* words;     // the stream
  const uint32_t* full_end;  // the first word not wholly inside the segment
  int64_t end;               // the segment's end, in bytes of the stream
  const uint32_t* nextp;     // the next word to merge
  uint32_t ahead;            // that word, loaded ahead
  uint64_t buf;              // MSB-aligned bit buffer
  int nbits;                 // valid bits in buf
  uint32_t consumed;         // bits consumed since start()

  // The word at w, big-endian; bytes past the segment's end read as zero.
  __device__ __forceinline__ uint32_t load(const uint32_t* w) const {
    if (w < full_end) return __byte_perm(__ldg(w), 0, 0x0123);
    const int64_t b = (w - words) * 4;
    if (b >= end) return 0;
    return __byte_perm(__ldg(w), 0, 0x0123) & (0xFFFFFFFFu << (8 * static_cast<int>(b + 4 - end)));
  }
  __device__ __forceinline__ void start(const uint8_t* stream, int64_t begin, int64_t end_,
                                        uint32_t p) {
    words = reinterpret_cast<const uint32_t*>(stream);
    end = end_;
    full_end = words + (end_ >> 2);
    const int64_t byte = begin + (p >> 3);
    const uint32_t* w = words + (byte >> 2);
    const int off = static_cast<int>(byte & 3) * 8 + static_cast<int>(p & 7);
    buf = ((static_cast<uint64_t>(load(w)) << 32) | load(w + 1)) << off;
    nbits = 64 - off;
    nextp = w + 2;
    ahead = load(nextp);
    consumed = 0;
  }
  // At least 33 valid bits afterwards: a code (<= 16) and its extra bits
  // (<= 15) always fit. The word merged was loaded at the refill before,
  // so its latency is off the chain of dependent symbols.
  __device__ __forceinline__ void fill() {
    if (nbits <= 32) {
      buf |= static_cast<uint64_t>(ahead) << (32 - nbits);
      nbits += 32;
      ahead = load(++nextp);
    }
  }
  __device__ __forceinline__ uint32_t high() const { return static_cast<uint32_t>(buf >> 32); }
  __device__ __forceinline__ void consume(int n) {  // n <= 31
    buf <<= n;
    nbits -= n;
    consumed += n;
  }
};

// Canonical decode from the 16-bit peek: len = 1 + #(code16 >= thr[j])
// (capped at 16), index = (code16 >> (16 - len)) + base[len - 1]; an index
// outside the symbol table, or a slot past the last code, is invalid.
__device__ int ladder_sym(const int32_t* __restrict__ tab, int code16, int* len_out) {
  int len = 1;
#pragma unroll
  for (int j = 0; j < 16; ++j) len += code16 >= __ldg(tab + j);
  len = len > 16 ? 16 : len;
  const int idx = (code16 >> (16 - len)) + __ldg(tab + 16 + len - 1);
  *len_out = len;
  return (idx < 0 || idx > 1023) ? kInvalid : __ldg(tab + 32 + idx);
}

// One symbol and its code length (nothing is consumed) from the buffer's
// high 32 bits: the first-level table, then the ladder for longer codes.
__device__ __forceinline__ int decode_sym(uint32_t high, const uint16_t* lut,
                                          const int32_t* __restrict__ tab, int* len) {
  const uint32_t e = lut[high >> (32 - kLutBits)];
  *len = e >> 9;
  if (*len == 0) return ladder_sym(tab, static_cast<int>(high >> 16), len);
  return e & 0x1FF;
}

// The `size` bits (0..15) that follow the first `len` bits of `high`.
__device__ __forceinline__ int value_bits(uint32_t high, int len, int size) {
  return static_cast<int>(((high << len) >> 1) >> (31 - size));
}

__device__ __forceinline__ int extend(int v, int size) {
  return size == 0 ? 0 : (v < (1 << (size - 1)) ? v - (1 << size) + 1 : v);
}

// What a block knows of its segment and of the call.
struct Segment {
  const uint8_t* stream;
  int64_t begin, end;      // the segment's bytes in the stream
  uint32_t total_du;       // its data units: its MCUs x n_units
  uint32_t m_lo;           // its first MCU, in its image
  int64_t du_base;         // its first slot in the difference array
  const unsigned long long* planes;  // its image's plane addresses
  const int32_t* units;    // its image's unit layout (shared or global memory)
  int n_units;
};

struct Call {
  const uint8_t* stream;
  const int64_t* seg_off;
  const int32_t* seg_img;
  const int32_t* seg_idx;
  int64_t ri;
  const int64_t* total_mcus;
  const int32_t* units;
  int n_units;
  const int32_t* tables;
  int n_specs;
  const unsigned long long* plane_ptrs;
  int64_t* status;
  const int64_t* sub_base;     // [n_segs + 1] first record of each segment
  const int64_t* du_base_img;  // [n_img] first difference slot of each image
  unsigned long long* rec;     // [n_subs] records
  unsigned long long* used;    // [n_subs] the state each record was decoded from
  uint32_t* first_du;          // [n_subs] index of the first data unit
  int16_t* dcdiff;             // DC differences, data-unit order
  uint16_t* lut;               // [n_specs, kLutSize] first-level tables
  int* flag;                   // pass 2: the most steps a block took that replaced a record
  int64_t n_segs;
  unsigned long long* tickets;     // [2] the next chunk of the scan and dc passes, zeroed
  unsigned long long* scan_state;  // [n_segs][scan_chunks] look-back words, zeroed
  int64_t scan_chunks;             // chunks of the longest segment's records
  unsigned long long* dc_state;    // [n_segs][dc_chunks][4] look-back words, zeroed
  int64_t dc_chunks;               // chunks of the longest segment's data units
};

__device__ __forceinline__ Segment segment_of(const Call& c, int64_t s,
                                              const int32_t* units) {
  Segment seg;
  const int64_t img = __ldg(c.seg_img + s);
  seg.stream = c.stream;
  seg.begin = __ldg(c.seg_off + s);
  seg.end = __ldg(c.seg_off + s + 1);
  const int64_t total = __ldg(c.total_mcus + img);
  const int64_t m_lo = static_cast<int64_t>(__ldg(c.seg_idx + s)) * c.ri;
  int64_t mcus = total - m_lo < c.ri ? total - m_lo : c.ri;
  if (mcus < 0 || m_lo < 0) mcus = 0;  // a segment past its image decodes nothing
  seg.total_du = static_cast<uint32_t>(mcus * c.n_units);
  seg.m_lo = static_cast<uint32_t>(m_lo);
  seg.du_base = __ldg(c.du_base_img + img) + m_lo * c.n_units;
  seg.planes = c.plane_ptrs + img * 4;
  seg.units = units != nullptr ? units : c.units + img * c.n_units * kUnitCols;
  seg.n_units = c.n_units;
  return seg;
}

// Address of data unit u of MCU m in its plane, or nullptr outside the plane.
__device__ __forceinline__ int16_t* du_address(const Segment& seg, const int32_t* ul,
                                               uint32_t m) {
  const uint32_t wrap = ul[8], bw = ul[9];
  const uint32_t base = m * ul[4] + ul[7];
  const uint32_t bx = base % wrap;
  const uint32_t by = (base / wrap) * ul[5] + ul[6];
  if (by >= static_cast<uint32_t>(ul[10]) || bx >= bw) return nullptr;
  return reinterpret_cast<int16_t*>(seg.planes[ul[0]]) +
         (static_cast<int64_t>(by) * bw + bx) * 64;
}

// Decode from state `in` until the position reaches end_bit at a symbol
// boundary, or max_du data units are complete, or a code is bad (invalid
// prefix, DC size > 15, a coefficient run past 63). Returns the record: end
// state and count, or invalid with the count before the bad code. WRITE:
// `first_du` is the index of the data unit the state stands in;
// coefficients go to the planes, DC differences to dcdiff, and the thread
// that completes the last of its max_du data units stores the consumed bits.
template <bool WRITE>
__device__ uint64_t decode_sub(const Segment& seg, const uint16_t* s_lut,
                               const int32_t* __restrict__ tables, uint64_t in,
                               uint32_t end_bit, uint32_t max_du, uint32_t first_du,
                               int16_t* __restrict__ dcdiff, int64_t* seg_status) {
  if (in & kInvalidRec) return kInvalidRec;
  const uint32_t p0 = static_cast<uint32_t>(in >> 32);
  // bits from the start state to the subsequence's end
  const uint32_t span = end_bit > p0 ? end_bit - p0 : 0;
  BitReader br;
  br.start(seg.stream, seg.begin, seg.end, p0);
  int u = static_cast<int>(in >> 12) & 15;
  int k = static_cast<int>(in >> 6) & 63;
  uint32_t count = 0;
  // the unit's layout row and tables, looked up once a data unit
  const int32_t* ul;
  const uint16_t *dc_lut, *ac_lut;
  const int32_t *dc_tab, *ac_tab;
  auto set_unit = [&]() {
    ul = seg.units + u * kUnitCols;
    const int dc = ul[2], ac = ul[3];
    dc_lut = s_lut + dc * kLutSize;
    ac_lut = s_lut + ac * kLutSize;
    dc_tab = tables + dc * kTabInts;
    ac_tab = tables + ac * kTabInts;
  };
  set_unit();
  uint32_t m = 0;
  int16_t* du = nullptr;
  if (WRITE) {
    m = seg.m_lo + first_du / seg.n_units;
    du = du_address(seg, ul, m);
  }
  // A symbol's code and extra bits leave the buffer in one shift: the chain
  // from symbol to symbol is peek, table, add, shift. The value is cut
  // beside it, and only the write pass looks at it.
  while (count < max_du && br.consumed < span) {
    br.fill();
    const uint32_t high = br.high();
    int len;
    if (k == 0) {
      const int sym = decode_sym(high, dc_lut, dc_tab, &len);
      if (sym > 15) {
        if (WRITE) seg_status[0] = 1;
        return kInvalidRec | (static_cast<uint64_t>(count) << 16);
      }
      br.consume(len + sym);
      if (WRITE)
        dcdiff[seg.du_base + first_du + count] =
            static_cast<int16_t>(extend(value_bits(high, len, sym), sym));
      k = 1;
      continue;
    }
    const int sym = decode_sym(high, ac_lut, ac_tab, &len);
    const int size = sym & 15;
    if (size != 0 && sym != kInvalid) {  // a coefficient after a run
      k += sym >> 4;
      // A run past 63 is a bad code only in the write pass: from a wrong
      // start it is expected, and the data unit ends there so that the
      // chain lives on and can fall into step.
      if (WRITE && k > 63) {
        seg_status[0] = 1;
        return kInvalidRec | (static_cast<uint64_t>(count) << 16);
      }
      br.consume(len + size);
      if (WRITE && du != nullptr)
        du[k] = static_cast<int16_t>(extend(value_bits(high, len, size), size));
      ++k;
    } else if (sym == 0x00) {  // EOB
      k = 64;
      br.consume(len);
    } else if (sym == 0xF0) {  // ZRL
      k += 16;
      br.consume(len);
    } else if (sym == kInvalid) {
      if (WRITE) seg_status[0] = 1;
      return kInvalidRec | (static_cast<uint64_t>(count) << 16);
    } else {  // a run with no coefficient (size 0): the position moves on
      k += (sym >> 4) + 1;
      if (WRITE && k > 64) {
        seg_status[0] = 1;
        return kInvalidRec | (static_cast<uint64_t>(count) << 16);
      }
      br.consume(len);
    }
    if (k > 63) {  // the data unit is complete
      k = 0;
      ++count;
      if (++u == seg.n_units) {
        u = 0;
        ++m;
      }
      set_unit();
      if (WRITE && count < max_du) du = du_address(seg, ul, m);
    }
  }
  if (WRITE && count == max_du) seg_status[1] = p0 + br.consumed;
  return pack_rec(p0 + br.consumed, count, u, k);
}

// The first-level tables of the call, from the ladder tables: entry =
// symbol | length << 9 for a code of at most kLutBits bits, 0 for a longer
// or invalid one. thr[j] for j < kLutBits is a multiple of 2^(16 - kLutBits),
// so the compares see what they would see with all 16 bits.
__global__ void build_lut_kernel(const int32_t* __restrict__ tables, uint16_t* lut) {
  const int32_t* tab = tables + blockIdx.x * kTabInts;
  for (int c = threadIdx.x; c < kLutSize; c += blockDim.x) {
    const int code16 = c << (16 - kLutBits);
    int len = 1;
    for (int j = 0; j < kLutBits; ++j) len += code16 >= tab[j];
    uint16_t e = 0;
    if (len <= kLutBits) {
      const int idx = (code16 >> (16 - len)) + tab[16 + len - 1];
      const int sym = (idx < 0 || idx > 1023) ? kInvalid : tab[32 + idx];
      e = static_cast<uint16_t>(sym | (len << 9));
    }
    lut[blockIdx.x * kLutSize + c] = e;
  }
}

// Shared state of a decoding block: the call's first-level tables and the
// unit layout of the segment's image.
struct BlockTables {
  uint16_t lut[kMaxSpecs * kLutSize];
  int32_t units[kMaxUnits * kUnitCols];
};

__device__ __forceinline__ void load_block_tables(const Call& c, int64_t s, BlockTables& t) {
  const uint32_t* src = reinterpret_cast<const uint32_t*>(c.lut);
  uint32_t* dst = reinterpret_cast<uint32_t*>(t.lut);
  for (int i = threadIdx.x; i < c.n_specs * kLutSize / 2; i += blockDim.x) dst[i] = src[i];
  const int32_t* img_units =
      c.units + static_cast<int64_t>(__ldg(c.seg_img + s)) * c.n_units * kUnitCols;
  for (int i = threadIdx.x; i < c.n_units * kUnitCols; i += blockDim.x)
    t.units[i] = img_units[i];
  __syncthreads();
}

// The bit at which subsequence `local` of `nsub` ends. The last one ends
// with the segment's bytes while the chains are sought (passes 1 and 2: a
// chain from a wrong start would otherwise decode zeros up to the MCU
// count, a segment's worth of symbols in one thread); in the write pass it
// runs on to the segment's MCU count, wherever that is, alone: past the end
// only if the segment is truncated.
template <bool WRITE>
__device__ __forceinline__ uint32_t end_bit_of(const Segment& seg, int64_t local,
                                               int64_t nsub) {
  if (local + 1 < nsub) return static_cast<uint32_t>((local + 1) * kSubBytes * 8);
  return WRITE ? 0xFFFFFFFFu : static_cast<uint32_t>((seg.end - seg.begin) * 8);
}

__global__ void __launch_bounds__(kThreads) pass1_kernel(Call c) {
  __shared__ BlockTables t;
  const int64_t s = blockIdx.x;
  const int64_t sub0 = __ldg(c.sub_base + s);
  const int64_t nsub = __ldg(c.sub_base + s + 1) - sub0;
  if (static_cast<int64_t>(blockIdx.y) * kThreads >= nsub) return;
  load_block_tables(c, s, t);
  const int64_t local = static_cast<int64_t>(blockIdx.y) * kThreads + threadIdx.x;
  if (local >= nsub) return;
  const Segment seg = segment_of(c, s, t.units);
  // the guess: a DC code of unit 0 starts at the subsequence's first bit
  // (true for the segment's first subsequence)
  const uint64_t in = pack_rec(static_cast<uint32_t>(local * kSubBytes * 8), 0, 0, 0);
  c.used[sub0 + local] = in;
  c.rec[sub0 + local] = decode_sub<false>(seg, t.lut, c.tables, in,
                                          end_bit_of<false>(seg, local, nsub),
                                          seg.total_du, 0, nullptr, nullptr);
}

__global__ void __launch_bounds__(kThreads) pass2_kernel(Call c) {
  __shared__ BlockTables t;
  const int64_t s = blockIdx.x;
  const int64_t sub0 = __ldg(c.sub_base + s);
  const int64_t nsub = __ldg(c.sub_base + s + 1) - sub0;
  if (static_cast<int64_t>(blockIdx.y) * kThreads >= nsub) return;
  load_block_tables(c, s, t);
  const int64_t local = static_cast<int64_t>(blockIdx.y) * kThreads + threadIdx.x;
  const bool active = local > 0 && local < nsub;
  const Segment seg = segment_of(c, s, t.units);
  const int64_t i = sub0 + local;
  uint64_t used = 0, rec = 0;
  if (active) {
    used = c.used[i];
    rec = c.rec[i];
  }
  int steps = 0;  // the block's steps that replaced a record
  for (;;) {
    int changed = 0;
    if (active) {
      // read around L1: the predecessor may belong to another block
      const uint64_t in = state_of(__ldcg(c.rec + i - 1));
      // an invalid predecessor says nothing: the thread keeps its own chain
      if (!(in & kInvalidRec) && in != used) {
        used = in;
        const uint64_t out = decode_sub<false>(seg, t.lut, c.tables, in,
                                               end_bit_of<false>(seg, local, nsub),
                                               seg.total_du, 0,
                                               nullptr, nullptr);
        if (out != rec) {
          rec = out;
          __stcg(c.rec + i, out);
          changed = 1;
        }
      }
    }
    // a barrier too: the block's stores above are visible to its loads below
    if (!__syncthreads_or(changed)) break;
    ++steps;
  }
  if (active) c.used[i] = used;
  if (threadIdx.x == 0 && steps) atomicMax(c.flag, steps);
}

// Exclusive prefix sum of the records' counts within each segment, a block
// per segment walking its records kThreads at a time: the scan pass where
// every segment is one chunk of records, and for measurement (the
// wrapper's `earlier_tail`) where it is not.
__global__ void __launch_bounds__(kThreads) scan_segment_kernel(Call c) {
  __shared__ uint32_t warp_sum[kThreads / 32];
  const int64_t s = blockIdx.x;
  const int64_t sub0 = __ldg(c.sub_base + s);
  const int64_t nsub = __ldg(c.sub_base + s + 1) - sub0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t carry = 0;
  for (int64_t at = 0; at < nsub; at += kThreads) {
    const int64_t local = at + threadIdx.x;
    const uint32_t v = local < nsub ? count_of(c.rec[sub0 + local]) : 0;
    uint32_t x = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t y = __shfl_up_sync(0xFFFFFFFFu, x, d);
      if (lane >= d) x += y;
    }
    if (lane == 31) warp_sum[warp] = x;
    __syncthreads();
    uint32_t before = 0, all = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
      const uint32_t ws = warp_sum[w];
      if (w < warp) before += ws;
      all += ws;
    }
    if (local < nsub) c.first_du[sub0 + local] = carry + before + x - v;
    carry += all;
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads) write_kernel(Call c) {
  __shared__ BlockTables t;
  const int64_t s = blockIdx.x;
  const int64_t sub0 = __ldg(c.sub_base + s);
  const int64_t nsub = __ldg(c.sub_base + s + 1) - sub0;
  if (static_cast<int64_t>(blockIdx.y) * kThreads >= nsub) return;
  load_block_tables(c, s, t);
  const int64_t local = static_cast<int64_t>(blockIdx.y) * kThreads + threadIdx.x;
  if (local >= nsub) return;
  const Segment seg = segment_of(c, s, t.units);
  const int64_t i = sub0 + local;
  const uint64_t in = local == 0 ? 0 : state_of(c.rec[i - 1]);
  const uint32_t first = c.first_du[i];
  // past a bad code, or past the segment's last data unit: nothing to do
  if ((in & kInvalidRec) || first >= seg.total_du) return;
  decode_sub<true>(seg, t.lut, c.tables, in, end_bit_of<true>(seg, local, nsub),
                   seg.total_du - first, first, c.dcdiff, c.status + 2 * s);
}

// The earlier dc pass, kept for measurement (the wrapper's `earlier_tail`):
// warp w of a block takes scan component w of the block's segment, walks
// the segment's data units 32 at a time, and stores int16(pred) for the
// blocks inside the plane.
__global__ void __launch_bounds__(128) dc_segment_kernel(Call c) {
  const int64_t s = blockIdx.x;
  if (c.status[2 * s] != 0) return;
  const Segment seg = segment_of(c, s, nullptr);
  const int lane = threadIdx.x & 31, comp = threadIdx.x >> 5;
  bool any = false;
  for (int u = 0; u < seg.n_units; ++u) any |= seg.units[u * kUnitCols + 1] == comp;
  if (!any) return;
  uint32_t pred = 0;
  for (uint32_t at = 0; at < seg.total_du; at += 32) {
    const uint32_t d = at + lane;
    const uint32_t u = d % seg.n_units;
    const int32_t* ul = seg.units + u * kUnitCols;
    const bool mine = d < seg.total_du && ul[1] == comp;
    const uint32_t v = mine ? static_cast<uint32_t>(static_cast<int32_t>(c.dcdiff[seg.du_base + d])) : 0;
    uint32_t x = v;
#pragma unroll
    for (int k = 1; k < 32; k <<= 1) {
      const uint32_t y = __shfl_up_sync(0xFFFFFFFFu, x, k);
      if (lane >= k) x += y;
    }
    if (mine) {
      int16_t* du = du_address(seg, ul, seg.m_lo + d / seg.n_units);
      if (du != nullptr) du[0] = static_cast<int16_t>(static_cast<uint16_t>(pred + x));
    }
    pred += __shfl_sync(0xFFFFFFFFu, x, 31);
  }
}

__device__ __forceinline__ unsigned long long load_state(const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ void store_state(unsigned long long* p, unsigned long long v) {
  *reinterpret_cast<volatile unsigned long long*>(p) = v;
}

// Exclusive prefix of x over the block's threads, in thread order; *total
// receives the block's sum. Every thread of the block calls it.
template <typename T>
__device__ __forceinline__ T block_exclusive(T x, T* warp_sum, T* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T v = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  T before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    const T ws = warp_sum[w];
    if (w < warp) before += ws;
    all += ws;
  }
  __syncthreads();  // warp_sum may be used again
  *total = all;
  return before + x - v;
}

// The sum, within `mask`, of the values of chunks [0, chunk) of one chain
// (chunk j's word at state[j * stride]), by the 32 lanes of a warp: each
// round reads the 32 words before the last one read, waits until each is
// published, and stops at the nearest inclusive prefix (decoupled
// look-back, Merrill & Garland). Chunks take their ids from a counter, in
// order, so every chunk waited for belongs to a block that runs or ran.
__device__ unsigned long long look_back(const unsigned long long* state, int64_t stride,
                                        int64_t chunk, unsigned long long mask, int lane) {
  unsigned long long sum = 0;
  for (int64_t end = chunk;; end -= 32) {
    const int64_t i = end - 1 - lane;
    unsigned long long s = kPrefix;  // before chunk 0: a prefix of 0
    if (i >= 0) {
      do {
        s = load_state(state + i * stride);
      } while ((s >> 62) == 0);
    }
    const uint32_t p = __ballot_sync(kFull, (s >> 62) == 2);
    const int stop = p ? __ffs(p) - 1 : 31;  // the nearest prefix
    unsigned long long v = lane <= stop ? (s & kValue) : 0;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
    sum = (sum + v) & mask;
    if (p) return sum;
  }
}

// The chunk a block of the scan or dc pass takes: chunk id / n_segs of
// segment id % n_segs. Where segments are chained (more than one chunk),
// the ids come from a counter in launch order, so that the chunks a
// segment's look-back waits for were handed out before its own; where
// every segment is one chunk of the dc pass (a restart interval of a few
// MCU rows), no block waits for another and the id is the block's.
__device__ __forceinline__ int64_t next_chunk(unsigned long long* ticket, bool chained,
                                              int64_t* s_id) {
  if (!chained) return blockIdx.x;
  if (threadIdx.x == 0) *s_id = static_cast<int64_t>(atomicAdd(ticket, 1ull));
  __syncthreads();
  return *s_id;
}

// A padded index into a chunk staged in shared memory: thread t's run of
// kScanRun words, t * kScanRun + r, spread over the banks.
__device__ __forceinline__ int staged(int i) { return i + (i >> 5); }

// Exclusive prefix sum of the records' counts within each segment where a
// segment is more than one chunk: a block per chunk of kScanChunk records,
// staged through shared memory (loads and stores coalesced), a thread a run
// of kScanRun of them, the chunks of a segment chained by look-back.
__global__ void __launch_bounds__(kThreads) scan_kernel(Call c) {
  __shared__ uint32_t warp_sum[kThreads / 32];
  __shared__ uint32_t counts[kScanChunk + kScanChunk / 32];
  __shared__ int64_t s_id;
  __shared__ uint32_t s_before;
  const int64_t id = next_chunk(c.tickets, true, &s_id);
  const int64_t s = id % c.n_segs, chunk = id / c.n_segs;
  const int64_t sub0 = __ldg(c.sub_base + s);
  const int64_t nsub = __ldg(c.sub_base + s + 1) - sub0;
  const int64_t base = chunk * kScanChunk;
  if (base >= nsub) return;
  const int n = nsub - base < kScanChunk ? static_cast<int>(nsub - base) : kScanChunk;
  for (int i = threadIdx.x; i < n; i += kThreads) counts[staged(i)] = count_of(c.rec[sub0 + base + i]);
  __syncthreads();
  const int first = threadIdx.x * kScanRun;
  uint32_t v[kScanRun], sum = 0;
#pragma unroll
  for (int r = 0; r < kScanRun; ++r) {
    v[r] = first + r < n ? counts[staged(first + r)] : 0;
    sum += v[r];
  }
  uint32_t total;
  const uint32_t before = block_exclusive<uint32_t>(sum, warp_sum, &total);
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    unsigned long long* chain = c.scan_state + s * c.scan_chunks;
    if (lane == 0) store_state(chain + chunk, (chunk == 0 ? kPrefix : kAggregate) | total);
    uint32_t prefix = 0;
    if (chunk > 0) {
      prefix = static_cast<uint32_t>(look_back(chain, 1, chunk, 0xFFFFFFFFull, lane));
      if (lane == 0) store_state(chain + chunk, kPrefix | static_cast<uint32_t>(prefix + total));
    }
    if (lane == 0) s_before = prefix;
  }
  __syncthreads();
  uint32_t at = s_before + before;
#pragma unroll
  for (int r = 0; r < kScanRun; ++r) {
    if (first + r < n) counts[staged(first + r)] = at;
    at += v[r];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += kThreads) c.first_du[sub0 + base + i] = counts[staged(i)];
}

// Scan component u's difference x (as 16 bits) in the field of its
// component: components 0 and 1 in the low and high words of one 64-bit
// sum, 2 and 3 in another, so that a chunk's carries stay in their field.
__device__ __forceinline__ void add_dc(int comp, uint32_t x, unsigned long long* s01,
                                       unsigned long long* s23) {
  const unsigned long long w = comp & 1 ? static_cast<unsigned long long>(x) << 32 : x;
  if (comp < 2) *s01 += w; else *s23 += w;
}

__device__ __forceinline__ uint32_t dc_field(unsigned long long s01, unsigned long long s23,
                                             int comp) {
  const unsigned long long w = comp < 2 ? s01 : s23;
  return static_cast<uint32_t>(comp & 1 ? w >> 32 : w) & 0xFFFF;
}

// The DC running sums: a block per chunk of kDcChunk data units of a
// segment, a thread a run of kDcRun of them. The thread's sums per scan
// component, the block's exclusive prefix of them, the chunk's prefix by
// look-back (warp w the chain of component w), then the run walked again,
// storing int16(pred) for the blocks inside the plane.
__global__ void __launch_bounds__(kThreads) dc_kernel(Call c) {
  __shared__ unsigned long long warp_sum[kThreads / 32];
  __shared__ int32_t s_units[kMaxUnits * kUnitCols];
  __shared__ int64_t s_id;
  __shared__ uint32_t s_before[4];
  const int64_t id = next_chunk(c.tickets + 1, c.dc_chunks > 1, &s_id);
  const int64_t s = id % c.n_segs, chunk = id / c.n_segs;
  // a bad segment's planes are not looked at (check_status raises): every
  // chunk of it returns here, so none waits for another
  if (c.status[2 * s] != 0) return;
  Segment seg = segment_of(c, s, nullptr);
  if (chunk * kDcChunk >= seg.total_du) return;
  for (int i = threadIdx.x; i < seg.n_units * kUnitCols; i += blockDim.x) s_units[i] = seg.units[i];
  __syncthreads();
  seg.units = s_units;
  const uint32_t d0 = static_cast<uint32_t>(chunk * kDcChunk) + threadIdx.x * kDcRun;
  const int16_t* diff = c.dcdiff + seg.du_base;
  const uint32_t u0 = d0 % seg.n_units;
  int16_t v[kDcRun];
  unsigned long long s01 = 0, s23 = 0;
  uint32_t u = u0;
#pragma unroll
  for (int r = 0; r < kDcRun; ++r) {
    v[r] = d0 + r < seg.total_du ? diff[d0 + r] : 0;
    add_dc(s_units[u * kUnitCols + 1], static_cast<uint16_t>(v[r]), &s01, &s23);
    u = u + 1 == static_cast<uint32_t>(seg.n_units) ? 0 : u + 1;
  }
  unsigned long long t01, t23;
  const unsigned long long b01 = block_exclusive<unsigned long long>(s01, warp_sum, &t01);
  const unsigned long long b23 = block_exclusive<unsigned long long>(s23, warp_sum, &t23);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < 4) {
    unsigned long long* chain = c.dc_state + s * c.dc_chunks * 4 + warp;
    const uint32_t total = dc_field(t01, t23, warp);
    if (lane == 0) store_state(chain + chunk * 4, (chunk == 0 ? kPrefix : kAggregate) | total);
    uint32_t prefix = 0;
    if (chunk > 0) {
      prefix = static_cast<uint32_t>(look_back(chain, 4, chunk, 0xFFFFull, lane));
      if (lane == 0) store_state(chain + chunk * 4, kPrefix | ((prefix + total) & 0xFFFF));
    }
    if (lane == 0) s_before[warp] = prefix;
  }
  __syncthreads();
  uint32_t pred[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) pred[k] = s_before[k] + dc_field(b01, b23, k);
  u = u0;
  uint32_t m = seg.m_lo + d0 / seg.n_units;
#pragma unroll
  for (int r = 0; r < kDcRun; ++r) {
    if (d0 + r < seg.total_du) {
      const int32_t* ul = s_units + u * kUnitCols;
      const int comp = ul[1];
      uint32_t p = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (k == comp) {
          pred[k] += static_cast<uint32_t>(static_cast<int32_t>(v[r]));
          p = pred[k];
        }
      }
      int16_t* du = du_address(seg, ul, m);
      if (du != nullptr) du[0] = static_cast<int16_t>(static_cast<uint16_t>(p));
    }
    if (++u == static_cast<uint32_t>(seg.n_units)) {
      u = 0;
      ++m;
    }
  }
}

}  // namespace

// The subsequence size the kernels were built with: the wrapper lays the
// records out by it.
extern "C" int jdtc_entropy_sub_bytes() { return kSubBytes; }

// The records a block of the scan pass takes (which = 0) and the data units
// a block of the dc pass takes (which = 1): the wrapper sizes the
// look-back scratch by them.
extern "C" int jdtc_entropy_chunk(int which) { return which == 0 ? kScanChunk : kDcChunk; }

// One decode of a group: first-level tables, pass 1, pass 2 until no record
// changes (the host reads a flag after each launch), scan, write, dc.
// `chain` is the scan and dc passes' look-back scratch, `chain_words` int64
// of it: 2 + n_segs * (ceil(max_subs / kScanChunk) + 4 * ceil(ri * n_units
// / kDcChunk)), cleared here. `earlier_tail` runs the earlier scan and dc
// passes (a block per segment) whatever the segments' length, for
// measurement.
// `rounds` receives the launches of pass 2 and, summed over them, the most
// steps a block took within a launch (the length of the longest chain that
// had to be walked). `pass_ms`, when not null,
// receives the milliseconds of (tables + pass 1, pass 2, scan, write, dc)
// from CUDA events, and the call then ends with the stream idle.
extern "C" int jdtc_entropy_decode(
    const void* stream, const void* seg_off, const void* seg_img, const void* seg_idx,
    int64_t n_segs, int64_t ri, const void* total_mcus, const void* units, int n_units,
    const void* tables, int n_specs, const void* plane_ptrs, void* status,
    const void* sub_base, const void* du_base_img, int64_t max_subs, void* rec, void* used,
    void* first_du, void* dcdiff, void* lut, void* flag, void* chain, int64_t chain_words,
    int earlier_tail, int* rounds, float* pass_ms, void* cuda_stream) {
  if (n_units > kMaxUnits || n_specs > kMaxSpecs || n_units < 1 || n_specs < 1 || n_segs < 1
      || ri < 1 || max_subs < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t scan_chunks = (max_subs + kScanChunk - 1) / kScanChunk;
  const int64_t dc_chunks = (ri * n_units + kDcChunk - 1) / kDcChunk;
  const int64_t words = 2 + n_segs * (scan_chunks + 4 * dc_chunks);
  if (chain_words < words || n_segs * scan_chunks >= (1ll << 31)
      || n_segs * dc_chunks >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(cuda_stream);
  Call c;
  c.stream = static_cast<const uint8_t*>(stream);
  c.seg_off = static_cast<const int64_t*>(seg_off);
  c.seg_img = static_cast<const int32_t*>(seg_img);
  c.seg_idx = static_cast<const int32_t*>(seg_idx);
  c.ri = ri;
  c.total_mcus = static_cast<const int64_t*>(total_mcus);
  c.units = static_cast<const int32_t*>(units);
  c.n_units = n_units;
  c.tables = static_cast<const int32_t*>(tables);
  c.n_specs = n_specs;
  c.plane_ptrs = static_cast<const unsigned long long*>(plane_ptrs);
  c.status = static_cast<int64_t*>(status);
  c.sub_base = static_cast<const int64_t*>(sub_base);
  c.du_base_img = static_cast<const int64_t*>(du_base_img);
  c.rec = static_cast<unsigned long long*>(rec);
  c.used = static_cast<unsigned long long*>(used);
  c.first_du = static_cast<uint32_t*>(first_du);
  c.dcdiff = static_cast<int16_t*>(dcdiff);
  c.lut = static_cast<uint16_t*>(lut);
  c.flag = static_cast<int*>(flag);
  c.n_segs = n_segs;
  c.tickets = static_cast<unsigned long long*>(chain);
  c.scan_state = c.tickets + 2;
  c.scan_chunks = scan_chunks;
  c.dc_state = c.scan_state + n_segs * scan_chunks;
  c.dc_chunks = dc_chunks;

  cudaEvent_t ev[6];
  if (pass_ms != nullptr)
    for (auto& e : ev) cudaEventCreate(&e);
  auto mark = [&](int i) {
    if (pass_ms != nullptr) cudaEventRecord(ev[i], st);
  };
  const dim3 grid(static_cast<unsigned>(n_segs),
                  static_cast<unsigned>((max_subs + kThreads - 1) / kThreads));
  const unsigned segs = static_cast<unsigned>(n_segs);
  int n_rounds = 0, n_steps = 0;
  int err = 0;

  mark(0);
  cudaMemsetAsync(status, 0, sizeof(int64_t) * 2 * n_segs, st);
  cudaMemsetAsync(chain, 0, sizeof(unsigned long long) * words, st);
  build_lut_kernel<<<n_specs, 256, 0, st>>>(c.tables, c.lut);
  pass1_kernel<<<grid, kThreads, 0, st>>>(c);
  mark(1);
  // The fixed point is reached after at most max_subs launches (a record
  // becomes final once its predecessor is); one more finds nothing to do.
  for (;;) {
    int changed = 0;
    cudaMemsetAsync(c.flag, 0, sizeof(int), st);
    pass2_kernel<<<grid, kThreads, 0, st>>>(c);
    cudaMemcpyAsync(&changed, c.flag, sizeof(int), cudaMemcpyDeviceToHost, st);
    err = static_cast<int>(cudaStreamSynchronize(st));
    ++n_rounds;
    n_steps += changed;
    if (err != 0 || !changed) break;
    if (n_rounds > max_subs + 1) {
      err = static_cast<int>(cudaErrorUnknown);
      break;
    }
  }
  mark(2);
  if (err == 0) {
    if (earlier_tail || scan_chunks == 1)
      scan_segment_kernel<<<segs, kThreads, 0, st>>>(c);
    else
      scan_kernel<<<static_cast<unsigned>(n_segs * scan_chunks), kThreads, 0, st>>>(c);
    mark(3);
    write_kernel<<<grid, kThreads, 0, st>>>(c);
    mark(4);
    if (earlier_tail)
      dc_segment_kernel<<<segs, 128, 0, st>>>(c);
    else
      dc_kernel<<<static_cast<unsigned>(n_segs * dc_chunks), kThreads, 0, st>>>(c);
    mark(5);
    err = static_cast<int>(cudaGetLastError());
  }
  if (rounds != nullptr) {
    rounds[0] = n_rounds;
    rounds[1] = n_steps;
  }
  if (pass_ms != nullptr) {
    if (err == 0) {
      err = static_cast<int>(cudaStreamSynchronize(st));
      for (int i = 0; i < 5 && err == 0; ++i) cudaEventElapsedTime(pass_ms + i, ev[i], ev[i + 1]);
    }
    for (auto& e : ev) cudaEventDestroy(e);
  }
  return err;
}

// Shared by every entry point's wrapper to name a failed launch.
extern "C" const char* jdtc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
