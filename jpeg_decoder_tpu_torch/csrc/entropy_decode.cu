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
//   write    every thread decodes its subsequence once more from its true
//            start state and stores coefficients into the zeroed planes
//            through the unit layout; the DC differences go to a compact
//            array per segment, because a block outside the plane stores
//            nothing yet moves the predictor. Only here is a bad code a bad
//            code, and only up to the segment's MCU count: the thread that
//            completes the segment's last data unit reports the consumed
//            bits, and whatever lies beyond is never looked at.
//   dc       a warp per (segment, scan component) forms the running sum of
//            the differences in data-unit order and stores int16(pred); the
//            serial design's int32 predictor wrapped and kept its low 16
//            bits, so the sum is taken modulo 2^16.
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

// Exclusive prefix sum of the records' counts within each segment: a block
// per segment walks its records kThreads at a time.
__global__ void __launch_bounds__(kThreads) scan_kernel(Call c) {
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

// The DC running sums: warp w of a block takes scan component w of the
// block's segment, walks the segment's data units 32 at a time, and stores
// int16(pred) for the blocks inside the plane.
__global__ void __launch_bounds__(128) dc_kernel(Call c) {
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

}  // namespace

// The subsequence size the kernels were built with: the wrapper lays the
// records out by it.
extern "C" int jdtc_entropy_sub_bytes() { return kSubBytes; }

// One decode of a group: first-level tables, pass 1, pass 2 until no record
// changes (the host reads a flag after each launch), scan, write, dc.
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
    void* first_du, void* dcdiff, void* lut, void* flag, int* rounds, float* pass_ms,
    void* cuda_stream) {
  if (n_units > kMaxUnits || n_specs > kMaxSpecs || n_units < 1 || n_specs < 1)
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
    scan_kernel<<<segs, kThreads, 0, st>>>(c);
    mark(3);
    write_kernel<<<grid, kThreads, 0, st>>>(c);
    mark(4);
    dc_kernel<<<segs, 128, 0, st>>>(c);
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
