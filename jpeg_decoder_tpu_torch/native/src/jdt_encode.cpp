// jdt_encode.cpp — native Huffman entropy packing for the encoder.
//
// Packs zigzag-order quantized coefficient blocks (produced by the device
// FDCT stage, ops/fdct.py) into a JPEG entropy-coded segment: DC-predicted
// run/size symbols + extend bits, byte stuffing, restart markers every ri
// MCUs — the serialization the reference intends but never ships working
// (its encode-side tables are dead/buggy: reference/src/
// huff_table.c:69-163, quant_table.c:36-89; spec F.1.2 is the model).
//
// Restart segments are packed CONCURRENTLY (independent by construction —
// DC predictors reset at every RSTn), then stitched with the RSTn markers;
// segment-parallel encode mirrors the decoder's segment-parallel seam.
//
// C ABI only (ctypes); buffers are malloc'd here and released with
// jdt_free.

#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

#if defined(__AVX2__)
#include <immintrin.h>
#endif

namespace {

struct EncTable {
  const uint16_t* code;  // [256]
  const uint8_t* size;   // [256]
};

// Cursor-addressed bit packer. The original wrote one byte per
// vector::push_back (a size check, a potential realloc dispatch, and a
// store per OUTPUT byte — ~6 M push_backs per 4K image, measured as the
// encode pack's dominant cost). This form drains the accumulator 32 bits
// at a time through a raw cursor: a SWAR test finds the no-0xFF common
// case (likely: stuffing density is ~1/256 per byte) and stores all four
// bytes with one bswap store; only chunks containing an 0xFF fall back to
// the byte loop. Callers guarantee capacity via ensure() once per data
// unit. Bit order and stuffing are IDENTICAL to the push_back form
// (differential-tested byte-for-byte against core/entropy_encode).
// alignas(64): these live in per-segment arrays (encode_segments' arena)
// with the hot cursor fields (w/acc/nbits) stored on EVERY put(); without
// the alignment two adjacent segments — typically owned by DIFFERENT
// threads under the dynamic grab — share a cache line and ping-pong it
// per symbol.
struct alignas(64) BitPacker {
  std::vector<uint8_t> out;
  size_t w = 0;  // write cursor; out.size() is capacity
  uint64_t acc = 0;
  int nbits = 0;  // pending bits in acc (< 32 between put() calls)

  // Guarantee `need` writable bytes at the cursor (amortized growth).
  inline void ensure(size_t need) {
    if (out.size() - w < need)
      out.resize(std::max(out.size() * 2, w + need + 4096));
  }

  inline void drain_byte_loop() {
    uint8_t* b = out.data();
    while (nbits >= 8) {
      nbits -= 8;
      uint8_t v = static_cast<uint8_t>(acc >> nbits);
      b[w++] = v;
      if (v == 0xFF) b[w++] = 0x00;  // stuffing (spec B.1.1.5)
    }
    acc &= (1ull << nbits) - 1;
  }

  // n <= 31 (one Huffman code <= 16 bits + one EXTEND field <= 15 bits).
  inline void put(uint32_t value, int n) {
    acc = (acc << n) | (value & ((1ull << n) - 1));
    nbits += n;
    if (nbits < 32) return;
    nbits -= 32;
    uint32_t chunk = static_cast<uint32_t>(acc >> nbits);
    acc &= (1ull << nbits) - 1;
    // SWAR any-byte-is-0xFF: low7==0x7F propagates a carry into bit 7.
    if ((((chunk & 0x7F7F7F7Fu) + 0x01010101u) & chunk & 0x80808080u) == 0) {
      uint32_t be = __builtin_bswap32(chunk);
      std::memcpy(out.data() + w, &be, 4);
      w += 4;
      return;
    }
    uint8_t* b = out.data();
    for (int i = 24; i >= 0; i -= 8) {
      uint8_t v = static_cast<uint8_t>(chunk >> i);
      b[w++] = v;
      if (v == 0xFF) b[w++] = 0x00;
    }
  }

  inline void align() {  // 1-fill (spec F.1.2.3)
    ensure(16);
    if (nbits & 7) {
      int pad = 8 - (nbits & 7);
      acc = (acc << pad) | ((1u << pad) - 1);
      nbits += pad;
    }
    drain_byte_loop();
  }
};

// Register-resident pack cursor. BitPacker::put stores bytes through
// out.data() — a char* that ALIASES EVERYTHING, so the compiler must
// reload and re-store bp.acc/nbits/w around every byte store: the
// accumulator dependency chain becomes a load+op+store round trip per
// symbol instead of a register op. This cursor copies the four hot
// fields into locals whose address never escapes (after inlining they
// are SSA values the char stores provably cannot alias), and flushes
// back at DU/segment boundaries. Bit semantics are IDENTICAL to
// BitPacker::put/drain (differential-tested byte-for-byte).
struct PackCursor {
  uint64_t acc;
  int nbits;
  size_t w;
  uint8_t* b;

  inline void load(BitPacker& bp) {
    acc = bp.acc;
    nbits = bp.nbits;
    w = bp.w;
    b = bp.out.data();
  }
  inline void flush(BitPacker& bp) {
    bp.acc = acc;
    bp.nbits = nbits;
    bp.w = w;
  }
  // Sync w, grow if needed, re-acquire the (possibly moved) base pointer.
  inline void ensure(BitPacker& bp, size_t need) {
    bp.w = w;
    bp.ensure(need);
    b = bp.out.data();
  }

  inline void put(uint32_t value, int n) {  // mirror of BitPacker::put
    acc = (acc << n) | (value & ((1ull << n) - 1));
    nbits += n;
    if (nbits < 32) return;
    nbits -= 32;
    uint32_t chunk = static_cast<uint32_t>(acc >> nbits);
    acc &= (1ull << nbits) - 1;
    if ((((chunk & 0x7F7F7F7Fu) + 0x01010101u) & chunk & 0x80808080u) == 0) {
      uint32_t be = __builtin_bswap32(chunk);
      std::memcpy(b + w, &be, 4);
      w += 4;
      return;
    }
    for (int i = 24; i >= 0; i -= 8) {
      uint8_t v = static_cast<uint8_t>(chunk >> i);
      b[w++] = v;
      if (v == 0xFF) b[w++] = 0x00;
    }
  }
};

inline int csize_fast(int32_t v) {  // bit category (Table F.1)
  // 0u - cast avoids signed-overflow UB for INT32_MIN.
  uint32_t a = v < 0 ? 0u - static_cast<uint32_t>(v)
                     : static_cast<uint32_t>(v);
  return a == 0 ? 0 : 32 - __builtin_clz(a);
}

struct EncodeArgs {
  const int32_t* blocks;  // [n_units_total, 64] zigzag, MCU order
  int64_t total_units;
  int32_t units_per_mcu;
  const int32_t* unit_sci;     // [units_per_mcu]
  const int32_t* unit_dc;      // [units_per_mcu] table index
  const int32_t* unit_ac;      // [units_per_mcu]
  const EncTable* tables_dc;
  const EncTable* tables_ac;
  int64_t ri;  // restart interval in MCUs (0 = none)
};

#if defined(__AVX2__)
// Nonzero-position mask for one 64-coefficient data unit: bit k set iff
// unit[k] != 0. The ctz walk over this mask replaces the scalar loop's
// per-coefficient zero test, which is data-random on natural content and
// mispredicts ~per coefficient.
inline uint64_t nz_mask(const int32_t* unit) {
  uint64_t nz = 0;
  for (int g = 0; g < 64; g += 8) {
    __m256i v8 =
        _mm256_loadu_si256(reinterpret_cast<const __m256i*>(unit + g));
    __m256i z = _mm256_cmpeq_epi32(v8, _mm256_setzero_si256());
    uint32_t zm = static_cast<uint32_t>(
        _mm256_movemask_ps(_mm256_castsi256_ps(z)));
    nz |= static_cast<uint64_t>(~zm & 0xFFu) << g;
  }
  return nz;
}

inline uint64_t nz_mask(const int16_t* unit) {
  uint64_t nz = 0;
  for (int g = 0; g < 64; g += 16) {
    __m256i v16 =
        _mm256_loadu_si256(reinterpret_cast<const __m256i*>(unit + g));
    uint32_t zm = static_cast<uint32_t>(_mm256_movemask_epi8(
        _mm256_cmpeq_epi16(v16, _mm256_setzero_si256())));
    // movemask_epi8 repeats each int16 lane's bit twice; keep the even bits.
#if defined(__BMI2__)
    uint32_t z16 = _pext_u32(zm, 0x55555555u);
#else
    uint32_t x = zm & 0x55555555u;
    x = (x | (x >> 1)) & 0x33333333u;
    x = (x | (x >> 2)) & 0x0F0F0F0Fu;
    x = (x | (x >> 4)) & 0x00FF00FFu;
    x = (x | (x >> 8)) & 0x0000FFFFu;
    uint32_t z16 = x;
#endif
    nz |= static_cast<uint64_t>(~z16 & 0xFFFFu) << g;
  }
  return nz;
}
#if defined(__AVX512F__) && defined(__AVX512BW__)
// Vectorized per-block (size, EXTEND) precompute: csize and the extend
// field of every coefficient computed on SIMD ports up front, so the
// serial symbol walk only does table lookups and bit emission —
// removing the per-coefficient csize/extend dependency chain measured
// +58% dense / +39% sparse pack throughput (paired A/B, 4K q85).
//   s[k]   = bit category of coef[k]   (0..15 for int16 inputs <= 2047)
//   ext[k] = extend-coded magnitude bits (low s[k] bits valid)
inline void csize_ext_block_i16(const int16_t* unit, uint8_t* s_out,
                            uint16_t* ext_out) {
  for (int g = 0; g < 64; g += 16) {
    __m256i v16 = _mm256_loadu_si256(
        reinterpret_cast<const __m256i*>(unit + g));
    __m512i v = _mm512_cvtepi16_epi32(v16);
    __m512i av = _mm512_abs_epi32(v);
    // csize = 32 - lzcnt(|v|); lzcnt(0) = 32 -> s = 0.
    __m512i s = _mm512_sub_epi32(_mm512_set1_epi32(32),
                                 _mm512_lzcnt_epi32(av));
    // extend: v >= 0 ? v : v + (1 << s) - 1  (low s bits of the result)
    __m512i pow = _mm512_sllv_epi32(_mm512_set1_epi32(1), s);
    __m512i neg = _mm512_add_epi32(
        v, _mm512_sub_epi32(pow, _mm512_set1_epi32(1)));
    __mmask16 isneg = _mm512_cmplt_epi32_mask(v, _mm512_setzero_si512());
    __m512i ext = _mm512_mask_blend_epi32(isneg, v, neg);
    _mm_storeu_si128(reinterpret_cast<__m128i*>(s_out + g),
                     _mm512_cvtepi32_epi8(s));
    _mm256_storeu_si256(reinterpret_cast<__m256i*>(ext_out + g),
                        _mm512_cvtepi32_epi16(ext));
  }
}
#endif

#endif

// Pack ONE data unit. Shared by the contiguous int32 entry and the
// plane-direct int16 entry; each (code, EXTEND) pair is emitted as ONE
// put of <= 31 bits. Returns 0 or 1 on absent symbol / range error.
// Worst case one DU emits 64 * (16+15) bits = 248 B, *2 if every byte
// stuffs, + the 8-byte fast-path store margin. Callers guarantee this
// per DU via PackCursor::ensure.
constexpr size_t kDuCap = 2 * 248 + 16;

template <typename Coef>
inline int pack_du(const Coef* unit, const EncTable& dct,
                   const EncTable& act, int32_t sci, int32_t preds[4],
                   PackCursor& bp) {
  int32_t dc = unit[0];
  int32_t diff = dc - preds[sci];
  preds[sci] = dc;
  int s = csize_fast(diff);
  // Out-of-range magnitudes must error, not alias into the run nibble
  // of (run << 4 | s) and emit a decodable-but-wrong symbol.
  if (s > 15 || dct.size[s] == 0) return 1;
  uint32_t ext =
      static_cast<uint32_t>(diff >= 0 ? diff : diff + (1 << s) - 1);
  bp.put((static_cast<uint32_t>(dct.code[s]) << s) | (ext & ((1u << s) - 1)),
         dct.size[s] + s);

#if defined(__AVX2__)
  uint64_t nz = nz_mask(unit) & ~1ull;  // DC handled above
#if defined(__AVX512F__) && defined(__AVX512BW__)
  // Precompute every coefficient's (csize, EXTEND) on SIMD ports; the
  // serial walk below then only does table lookups + bit emission.
  uint8_t s_pre[64];
  uint16_t ext_pre[64];
  constexpr bool kPre = sizeof(Coef) == 2;
  if constexpr (kPre) {
    if (nz)
      csize_ext_block_i16(reinterpret_cast<const int16_t*>(unit), s_pre,
                          ext_pre);
  }
#endif
  int prev = 0;
  while (nz) {
    int k = __builtin_ctzll(nz);
    nz &= nz - 1;
    int run = k - prev - 1;
    prev = k;
    while (run >= 16) {
      if (act.size[0xF0] == 0) return 1;
      bp.put(act.code[0xF0], act.size[0xF0]);  // ZRL
      run -= 16;
    }
#if defined(__AVX512F__) && defined(__AVX512BW__)
    if constexpr (kPre) {
      s = s_pre[k];
      if (s > 15) return 1;
      int sym = (run << 4) | s;
      if (act.size[sym] == 0) return 1;
      bp.put((static_cast<uint32_t>(act.code[sym]) << s) |
                 (ext_pre[k] & ((1u << s) - 1)),
             act.size[sym] + s);
      continue;
    }
#endif
    int32_t v = unit[k];
    s = csize_fast(v);
    if (s > 15) return 1;
    int sym = (run << 4) | s;
    if (act.size[sym] == 0) return 1;
    ext = static_cast<uint32_t>(v >= 0 ? v : v + (1 << s) - 1);
    bp.put((static_cast<uint32_t>(act.code[sym]) << s) |
               (ext & ((1u << s) - 1)),
           act.size[sym] + s);
  }
  if (prev < 63) {
    if (act.size[0x00] == 0) return 1;
    bp.put(act.code[0x00], act.size[0x00]);  // EOB
  }
#else
  int run = 0;
  for (int k = 1; k < 64; k++) {
    int32_t v = unit[k];
    if (v == 0) {
      run++;
      continue;
    }
    while (run >= 16) {
      if (act.size[0xF0] == 0) return 1;
      bp.put(act.code[0xF0], act.size[0xF0]);  // ZRL
      run -= 16;
    }
    s = csize_fast(v);
    if (s > 15) return 1;
    int sym = (run << 4) | s;
    if (act.size[sym] == 0) return 1;
    ext = static_cast<uint32_t>(v >= 0 ? v : v + (1 << s) - 1);
    bp.put((static_cast<uint32_t>(act.code[sym]) << s) |
               (ext & ((1u << s) - 1)),
           act.size[sym] + s);
    run = 0;
  }
  if (run) {
    if (act.size[0x00] == 0) return 1;
    bp.put(act.code[0x00], act.size[0x00]);  // EOB
  }
#endif
  return 0;
}

// Pack MCUs [mcu_lo, mcu_hi) from the contiguous MCU-ordered layout.
int pack_range(const EncodeArgs& a, int64_t mcu_lo, int64_t mcu_hi,
               BitPacker& bp) {
  int32_t preds[4] = {0, 0, 0, 0};
  PackCursor pc;
  pc.load(bp);
  for (int64_t m = mcu_lo; m < mcu_hi; m++) {
    const int32_t* unit = a.blocks + m * a.units_per_mcu * 64;
    for (int32_t u = 0; u < a.units_per_mcu; u++, unit += 64) {
      pc.ensure(bp, kDuCap);
      if (pack_du(unit, a.tables_dc[a.unit_dc[u]], a.tables_ac[a.unit_ac[u]],
                  a.unit_sci[u], preds, pc))
        return 1;
    }
  }
  pc.flush(bp);
  return 0;
}

// Plane-direct layout: blocks stay in the per-component [by, bx, 64]
// arrays the device FDCT stage emits (int16, zigzag); the MCU-interleave
// is ADDRESSED here instead of materialized by a NumPy reshuffle. Unit u
// of an MCU at (my, mx) lives at block (my*fv + j, mx*fh + k) of its
// component plane — the encode-side mirror of the decoder's UnitLayout
// walk (planes are MCU-padded, so no partial-coverage scratch case).
struct PlaneUnit {
  const int16_t* base;  // component plane [by, bx, 64]
  int64_t bw;           // blocks per row
  int32_t fh, fv, j, k;
  int32_t sci, dc, ac;
};

template <typename PerUnit>
inline int walk_planes(const PlaneUnit* pus, int32_t upm, int32_t mcus_x,
                       int64_t mcu_lo, int64_t mcu_hi, PerUnit&& f) {
  int64_t my = mcu_lo / mcus_x;
  int32_t mx = static_cast<int32_t>(mcu_lo % mcus_x);
  int32_t preds[4] = {0, 0, 0, 0};
  for (int64_t m = mcu_lo; m < mcu_hi; m++) {
    for (int32_t u = 0; u < upm; u++) {
      const PlaneUnit& pu = pus[u];
      const int16_t* unit =
          pu.base + ((my * pu.fv + pu.j) * pu.bw +
                     static_cast<int64_t>(mx) * pu.fh + pu.k) * 64;
      if (f(unit, pu, preds)) return 1;
    }
    if (++mx == mcus_x) {
      mx = 0;
      my++;
    }
  }
  return 0;
}

int pack_range_planes(const PlaneUnit* pus, int32_t upm,
                      const EncTable* tdc, const EncTable* tac,
                      int32_t mcus_x, int64_t mcu_lo, int64_t mcu_hi,
                      BitPacker& bp) {
  PackCursor pc;
  pc.load(bp);
  int rc = walk_planes(
      pus, upm, mcus_x, mcu_lo, mcu_hi,
      [&](const int16_t* unit, const PlaneUnit& pu, int32_t preds[4]) {
        pc.ensure(bp, kDuCap);
        return pack_du(unit, tdc[pu.dc], tac[pu.ac], pu.sci, preds, pc);
      });
  if (rc == 0) pc.flush(bp);
  return rc;
}

// Count one data unit's symbols (the frequency pass of two-pass optimized
// tables, Annex K.2). Mirrors core/entropy_encode._encode_one_block's
// counting mode exactly; same AVX2 nonzero-mask walk as pack_du.
inline int count_du(const int16_t* unit, int32_t sci, int32_t preds[4],
                    int64_t* dcf, int64_t* acf) {
  int32_t dc = unit[0];
  int32_t diff = dc - preds[sci];
  preds[sci] = dc;
  int s = csize_fast(diff);
  if (s > 15) return 1;
  dcf[s]++;
#if defined(__AVX2__)
  uint64_t nz = nz_mask(unit) & ~1ull;
  int prev = 0;
  while (nz) {
    int k = __builtin_ctzll(nz);
    nz &= nz - 1;
    int run = k - prev - 1;
    prev = k;
    while (run >= 16) {
      acf[0xF0]++;
      run -= 16;
    }
    s = csize_fast(unit[k]);
    if (s > 15) return 1;
    acf[(run << 4) | s]++;
  }
  if (prev < 63) acf[0x00]++;
#else
  int run = 0;
  for (int k = 1; k < 64; k++) {
    if (unit[k] == 0) {
      run++;
      continue;
    }
    while (run >= 16) {
      acf[0xF0]++;
      run -= 16;
    }
    s = csize_fast(unit[k]);
    if (s > 15) return 1;
    acf[(run << 4) | s]++;
    run = 0;
  }
  if (run) acf[0x00]++;
#endif
  return 0;
}

// Validate the per-MCU unit descriptors and the plane dimensions they
// address: a bad caller must get status 2, not an out-of-bounds read
// ((my*fv + j) must stay inside plane_bh rows, (mx*fh + k) inside
// plane_bw columns, for every MCU of the walk).
int32_t build_plane_units(const int16_t* const* planes,
                          const int64_t* plane_bw, const int64_t* plane_bh,
                          int32_t n_comps, int32_t mcus_x, int64_t total_mcus,
                          int32_t upm, const int32_t* unit_params,
                          int32_t n_dc, int32_t n_ac,
                          std::vector<PlaneUnit>& pus) {
  if (total_mcus <= 0 || upm <= 0 || mcus_x <= 0 || n_comps <= 0 ||
      total_mcus % mcus_x != 0)
    return 2;
  int64_t mcus_y = total_mcus / mcus_x;
  pus.resize(upm);
  for (int32_t u = 0; u < upm; u++) {
    const int32_t* q = unit_params + u * 8;
    if (q[0] < 0 || q[0] >= n_comps || q[1] < 1 || q[1] > 4 || q[2] < 1 ||
        q[2] > 4 || q[3] < 0 || q[3] >= q[2] || q[4] < 0 || q[4] >= q[1] ||
        q[5] < 0 || q[5] > 3 || q[6] < 0 || q[6] >= n_dc || q[7] < 0 ||
        q[7] >= n_ac)
      return 2;
    if (!planes[q[0]] || plane_bw[q[0]] < static_cast<int64_t>(mcus_x) * q[1] ||
        plane_bh[q[0]] < mcus_y * q[2])
      return 2;
    pus[u] = PlaneUnit{planes[q[0]], plane_bw[q[0]],
                       q[1], q[2], q[3], q[4], q[5], q[6], q[7]};
  }
  return 0;
}

// Shared segment-parallel runner: pack every restart segment concurrently
// via `pack` (seg, mcu_lo, mcu_hi, packer) -> rc, then stitch with RSTn
// markers into one malloc'd buffer.
template <typename PackFn>
int32_t encode_segments(int64_t total_mcus, int64_t ri, int32_t n_threads,
                        PackFn&& pack, uint8_t** out, int64_t* out_len) {
  int64_t n_segs = (ri > 0) ? (total_mcus + ri - 1) / ri : 1;
  // Packer arena: recycle the per-segment output vectors across calls
  // (the decode side's SpecArena lesson — fresh vectors pay zero-fill,
  // growth copies, and allocator churn per call; steady-state serving
  // reuses warm capacity; measured +1% dense pack, tighter latency).
  // Reset is w/acc/nbits only. The arena is capped below so one
  // gigapixel encode cannot pin hundreds of MB per thread forever.
  thread_local std::vector<BitPacker> packers_tls;
  if (static_cast<int64_t>(packers_tls.size()) < n_segs)
    packers_tls.resize(n_segs);
  std::vector<BitPacker>& packers = packers_tls;
  for (int64_t s = 0; s < n_segs; s++) {
    packers[s].w = 0;
    packers[s].acc = 0;
    packers[s].nbits = 0;
  }
  std::atomic<int32_t> status(0);

  if (n_threads <= 0) n_threads = std::thread::hardware_concurrency();
  int workers =
      static_cast<int>(std::min<int64_t>(std::max(1, n_threads), n_segs));
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    for (;;) {
      int64_t s = next.fetch_add(1);
      if (s >= n_segs || status.load(std::memory_order_relaxed)) return;
      int64_t lo = ri ? s * ri : 0;
      int64_t hi = ri ? std::min<int64_t>(lo + ri, total_mcus) : total_mcus;
      int rc = pack(lo, hi, packers[s]);
      packers[s].align();
      if (rc) status.store(rc);
    }
  };
  if (workers <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    for (int t = 0; t < workers; t++) pool.emplace_back(worker);
    for (auto& t : pool) t.join();
  }
  if (int32_t rc = status.load()) return rc;

  int64_t total = 0;
  for (int64_t s = 0; s < n_segs; s++)
    total += static_cast<int64_t>(packers[s].w);
  total += 2 * (n_segs - 1);  // RSTn markers
  uint8_t* buf =
      static_cast<uint8_t*>(std::malloc(std::max<int64_t>(total, 1)));
  if (!buf) return 3;
  int64_t off = 0;
  for (int64_t s = 0; s < n_segs; s++) {
    std::memcpy(buf + off, packers[s].out.data(), packers[s].w);
    off += static_cast<int64_t>(packers[s].w);
    if (s + 1 < n_segs) {
      buf[off++] = 0xFF;
      buf[off++] = 0xD0 + static_cast<uint8_t>(s & 7);
    }
  }
  *out = buf;
  *out_len = off;
  // Arena cap: a gigapixel encode would otherwise pin its whole entropy
  // stream's worth of capacity in this thread forever. Steady-state
  // serving of ordinary frames stays far under the cap and keeps the
  // warm buffers.
  constexpr int64_t kArenaCapBytes = 64 << 20;
  int64_t retained = 0;
  for (auto& p : packers_tls) retained += static_cast<int64_t>(p.out.capacity());
  if (retained > kArenaCapBytes) {
    packers_tls.clear();
    packers_tls.shrink_to_fit();
  }
  return 0;
}

}  // namespace

extern "C" {

void jdt_free(uint8_t* p) { std::free(p); }

// Pack a whole scan. Returns malloc'd buffer in *out (caller jdt_free's),
// length in *out_len; returns 0 on success.
int32_t jdt_encode_scan(const int32_t* blocks, int64_t total_units,
                        int32_t units_per_mcu, const int32_t* unit_sci,
                        const int32_t* unit_dc, const int32_t* unit_ac,
                        const uint16_t* const* dc_codes,
                        const uint8_t* const* dc_sizes, int32_t n_dc,
                        const uint16_t* const* ac_codes,
                        const uint8_t* const* ac_sizes, int32_t n_ac,
                        int64_t ri, int32_t n_threads, uint8_t** out,
                        int64_t* out_len) {
  if (total_units <= 0 || units_per_mcu <= 0 ||
      total_units % units_per_mcu != 0)
    return 2;
  std::vector<EncTable> tdc(n_dc), tac(n_ac);
  for (int32_t i = 0; i < n_dc; i++) tdc[i] = EncTable{dc_codes[i], dc_sizes[i]};
  for (int32_t i = 0; i < n_ac; i++) tac[i] = EncTable{ac_codes[i], ac_sizes[i]};
  EncodeArgs a{blocks, total_units, units_per_mcu, unit_sci,
               unit_dc, unit_ac, tdc.data(), tac.data(), ri};
  int64_t total_mcus = total_units / units_per_mcu;
  return encode_segments(
      total_mcus, ri, n_threads,
      [&](int64_t lo, int64_t hi, BitPacker& bp) {
        return pack_range(a, lo, hi, bp);
      },
      out, out_len);
}

// Plane-direct pack: per-component int16 zigzag block planes straight
// from the device FDCT stage (no NumPy MCU-interleave materialization,
// half the coefficient bytes of the int32 layout). unit_params is
// [units_per_mcu x 8] int32: (comp, fh, fv, j, k, sci, dc_table,
// ac_table); plane_bw gives blocks-per-row per component.
int32_t jdt_encode_scan_planes(
    const int16_t* const* planes, const int64_t* plane_bw,
    const int64_t* plane_bh, int32_t n_comps, int32_t mcus_x,
    int64_t total_mcus, int32_t units_per_mcu, const int32_t* unit_params,
    const uint16_t* const* dc_codes, const uint8_t* const* dc_sizes,
    int32_t n_dc, const uint16_t* const* ac_codes,
    const uint8_t* const* ac_sizes, int32_t n_ac, int64_t ri,
    int32_t n_threads, uint8_t** out, int64_t* out_len) {
  std::vector<PlaneUnit> pus;
  if (int32_t rc = build_plane_units(planes, plane_bw, plane_bh, n_comps,
                                     mcus_x, total_mcus, units_per_mcu,
                                     unit_params, n_dc, n_ac, pus))
    return rc;
  std::vector<EncTable> tdc(n_dc), tac(n_ac);
  for (int32_t i = 0; i < n_dc; i++)
    tdc[i] = EncTable{dc_codes[i], dc_sizes[i]};
  for (int32_t i = 0; i < n_ac; i++)
    tac[i] = EncTable{ac_codes[i], ac_sizes[i]};
  return encode_segments(
      total_mcus, ri, n_threads,
      [&](int64_t lo, int64_t hi, BitPacker& bp) {
        return pack_range_planes(pus.data(), units_per_mcu, tdc.data(),
                                 tac.data(), mcus_x, lo, hi, bp);
      },
      out, out_len);
}

// Frequency-count pass over the same plane-direct layout (two-pass
// optimized tables): fills dc_freq [n_dc * 256] / ac_freq [n_ac * 256]
// with symbol counts identical to core/entropy_encode.count_symbols.
// Restart segments count concurrently (DC predictors reset per segment,
// so per-segment counts are independent and sum).
int32_t jdt_count_scan_planes(
    const int16_t* const* planes, const int64_t* plane_bw,
    const int64_t* plane_bh, int32_t n_comps, int32_t mcus_x,
    int64_t total_mcus, int32_t units_per_mcu, const int32_t* unit_params,
    int32_t n_dc, int32_t n_ac, int64_t ri, int32_t n_threads,
    int64_t* dc_freq, int64_t* ac_freq) {
  std::vector<PlaneUnit> pus;
  if (int32_t rc = build_plane_units(planes, plane_bw, plane_bh, n_comps,
                                     mcus_x, total_mcus, units_per_mcu,
                                     unit_params, n_dc, n_ac, pus))
    return rc;
  std::memset(dc_freq, 0, sizeof(int64_t) * 256 * n_dc);
  std::memset(ac_freq, 0, sizeof(int64_t) * 256 * n_ac);
  int64_t n_segs = (ri > 0) ? (total_mcus + ri - 1) / ri : 1;
  if (n_threads <= 0) n_threads = std::thread::hardware_concurrency();
  int workers =
      static_cast<int>(std::min<int64_t>(std::max(1, n_threads), n_segs));
  std::vector<std::vector<int64_t>> local(
      workers, std::vector<int64_t>(256 * (n_dc + n_ac), 0));
  std::atomic<int64_t> next(0);
  std::atomic<int32_t> status(0);
  auto worker = [&](int w) {
    int64_t* ld = local[w].data();
    int64_t* la = ld + 256 * n_dc;
    for (;;) {
      int64_t s = next.fetch_add(1);
      if (s >= n_segs || status.load(std::memory_order_relaxed)) return;
      int64_t lo = ri ? s * ri : 0;
      int64_t hi = ri ? std::min<int64_t>(lo + ri, total_mcus) : total_mcus;
      int rc = walk_planes(
          pus.data(), units_per_mcu, mcus_x, lo, hi,
          [&](const int16_t* unit, const PlaneUnit& pu, int32_t preds[4]) {
            return count_du(unit, pu.sci, preds, ld + pu.dc * 256,
                            la + pu.ac * 256);
          });
      if (rc) status.store(rc);
    }
  };
  if (workers <= 1) {
    worker(0);
  } else {
    std::vector<std::thread> pool;
    for (int t = 0; t < workers; t++) pool.emplace_back(worker, t);
    for (auto& t : pool) t.join();
  }
  if (int32_t rc = status.load()) return rc;
  for (int w = 0; w < workers; w++) {
    const int64_t* ld = local[w].data();
    for (int i = 0; i < 256 * n_dc; i++) dc_freq[i] += ld[i];
    const int64_t* la = ld + 256 * n_dc;
    for (int i = 0; i < 256 * n_ac; i++) ac_freq[i] += la[i];
  }
  return 0;
}

}  // extern "C"
