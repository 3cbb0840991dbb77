"""Canonical Huffman code construction and flat-LUT acceleration.

The reference builds per-length {min_code, max_code, symbol pointer} tables
(`decode_huff_tables` `reference/src/huff_table.c:187-216`, JPEG Annex C)
and decodes each symbol with a <=16-step compare walk
(`decode.c:674-681`). Same observable mapping here, two forms:

  * `CanonicalTable` — the Annex C form, used by the oracle decoder to mirror
    the reference's walk exactly;
  * `FlatLut`        — a 2^16-entry table mapping the next 16 bits directly to
    (symbol, code_length), O(1) per symbol; this is what the vectorized NumPy
    decoder, the native C++ runtime, and the device decoder consume
    (SURVEY.md §3.4: "replace with a flat LUT — same observable mapping").

Also here: Annex K default tables for the encoder, optimal code-length
construction (Annex K.2 procedure) for optimized encoding, and the
encode-side canonical code assignment (the reference's encode-side
serializers huff_table.c:69-163 are dead/buggy; these are built from spec).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from ..utils.errors import JpegEntropyError, JpegFormatError
from .types import HuffTableSpec


@dataclasses.dataclass(frozen=True)
class CanonicalTable:
    """Annex C decode tables (reference HuffTable huff_table.h:9-14)."""

    spec: HuffTableSpec
    min_codes: np.ndarray  # (16,) int32, -1 where no codes of that length
    max_codes: np.ndarray  # (16,) int32, -1 where no codes of that length
    # symbols grouped per length, symbol_start[j] = index into spec.symbols
    symbol_start: np.ndarray  # (16,) int32

    def decode_walk(self, first_bit: int, next_bit) -> int:
        """The reference's compare walk (decode.c:672-681): start with one
        bit, extend until max_codes[len-1] >= code. Returns the symbol."""
        code = first_bit
        for i in range(16):
            if int(self.max_codes[i]) >= code and int(self.min_codes[i]) != -1:
                off = int(self.symbol_start[i]) + (code - int(self.min_codes[i]))
                return int(self.spec.symbols[off])
            code = (code << 1) | next_bit()
        raise JpegEntropyError("invalid Huffman code (no length <= 16 matched)")

    def decode(self, reader) -> int:
        """Decode one symbol from a bit reader (walk form)."""
        return self.decode_walk(reader.read_bit(), reader.read_bit)


def build_canonical(spec: HuffTableSpec) -> CanonicalTable:
    """Annex C code assignment, matching huff_table.c:187-216: for each
    length j (1..16): min = code, code += count, max = code - 1, code <<= 1."""
    min_codes = np.full(16, -1, dtype=np.int32)
    max_codes = np.full(16, -1, dtype=np.int32)
    symbol_start = np.zeros(16, dtype=np.int32)
    code = 0
    sym = 0
    for j in range(16):
        cnt = int(spec.counts[j])
        if cnt == 0:
            code <<= 1
            continue
        min_codes[j] = code
        symbol_start[j] = sym
        code += cnt
        sym += cnt
        max_codes[j] = code - 1
        if code > (1 << (j + 1)):
            raise JpegFormatError(
                f"over-subscribed Huffman table at length {j + 1}"
            )
        code <<= 1
    return CanonicalTable(
        spec=spec,
        min_codes=min_codes,
        max_codes=max_codes,
        symbol_start=symbol_start,
    )


@dataclasses.dataclass(frozen=True)
class FlatLut:
    """16-bit-indexed decode LUT.

    lut_symbol[peek16] = decoded symbol byte; lut_length[peek16] = code length
    in bits (0 marks an invalid prefix). Size: 2 * 64 KiB per table.

    The native runtime's derived tables (combined/first-level/value-resolved;
    layouts documented in native/src/jdt_entropy.cpp HuffLut) are built here
    vectorized and cached with the table content, so the C++ side does zero
    per-scan table work:
      lut16c [65536] u16 : (len << 8) | symbol
      lut12c [4096]  u16 : same, codes <= 12 bits only (0 = miss)
      vlut   [4096]  i32 : AC fast path — value/total/run/kind packed
    """

    lut_symbol: np.ndarray  # (65536,) uint8
    lut_length: np.ndarray  # (65536,) uint8
    lut16c: np.ndarray = None  # (65536,) uint16
    lut12c: np.ndarray = None  # (4096,) uint16
    vlut: np.ndarray = None  # (4096,) int32
    # Pair-resolved AC fast path: one 12-bit lookup resolves up to TWO
    # complete coefficient symbols (code + extend each). Measured on the 4K
    # q85 benchmark stream the mean AC symbol is ~5.1 bits, so ~3/4 of
    # adjacent symbol pairs fit one 12-bit window — the native drain loop
    # runs ~1.6x fewer iterations. int64 layout (see jdt_entropy.cpp):
    #   [15:0]  val1 (int16)        [31:16] val2 (int16)
    #   [35:32] off1 = run1         [41:36] off2 = run1 + 1 + run2
    #   [45:42] w1 (bits, sym 1)    [51:46] w  (bits, whole entry)
    #   [54:52] kind: 0 pair, 1 coef, 2 EOB, 3 ZRL, 4 slow, 5 coef+EOB
    vlut2: np.ndarray = None  # (4096,) int64
    # Progressive-AC variant of vlut: symbols (r<<4)|0 are EOBn runs there,
    # not zero coefficients; kinds: 0 coef, 1 EOBn, 2 ZRL, 3 slow. EOBn
    # entries carry run in [25:22] and the CODE length in [21:16] (the r
    # extension bits are read separately); coef entries carry the raw value
    # (the decoder applies << al).
    pvlut: np.ndarray = None  # (4096,) int32

    def decode_peek(self, peek16: int) -> tuple[int, int]:
        length = int(self.lut_length[peek16])
        if length == 0:
            raise JpegEntropyError("invalid Huffman code")
        return int(self.lut_symbol[peek16]), length

    def decode(self, reader) -> int:
        """Decode one symbol from a bit reader (LUT form): one 16-bit peek,
        one table hit, one skip — the O(1) replacement for the reference's
        compare walk (SURVEY.md §3.4)."""
        sym, length = self.decode_peek(reader.peek16())
        reader.skip(length)
        return sym


@dataclasses.dataclass(frozen=True)
class _LutCacheKey:
    counts: bytes
    symbols: bytes


@functools.lru_cache(maxsize=256)
def _flat_lut_cached(key: _LutCacheKey) -> "FlatLut":
    spec = HuffTableSpec(
        table_class=0,
        table_id=0,
        counts=np.frombuffer(key.counts, dtype=np.uint8).copy(),
        symbols=np.frombuffer(key.symbols, dtype=np.uint8).copy(),
    )
    return build_flat_lut(build_canonical(spec))


def flat_lut_for_spec(spec: HuffTableSpec) -> "FlatLut":
    """Content-cached flat LUT: the same DHT bytes recur across a stream of
    same-encoder JPEGs (serving), so the 2x64Ki-entry build runs once per
    distinct table, not once per image."""
    return _flat_lut_cached(
        _LutCacheKey(spec.counts.tobytes(), spec.symbols.tobytes())
    )


# Pair-table window width in bits. 12 (32 KB/table) was the round-2 choice;
# the width is parametrized so the table-size-vs-hit-rate tradeoff can be
# re-measured (the native kernel must be built with the matching
# JDT_PAIR_SHIFT = 64 - PAIR_BITS; native/build.py keeps them in sync).
PAIR_BITS = 12


def _build_vlut2(
    lut_length: np.ndarray, lut_symbol: np.ndarray, bits: int
) -> np.ndarray:
    """Pair-resolved AC table at a `bits`-wide window (vlut2 layout in the
    FlatLut docstring). Symbol 2's fields come from re-indexing the
    single-symbol arrays at the window shifted past symbol 1: idx2's entry
    depends only on its top w2 bits, so when w1 + w2 <= bits the
    zero-padded shift is exact."""
    nb = 1 << bits
    jb = np.arange(nb) << (16 - bits)
    lenb = lut_length[jb].astype(np.int64)
    symb = lut_symbol[jb].astype(np.int64)
    okb = (lenb > 0) & (lenb <= bits)
    run = symb >> 4
    size = symb & 0x0F
    total = lenb + size
    coef_ok = okb & (symb != 0) & (symb != 0xF0) & (total <= bits)
    shift = np.clip(bits - total, 0, bits)
    vbits = (np.arange(nb) >> shift) & ((1 << np.clip(size, 0, bits)) - 1)
    half = np.where(size > 0, 1 << np.maximum(size - 1, 0), 0)
    value = np.where((size > 0) & (vbits < half), vbits - 2 * half + 1, vbits)

    idx = np.arange(nb, dtype=np.int64)
    w1 = np.clip(total, 0, bits)
    idx2 = (idx << w1) & (nb - 1)
    coef2 = coef_ok[idx2]
    eob2 = okb[idx2] & (symb[idx2] == 0)
    run2 = run[idx2]
    total2 = total[idx2]
    value2 = value[idx2]
    len2 = lenb[idx2]
    pair_ok = coef_ok & coef2 & (total + total2 <= bits)
    pair_eob = coef_ok & ~pair_ok & eob2 & (total + len2 <= bits)
    off2 = run + 1 + run2
    K_PAIR, K_COEF, K_EOB, K_ZRL, K_SLOW, K_COEF_EOB = 0, 1, 2, 3, 4, 5
    vlut2 = np.full(nb, K_SLOW << 52, dtype=np.int64)
    vlut2 = np.where(
        okb & (symb == 0), (K_EOB << 52) | (lenb << 46), vlut2
    )
    vlut2 = np.where(
        okb & (symb == 0xF0), (K_ZRL << 52) | (lenb << 46), vlut2
    )
    # COEF entries duplicate the symbol into the val2/off2 slots so the
    # decoder's hot loop can treat PAIR and COEF uniformly (the second
    # store just rewrites the same coefficient).
    vlut2 = np.where(
        coef_ok,
        (K_COEF << 52) | (total << 46) | (total << 42) | (run << 36)
        | (run << 32) | ((value & 0xFFFF) << 16) | (value & 0xFFFF),
        vlut2,
    )
    vlut2 = np.where(
        pair_eob,
        (np.int64(K_COEF_EOB) << 52) | ((total + len2) << 46) | (total << 42)
        | (run << 32) | (value & 0xFFFF),
        vlut2,
    )
    vlut2 = np.where(
        pair_ok,
        (K_PAIR << 52) | ((total + total2) << 46) | (total << 42)
        | (off2 << 36) | (run << 32) | ((value2 & 0xFFFF) << 16)
        | (value & 0xFFFF),
        vlut2,
    )
    return vlut2


def build_flat_lut(canon: CanonicalTable) -> FlatLut:
    lut_symbol = np.zeros(65536, dtype=np.uint8)
    lut_length = np.zeros(65536, dtype=np.uint8)
    spec = canon.spec
    for j in range(16):
        if int(canon.min_codes[j]) == -1:
            continue
        length = j + 1
        lo = int(canon.min_codes[j])
        hi = int(canon.max_codes[j])
        base = int(canon.symbol_start[j])
        span = 16 - length  # free low bits
        for code in range(lo, hi + 1):
            start = code << span
            end = (code + 1) << span
            lut_symbol[start:end] = spec.symbols[base + (code - lo)]
            lut_length[start:end] = length

    # Derived native-runtime tables (vectorized; see class docstring).
    lut16c = (lut_length.astype(np.uint16) << 8) | lut_symbol
    j12 = np.arange(4096) << 4
    len12 = lut_length[j12].astype(np.int64)
    sym12 = lut_symbol[j12].astype(np.int64)
    ok12 = (len12 > 0) & (len12 <= 12)
    lut12c = np.where(ok12, lut16c[j12], 0).astype(np.uint16)

    KIND_EOB, KIND_ZRL, KIND_SLOW = 1, 2, 3
    run = sym12 >> 4
    size = sym12 & 0x0F
    total = len12 + size
    coef_ok = ok12 & (sym12 != 0) & (sym12 != 0xF0) & (total <= 12)
    shift = np.clip(12 - total, 0, 12)
    vbits = (np.arange(4096) >> shift) & ((1 << np.clip(size, 0, 12)) - 1)
    half = np.where(size > 0, 1 << np.maximum(size - 1, 0), 0)
    value = np.where((size > 0) & (vbits < half), vbits - 2 * half + 1, vbits)
    vlut = np.full(4096, KIND_SLOW << 26, dtype=np.int64)
    vlut = np.where(
        ok12 & (sym12 == 0), (KIND_EOB << 26) | (len12 << 16), vlut
    )
    vlut = np.where(
        ok12 & (sym12 == 0xF0), (KIND_ZRL << 26) | (len12 << 16), vlut
    )
    vlut = np.where(
        coef_ok, (run << 22) | (total << 16) | (value & 0xFFFF), vlut
    )

    vlut2 = _build_vlut2(lut_length, lut_symbol, PAIR_BITS)

    # Progressive-AC variant (spec G.1.2.2 semantics): size==0 means an
    # EOBn run of (1<<run)+extra blocks (run<15) or ZRL (run==15); the r
    # extension bits must still be in the stream, so EOBn entries are only
    # fast-pathed when len is known (extension read by the decoder).
    KIND_EOBN = 1
    pvlut = np.full(4096, KIND_SLOW << 26, dtype=np.int64)
    eobn_ok = ok12 & (size == 0) & (run != 15)
    pvlut = np.where(
        eobn_ok, (KIND_EOBN << 26) | (run << 22) | (len12 << 16), pvlut
    )
    pvlut = np.where(
        ok12 & (sym12 == 0xF0), (KIND_ZRL << 26) | (len12 << 16), pvlut
    )
    pvlut = np.where(
        coef_ok & (size > 0),
        (run << 22) | (total << 16) | (value & 0xFFFF),
        pvlut,
    )
    return FlatLut(
        lut_symbol=lut_symbol,
        lut_length=lut_length,
        lut16c=np.ascontiguousarray(lut16c),
        lut12c=np.ascontiguousarray(lut12c),
        vlut=np.ascontiguousarray(vlut.astype(np.int32)),
        vlut2=np.ascontiguousarray(vlut2),
        pvlut=np.ascontiguousarray(pvlut.astype(np.int32)),
    )


# ---------------------------------------------------------------------------
# Encode side
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EncodeTable:
    """Symbol -> (code, length) for Huffman packing (spec C.3 EHUFCO/EHUFSI)."""

    code: np.ndarray  # (256,) uint16
    size: np.ndarray  # (256,) uint8 (0 = symbol absent)


def build_encode_table(spec: HuffTableSpec) -> EncodeTable:
    canon = build_canonical(spec)
    code = np.zeros(256, dtype=np.uint16)
    size = np.zeros(256, dtype=np.uint8)
    for j in range(16):
        if int(canon.min_codes[j]) == -1:
            continue
        base = int(canon.symbol_start[j])
        cnt = int(spec.counts[j])
        for k in range(cnt):
            s = int(spec.symbols[base + k])
            code[s] = int(canon.min_codes[j]) + k
            size[s] = j + 1
    return EncodeTable(code=code, size=size)


def optimal_code_lengths(freq_in: np.ndarray) -> HuffTableSpec:
    """Annex K.2 procedure: frequencies -> BITS/HUFFVAL limited to 16 bits.

    freq_in: (256,) int64 symbol frequencies. Returns a HuffTableSpec (class
    and id 0; caller re-tags)."""
    freq = np.zeros(257, dtype=np.int64)
    freq[:256] = freq_in
    freq[256] = 1  # reserved symbol guaranteeing no all-ones code (K.2 figure K.1)
    codesize = np.zeros(257, dtype=np.int64)
    others = np.full(257, -1, dtype=np.int64)

    while True:
        nz = np.flatnonzero(freq > 0)
        if nz.size <= 1:
            break
        # v1 = least frequent (largest index breaks ties), v2 = next least
        order = nz[np.lexsort((-nz, freq[nz]))]
        v1, v2 = int(order[0]), int(order[1])
        freq[v1] += freq[v2]
        freq[v2] = 0
        codesize[v1] += 1
        while others[v1] != -1:
            v1 = int(others[v1])
            codesize[v1] += 1
        others[v1] = v2
        codesize[v2] += 1
        while others[v2] != -1:
            v2 = int(others[v2])
            codesize[v2] += 1

    # Clamp pathological depths (>32 is possible only for astronomically
    # skewed frequencies) so Sort_Input below still collects every symbol.
    codesize = np.minimum(codesize, 32)
    bits = np.zeros(33, dtype=np.int64)
    for i in range(257):
        if codesize[i] > 0:
            bits[int(codesize[i])] += 1

    # Adjust_BITS (figure K.3): fold lengths > 16 down.
    i = 32
    while i > 16:
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
        i -= 1
    # Remove the reserved symbol's code (largest code of longest length).
    j = 16
    while bits[j] == 0:
        j -= 1
    bits[j] -= 1

    # Sort_Input (figure K.4): symbols by (codesize, value).
    huffval = []
    for size in range(1, 33):
        for sym in range(256):
            if codesize[sym] == size:
                huffval.append(sym)
    counts = bits[1:17].astype(np.uint8)
    return HuffTableSpec(
        table_class=0,
        table_id=0,
        counts=counts,
        symbols=np.array(huffval, dtype=np.uint8),
    )


# ---------------------------------------------------------------------------
# Annex K default tables (K.3.3) — used by the encoder's "annex_k" mode.
# ---------------------------------------------------------------------------


def _spec(table_class: int, table_id: int, counts, symbols) -> HuffTableSpec:
    return HuffTableSpec(
        table_class=table_class,
        table_id=table_id,
        counts=np.array(counts, dtype=np.uint8),
        symbols=np.array(symbols, dtype=np.uint8),
    )


def annex_k_dc_luminance() -> HuffTableSpec:
    return _spec(
        0, 0,
        [0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0],
        list(range(12)),
    )


def annex_k_dc_chrominance() -> HuffTableSpec:
    return _spec(
        0, 1,
        [0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
        list(range(12)),
    )


def annex_k_ac_luminance() -> HuffTableSpec:
    return _spec(
        1, 0,
        [0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D],
        [
            0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12,
            0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07,
            0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08,
            0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0,
            0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16,
            0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
            0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
            0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49,
            0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
            0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69,
            0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79,
            0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
            0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98,
            0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7,
            0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
            0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5,
            0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4,
            0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2,
            0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA,
            0xF1, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8,
            0xF9, 0xFA,
        ],
    )


def annex_k_ac_chrominance() -> HuffTableSpec:
    return _spec(
        1, 1,
        [0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77],
        [
            0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21,
            0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71,
            0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
            0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0,
            0x15, 0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24, 0x34,
            0xE1, 0x25, 0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26,
            0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38,
            0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48,
            0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
            0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68,
            0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78,
            0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
            0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96,
            0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5,
            0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4,
            0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3,
            0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2,
            0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA,
            0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9,
            0xEA, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8,
            0xF9, 0xFA,
        ],
    )
