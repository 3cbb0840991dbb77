"""Byte-stream scanning and bit extraction, vectorized.

The reference walks the stream a byte at a time (`next_byte`
`reference/src/bitstream.c:8-14`) and discovers restart/EOI markers via
a serial 3-byte lookahead per MCU (`check_marker` bitstream.c:84-134). That is
exactly the serial dependence a parallel design must not have, so here the
byte domain is preprocessed with NumPy array scans:

  * `scan_entropy_span`  — one pass finding where a scan's entropy bytes
    end AND every RSTn offset (the segment-parallel seam, SURVEY.md §2);
  * `unstuff`            — remove 0x00 bytes following 0xFF (byte unstuffing,
    reference `next_byte_for_bits` bitstream.c:22-59) in one vector pass.

Bit-level access for host decoders uses the unstuffed buffer with MSB-first
indexing, matching `next_bit` (bitstream.c:61-67).
"""

from __future__ import annotations

import numpy as np

from ..utils.errors import JpegFormatError, JpegTruncatedError


def _native_scan_span(data: np.ndarray, start: int):
    """Try the C++ memchr-based span scan; None -> use the NumPy fallback.
    Imported lazily to keep io/ free of a hard native dependency."""
    try:
        from ..native import runtime as native_runtime
    except Exception:
        return None
    return native_runtime.scan_span(data, start)


def as_byte_array(data: bytes | bytearray | memoryview | np.ndarray) -> np.ndarray:
    """Zero-copy view of the input as a uint8 array."""
    if isinstance(data, np.ndarray):
        if data.dtype != np.uint8:
            raise JpegFormatError(f"expected uint8 buffer, got {data.dtype}")
        return data
    return np.frombuffer(data, dtype=np.uint8)


def read_u16be(data: np.ndarray, off: int) -> int:
    """Big-endian uint16 at `off` with bounds checking (the reference reads
    with no bounds checks anywhere, bitstream.c:10)."""
    if off + 2 > data.shape[0]:
        raise JpegTruncatedError("u16 read past end of stream", offset=off)
    return (int(data[off]) << 8) | int(data[off + 1])


def scan_entropy_span(
    data: np.ndarray, start: int
) -> tuple[int, np.ndarray, np.ndarray | None]:
    """One combined pass over a scan's bytes: returns
    (end, rst_offsets, stuff_offsets) — what entropy_span_end +
    find_restart_markers compute in two passes, plus the offsets of every
    stuffed 0xFF (consumed by the native index-driven unstuff; None when
    the native scan's buffer overflowed on pathological density).
    The classifier: a 0xFF is stuffing (next == 0x00), an in-scan restart
    marker (0xD0-0xD7), a fill byte (next == 0xFF, spec B.1.1.2 — the
    marker comes after the fill run), or the scan terminator (anything
    else / EOF).

    Delegates to the native runtime's memchr-based scan when available
    (identical classification, ~10x faster on multi-MB scans); this NumPy
    body is the semantic reference and the fallback."""
    n = data.shape[0]
    if start >= n:
        raise JpegTruncatedError("scan starts past end of stream", offset=start)

    native = _native_scan_span(data, start)
    if native is not None:
        return native
    ff = np.flatnonzero(data[start:] == 0xFF)
    if ff.size == 0:
        return n, np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64)
    nxt = data[start:][np.minimum(ff + 1, n - start - 1)]
    is_rst = (nxt >= 0xD0) & (nxt <= 0xD7)
    is_fill = nxt == 0xFF
    is_stuff = nxt == 0x00
    is_term = ~(is_stuff | is_rst | is_fill)
    is_term |= (ff + 1) >= (n - start)
    hits = np.flatnonzero(is_term)
    end_rel = int(ff[hits[0]]) if hits.size else n - start
    rst = ff[is_rst & (ff < end_rel)].astype(np.int64) + start
    stuff = ff[is_stuff & (ff < end_rel)].astype(np.int64) + start
    return start + end_rel, rst, stuff


def unstuff(data: np.ndarray, start: int, end: int) -> tuple[np.ndarray, np.ndarray]:
    """Remove stuffed 0x00 bytes after 0xFF within [start, end).

    Returns (unstuffed_bytes, original_offsets) where original_offsets[i] is
    the offset in `data` the i-th unstuffed byte came from (needed to map
    decode errors back to stream positions).
    """
    seg = data[start:end]
    if seg.shape[0] == 0:
        return seg.copy(), np.empty(0, dtype=np.int64)
    # A byte is dropped iff it is 0x00 and the previous byte is 0xFF.
    prev_ff = np.empty(seg.shape[0], dtype=bool)
    prev_ff[0] = False
    np.equal(seg[:-1], 0xFF, out=prev_ff[1:])
    drop = prev_ff & (seg == 0x00)
    keep = ~drop
    offsets = np.flatnonzero(keep).astype(np.int64) + start
    return seg[keep], offsets


class BitReader:
    """MSB-first bit reader over an unstuffed byte buffer.

    Mirrors the observable behavior of the reference Bitstream bit API
    (`next_bit` bitstream.c:61-67, `next_bit_size` bitstream.c:69-78) but with
    bounds checking and O(1) multi-bit reads off a prefix-unpacked bit array.
    """

    __slots__ = ("bits", "pos")

    def __init__(self, unstuffed: np.ndarray):
        self.bits = np.unpackbits(unstuffed).astype(np.int64)
        self.pos = 0

    def read_bit(self) -> int:
        if self.pos >= self.bits.shape[0]:
            raise JpegTruncatedError("bit read past end of entropy data")
        b = int(self.bits[self.pos])
        self.pos += 1
        return b

    def read_bits(self, n: int) -> int:
        """MSB-first n-bit read (reference next_bit_size)."""
        if n == 0:
            return 0
        if self.pos + n > self.bits.shape[0]:
            raise JpegTruncatedError("bit read past end of entropy data")
        chunk = self.bits[self.pos : self.pos + n]
        self.pos += n
        val = 0
        for b in chunk:
            val = (val << 1) | int(b)
        return val

    def peek16(self) -> int:
        """Next 16 bits, left-aligned, zero-padded past the end (for LUT
        decode). Does not advance."""
        end = min(self.pos + 16, self.bits.shape[0])
        chunk = self.bits[self.pos : end]
        val = 0
        for b in chunk:
            val = (val << 1) | int(b)
        return val << (16 - (end - self.pos))

    def skip(self, n: int) -> None:
        self.pos += n

    @property
    def exhausted(self) -> bool:
        return self.pos >= self.bits.shape[0]

    @property
    def overran(self) -> bool:
        # BitReader raises on past-end reads; it can never silently overrun.
        return False


class FastBitReader:
    """Byte-addressed MSB-first bit reader over an unstuffed buffer.

    Same observable API as BitReader but O(1) peeks/reads via Python int
    arithmetic on the byte string instead of a prefix-unpacked bit array —
    the host fast path backing the NumPy LUT entropy backend. Reads past
    the end yield zero bits (callers detect truncation from marker/segment
    bookkeeping), matching the native runtime's padding behavior.
    """

    __slots__ = ("b", "pos", "nbits")

    def __init__(self, unstuffed: np.ndarray):
        self.b = unstuffed.tobytes() + b"\x00" * 8
        self.pos = 0
        self.nbits = (len(self.b) - 8) * 8

    def read_bit(self) -> int:
        p = self.pos
        self.pos = p + 1
        byte = min(p >> 3, len(self.b) - 1)  # far-past-end reads yield 0s
        return (self.b[byte] >> (7 - (p & 7))) & 1

    def read_bits(self, n: int) -> int:
        if n == 0:
            return 0
        p = self.pos
        self.pos = p + n
        byte = min(p >> 3, len(self.b) - 5)
        sh = p & 7
        w = int.from_bytes(self.b[byte : byte + 5], "big")
        return (w >> (40 - sh - n)) & ((1 << n) - 1)

    def peek16(self) -> int:
        p = self.pos
        byte = min(p >> 3, len(self.b) - 4)
        sh = p & 7
        w = int.from_bytes(self.b[byte : byte + 4], "big")
        return (w >> (16 - sh)) & 0xFFFF

    def skip(self, n: int) -> None:
        self.pos += n

    @property
    def exhausted(self) -> bool:
        return self.pos >= self.nbits

    @property
    def overran(self) -> bool:
        """Consumed more than the 7 possible alignment-fill bits past the
        real end: the zero-padded reads decoded fabricated data (matches
        the native runtime's truncation rule)."""
        return self.pos > self.nbits + 7


def receive_extend(value: int, size: int) -> int:
    """JPEG RECEIVE/EXTEND (spec F.2.2.1): map `size` raw bits to a signed
    coefficient difference.

    The reference's form (`decode.c:684-686`): if v < 2^(size-1), v -= 2^size - 1.
    For size == 0 the reference relies on x86 shift-count wrapping to make the
    test false (SURVEY.md quirk ledger); here size 0 explicitly returns 0.
    """
    if size == 0:
        return 0
    if value < (1 << (size - 1)):
        return value - (1 << size) + 1
    return value
