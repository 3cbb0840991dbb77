"""Host-side entropy encoding: run/size symbol stream + Huffman bit packing.

The serialization halves the reference does ship are dead and bit-buggy
(`encode_huff_tables` reference/src/huff_table.c:69-163 — inverted
length check at :78; `encode_quant_tables` quant_table.c:48-89 — `&&` for
`&` at :72). This module is built from spec F.1.2 (sequential DCT encode
procedures) instead:

  * `BitWriter` — MSB-first accumulator with 0xFF00 byte stuffing and
    1-fill alignment (spec F.1.2.3);
  * `encode_blocks` — DC-predicted run/size symbol walk over zigzag
    coefficient blocks in MCU order, emitting Huffman codes + extend bits,
    with restart markers every `ri` MCUs;
  * `count_symbols` — the same walk emitting only symbol frequencies, for
    two-pass optimized Huffman tables (Annex K.2 via
    core/huffman.optimal_code_lengths).
"""

from __future__ import annotations

import numpy as np

from .huffman import EncodeTable

RST0 = 0xD0


class BitWriter:
    """MSB-first bit accumulator with JPEG byte stuffing."""

    __slots__ = ("out", "_acc", "_nbits")

    def __init__(self) -> None:
        self.out = bytearray()
        self._acc = 0
        self._nbits = 0

    def put(self, value: int, nbits: int) -> None:
        if nbits == 0:
            return
        self._acc = (self._acc << nbits) | (value & ((1 << nbits) - 1))
        self._nbits += nbits
        while self._nbits >= 8:
            self._nbits -= 8
            byte = (self._acc >> self._nbits) & 0xFF
            self.out.append(byte)
            if byte == 0xFF:
                self.out.append(0x00)  # stuffing (spec B.1.1.5)
        self._acc &= (1 << self._nbits) - 1

    def align(self) -> None:
        """Pad the final partial byte with 1-bits (spec F.1.2.3)."""
        if self._nbits:
            self.put(0xFF, 8 - self._nbits)

    def restart(self, n: int) -> None:
        """Byte-align and emit RSTn."""
        self.align()
        self.out += bytes((0xFF, RST0 + (n & 7)))

    def getvalue(self) -> bytes:
        self.align()
        return bytes(self.out)


def _csize(v: int) -> int:
    """Bit category of a coefficient value (spec F.1.2.1.1, Table F.1)."""
    return int(v).bit_length() if v >= 0 else int(-v).bit_length()


def _put_code(bw: BitWriter, table: EncodeTable, sym: int) -> None:
    size = int(table.size[sym])
    if size == 0:
        raise ValueError(f"symbol 0x{sym:02X} absent from Huffman table")
    bw.put(int(table.code[sym]), size)


def _encode_one_block(
    bw: BitWriter | None,
    freq_dc: np.ndarray | None,
    freq_ac: np.ndarray | None,
    dc_table: EncodeTable | None,
    ac_table: EncodeTable | None,
    zz: np.ndarray,
    pred: int,
) -> int:
    """Emit (or count) one block's symbols; returns the new DC predictor."""
    dc = int(zz[0])
    diff = dc - pred
    s = _csize(diff)
    if bw is not None:
        _put_code(bw, dc_table, s)
        if s:
            v = diff if diff >= 0 else diff + (1 << s) - 1
            bw.put(v, s)
    else:
        freq_dc[s] += 1

    nz = np.flatnonzero(zz[1:63 + 1]) + 1
    run_start = 1
    for idx in nz:
        run = int(idx) - run_start
        while run >= 16:
            if bw is not None:
                _put_code(bw, ac_table, 0xF0)  # ZRL
            else:
                freq_ac[0xF0] += 1
            run -= 16
        v = int(zz[idx])
        s = _csize(v)
        sym = (run << 4) | s
        if bw is not None:
            _put_code(bw, ac_table, sym)
            ev = v if v >= 0 else v + (1 << s) - 1
            bw.put(ev, s)
        else:
            freq_ac[sym] += 1
        run_start = int(idx) + 1
    if run_start <= 63:
        if bw is not None:
            _put_code(bw, ac_table, 0x00)  # EOB
        else:
            freq_ac[0x00] += 1
    return dc


# ---------------------------------------------------------------------------
# Progressive scans (spectral selection, spec G.2) — encode side.
# The decoder counterpart is core/oracle._ac_first; the reference has no
# progressive encoder (or decoder that works).
# ---------------------------------------------------------------------------


def _flush_eobrun(bw: BitWriter | None, freq: np.ndarray | None,
                  table: EncodeTable | None, eobrun: int) -> int:
    """Emit (or count) a pending EOB run; returns 0."""
    while eobrun > 0:
        chunk = min(eobrun, 32767)
        r = chunk.bit_length() - 1
        if bw is not None:
            _put_code(bw, table, r << 4)
            if r:
                bw.put(chunk - (1 << r), r)
        else:
            freq[r << 4] += 1
        eobrun -= chunk
    return 0


def encode_dc_scan(
    dcs: np.ndarray,
    unit_sci: list[int],
    table_of_unit: list[int],
    dc_tables: list[EncodeTable] | None,
    freq: list[np.ndarray] | None = None,
) -> bytes:
    """Progressive DC scan (ss=0, se=0, ah=0, al=0), interleaved MCU order.

    dcs: [total_units] int32 DC coefficients in MCU order. When `freq` is
    given, counts symbols instead of emitting."""
    bw = None if freq is not None else BitWriter()
    preds = [0] * 4
    u = len(unit_sci)
    for i, dc in enumerate(np.asarray(dcs, dtype=np.int64)):
        sci = unit_sci[i % u]
        t = table_of_unit[i % u]
        diff = int(dc) - preds[sci]
        preds[sci] = int(dc)
        s = _csize(diff)
        if bw is not None:
            _put_code(bw, dc_tables[t], s)
            if s:
                bw.put(diff if diff >= 0 else diff + (1 << s) - 1, s)
        else:
            freq[t][s] += 1
    return bw.getvalue() if bw is not None else b""


def encode_ac_scan(
    blocks: np.ndarray,
    ss: int,
    se: int,
    ac_table: EncodeTable | None,
    freq: np.ndarray | None = None,
) -> bytes:
    """Progressive AC-first scan (ah=0, al=0) for ONE component,
    non-interleaved block raster order, with EOB-run coding (G.2.2).

    blocks: [n_blocks, 64] zigzag coefficients."""
    bw = None if freq is not None else BitWriter()
    eobrun = 0
    for zz in blocks:
        band = zz[ss : se + 1]
        nz = np.flatnonzero(band)
        if nz.size == 0:
            eobrun += 1
            if eobrun == 32767:
                eobrun = _flush_eobrun(bw, freq, ac_table, eobrun)
            continue
        eobrun = _flush_eobrun(bw, freq, ac_table, eobrun)
        run = 0
        last = int(nz[-1])
        for k in range(last + 1):
            v = int(band[k])
            if v == 0:
                run += 1
                continue
            while run >= 16:
                if bw is not None:
                    _put_code(bw, ac_table, 0xF0)
                else:
                    freq[0xF0] += 1
                run -= 16
            s = _csize(v)
            if bw is not None:
                _put_code(bw, ac_table, (run << 4) | s)
                bw.put(v if v >= 0 else v + (1 << s) - 1, s)
            else:
                freq[(run << 4) | s] += 1
            run = 0
        if last < se - ss:
            eobrun += 1  # this block's tail is part of an EOB run
    _flush_eobrun(bw, freq, ac_table, eobrun)
    return bw.getvalue() if bw is not None else b""


def encode_blocks(
    mcu_blocks: list[tuple[int, np.ndarray]],
    dc_tables: list[EncodeTable],
    ac_tables: list[EncodeTable],
    table_of_unit: list[tuple[int, int]],
    units_per_mcu: int,
    restart_interval: int = 0,
) -> bytes:
    """Pack an entropy-coded segment.

    mcu_blocks: flat list of (scan_component_index, zz[64]) in MCU order.
    table_of_unit: per unit-in-MCU, (dc_table_idx, ac_table_idx).
    """
    bw = BitWriter()
    preds = [0] * 4
    total_units = len(mcu_blocks)
    rst = 0
    for i in range(0, total_units, units_per_mcu):
        mcu = i // units_per_mcu
        if restart_interval and mcu > 0 and mcu % restart_interval == 0:
            bw.restart(rst)
            rst = (rst + 1) & 7
            preds = [0] * 4
        for u in range(units_per_mcu):
            sci, zz = mcu_blocks[i + u]
            dct_i, act_i = table_of_unit[u]
            preds[sci] = _encode_one_block(
                bw, None, None, dc_tables[dct_i], ac_tables[act_i], zz,
                preds[sci],
            )
    return bw.getvalue()


def count_symbols(
    mcu_blocks: list[tuple[int, np.ndarray]],
    n_dc_tables: int,
    n_ac_tables: int,
    table_of_unit: list[tuple[int, int]],
    units_per_mcu: int,
    restart_interval: int = 0,
) -> tuple[list[np.ndarray], list[np.ndarray]]:
    """Frequency-count pass for optimized Huffman tables (Annex K.2)."""
    freq_dc = [np.zeros(256, dtype=np.int64) for _ in range(n_dc_tables)]
    freq_ac = [np.zeros(256, dtype=np.int64) for _ in range(n_ac_tables)]
    preds = [0] * 4
    total_units = len(mcu_blocks)
    for i in range(0, total_units, units_per_mcu):
        mcu = i // units_per_mcu
        if restart_interval and mcu > 0 and mcu % restart_interval == 0:
            preds = [0] * 4
        for u in range(units_per_mcu):
            sci, zz = mcu_blocks[i + u]
            dct_i, act_i = table_of_unit[u]
            preds[sci] = _encode_one_block(
                None, freq_dc[dct_i], freq_ac[act_i], None, None, zz,
                preds[sci],
            )
    return freq_dc, freq_ac
