"""The benchmark's own JPEG writer: baseline sequential 4:2:0 streams of
given quantised coefficients, Huffman-coded with the Annex K tables
(K.3.3).

The headers are written here; the entropy-coded data by one small C
function (`csrc/pack.c`: DC differences per component, runs of zeros, ZRL
and EOB, 0x00 after every 0xFF, a restart marker every restart interval),
built with the C compiler at first use into `perfbench/build/` under a hash
of its source, and loaded with ctypes: a 4K frame takes milliseconds, where
Python would take seconds of every run's set-up.

It imports nothing of the program; `reference.decode_coefficients` reads
its streams back in the tests.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
import threading
from pathlib import Path

import numpy as np

#: Annex K tables: (counts of codes of each length 1..16, symbols).
DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12)))
AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125], [
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08,
    0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3,
    0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
    0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9,
    0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2,
    0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA,
])
AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119], [
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0, 0x15, 0x62, 0x72, 0xD1,
    0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26,
    0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A,
    0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4,
    0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7,
    0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA,
    0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA,
])

#: 4:2:0: (component id, h, v, quant table, dc table, ac table).
COMPONENTS_420 = ((1, 2, 2, 0, 0, 0), (2, 1, 1, 1, 1, 1), (3, 1, 1, 1, 1, 1))


def code_table(spec) -> tuple[np.ndarray, np.ndarray]:
    """(code, length) of every symbol 0..255 under the canonical code of
    `spec`; length 0 where the table has no such symbol."""
    counts, symbols = spec
    code_of = np.zeros(256, np.int64)
    len_of = np.zeros(256, np.int64)
    code = k = 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            code_of[symbols[k]] = code
            len_of[symbols[k]] = length
            code += 1
            k += 1
        code <<= 1
    return code_of, len_of



SRC = Path(__file__).resolve().parent / "csrc" / "pack.c"
BUILD_DIR = Path(__file__).resolve().parent / "build"
CFLAGS = ("-O2", "-shared", "-fPIC", "-std=c99")

_lib = None
_lock = threading.Lock()


def library() -> ctypes.CDLL:
    """The entropy coder, compiled on first use (cc, or $CC), cached by the
    hash of its source and flags, renamed into place whole."""
    global _lib
    with _lock:
        if _lib is None:
            h = hashlib.sha256(SRC.read_bytes() + " ".join(CFLAGS).encode()).hexdigest()[:16]
            path = BUILD_DIR / f"libpbpack-{h}.so"
            if not path.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = BUILD_DIR / f"libpbpack-{h}.{os.getpid()}.tmp"
                subprocess.run([os.environ.get("CC", "cc"), *CFLAGS, str(SRC), "-o", str(tmp)],
                               check=True, capture_output=True, timeout=120)
                os.replace(tmp, path)
            lib = ctypes.CDLL(str(path))
            fn = lib.pb_pack_scan
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2 + [ctypes.c_void_p] * 3 + [
                ctypes.c_int64, ctypes.c_void_p]
            fn.restype = ctypes.c_int64
            _lib = lib
        return _lib


def code_table(spec) -> tuple[np.ndarray, np.ndarray]:
    """(code, length) of every symbol 0..255 under the canonical code of
    `spec`; length 0 where the table has no such symbol."""
    counts, symbols = spec
    code_of = np.zeros(256, np.int32)
    len_of = np.zeros(256, np.int32)
    code = k = 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            code_of[symbols[k]] = code
            len_of[symbols[k]] = length
            code += 1
            k += 1
        code <<= 1
    return code_of, len_of


def _flat_tables() -> tuple[np.ndarray, np.ndarray]:
    """(codes, lengths), int32 [4, 256]: luma DC, luma AC, chroma DC,
    chroma AC."""
    tabs = [code_table(s) for s in (DC_LUMA, AC_LUMA, DC_CHROMA, AC_CHROMA)]
    return (np.ascontiguousarray(np.stack([t[0] for t in tabs])),
            np.ascontiguousarray(np.stack([t[1] for t in tabs])))


def scan_order_420(planes, mcus_x: int, mcus_y: int):
    """The blocks of interleaved 4:2:0 planes in scan order: (int16
    [n, 64] zigzag coefficients, table set per block (0 luma, 1 chroma),
    component per block). Each MCU: four luma blocks row by row, then Cb,
    then Cr."""
    y, cb, cr = planes
    yb = (y[:2 * mcus_y, :2 * mcus_x].reshape(mcus_y, 2, mcus_x, 2, 64)
          .transpose(0, 2, 1, 3, 4).reshape(mcus_y, mcus_x, 4, 64))
    mcu = np.concatenate([yb, cb[:mcus_y, :mcus_x, None], cr[:mcus_y, :mcus_x, None]], axis=2)
    comp = np.tile(np.array([0, 0, 0, 0, 1, 2], np.uint8), mcus_y * mcus_x)
    return (np.ascontiguousarray(mcu.reshape(-1, 64), dtype=np.int16),
            np.minimum(comp, 1), comp)


def header(width: int, height: int, qts_zz, ri: int) -> bytes:
    """SOI, DQT (two tables, zigzag order), SOF0 4:2:0, DHT (Annex K), DRI
    when ri > 0, SOS."""
    out = bytearray(b"\xff\xd8")
    for tq, qt in enumerate(qts_zz):
        q = np.asarray(qt)
        if q.min() < 1 or q.max() > 255:
            raise ValueError("8-bit quant tables only")
        out += b"\xff\xdb" + struct.pack(">HB", 67, tq) + q.astype(np.uint8).tobytes()
    out += b"\xff\xc0" + struct.pack(">HBHHB", 17, 8, height, width, 3)
    for cid, h, v, tq, _, _ in COMPONENTS_420:
        out += bytes([cid, h * 16 + v, tq])
    for tc, th, (counts, symbols) in ((0, 0, DC_LUMA), (1, 0, AC_LUMA),
                                      (0, 1, DC_CHROMA), (1, 1, AC_CHROMA)):
        body = bytes([tc * 16 + th]) + bytes(counts) + bytes(symbols)
        out += b"\xff\xc4" + struct.pack(">H", 2 + len(body)) + body
    if ri:
        out += b"\xff\xdd" + struct.pack(">HH", 4, ri)
    out += b"\xff\xda" + struct.pack(">HB", 12, 3)
    for cid, _, _, _, td, ta in COMPONENTS_420:
        out += bytes([cid, td * 16 + ta])
    out += bytes([0, 63, 0])
    return bytes(out)


def pack_420(images, width: int, height: int, qts_zz, ri: int) -> tuple[list[bytes], list[int]]:
    """Baseline 4:2:0 streams of `images`, each a (Y, Cb, Cr) triple of
    int16 zigzag planes at MCU padding for width x height; one restart
    marker every `ri` MCUs (0: none). Returns (the streams, the Huffman
    symbols each codes)."""
    fn = library().pb_pack_scan
    codes, lens = _flat_tables()
    mx, my = -(-width // 16), -(-height // 16)
    head = header(width, height, qts_zz, ri)
    streams, symbols = [], []
    for planes in images:
        coefs, table, comp = scan_order_420(planes, mx, my)
        cap = 2 * coefs.nbytes + 1024
        out = np.empty(cap, np.uint8)
        nsym = ctypes.c_int64()
        n = fn(coefs.ctypes.data, table.ctypes.data, comp.ctypes.data, coefs.shape[0],
               6 * ri, codes.ctypes.data, lens.ctypes.data, out.ctypes.data, cap,
               ctypes.byref(nsym))
        if n < 0:
            raise ValueError("a coefficient the Annex K tables do not code")
        streams.append(head + out[:n].tobytes() + b"\xff\xd9")
        symbols.append(nsym.value)
    return streams, symbols
