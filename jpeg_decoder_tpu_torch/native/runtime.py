"""ctypes bindings + Python-side orchestration for the native runtime.

`entropy_decode(structure, cfg)` runs every scan of a parsed JPEG through
the C++ segment-parallel entropy decoder (src/jdt_entropy.cpp) into the
coefficient-plane IR. The scan-layout math here mirrors core/oracle.py
exactly (which mirrors the reference's write_mcu coordinate rule,
reference/src/decode.c:475-486); the bitstream work happens in C++.

Falls back cleanly: `available()` returns False when the toolchain or
library is missing, and models/decoder.py then uses the NumPy backend.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from ..core.huffman import build_canonical, build_flat_lut, flat_lut_for_spec
from ..core.driver import run_scans, run_scans_parallel
from ..core.types import CoefficientPlanes, JpegStructure, Scan
from ..io.markers import Encoding
from ..utils.config import DecodeConfig
from ..utils.errors import JpegEntropyError, JpegFormatError
from ..utils.logging import get_logger
from . import build as build_mod

log = get_logger("native.runtime")

_lib = None
_lib_failed = False  # cache build/load failures: retry only on new process
_lib_lock = threading.Lock()
_STATUS = {
    1: "invalid Huffman code",
    2: "coefficient index out of range",
    3: "entropy data truncated",
    4: "bad native-call argument",
    5: "restart-marker count inconsistent with restart interval",
}


def _load():
    global _lib, _lib_failed
    with _lib_lock:
        if _lib is not None:
            return _lib
        if _lib_failed:
            return None  # don't re-run g++ per decode after one failure
        # JDT_LIB overrides the hash-named production build — used by the
        # sanitizer pass (tests/tools/sanitize.sh) to run the whole Python
        # suite against an ASan/UBSan/TSan-instrumented library.
        override = os.environ.get("JDT_LIB")
        path = override if override else build_mod.build()
        if path is None:
            _lib_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            log.error("cannot load native runtime: %s", e)
            _lib_failed = True
            return None
        # ABI gate FIRST: a stale library (e.g. an old build pinned via
        # JDT_LIB) may predate newer entry points, so binding any symbol
        # before the version check would raise an uncaught AttributeError
        # instead of the graceful "ABI mismatch" fallback below.
        try:
            lib.jdt_version.restype = ctypes.c_int32
            version = lib.jdt_version()
        except AttributeError:
            version = -1
        if version != 12:
            log.error(
                "native runtime ABI mismatch (got %d, want 12)", version
            )
            _lib_failed = True
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.jdt_decode_sequential.restype = ctypes.c_int32
        u16p = ctypes.POINTER(ctypes.c_uint16)
        i32pp = ctypes.POINTER(ctypes.c_int32)
        i16pp = ctypes.POINTER(ctypes.c_int16)
        u64pp = ctypes.POINTER(ctypes.c_uint64)
        lib.jdt_decode_sequential.argtypes = [
            u8p,                                 # data
            ctypes.POINTER(ctypes.c_int64),      # seg_bounds
            ctypes.c_int64,                      # n_segs
            ctypes.c_int64,                      # total_mcus
            ctypes.c_int64,                      # ri
            i32pp,                               # unit_params
            ctypes.c_int32,                      # n_units
            ctypes.POINTER(u16p),                # lut12s
            ctypes.POINTER(u16p),                # lut16s
            ctypes.POINTER(i32pp),               # vluts
            ctypes.POINTER(i32pp),               # pvluts
            ctypes.POINTER(u64pp),               # vlut2s
            ctypes.c_int32,                      # n_luts
            ctypes.POINTER(i16pp),               # planes (int16 coeff IR)
            ctypes.c_int32,                      # n_threads
            ctypes.POINTER(ctypes.c_int64),      # err_out
            ctypes.POINTER(ctypes.c_int64),      # stuff (may be None)
            ctypes.c_int64,                      # n_stuff (-1 = absent)
        ]
        # progressive: same prefix but WITHOUT the vlut2s slot (the
        # pair table is sequential-AC-only), plus ss/se/ah/al.
        lib.jdt_decode_progressive.restype = ctypes.c_int32
        lib.jdt_decode_progressive.argtypes = (
            lib.jdt_decode_sequential.argtypes[:11]
            + lib.jdt_decode_sequential.argtypes[12:14]
            + [ctypes.c_int32] * 4               # ss, se, ah, al
            + [ctypes.c_int32, ctypes.POINTER(ctypes.c_int64)]
        )
        lib.jdt_decode_sequential_spec.restype = ctypes.c_int32
        lib.jdt_decode_sequential_spec.argtypes = [
            u8p,                                 # data
            ctypes.c_int64,                      # scan_start
            ctypes.c_int64,                      # scan_end
            ctypes.c_int64,                      # total_mcus
            i32pp,                               # unit_params [n_units x 11]
            ctypes.c_int32,                      # n_units
            ctypes.POINTER(u16p),                # lut12s
            ctypes.POINTER(u16p),                # lut16s
            ctypes.POINTER(i32pp),               # vluts
            ctypes.POINTER(u64pp),               # vlut2s
            ctypes.c_int32,                      # n_luts
            ctypes.POINTER(i16pp),               # planes (int16 coeff IR)
            ctypes.c_int32,                      # n_threads
            ctypes.POINTER(ctypes.c_int64),      # stuff (may be None)
            ctypes.c_int64,                      # n_stuff (-1 = absent)
        ]
        lib.jdt_encode_scan.restype = ctypes.c_int32
        lib.jdt_encode_scan.argtypes = [
            ctypes.POINTER(ctypes.c_int32),      # blocks
            ctypes.c_int64,                      # total_units
            ctypes.c_int32,                      # units_per_mcu
            ctypes.POINTER(ctypes.c_int32),      # unit_sci
            ctypes.POINTER(ctypes.c_int32),      # unit_dc
            ctypes.POINTER(ctypes.c_int32),      # unit_ac
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint16)),  # dc_codes
            ctypes.POINTER(u8p),                 # dc_sizes
            ctypes.c_int32,                      # n_dc
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint16)),  # ac_codes
            ctypes.POINTER(u8p),                 # ac_sizes
            ctypes.c_int32,                      # n_ac
            ctypes.c_int64,                      # ri
            ctypes.c_int32,                      # n_threads
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),   # out
            ctypes.POINTER(ctypes.c_int64),      # out_len
        ]
        lib.jdt_encode_scan_planes.restype = ctypes.c_int32
        lib.jdt_encode_scan_planes.argtypes = [
            ctypes.POINTER(i16pp),               # planes (per-comp blocks)
            ctypes.POINTER(ctypes.c_int64),      # plane_bw (per comp)
            ctypes.POINTER(ctypes.c_int64),      # plane_bh (per comp)
            ctypes.c_int32,                      # n_comps
            ctypes.c_int32,                      # mcus_x
            ctypes.c_int64,                      # total_mcus
            ctypes.c_int32,                      # units_per_mcu
            ctypes.POINTER(ctypes.c_int32),      # unit_params [upm x 8]
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint16)),  # dc_codes
            ctypes.POINTER(u8p),                 # dc_sizes
            ctypes.c_int32,                      # n_dc
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint16)),  # ac_codes
            ctypes.POINTER(u8p),                 # ac_sizes
            ctypes.c_int32,                      # n_ac
            ctypes.c_int64,                      # ri
            ctypes.c_int32,                      # n_threads
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),   # out
            ctypes.POINTER(ctypes.c_int64),      # out_len
        ]
        lib.jdt_count_scan_planes.restype = ctypes.c_int32
        lib.jdt_count_scan_planes.argtypes = [
            ctypes.POINTER(i16pp),               # planes (per-comp blocks)
            ctypes.POINTER(ctypes.c_int64),      # plane_bw (per comp)
            ctypes.POINTER(ctypes.c_int64),      # plane_bh (per comp)
            ctypes.c_int32,                      # n_comps
            ctypes.c_int32,                      # mcus_x
            ctypes.c_int64,                      # total_mcus
            ctypes.c_int32,                      # units_per_mcu
            ctypes.POINTER(ctypes.c_int32),      # unit_params [upm x 8]
            ctypes.c_int32,                      # n_dc
            ctypes.c_int32,                      # n_ac
            ctypes.c_int64,                      # ri
            ctypes.c_int32,                      # n_threads
            ctypes.POINTER(ctypes.c_int64),      # dc_freq [n_dc * 256]
            ctypes.POINTER(ctypes.c_int64),      # ac_freq [n_ac * 256]
        ]
        lib.jdt_free.restype = None
        lib.jdt_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.jdt_scan_span.restype = ctypes.c_int32
        lib.jdt_scan_span.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int64,  # data, n, start
            i64p,                                  # end_out
            i64p, ctypes.c_int64,                  # rst_out, max_rst
            i64p,                                  # n_rst_out
            ctypes.c_int32,                        # n_threads
            i64p, ctypes.c_int64, i64p,            # stuff_out, max, n_out
        ]
        lib.jdt_scan_decode.restype = ctypes.c_int32
        lib.jdt_scan_decode.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int64,   # data, n, start
            ctypes.c_int64, ctypes.c_int64,        # total_mcus, ri
            i32pp, ctypes.c_int32,                 # unit_params, n_units
            ctypes.POINTER(u16p),                  # lut12s
            ctypes.POINTER(u16p),                  # lut16s
            ctypes.POINTER(i32pp),                 # vluts
            ctypes.POINTER(u64pp),                 # vlut2s
            ctypes.c_int32,                        # n_luts
            ctypes.POINTER(i16pp),                 # planes
            ctypes.c_int32,                        # n_threads
            ctypes.c_int32,                        # allow_spec
            i64p, i64p,                            # end_out, n_segs_out
            i64p,                                  # err_out [seg, mcu]
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


# ---------------------------------------------------------------------------
# Scan layout (shared with oracle; see oracle._block_position)
# ---------------------------------------------------------------------------


def scan_layout(structure: JpegStructure, scan: Scan):
    """Returns (total_mcus, unit_params int32 [n_units, 11], lut arrays).

    unit_params columns: plane, scomp, dc_lut, ac_lut, h, v, j, k, wrap,
    plane_bw, plane_bh — consumed by UnitLayout in jdt_entropy.cpp.
    """
    frame = structure.frame
    sh = scan.header

    # Progressive scan-header validation (same rules the oracle enforces;
    # spec G.1.1.1.1) — without this, an interleaved AC scan would share
    # one EOB run across units and silently decode garbage.
    if frame.process == Encoding.PROGRESSIVE_DCT:
        if sh.ss == 0 and sh.se != 0:
            raise JpegFormatError(
                "progressive scan with ss=0 must have se=0 (G.1.1.1.1)"
            )
        if sh.ss != 0 and sh.nics != 1:
            raise JpegFormatError("progressive AC scan must be non-interleaved")
        if sh.ss > sh.se:
            raise JpegFormatError(
                f"progressive scan has ss={sh.ss} > se={sh.se}"
            )

    luts = []
    lut_index: dict[tuple[int, int], int] = {}

    def lut_for(table_class: int, table_id: int, tables) -> int:
        key = (table_class, table_id)
        if key not in lut_index:
            if table_id not in tables:
                raise JpegFormatError(
                    f"scan uses undefined {'DC' if table_class == 0 else 'AC'}"
                    f" table {table_id}"
                )
            flat = flat_lut_for_spec(tables[table_id])
            lut_index[key] = len(luts)
            luts.append(flat)
        return lut_index[key]

    units = []
    is_dc_scan = frame.process == Encoding.PROGRESSIVE_DCT and sh.ss == 0
    is_prog = frame.process == Encoding.PROGRESSIVE_DCT
    needs_dc = (not is_prog) or (is_dc_scan and sh.ah == 0)
    needs_ac = (not is_prog) or (not is_dc_scan)

    if sh.nics == 1:
        sc = sh.components[0]
        ci, c = frame.find_component(sc.sc)
        pad_x = (c.x + 7) // 8
        pad_y = (c.y + 7) // 8
        total_mcus = pad_x * pad_y
        plane_bw, plane_bh = c.blocks_x, c.blocks_y
        wrap = pad_x if plane_bw > pad_x else plane_bw
        dc = lut_for(0, sc.dc, scan.dc_tables) if needs_dc else 0
        ac = lut_for(1, sc.ac, scan.ac_tables) if needs_ac else 0
        units.append((ci, 0, dc, ac, 1, 1, 0, 0, wrap, plane_bw, plane_bh))
    else:
        total_mcus = frame.mcus_x * frame.mcus_y
        for sci, sc in enumerate(sh.components):
            ci, c = frame.find_component(sc.sc)
            dc = lut_for(0, sc.dc, scan.dc_tables) if needs_dc else 0
            ac = lut_for(1, sc.ac, scan.ac_tables) if needs_ac else 0
            pad = 8 * c.hsf
            x_to_mcu = (c.x + ((pad - (c.x % pad)) % pad)) // 8
            plane_bw, plane_bh = c.blocks_x, c.blocks_y
            wrap = x_to_mcu if plane_bw > x_to_mcu else plane_bw
            for j in range(c.vsf):
                for k in range(c.hsf):
                    units.append(
                        (ci, sci, dc, ac, c.hsf, c.vsf, j, k,
                         wrap, plane_bw, plane_bh)
                    )

    if not luts:
        # DC-refine scans decode raw bits only; the C side still wants one
        # valid LUT pointer pair.
        from ..core.types import HuffTableSpec

        dummy = HuffTableSpec(
            table_class=0,
            table_id=0,
            counts=np.array([1] + [0] * 15, dtype=np.uint8),
            symbols=np.array([0], dtype=np.uint8),
        )
        luts.append(build_flat_lut(build_canonical(dummy)))

    params = np.array(units, dtype=np.int32)
    return total_mcus, params, luts


def _check_segments(scan: Scan, total_mcus: int) -> int:
    """Validate segment count against the restart interval; returns n_segs."""
    n_segs = scan.span.num_segments
    ri = scan.restart_interval
    if ri == 0:
        if n_segs != 1:
            # Restart markers present but DRI never seen: reference would
            # desync; treat as malformed.
            raise JpegEntropyError(
                f"{n_segs - 1} restart markers in scan but restart interval 0"
            )
        return 1
    expect = -(-total_mcus // ri)
    if n_segs != expect:
        raise JpegEntropyError(
            f"scan has {n_segs} restart segments, expected {expect}"
        )
    return n_segs


def _try_speculative(
    structure: JpegStructure, scan: Scan, planes: CoefficientPlanes,
    cfg: DecodeConfig, total_mcus: int, params: np.ndarray, luts,
) -> bool:
    """Chunk-parallel decode of a no-restart sequential scan via Huffman
    self-synchronization (jdt_decode_sequential_spec) — single-component or
    interleaved (the table phase is folded into the sync key on the C++
    side). Returns True when the speculative path succeeded."""
    lib = _load()
    sh = scan.header
    if (
        scan.restart_interval != 0
        or scan.span.num_segments != 1  # stray RSTn bytes: serial path errors
        or structure.frame.process == Encoding.PROGRESSIVE_DCT
        or total_mcus * params.shape[0] < 4096  # not worth stitch overhead
        or cfg.num_threads == 1
    ):
        return False
    frame = structure.frame
    i32p = ctypes.POINTER(ctypes.c_int32)
    i16p = ctypes.POINTER(ctypes.c_int16)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u16p = ctypes.POINTER(ctypes.c_uint16)
    data = np.ascontiguousarray(structure.data)
    params_c = np.ascontiguousarray(params, dtype=np.int32)
    lut12s = (u16p * len(luts))(
        *[lut.lut12c.ctypes.data_as(u16p) for lut in luts]
    )
    lut16s = (u16p * len(luts))(
        *[lut.lut16c.ctypes.data_as(u16p) for lut in luts]
    )
    vluts = (i32p * len(luts))(
        *[lut.vlut.ctypes.data_as(i32p) for lut in luts]
    )
    u64p = ctypes.POINTER(ctypes.c_uint64)
    vlut2s = (u64p * len(luts))(
        *[lut.vlut2.ctypes.data_as(u64p) for lut in luts]
    )
    plane_ptrs = (i16p * frame.ncs)(
        *[planes.plane(i).ctypes.data_as(i16p) for i in range(frame.ncs)]
    )
    rc = lib.jdt_decode_sequential_spec(
        data.ctypes.data_as(u8p),
        int(scan.span.start),
        int(scan.span.end),
        total_mcus,
        params_c.ctypes.data_as(i32p),
        params_c.shape[0],
        lut12s,
        lut16s,
        vluts,
        vlut2s,
        len(luts),
        plane_ptrs,
        cfg.num_threads,
        *_stuff_args(scan),
    )
    if rc == 0:
        return True
    if rc == 4:
        # Could not apply/synchronize. Chunk 0 decodes DIRECTLY into the
        # planes before the stitch can fail, so the planes may hold partial
        # data here — safe only because the serial fallback re-decodes and
        # overwrites every block the scan covers. Do not reuse the planes
        # for anything else between this return and the serial decode.
        return False
    raise JpegEntropyError(f"speculative decode failed: {_STATUS.get(rc, rc)}")


def _stuff_args(scan: Scan):
    """(stuff_ptr, n_stuff) for the native index-driven unstuff; the scan
    keeps the array alive for the duration of the call."""
    st = scan.span.stuff_offsets
    if st is None:
        return None, -1
    if not (st.dtype == np.int64 and st.flags["C_CONTIGUOUS"]):
        return None, -1
    return st.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), st.shape[0]


def decode_scan_native_raw(
    structure: JpegStructure,
    scan: Scan,
    plane_arrays,
    cfg: DecodeConfig,
    segment_bounds,
    total_mcus: int,
    params: np.ndarray,
    luts,
) -> None:
    """Low-level scan decode into caller-provided [by, bx, 64] int16 arrays
    with explicit segment bounds / MCU count / unit params — the building
    block for stripe-local entropy decode (parallel/stripes.py), where each
    stripe's segment group decodes into a stripe-local buffer (segment MCU
    indices are relative to the given bounds by construction)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native runtime unavailable")
    frame = structure.frame
    n_segs = len(segment_bounds)
    bounds = np.array(
        [b for se in segment_bounds for b in se], dtype=np.int64
    )
    data = np.ascontiguousarray(structure.data)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u16p = ctypes.POINTER(ctypes.c_uint16)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i16p = ctypes.POINTER(ctypes.c_int16)
    lut12s = (u16p * len(luts))(
        *[lut.lut12c.ctypes.data_as(u16p) for lut in luts]
    )
    lut16s = (u16p * len(luts))(
        *[lut.lut16c.ctypes.data_as(u16p) for lut in luts]
    )
    vluts = (i32p * len(luts))(
        *[lut.vlut.ctypes.data_as(i32p) for lut in luts]
    )
    pvluts = (i32p * len(luts))(
        *[lut.pvlut.ctypes.data_as(i32p) for lut in luts]
    )
    u64p = ctypes.POINTER(ctypes.c_uint64)
    vlut2s = (u64p * len(luts))(
        *[lut.vlut2.ctypes.data_as(u64p) for lut in luts]
    )
    params = np.ascontiguousarray(params, dtype=np.int32)
    plane_ptrs = (i16p * frame.ncs)(
        *[p.ctypes.data_as(i16p) for p in plane_arrays]
    )
    err = np.full(2, -1, dtype=np.int64)
    stuff_ptr, n_stuff = _stuff_args(scan)
    rc = lib.jdt_decode_sequential(
        data.ctypes.data_as(u8p),
        bounds.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n_segs,
        total_mcus,
        scan.restart_interval,
        params.ctypes.data_as(i32p),
        params.shape[0],
        lut12s,
        lut16s,
        vluts,
        pvluts,
        vlut2s,
        len(luts),
        plane_ptrs,
        cfg.num_threads,
        err.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        stuff_ptr,
        n_stuff,
    )
    if rc != 0:
        raise JpegEntropyError(
            f"native entropy decode failed: {_STATUS.get(rc, rc)}"
            f" (segment {err[0]}, mcu {err[1]})",
            mcu=int(err[1]),
        )


# Prepared ctypes pointer-array bundles for decode_scan_native, keyed by the
# identity of the lut objects. flat_lut_for_spec content-caches the lut
# objects themselves, so in steady-state serving the same objects recur on
# every image and the per-call ctypes construction (~0.2 ms/image measured)
# is pure overhead. Values keep a strong reference to the luts so the ids
# can never be recycled while cached. Bounded; cleared wholesale when full.
_LUT_PTRS_CACHE: dict = {}
_LUT_PTRS_CAP = 128


def _lut_ptr_arrays(luts):
    key = tuple(id(lut) for lut in luts)
    hit = _LUT_PTRS_CACHE.get(key)
    if hit is not None:
        return hit[1]
    u16p = ctypes.POINTER(ctypes.c_uint16)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    arrays = (
        (u16p * len(luts))(*[l.lut12c.ctypes.data_as(u16p) for l in luts]),
        (u16p * len(luts))(*[l.lut16c.ctypes.data_as(u16p) for l in luts]),
        (i32p * len(luts))(*[l.vlut.ctypes.data_as(i32p) for l in luts]),
        (i32p * len(luts))(*[l.pvlut.ctypes.data_as(i32p) for l in luts]),
        (u64p * len(luts))(*[l.vlut2.ctypes.data_as(u64p) for l in luts]),
    )
    if len(_LUT_PTRS_CACHE) >= _LUT_PTRS_CAP:
        _LUT_PTRS_CACHE.clear()
    _LUT_PTRS_CACHE[key] = (list(luts), arrays)
    return arrays


def _plane_ptr_array(planes: CoefficientPlanes):
    """Per-CoefficientPlanes ctypes pointer array, cached on the object
    (its plane arrays are allocated once and never replaced, so the
    pointers stay valid for the object's lifetime — pool reuse hits this
    every image)."""
    pp = getattr(planes, "_jdt_plane_ptrs", None)
    if pp is None:
        i16p = ctypes.POINTER(ctypes.c_int16)
        pp = (i16p * len(planes.planes))(
            *[p.ctypes.data_as(i16p) for p in planes.planes]
        )
        planes._jdt_plane_ptrs = pp
    return pp


def decode_scan_native(
    structure: JpegStructure,
    scan: Scan,
    planes: CoefficientPlanes,
    cfg: DecodeConfig,
) -> None:
    """Decode one scan (sequential or progressive) via the C++ runtime."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native runtime unavailable")
    frame = structure.frame
    total_mcus, params, luts = scan_layout(structure, scan)
    if frame.process != Encoding.PROGRESSIVE_DCT and _try_speculative(
        structure, scan, planes, cfg, total_mcus, params, luts
    ):
        return
    n_segs = _check_segments(scan, total_mcus)

    bounds = scan.span.segment_bounds_flat()
    data = np.ascontiguousarray(structure.data)

    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lut12s, lut16s, vluts, pvluts, vlut2s = _lut_ptr_arrays(luts)
    plane_ptrs = _plane_ptr_array(planes)
    err = np.full(2, -1, dtype=np.int64)

    common = (
        data.ctypes.data_as(u8p),
        bounds.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n_segs,
        total_mcus,
        scan.restart_interval,
        params.ctypes.data_as(i32p),
        params.shape[0],
        lut12s,
        lut16s,
        vluts,
        pvluts,
    )
    tail = (len(luts), plane_ptrs, cfg.num_threads,
            err.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    if frame.process == Encoding.PROGRESSIVE_DCT:
        sh = scan.header
        rc = lib.jdt_decode_progressive(
            *common, *tail[:2], sh.ss, sh.se, sh.ah, sh.al, *tail[2:]
        )
    else:
        rc = lib.jdt_decode_sequential(*common, vlut2s, *tail, *_stuff_args(scan))
    if rc != 0:
        raise JpegEntropyError(
            f"native entropy decode failed: {_STATUS.get(rc, rc)}"
            f" (segment {err[0]}, mcu {err[1]})",
            mcu=int(err[1]),
        )


def scan_decode_fused(
    data: np.ndarray,
    start: int,
    total_mcus: int,
    ri: int,
    params: np.ndarray,
    luts,
    planes: CoefficientPlanes,
    cfg: DecodeConfig,
    allow_spec: bool,
) -> tuple[int, int]:
    """Fused prescan + sequential scan decode (jdt_scan_decode): one native
    call finds the scan's entropy span (restart cuts, stuff index, scan
    terminator) and decodes it segment-parallel — no Python round trip
    between prescan and decode. Returns (entropy_end, n_segments) so the
    caller's marker walk resumes after the scan. Raises JpegEntropyError
    with the same typed contract as decode_scan_native (+_check_segments:
    status 5 is the restart-structure mismatch both would raise)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native runtime unavailable")
    data = np.ascontiguousarray(data)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lut12s, lut16s, vluts, _pvluts, vlut2s = _lut_ptr_arrays(luts)
    plane_ptrs = _plane_ptr_array(planes)
    params_c = np.ascontiguousarray(params, dtype=np.int32)
    end = ctypes.c_int64(0)
    n_segs = ctypes.c_int64(0)
    err = np.full(2, -1, dtype=np.int64)
    rc = lib.jdt_scan_decode(
        data.ctypes.data_as(u8p),
        data.shape[0],
        start,
        total_mcus,
        ri,
        params_c.ctypes.data_as(i32p),
        params_c.shape[0],
        lut12s,
        lut16s,
        vluts,
        vlut2s,
        len(luts),
        plane_ptrs,
        cfg.num_threads,
        1 if allow_spec else 0,
        ctypes.byref(end),
        ctypes.byref(n_segs),
        err.ctypes.data_as(i64p),
    )
    if rc == 5:
        if ri == 0:
            raise JpegEntropyError(
                f"{n_segs.value - 1} restart markers in scan but restart"
                " interval 0"
            )
        raise JpegEntropyError(
            f"scan has {n_segs.value} restart segments, expected"
            f" {-(-total_mcus // ri)}"
        )
    if rc != 0:
        raise JpegEntropyError(
            f"native entropy decode failed: {_STATUS.get(rc, rc)}"
            f" (segment {err[0]}, mcu {err[1]})",
            mcu=int(err[1]),
        )
    return int(end.value), int(n_segs.value)


_SCAN_RST_CAP = 1 << 17  # plenty for any realistic restart count
# The 1 MiB rst scratch crosses NumPy's mmap threshold, so allocating it
# per call costs mmap/munmap + page-fault churn on the parse hot path;
# reuse one buffer per thread instead (the C side only writes into it
# during the call, and the caller copies out the filled prefix).
_SCAN_TLS = threading.local()


def scan_span(data: np.ndarray, start: int):
    """memchr-based entropy-span scan (see jdt_scan_span); returns
    (end, rst_offsets, stuff_offsets) or None when unavailable/overflowing
    (caller uses the NumPy reference implementation). stuff_offsets is None
    when its buffer overflowed (pathological stuffing density) — decode
    then falls back to per-segment memchr unstuffing."""
    lib = _load()
    if lib is None:
        return None
    data = np.ascontiguousarray(data)
    rst = getattr(_SCAN_TLS, "rst", None)
    if rst is None:
        rst = _SCAN_TLS.rst = np.empty(_SCAN_RST_CAP, dtype=np.int64)
    # Stuffed-0xFF density is ~1/256 for typical entropy data; a span//32
    # cap covers 8x that before falling back. Bounded at 8M entries
    # (64 MB scratch) for multi-GB streams — overflow just means decode
    # falls back to per-segment memchr unstuffing.
    span = data.shape[0] - start
    stuff_cap = min(max(1 << 14, span // 32), 1 << 23)
    stuff = getattr(_SCAN_TLS, "stuff", None)
    if stuff is None or stuff.shape[0] < stuff_cap:
        stuff = _SCAN_TLS.stuff = np.empty(stuff_cap, dtype=np.int64)
    end = ctypes.c_int64(0)
    n_rst = ctypes.c_int64(0)
    n_stuff = ctypes.c_int64(-1)
    i64p = ctypes.POINTER(ctypes.c_int64)
    rc = lib.jdt_scan_span(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        data.shape[0],
        start,
        ctypes.byref(end),
        rst.ctypes.data_as(i64p),
        _SCAN_RST_CAP,
        ctypes.byref(n_rst),
        0,  # n_threads: 0 = all cores (pooled; large spans only)
        stuff.ctypes.data_as(i64p),
        stuff.shape[0],
        ctypes.byref(n_stuff),
    )
    if rc != 0:
        return None  # more restarts than the cap: NumPy path handles it
    stuff_out = (
        stuff[: n_stuff.value].copy() if n_stuff.value >= 0 else None
    )
    return int(end.value), rst[: n_rst.value].copy(), stuff_out


def encode_scan_native(
    blocks: np.ndarray,
    unit_sci: np.ndarray,
    unit_dc: np.ndarray,
    unit_ac: np.ndarray,
    dc_tables,
    ac_tables,
    restart_interval: int = 0,
    num_threads: int = 0,
) -> bytes:
    """Pack one scan's entropy data via the C++ runtime.

    blocks: [total_units, 64] int32 zigzag in MCU order; unit_* arrays give
    per-unit-in-MCU scan-component and table indices; dc/ac_tables are
    core.huffman.EncodeTable lists. Mirrors core/entropy_encode.encode_blocks
    (tested byte-identical)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native runtime unavailable")
    blocks = np.ascontiguousarray(blocks, dtype=np.int32)
    unit_sci = np.ascontiguousarray(unit_sci, dtype=np.int32)
    unit_dc = np.ascontiguousarray(unit_dc, dtype=np.int32)
    unit_ac = np.ascontiguousarray(unit_ac, dtype=np.int32)

    u16p = ctypes.POINTER(ctypes.c_uint16)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    # EncodeTable arrays are contiguous; `keepalive` pins any copies that
    # ascontiguousarray makes for the duration of the call.
    keepalive = [
        (np.ascontiguousarray(t.code, dtype=np.uint16),
         np.ascontiguousarray(t.size, dtype=np.uint8))
        for t in list(dc_tables) + list(ac_tables)
    ]
    n_dc = len(dc_tables)
    dc_codes = (u16p * n_dc)(
        *[keepalive[i][0].ctypes.data_as(u16p) for i in range(n_dc)]
    )
    dc_sizes = (u8p * n_dc)(
        *[keepalive[i][1].ctypes.data_as(u8p) for i in range(n_dc)]
    )
    ac_codes = (u16p * len(ac_tables))(
        *[keepalive[n_dc + i][0].ctypes.data_as(u16p)
          for i in range(len(ac_tables))]
    )
    ac_sizes = (u8p * len(ac_tables))(
        *[keepalive[n_dc + i][1].ctypes.data_as(u8p)
          for i in range(len(ac_tables))]
    )

    out_ptr = ctypes.POINTER(ctypes.c_uint8)()
    out_len = ctypes.c_int64(0)
    rc = lib.jdt_encode_scan(
        blocks.ctypes.data_as(i32p),
        blocks.shape[0],
        unit_sci.shape[0],
        unit_sci.ctypes.data_as(i32p),
        unit_dc.ctypes.data_as(i32p),
        unit_ac.ctypes.data_as(i32p),
        dc_codes, dc_sizes, len(dc_tables),
        ac_codes, ac_sizes, len(ac_tables),
        restart_interval,
        num_threads,
        ctypes.byref(out_ptr),
        ctypes.byref(out_len),
    )
    if rc != 0:
        raise ValueError(f"native entropy encode failed (status {rc})")
    try:
        return ctypes.string_at(out_ptr, out_len.value)
    finally:
        lib.jdt_free(out_ptr)


def _plane_call_args(planes, unit_params):
    """Shared marshalling for the plane-direct encode/count entries:
    validates shapes and returns (plane_ptrs, bw_arr, bh_arr, unit_params,
    keepalive) — keepalive pins any contiguity copies for the call."""
    i16p = ctypes.POINTER(ctypes.c_int16)
    planes = [np.ascontiguousarray(p, dtype=np.int16) for p in planes]
    for p in planes:
        if p.ndim != 3 or p.shape[2] != 64:
            raise ValueError("each plane must be [by, bx, 64] int16")
    unit_params = np.ascontiguousarray(unit_params, dtype=np.int32)
    if unit_params.ndim != 2 or unit_params.shape[1] != 8:
        raise ValueError("unit_params must be [units_per_mcu, 8]")
    plane_ptrs = (i16p * len(planes))(
        *[p.ctypes.data_as(i16p) for p in planes]
    )
    bw_arr = np.asarray([p.shape[1] for p in planes], dtype=np.int64)
    bh_arr = np.asarray([p.shape[0] for p in planes], dtype=np.int64)
    return plane_ptrs, bw_arr, bh_arr, unit_params, planes


def _table_call_args(dc_tables, ac_tables):
    """ctypes arrays-of-pointers for EncodeTable lists (+ keepalive)."""
    u16p = ctypes.POINTER(ctypes.c_uint16)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    keepalive = [
        (np.ascontiguousarray(t.code, dtype=np.uint16),
         np.ascontiguousarray(t.size, dtype=np.uint8))
        for t in list(dc_tables) + list(ac_tables)
    ]
    n_dc = len(dc_tables)
    dc_codes = (u16p * n_dc)(
        *[keepalive[i][0].ctypes.data_as(u16p) for i in range(n_dc)]
    )
    dc_sizes = (u8p * n_dc)(
        *[keepalive[i][1].ctypes.data_as(u8p) for i in range(n_dc)]
    )
    ac_codes = (u16p * len(ac_tables))(
        *[keepalive[n_dc + i][0].ctypes.data_as(u16p)
          for i in range(len(ac_tables))]
    )
    ac_sizes = (u8p * len(ac_tables))(
        *[keepalive[n_dc + i][1].ctypes.data_as(u8p)
          for i in range(len(ac_tables))]
    )
    return dc_codes, dc_sizes, ac_codes, ac_sizes, keepalive


def encode_scan_planes(
    planes: list[np.ndarray],
    mcus_x: int,
    total_mcus: int,
    unit_params: np.ndarray,
    dc_tables,
    ac_tables,
    restart_interval: int = 0,
    num_threads: int = 0,
) -> bytes:
    """Pack one scan straight from per-component block planes.

    planes: per component, a C-contiguous int16 [by, bx, 64] zigzag block
    array exactly as the device FDCT stage emits it — the MCU interleave
    (spec A.2.3) is addressed inside the C++ walk instead of materialized
    by a NumPy reshuffle, and int16 halves the coefficient bytes of the
    int32 layout (quantized 8-bit-precision coefficients are <= 11 bits,
    T.81 F.1). unit_params: [units_per_mcu, 8] int32 rows
    (comp, fh, fv, j, k, sci, dc_table, ac_table). Byte-identical to
    encode_scan_native on the reordered layout
    (tests/test_encoder.py::test_plane_packer_byte_identical)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native runtime unavailable")
    plane_ptrs, bw_arr, bh_arr, unit_params, _keep = _plane_call_args(
        planes, unit_params
    )
    dc_codes, dc_sizes, ac_codes, ac_sizes, _keep2 = _table_call_args(
        dc_tables, ac_tables
    )
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    out_ptr = ctypes.POINTER(ctypes.c_uint8)()
    out_len = ctypes.c_int64(0)
    rc = lib.jdt_encode_scan_planes(
        plane_ptrs,
        bw_arr.ctypes.data_as(i64p),
        bh_arr.ctypes.data_as(i64p),
        len(_keep),
        mcus_x,
        total_mcus,
        unit_params.shape[0],
        unit_params.ctypes.data_as(i32p),
        dc_codes, dc_sizes, len(dc_tables),
        ac_codes, ac_sizes, len(ac_tables),
        restart_interval,
        num_threads,
        ctypes.byref(out_ptr),
        ctypes.byref(out_len),
    )
    if rc != 0:
        raise ValueError(f"native entropy encode failed (status {rc})")
    try:
        return ctypes.string_at(out_ptr, out_len.value)
    finally:
        lib.jdt_free(out_ptr)


def count_scan_planes(
    planes: list[np.ndarray],
    mcus_x: int,
    total_mcus: int,
    unit_params: np.ndarray,
    n_dc: int,
    n_ac: int,
    restart_interval: int = 0,
    num_threads: int = 0,
) -> tuple[list[np.ndarray], list[np.ndarray]]:
    """Symbol-frequency pass over the plane-direct layout (two-pass
    optimized Huffman tables). Returns (freq_dc, freq_ac) as lists of
    int64[256] arrays — count-identical to
    core/entropy_encode.count_symbols on the reordered layout."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native runtime unavailable")
    plane_ptrs, bw_arr, bh_arr, unit_params, _keep = _plane_call_args(
        planes, unit_params
    )
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    dc_freq = np.zeros((n_dc, 256), dtype=np.int64)
    ac_freq = np.zeros((n_ac, 256), dtype=np.int64)
    rc = lib.jdt_count_scan_planes(
        plane_ptrs,
        bw_arr.ctypes.data_as(i64p),
        bh_arr.ctypes.data_as(i64p),
        len(_keep),
        mcus_x,
        total_mcus,
        unit_params.shape[0],
        unit_params.ctypes.data_as(i32p),
        n_dc, n_ac,
        restart_interval,
        num_threads,
        dc_freq.ctypes.data_as(i64p),
        ac_freq.ctypes.data_as(i64p),
    )
    if rc != 0:
        raise ValueError(f"native symbol count failed (status {rc})")
    return list(dc_freq), list(ac_freq)


def entropy_decode(
    structure: JpegStructure,
    cfg: DecodeConfig,
    planes: CoefficientPlanes | None = None,
):
    """All scans -> (CoefficientPlanes, qtid -> natural-order table).

    `planes` may be a reusable buffer for the same geometry (serving path;
    see models/decoder.PlanePool): sequential scans overwrite every
    coefficient of every covered block, so re-zeroing is unnecessary;
    progressive accumulation REQUIRES zeroed planes — the pool handles that.
    """
    if planes is None:
        planes = CoefficientPlanes(structure.frame)
    # Restart-free multi-scan streams (the progressive shape): each scan
    # is bit-serial inside, so the parallelism axis is ACROSS independent
    # scans (core/driver.scan_deps DAG — chroma AC chains + DC chain
    # decode under the luma critical path). Scans WITH restart intervals
    # already parallelize internally over segments; running those
    # concurrently would just oversubscribe the cores.
    parallel = (
        len(structure.scans) >= 2
        and cfg.num_threads != 1
        and all(s.restart_interval == 0 for s in structure.scans)
    )
    runner = run_scans_parallel if parallel else run_scans
    qts = runner(
        structure, planes,
        lambda s, scan, p: decode_scan_native(s, scan, p, cfg),
    )
    return planes, qts
