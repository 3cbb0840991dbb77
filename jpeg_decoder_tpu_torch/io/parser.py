"""Marker walk: byte stream -> JpegStructure.

Replaces the reference's marker dispatch loop (`decode_jpeg_buffer`
`reference/src/decode.c:138-424`) with a structural parse that is
decoupled from entropy decoding: the walk records each scan's header, table
snapshot, and entropy byte span (with all restart-marker offsets gathered by
a vectorized prescan), so entropy decode can later run segment-parallel on
host threads or on device.

Parsing quirk compatibility notes (vs the reference):
  * frame component dims use the float32 ceil rule (frame_header.c:52-55)
    when cfg.quirks == REFERENCE, integer ceil division otherwise;
  * a DHT with table id > 3 is rejected (the reference's check `id > nDCAC`
    at huff_table.c:177 off-by-one-accepts id == nDCAC; we use the spec rule);
  * unknown APPn/COM/reserved segments are skipped by length, like
    read_app_segment (decode.c:426-434).
"""

from __future__ import annotations

import numpy as np

from ..core.types import (
    Component,
    EntropySpan,
    FrameHeader,
    HuffTableSpec,
    JpegStructure,
    QuantTable,
    Scan,
    ScanComponent,
    ScanHeader,
    ZIGZAG,
)
from ..utils.config import DecodeConfig, Quirks
from ..utils.errors import (
    JpegFormatError,
    JpegTruncatedError,
    JpegUnsupportedError,
)
from ..utils.logging import get_logger
from . import bitstream as bs
from .markers import (
    Encoding,
    Marker,
    SOF_TO_ENCODING,
    SUPPORTED_ENCODINGS,
    is_app,
    is_rst,
    is_sof,
)

log = get_logger("parser")


def _parse_frame_header(
    data: np.ndarray, off: int, process: Encoding, quirks: Quirks
) -> tuple[FrameHeader, int]:
    """Parse SOFn payload (reference decode_frame_header frame_header.c:9-58)."""
    length = bs.read_u16be(data, off)
    if length < 8:
        raise JpegFormatError("SOF segment too short", offset=off)
    if off + length > data.shape[0]:
        raise JpegTruncatedError("SOF extends past end of stream", offset=off)
    p = off + 2
    precision = int(data[p])
    height = bs.read_u16be(data, p + 1)
    width = bs.read_u16be(data, p + 3)
    ncs = int(data[p + 5])
    if ncs == 0 or ncs * 3 != length - 8:
        raise JpegFormatError(
            f"SOF component count {ncs} inconsistent with length {length}",
            offset=off,
        )
    p += 6
    raw = []
    for _ in range(ncs):
        cid = int(data[p])
        hv = int(data[p + 1])
        qtid = int(data[p + 2])
        raw.append((cid, hv >> 4, hv & 0xF, qtid))
        p += 3
    max_h = max(r[1] for r in raw)
    max_v = max(r[2] for r in raw)
    comps = []
    for cid, h, v, qtid in raw:
        if h == 0 or v == 0:
            raise JpegFormatError(f"component {cid} has zero sampling factor")
        if quirks == Quirks.REFERENCE:
            # float32 ceil rule, frame_header.c:52-55
            x = int(np.ceil(np.float32(width) * (np.float32(h) / np.float32(max_h))))
            y = int(np.ceil(np.float32(height) * (np.float32(v) / np.float32(max_v))))
        else:
            x = -(-width * h // max_h)
            y = -(-height * v // max_v)
        comps.append(Component(id=cid, hsf=h, vsf=v, qtid=qtid, x=x, y=y))
    fh = FrameHeader(
        process=process,
        precision=precision,
        width=width,
        height=height,
        components=tuple(comps),
    )
    return fh, off + length


# Successful DHT/DQT parses content-cached by segment bytes: serving
# workloads repeat encoder table sets image after image, and the numpy
# copies + dataclass builds cost ~0.1 ms/image on the host hot path. The
# cached specs are frozen dataclasses treated immutably downstream.
_DHT_CACHE: dict[bytes, list] = {}
_DQT_CACHE: dict[bytes, list] = {}
_SEG_CACHE_CAP = 512


def _parse_dht(
    data: np.ndarray, off: int
) -> tuple[list[HuffTableSpec], int]:
    """Parse a DHT segment, possibly holding several tables
    (reference decode_huff_tables huff_table.c:165-261)."""
    length = bs.read_u16be(data, off)
    if length < 2 + 17:
        raise JpegFormatError("DHT segment too short", offset=off)
    end = off + length
    if end > data.shape[0]:
        raise JpegTruncatedError("DHT extends past end of stream", offset=off)
    key = data[off : off + length].tobytes()
    hit = _DHT_CACHE.get(key)
    if hit is not None:
        # Shallow copy: the specs inside are shared but their arrays are
        # frozen (writeable=False below), so a future in-place tweak fails
        # loudly instead of corrupting every other parse of the same bytes.
        return list(hit), end
    p = off + 2
    tables = []
    while p < end:
        tc_id = int(data[p])
        table_class = (tc_id >> 4) & 0xF
        table_id = tc_id & 0xF
        if table_class > 1:
            raise JpegFormatError(f"bad DHT class {table_class}", offset=p)
        if table_id > 3:
            raise JpegFormatError(f"bad DHT id {table_id}", offset=p)
        if p + 17 > end:
            raise JpegTruncatedError("DHT counts truncated", offset=p)
        counts = data[p + 1 : p + 17].copy()
        counts.flags.writeable = False
        total = int(counts.sum())
        if total > 256:
            raise JpegFormatError("DHT has more than 256 symbols", offset=p)
        if p + 17 + total > end:
            raise JpegTruncatedError("DHT symbols truncated", offset=p)
        symbols = data[p + 17 : p + 17 + total].copy()
        symbols.flags.writeable = False
        tables.append(
            HuffTableSpec(
                table_class=table_class,
                table_id=table_id,
                counts=counts,
                symbols=symbols,
            )
        )
        p += 17 + total
    if len(_DHT_CACHE) >= _SEG_CACHE_CAP:
        _DHT_CACHE.clear()
    _DHT_CACHE[key] = tables
    return tables, end


def _parse_dqt(data: np.ndarray, off: int) -> tuple[list[tuple[int, QuantTable]], int]:
    """Parse a DQT segment (reference decode_quant_table quant_table.c:91-129).

    Values are de-zigzagged to natural order at parse time, exactly like the
    reference (quant_table.c:108-114)."""
    length = bs.read_u16be(data, off)
    if length < 2 + 65:
        raise JpegFormatError("DQT segment too short", offset=off)
    end = off + length
    if end > data.shape[0]:
        raise JpegTruncatedError("DQT extends past end of stream", offset=off)
    key = data[off : off + length].tobytes()
    hit = _DQT_CACHE.get(key)
    if hit is not None:
        return list(hit), end  # shallow copy; values arrays frozen below
    p = off + 2
    out = []
    while p < end:
        pq_tq = int(data[p])
        precision = (pq_tq >> 4) & 0xF
        table_id = pq_tq & 0xF
        if table_id > 3:
            raise JpegFormatError(f"bad DQT id {table_id}", offset=p)
        if precision > 1:
            raise JpegFormatError(f"bad DQT precision {precision}", offset=p)
        n = 64 * (2 if precision else 1)
        if p + 1 + n > end:
            raise JpegTruncatedError("DQT values truncated", offset=p)
        raw = data[p + 1 : p + 1 + n]
        if precision:
            zz_vals = (raw[0::2].astype(np.uint16) << 8) | raw[1::2]
        else:
            zz_vals = raw.astype(np.uint16)
        natural = np.zeros(64, dtype=np.uint16)
        natural[ZIGZAG] = zz_vals
        natural.flags.writeable = False
        out.append((table_id, QuantTable(precision=precision, values=natural)))
        p += 1 + n
    if len(_DQT_CACHE) >= _SEG_CACHE_CAP:
        _DQT_CACHE.clear()
    _DQT_CACHE[key] = out
    return out, end


def _parse_sos_header(data: np.ndarray, off: int) -> tuple[ScanHeader, int]:
    """Parse SOS payload (reference decode_scan_header scan_header.c:10-35)."""
    length = bs.read_u16be(data, off)
    if length < 6:
        raise JpegFormatError("SOS segment too short", offset=off)
    if off + length > data.shape[0]:
        raise JpegTruncatedError("SOS extends past end of stream", offset=off)
    nics = int(data[off + 2])
    if nics == 0 or nics > 4:
        raise JpegFormatError(f"bad SOS component count {nics}", offset=off)
    if length != 6 + 2 * nics:
        raise JpegFormatError("SOS length inconsistent with nics", offset=off)
    p = off + 3
    comps = []
    for _ in range(nics):
        sc = int(data[p])
        tt = int(data[p + 1])
        comps.append(ScanComponent(sc=sc, dc=(tt >> 4) & 0xF, ac=tt & 0xF))
        p += 2
    ss = int(data[p])
    se = int(data[p + 1])
    ahal = int(data[p + 2])
    # Spectral-selection bounds (spec B.2.3): unchecked values would drive
    # out-of-bounds coefficient writes in the native decoder. ss > se is
    # validated in the progressive scan decoders (sequential streams with
    # junk ss/se decode fine — the fields are unused there, and the
    # reference ignores them too).
    if ss > 63 or se > 63:
        raise JpegFormatError(
            f"bad spectral selection ss={ss} se={se}", offset=off
        )
    sh = ScanHeader(
        components=tuple(comps), ss=ss, se=se, ah=(ahal >> 4) & 0xF, al=ahal & 0xF
    )
    return sh, off + length


class HeaderParse:
    """Everything the fused host path needs from the bytes BEFORE a stream's
    first entropy byte: frame header, table state, scan header, DRI, and the
    prefix length. Produced by parse_headers (a prefix of parse()'s walk)
    and content-cached by exact prefix bytes: serving workloads repeat the
    same encoder header byte-for-byte image after image, and the parse is a
    pure function of (prefix bytes, quirks). Mutable `layout`/`qts` slots
    hold lazily-computed per-header decode state (unit params, LUTs) that
    likewise depends only on header content; `device_layout` the DEVICE
    route's (ops/entropy_device.header_layout)."""

    __slots__ = (
        "frame", "scan_header", "entropy_start", "restart_interval",
        "dc_tables", "ac_tables", "quant_tables", "app_segments",
        "layout", "qts", "full_coverage", "device_layout",
    )

    def __init__(self, frame, scan_header, entropy_start, restart_interval,
                 dc_tables, ac_tables, quant_tables, app_segments):
        self.frame = frame
        self.scan_header = scan_header
        self.entropy_start = entropy_start
        self.restart_interval = restart_interval
        self.dc_tables = dc_tables
        self.ac_tables = ac_tables
        self.quant_tables = quant_tables
        self.app_segments = app_segments
        self.layout = None  # (total_mcus, params, luts) — decoder fills in
        self.device_layout = None  # ops/entropy_device.HeaderLayout, or False
        self.qts = {tid: qt.values for tid, qt in quant_tables.items()}
        # Does the first scan provably overwrite every plane block? (Same
        # rule as PlanePool._full_coverage, for the single-scan shape.)
        if frame.ncs == 1:
            c = frame.components[0]
            self.full_coverage = (
                c.blocks_x == -(-c.x // 8) and c.blocks_y == -(-c.y // 8)
            )
        else:
            self.full_coverage = scan_header.nics == frame.ncs


def parse_headers(
    data_in: bytes | np.ndarray, cfg: DecodeConfig | None = None
) -> HeaderParse | None:
    """Walk markers up to the first SOS and return the header state, or None
    when the stream needs the full parse (progressive process, DNL-pending
    height, no SOS/SOF). Raises the same typed errors parse() would for the
    same malformed prefix — the walk shares parse()'s dispatch branches and
    helpers (differentially tested against it in tests/test_fused_path.py).
    """
    cfg = cfg or DecodeConfig()
    data = bs.as_byte_array(data_in)
    n = data.shape[0]
    if n < 4 or data[0] != 0xFF or data[1] != Marker.SOI:
        raise JpegFormatError("stream does not start with SOI")

    frame: FrameHeader | None = None
    app_segments: list[tuple[int, int, bytes]] = []
    dc_tables: dict[int, HuffTableSpec] = {}
    ac_tables: dict[int, HuffTableSpec] = {}
    quant_tables: dict[int, QuantTable] = {}
    restart_interval = 0

    p = 2
    while p < n:
        if data[p] != 0xFF:
            p += 1
            continue
        while p + 1 < n and data[p + 1] == 0xFF:
            p += 1
        if p + 1 >= n:
            break
        marker = int(data[p + 1])
        seg = p + 2

        if marker == Marker.EOI:
            break
        elif marker == Marker.SOI or is_rst(marker) or marker == Marker.TEM:
            p = seg
        elif is_sof(marker):
            process = SOF_TO_ENCODING[Marker(marker)]
            if process not in SUPPORTED_ENCODINGS:
                raise JpegUnsupportedError(
                    f"unsupported JPEG process {process.value}"
                )
            if process == Encoding.PROGRESSIVE_DCT:
                return None  # multi-scan by construction: full parse
            frame, p = _parse_frame_header(data, seg, process, cfg.quirks)
            if frame.height == 0:
                return None  # DNL-pending height: full parse handles it
        elif marker == Marker.DHT:
            tables, p = _parse_dht(data, seg)
            for t in tables:
                if t.table_class == 0:
                    dc_tables[t.table_id] = t
                else:
                    ac_tables[t.table_id] = t
        elif marker == Marker.DQT:
            tables, p = _parse_dqt(data, seg)
            for tid, t in tables:
                quant_tables[tid] = t
        elif marker == Marker.DRI:
            length = bs.read_u16be(data, seg)
            if length != 4:
                raise JpegFormatError("bad DRI length", offset=seg)
            restart_interval = bs.read_u16be(data, seg + 2)
            p = seg + length
        elif marker == Marker.DNL:
            return None  # DNL before SOS is malformed; let parse() decide
        elif marker == Marker.SOS:
            if frame is None:
                raise JpegFormatError("SOS before SOF", offset=p)
            sh, entropy_start = _parse_sos_header(data, seg)
            if not quant_tables:
                raise JpegFormatError("SOS with no quantization tables defined")
            return HeaderParse(
                frame=_attach_adobe(frame, app_segments),
                scan_header=sh,
                entropy_start=entropy_start,
                restart_interval=restart_interval,
                dc_tables=dict(dc_tables),
                ac_tables=dict(ac_tables),
                quant_tables=dict(quant_tables),
                app_segments=tuple(app_segments),
            )
        elif is_app(marker) or marker == Marker.COM:
            length = bs.read_u16be(data, seg)
            if length < 2:
                raise JpegFormatError(
                    f"bad segment length {length}", offset=seg
                )
            if seg + length > n:
                raise JpegTruncatedError(
                    "segment extends past end of stream", offset=seg
                )
            payload = bytes(data[seg + 2 : seg + length].tobytes())
            app_segments.append((marker, p, payload))
            p = seg + length
        elif marker in (Marker.DAC, Marker.DHP, Marker.EXP) or (
            Marker.JPG0 <= marker <= Marker.JPG13
        ):
            length = bs.read_u16be(data, seg)
            if length < 2:
                raise JpegFormatError(
                    f"bad segment length {length}", offset=seg
                )
            p = seg + length
        elif marker == Marker.JPG:
            raise JpegUnsupportedError("JPG extension marker")
        elif 0x02 <= marker <= 0xBF:
            p = seg
        else:
            log.warning("skipping unknown marker 0xFF%02X at %d", marker, p)
            p = seg

    return None  # no SOS found before EOI/end: full parse raises properly


# Header-prefix cache: parse_headers is a pure function of the bytes it
# consumed ([0, entropy_start)) plus cfg.quirks, so an exact-prefix match
# can reuse the parsed state wholesale. Lookup tries each distinct prefix
# length seen so far (serving workloads have one or two): a match at a
# cached length L is sound even if the new stream is longer — identical
# bytes walk identically, so its first SOS ends at L too.
_HEADER_CACHE: dict = {}
_HEADER_PREFIX_LENS: list[int] = []
_HEADER_CACHE_CAP = 64
_HEADER_PREFIX_MAX = 1 << 20  # don't hash multi-MB header prefixes per image


def parse_headers_cached(
    data_in: bytes | np.ndarray, cfg: DecodeConfig | None = None
) -> HeaderParse | None:
    cfg = cfg or DecodeConfig()
    data = bs.as_byte_array(data_in)
    n = data.shape[0]
    for length in _HEADER_PREFIX_LENS:
        if length <= n:
            hit = _HEADER_CACHE.get((cfg.quirks, data[:length].tobytes()))
            if hit is not None:
                return hit
    hp = parse_headers(data, cfg)
    if hp is not None and hp.entropy_start <= _HEADER_PREFIX_MAX:
        if len(_HEADER_CACHE) >= _HEADER_CACHE_CAP:
            _HEADER_CACHE.clear()
            _HEADER_PREFIX_LENS.clear()
        _HEADER_CACHE[(cfg.quirks, data[: hp.entropy_start].tobytes())] = hp
        if hp.entropy_start not in _HEADER_PREFIX_LENS:
            _HEADER_PREFIX_LENS.append(hp.entropy_start)
    return hp


def parse(
    data_in: bytes | np.ndarray, cfg: DecodeConfig | None = None
) -> JpegStructure:
    """Walk the marker stream and return the full JpegStructure.

    Mirrors decode_jpeg_buffer's dispatch (decode.c:160-409) structurally:
    SOI/EOI, SOFn, DHT, DQT, DRI, DNL, SOS, APPn skip, COM skip, fill bytes.
    """
    cfg = cfg or DecodeConfig()
    data = bs.as_byte_array(data_in)
    n = data.shape[0]
    if n < 4 or data[0] != 0xFF or data[1] != Marker.SOI:
        raise JpegFormatError("stream does not start with SOI")

    frame: FrameHeader | None = None
    scans: list[Scan] = []
    app_segments: list[tuple[int, int, bytes]] = []
    dc_tables: dict[int, HuffTableSpec] = {}
    ac_tables: dict[int, HuffTableSpec] = {}
    quant_tables: dict[int, QuantTable] = {}
    restart_interval = 0

    p = 2
    while p < n:
        # Find next marker: skip non-FF bytes and FF fill bytes.
        if data[p] != 0xFF:
            p += 1
            continue
        while p + 1 < n and data[p + 1] == 0xFF:
            p += 1
        if p + 1 >= n:
            break
        marker = int(data[p + 1])
        seg = p + 2  # offset of segment payload (length field), if any

        if marker == Marker.EOI:
            break
        elif marker == Marker.SOI or is_rst(marker) or marker == Marker.TEM:
            p = seg
        elif is_sof(marker):
            process = SOF_TO_ENCODING[Marker(marker)]
            if process not in SUPPORTED_ENCODINGS:
                # The reference returns -1 for these too (decode.c:224-269).
                raise JpegUnsupportedError(
                    f"unsupported JPEG process {process.value}"
                )
            frame, p = _parse_frame_header(data, seg, process, cfg.quirks)
        elif marker == Marker.DHT:
            tables, p = _parse_dht(data, seg)
            for t in tables:
                if t.table_class == 0:
                    dc_tables[t.table_id] = t
                else:
                    ac_tables[t.table_id] = t
        elif marker == Marker.DQT:
            tables, p = _parse_dqt(data, seg)
            for tid, t in tables:
                quant_tables[tid] = t
        elif marker == Marker.DRI:
            length = bs.read_u16be(data, seg)
            if length != 4:
                raise JpegFormatError("bad DRI length", offset=seg)
            restart_interval = bs.read_u16be(data, seg + 2)
            p = seg + length
        elif marker == Marker.DNL:
            length = bs.read_u16be(data, seg)
            if length != 4:
                raise JpegFormatError("bad DNL length", offset=seg)
            if frame is None:
                raise JpegFormatError("DNL before SOF", offset=seg)
            frame = frame.with_height(
                bs.read_u16be(data, seg + 2),
                reference_quirks=cfg.quirks == Quirks.REFERENCE,
            )
            p = seg + length
        elif marker == Marker.SOS:
            if frame is None:
                raise JpegFormatError("SOS before SOF", offset=p)
            sh, entropy_start = _parse_sos_header(data, seg)
            if not quant_tables:
                # Reference refuses to decode a scan without DQT (decode.c:321-326).
                raise JpegFormatError("SOS with no quantization tables defined")
            entropy_end, rst, stuff = bs.scan_entropy_span(
                data, entropy_start
            )
            span = EntropySpan(
                start=entropy_start,
                end=entropy_end,
                restart_offsets=rst,
                stuff_offsets=stuff,
            )
            scans.append(
                Scan(
                    header=sh,
                    span=span,
                    restart_interval=restart_interval,
                    dc_tables=dict(dc_tables),
                    ac_tables=dict(ac_tables),
                    quant_tables=dict(quant_tables),
                )
            )
            p = entropy_end
        elif is_app(marker) or marker == Marker.COM:
            length = bs.read_u16be(data, seg)
            if length < 2:
                raise JpegFormatError(
                    f"bad segment length {length}", offset=seg
                )
            if seg + length > n:
                raise JpegTruncatedError(
                    "segment extends past end of stream", offset=seg
                )
            payload = bytes(data[seg + 2 : seg + length].tobytes())
            app_segments.append((marker, p, payload))
            p = seg + length
        elif marker in (Marker.DAC, Marker.DHP, Marker.EXP) or (
            Marker.JPG0 <= marker <= Marker.JPG13
        ):
            # Segments we recognize but do not use; skip by length.
            length = bs.read_u16be(data, seg)
            if length < 2:
                raise JpegFormatError(
                    f"bad segment length {length}", offset=seg
                )
            p = seg + length
        elif marker == Marker.JPG:
            raise JpegUnsupportedError("JPG extension marker")
        elif 0x02 <= marker <= 0xBF:
            # Reserved: the reference ignores them (decode.c:164-170).
            p = seg
        else:
            log.warning("skipping unknown marker 0xFF%02X at %d", marker, p)
            p = seg

    if frame is None:
        raise JpegFormatError("no SOF marker found")
    if not scans:
        raise JpegFormatError("no SOS marker found")
    frame = _attach_adobe(frame, app_segments)
    return JpegStructure(
        frame=frame,
        scans=tuple(scans),
        data=data,
        app_segments=tuple(app_segments),
    )


def _attach_adobe(frame, app_segments):
    """For 4-component frames, record the APP14 'Adobe' transform byte on
    the FrameHeader (0 = raw inverted CMYK, 2 = YCCK). Only attached when
    it matters (ncs == 4) so 3-component stage-cache keys are unchanged.
    The reference ignores APP14 entirely (its yccb_rgb always runs the
    YCCK composite); Quirks.CORRECT honors transform=0."""
    if frame.ncs != 4:
        return frame
    for marker, _off, payload in app_segments:
        if marker == 0xEE and payload[:5] == b"Adobe" and len(payload) >= 12:
            import dataclasses

            return dataclasses.replace(
                frame, adobe_transform=int(payload[11])
            )
    return frame
