"""Bit-serial NumPy oracle decoder — slow, obviously correct, reference-exact.

This is the conformance anchor (SURVEY.md §7 step 2, replacing the role of
the reference's `testdct.c` naive-vs-fast cross-check): a from-spec decoder
whose every numeric step replicates the C decoder's arithmetic (via
core/numerics.py), validated byte-for-byte against the compiled reference in
tests/test_reference_parity.py. Faster paths (NumPy LUT, native C++, device
kernels) are all tested against THIS.

Sequential entropy decode mirrors `decode_scan`/`decode_data_unit`
(`reference/src/decode.c:535-723`). Progressive decode follows spec
G.1.2 built on the same coefficient-plane IR — the reference's progressive
path is broken (silent exit(1), decode.c:858-869) and is NOT the model here.
"""

from __future__ import annotations

import numpy as np

from ..io import bitstream as bsio
from ..utils.config import DecodeConfig, Quirks
from ..utils.errors import JpegEntropyError, JpegFormatError, JpegTruncatedError
from .huffman import CanonicalTable, build_canonical
from .numerics import (
    dequantize,
    gray_to_rgb_exact,
    idct_2d_exact,
    rescale_12bit,
    ycbcr_to_rgb_exact,
    cmyk_to_rgb_exact,
    ycck_to_rgb_exact,
)
from .types import (
    CoefficientPlanes,
    DecodedImage,
    FrameHeader,
    JpegStructure,
    Scan,
)


def _block_position(
    c, comp_blocks_x: int, mcu_index: int, j: int, k: int, hsf: int, vsf: int
) -> tuple[int, int]:
    """Block coords for the (j,k)-th data unit of `mcu_index`, mirroring
    write_mcu's wrap rule (decode.c:475-486) in block units.

    comp_blocks_x is the component plane's allocated blocks-per-row;
    the wrap width is pad8(c.x)/8 under hsf=1 semantics (non-interleaved), or
    the plane width for interleaved scans.
    """
    img_width = comp_blocks_x
    pad = 8 * hsf
    x_to_mcu = (c.x + ((pad - (c.x % pad)) % pad)) // 8
    base = mcu_index * hsf + k
    if img_width > x_to_mcu:
        bx = base % x_to_mcu
        by = (base // x_to_mcu) * vsf + j
    else:
        bx = base % img_width
        by = (base // img_width) * vsf + j
    return by, bx


def _scan_unit_layout(frame, sh):
    """Per-MCU data-unit order for a scan (decode.c:609-611): returns
    (total_mcus, [(frame_comp_idx, Component, j, k)], {ci: (h, v)},
    [scan_comp_idx per unit]). Non-interleaved scans (nics == 1) use
    hsf=vsf=1 semantics over the component's own ceil(x/8) grid
    (decode.c:454-456, 893-897). Shared by the sequential and progressive
    oracle decoders (the native runtime mirrors this in scan_layout)."""
    if sh.nics == 1:
        ci, c = frame.find_component(sh.components[0].sc)
        pad_x = (c.x + 7) // 8
        pad_y = (c.y + 7) // 8
        return pad_x * pad_y, [(ci, c, 0, 0)], {ci: (1, 1)}, [0]
    total_mcus = frame.mcus_x * frame.mcus_y
    units = []
    hv = {}
    comp_of_unit = []
    for idx, sc in enumerate(sh.components):
        ci, c = frame.find_component(sc.sc)
        hv[ci] = (c.hsf, c.vsf)
        for j in range(c.vsf):
            for k in range(c.hsf):
                units.append((ci, c, j, k))
                comp_of_unit.append(idx)
    return total_mcus, units, hv, comp_of_unit


def _check_readers_not_overrun(readers) -> None:
    """Backends whose readers pad past-end reads with zeros (FastBitReader)
    must fail on genuine truncation like every other backend."""
    for r in readers:
        if getattr(r, "overran", False):
            raise JpegTruncatedError(
                "entropy data truncated (decode consumed fabricated bits)"
            )


def _segment_readers(
    structure: JpegStructure, scan: Scan, reader_cls=bsio.BitReader
) -> list:
    """One bit reader per restart segment: each segment is unstuffed
    independently, so crossing into the next one resets bit alignment (and
    the caller resets DC predictors), matching restart_marker handling
    (decode.c:578-590, 1289-1293)."""
    readers = []
    for s, e in scan.span.segment_bounds():
        unstuffed, _ = bsio.unstuff(structure.data, s, e)
        readers.append(reader_cls(unstuffed))
    return readers


def _wrap16(v: int) -> int:
    """Wrap a Python int to int16 two's-complement range — the semantics of
    every backend's coefficient store (NumPy array casts and C++ int16_t
    stores both truncate mod 2^16). Legal streams never exceed int16
    (T.81 F.1.2.1/F.1.2.2); this keeps corrupt streams from raising
    OverflowError on scalar stores into the int16 planes."""
    return ((v + 0x8000) & 0xFFFF) - 0x8000


def _decode_data_unit_sequential(
    reader,
    dc_table,
    ac_table,
    pred: int,
) -> tuple[np.ndarray, int]:
    """One 8x8 data unit -> 64 zigzag-order coefficients; mirrors
    decode_data_unit (decode.c:665-723). Tables may be CanonicalTable
    (walk form) or FlatLut (LUT form) — both expose .decode(reader)."""
    du = np.zeros(64, dtype=np.int32)
    mag = dc_table.decode(reader)
    if mag > 15:
        raise JpegEntropyError(f"DC magnitude category {mag} > 15")
    diff = bsio.receive_extend(reader.read_bits(mag), mag)
    pred = pred + diff
    du[0] = _wrap16(pred)

    i = 1
    while i < 64:
        rs = ac_table.decode(reader)
        size = rs & 0x0F
        run = (rs >> 4) & 0x0F
        i += run
        if rs == 0x00:  # EOB
            break
        if rs == 0xF0:  # ZRL: run of 16 zeros (15 skipped + the i+=1 below)
            i += 1
            continue
        if i > 63:
            raise JpegEntropyError(f"AC index {i} out of range")
        du[i] = bsio.receive_extend(reader.read_bits(size), size)
        i += 1
    return du, pred


def decode_sequential_scan(
    structure: JpegStructure,
    scan: Scan,
    planes: CoefficientPlanes,
    reader_cls=bsio.BitReader,
    make_table=build_canonical,
) -> None:
    """Fill coefficient planes from a baseline/extended sequential scan.

    Mirrors decode_scan's MCU loop (decode.c:535-663): interleaved MCU order,
    per-component vsf x hsf data units, DC prediction per scan component,
    predictor reset + bit realignment at each restart marker.
    """
    frame = structure.frame
    sh = scan.header
    ri = scan.restart_interval
    readers = _segment_readers(structure, scan, reader_cls)

    dc_tables = {}
    ac_tables = {}
    for sc in sh.components:
        if sc.dc not in scan.dc_tables:
            raise JpegFormatError(f"scan uses undefined DC table {sc.dc}")
        if sc.ac not in scan.ac_tables:
            raise JpegFormatError(f"scan uses undefined AC table {sc.ac}")
        dc_tables[sc.dc] = make_table(scan.dc_tables[sc.dc])
        ac_tables[sc.ac] = make_table(scan.ac_tables[sc.ac])

    total_mcus, units, hv, comp_of_unit = _scan_unit_layout(frame, sh)
    preds = {i: 0 for i in range(sh.nics)}
    seg = 0
    reader = readers[0]
    for m in range(total_mcus):
        if ri and m > 0 and m % ri == 0:
            # Cross into the next restart segment: reset predictors
            # (decode.c:580-584) and bit alignment.
            seg += 1
            if seg >= len(readers):
                raise JpegEntropyError(
                    "restart marker expected but segment list exhausted", mcu=m
                )
            reader = readers[seg]
            preds = {i: 0 for i in range(sh.nics)}
        for u, (ci, c, j, k) in enumerate(units):
            sci = comp_of_unit[u]
            sc = sh.components[sci]
            du, preds[sci] = _decode_data_unit_sequential(
                reader,
                dc_tables[sc.dc],
                ac_tables[sc.ac],
                preds[sci],
            )
            h, v = hv[ci]
            plane = planes.plane(ci)
            by, bx = _block_position(c, plane.shape[1], m, j, k, h, v)
            if by < plane.shape[0] and bx < plane.shape[1]:
                plane[by, bx, :] = du
    _check_readers_not_overrun(readers)


# ---------------------------------------------------------------------------
# Progressive scans (spec G.1.2; reference's version is broken — built anew)
# ---------------------------------------------------------------------------


class ProgressiveState:
    """Cross-scan state: EOB run survives within a scan only; DC predictors
    reset per scan and per restart."""

    def __init__(self) -> None:
        self.eobrun = 0


def decode_progressive_scan(
    structure: JpegStructure,
    scan: Scan,
    planes: CoefficientPlanes,
    reader_cls=bsio.BitReader,
    make_table=build_canonical,
) -> None:
    frame = structure.frame
    sh = scan.header
    ri = scan.restart_interval
    readers = _segment_readers(structure, scan, reader_cls)

    is_dc = sh.ss == 0
    if is_dc and sh.se != 0:
        raise JpegFormatError("progressive scan with ss=0 must have se=0 (G.1.1.1.1)")
    if not is_dc and sh.nics != 1:
        raise JpegFormatError("progressive AC scan must be non-interleaved")
    if sh.ss > sh.se:
        raise JpegFormatError(f"progressive scan has ss={sh.ss} > se={sh.se}")

    dc_tables = {}
    ac_tables = {}
    for sc in sh.components:
        if is_dc and sh.ah == 0:
            if sc.dc not in scan.dc_tables:
                raise JpegFormatError(f"scan uses undefined DC table {sc.dc}")
            dc_tables[sc.dc] = make_table(scan.dc_tables[sc.dc])
        if not is_dc:
            if sc.ac not in scan.ac_tables:
                raise JpegFormatError(f"scan uses undefined AC table {sc.ac}")
            ac_tables[sc.ac] = make_table(scan.ac_tables[sc.ac])

    total_mcus, units, hv, comp_of_unit = _scan_unit_layout(frame, sh)
    preds = {i: 0 for i in range(sh.nics)}
    eobrun = 0
    seg = 0
    reader = readers[0]

    for m in range(total_mcus):
        if ri and m > 0 and m % ri == 0:
            seg += 1
            if seg >= len(readers):
                raise JpegEntropyError(
                    "restart marker expected but segment list exhausted", mcu=m
                )
            reader = readers[seg]
            preds = {i: 0 for i in range(sh.nics)}
            eobrun = 0
        for u, (cidx, c, j, k) in enumerate(units):
            sci = comp_of_unit[u]
            sc = sh.components[sci]
            plane = planes.plane(cidx)
            h, v = hv[cidx]
            by, bx = _block_position(c, plane.shape[1], m, j, k, h, v)
            if by >= plane.shape[0] or bx >= plane.shape[1]:
                continue
            coef = plane[by, bx]  # (64,) int32 view, zigzag order

            if is_dc and sh.ah == 0:
                mag = dc_tables[sc.dc].decode(reader)
                if mag > 15:
                    raise JpegEntropyError(f"DC magnitude category {mag} > 15")
                diff = bsio.receive_extend(reader.read_bits(mag), mag)
                preds[sci] += diff
                coef[0] = _wrap16(preds[sci] << sh.al)
            elif is_dc:
                # DC refine (G.1.2.1): one bit ORed in at position al. The
                # reference omits the <<al shift (decode.c:1055, quirk ledger).
                if reader.read_bit():
                    coef[0] = _wrap16(int(coef[0]) | (1 << sh.al))
            elif sh.ah == 0:
                eobrun = _ac_first(reader, coef, ac_tables[sc.ac], sh, eobrun)
            else:
                eobrun = _ac_refine(reader, coef, ac_tables[sc.ac], sh, eobrun)
    _check_readers_not_overrun(readers)


def _ac_first(
    reader: bsio.BitReader,
    coef: np.ndarray,
    ac: CanonicalTable,
    sh,
    eobrun: int,
) -> int:
    """AC first pass (G.1.2.2) for one block; returns updated EOB run."""
    if eobrun > 0:
        return eobrun - 1
    k = sh.ss
    while k <= sh.se:
        rs = ac.decode(reader)
        size = rs & 0x0F
        run = (rs >> 4) & 0x0F
        if size == 0:
            if run == 15:
                k += 16  # ZRL
                continue
            eobrun = (1 << run) - 1
            if run:
                eobrun += reader.read_bits(run)
            return eobrun
        k += run
        if k > sh.se:
            raise JpegEntropyError(f"AC index {k} beyond spectral band")
        coef[k] = _wrap16(
            bsio.receive_extend(reader.read_bits(size), size) << sh.al
        )
        k += 1
    return 0


def _ac_refine(
    reader: bsio.BitReader,
    coef: np.ndarray,
    ac: CanonicalTable,
    sh,
    eobrun: int,
) -> int:
    """AC refinement pass (G.1.2.3) for one block; returns updated EOB run."""
    p1 = 1 << sh.al
    m1 = -1 << sh.al

    def correct(idx: int) -> None:
        if reader.read_bit():
            if (coef[idx] & p1) == 0:
                coef[idx] = _wrap16(
                    int(coef[idx]) + (p1 if coef[idx] >= 0 else m1)
                )

    k = sh.ss
    if eobrun == 0:
        while k <= sh.se:
            rs = ac.decode(reader)
            size = rs & 0x0F
            run = (rs >> 4) & 0x0F
            val = 0
            if size == 0:
                if run != 15:
                    eobrun = 1 << run
                    if run:
                        eobrun += reader.read_bits(run)
                    break
                # ZRL: advance past 16 zero-history positions
            else:
                if size != 1:
                    raise JpegEntropyError("AC refine size must be 1")
                val = p1 if reader.read_bit() else m1
            # Advance over `run` zero-history coefficients, applying
            # correction bits to any nonzero-history coefficients passed.
            while k <= sh.se:
                if coef[k] != 0:
                    correct(k)
                else:
                    if run == 0:
                        break
                    run -= 1
                k += 1
            if val and k <= sh.se:
                coef[k] = _wrap16(val)
            k += 1
    if eobrun > 0:
        while k <= sh.se:
            if coef[k] != 0:
                correct(k)
            k += 1
        eobrun -= 1
    return eobrun


# ---------------------------------------------------------------------------
# Pixel pipeline: coefficient planes -> component planes -> RGB
# ---------------------------------------------------------------------------


def pixels_from_coeffs(
    frame: FrameHeader,
    planes: CoefficientPlanes,
    quant_tables: dict[int, np.ndarray],
) -> list[np.ndarray]:
    """Dequant + IDCT + block-to-plane scatter for every component.

    quant_tables: qtid -> (64,) natural-order table values."""
    out = []
    bits12 = frame.precision == 12
    for c in frame.components:
        if c.qtid not in quant_tables:
            raise JpegFormatError(
                f"component {c.id} references undefined quant table {c.qtid}"
            )
    for ci, c in enumerate(frame.components):
        zz = planes.plane(ci)  # (by, bx, 64)
        by, bx, _ = zz.shape
        deq = dequantize(zz.reshape(-1, 64), quant_tables[c.qtid])
        pix = idct_2d_exact(deq.reshape(-1, 8, 8), bits12=bits12)
        if bits12:
            pix = rescale_12bit(pix)
        # (by*bx, 8, 8) -> (by, 8-rows, bx, 8-cols) plane
        plane = (
            pix.reshape(by, bx, 8, 8)
            .transpose(0, 2, 1, 3)
            .reshape(by * 8, bx * 8)
        )
        out.append(plane)
    return out


def fancy_upsample_np(
    plane: np.ndarray, hsf: int, vsf: int, max_hsf: int, max_vsf: int
) -> np.ndarray:
    """NumPy mirror of ops/color.fancy_upsample's triangular 2x passes
    (libjpeg convention) for the no-JAX host fallback. Bit-compatible with
    the device version: every intermediate is an integer sum < 2**14
    scaled by an exact power of two, so f32 vs f64 cannot change the final
    floor. Non-2x ratios are left to color_convert's NN gather."""
    x = plane.astype(np.float64)
    if 2 * hsf == max_hsf:
        left = np.roll(x, 1, axis=1)
        left[:, 0] = x[:, 0]
        right = np.roll(x, -1, axis=1)
        right[:, -1] = x[:, -1]
        even = (3.0 * x + left + 1.0) * 0.25
        odd = (3.0 * x + right + 2.0) * 0.25
        x = np.stack([even, odd], axis=2).reshape(x.shape[0], -1)
    if 2 * vsf == max_vsf:
        up = np.roll(x, 1, axis=0)
        up[0] = x[0]
        down = np.roll(x, -1, axis=0)
        down[-1] = x[-1]
        even = (3.0 * x + up + 1.0) * 0.25
        odd = (3.0 * x + down + 2.0) * 0.25
        x = np.stack([even, odd], axis=1).reshape(-1, x.shape[1])
    # Clamp before the cast: the compounded rounding biases can reach
    # exactly 256.0 in an all-255 neighborhood (see ops/color.fancy_upsample)
    # and NumPy's uint8 cast would wrap it to 0.
    return np.clip(np.floor(x), 0.0, 255.0).astype(plane.dtype)


def color_convert(
    frame: FrameHeader,
    pixel_planes: list[np.ndarray],
    quirks: Quirks = Quirks.REFERENCE,
) -> np.ndarray:
    """Dispatch by component count like the viewer (jpeg_decoder.c:95-101)."""
    if frame.ncs == 1:
        return gray_to_rgb_exact(frame, pixel_planes[0], quirks)
    if frame.ncs == 3:
        return ycbcr_to_rgb_exact(frame, pixel_planes, quirks)
    if frame.ncs == 4:
        if quirks != Quirks.REFERENCE and frame.adobe_transform == 0:
            # APP14 transform=0: raw inverted CMYK (the reference ignores
            # APP14 and always composites YCCK; CORRECT honors the marker).
            return cmyk_to_rgb_exact(frame, pixel_planes, quirks)
        return ycck_to_rgb_exact(frame, pixel_planes, quirks)
    raise JpegFormatError(f"no color transform for {frame.ncs} components")


def decode_structure(
    structure: JpegStructure, cfg: DecodeConfig | None = None
) -> DecodedImage:
    """Full oracle decode of a parsed stream."""
    from ..io.markers import Encoding

    from .driver import run_scans

    cfg = cfg or DecodeConfig()
    frame = structure.frame
    planes = CoefficientPlanes(frame)

    def _decode_scan(s, scan, p):
        if frame.process == Encoding.PROGRESSIVE_DCT:
            decode_progressive_scan(s, scan, p)
        else:
            decode_sequential_scan(s, scan, p)

    qts = run_scans(structure, planes, _decode_scan)
    pixel_planes = pixels_from_coeffs(frame, planes, qts)
    rgb = color_convert(frame, pixel_planes, cfg.quirks)
    return DecodedImage(frame=frame, planes=pixel_planes, rgb=rgb)


def decode(data: bytes | np.ndarray, cfg: DecodeConfig | None = None) -> DecodedImage:
    """Parse + oracle-decode a JPEG byte stream."""
    from ..io.parser import parse

    cfg = cfg or DecodeConfig()
    return decode_structure(parse(data, cfg), cfg)
