"""Entropy (Huffman) decode of sequential scans on the device (counterpart of
jpeg_decoder_tpu/ops/entropy_pallas.py): one restart segment per lane.

The host unstuffs every segment of a scan (io/bitstream.unstuff, as the JAX
backend's _pack_group does) into one flat byte buffer with per-segment
offsets, copies it to the device once, and `decode_segments` turns it into
int16 zigzag data units written straight into the coefficient planes. For a
CUDA tensor that is kernel K2 (csrc/entropy_decode.cu), one thread per
segment; for a CPU tensor it is the plain version below, a torch loop over
segments in lockstep -- one tensor lane per segment, one symbol per step,
table lookups by indexing -- which is what the TPU kernel computes, without
its layout tricks.

Guards and errors are the JAX backend's, so both packages accept the same
streams: progressive scans, restart-free scans over 256 MCUs and segments
whose lockstep output would pass 512 MB are rejected with
JpegUnsupportedError; an invalid code raises JpegEntropyError, checked
before truncation; a segment that consumed more than 8 * nbytes + 7 bits
raises JpegTruncatedError.
"""

from __future__ import annotations

import numpy as np
import torch

from jpeg_decoder_tpu.core.driver import run_scans
from jpeg_decoder_tpu.io import bitstream as bsio
from jpeg_decoder_tpu.io.markers import Encoding
from jpeg_decoder_tpu.native.runtime import _check_segments, scan_layout
from jpeg_decoder_tpu.utils.config import DecodeConfig
from jpeg_decoder_tpu.utils.errors import (
    JpegEntropyError,
    JpegError,
    JpegTruncatedError,
    JpegUnsupportedError,
)

from .. import _build, convert

#: The JAX backend's lane width and per-lane-group output cap
#: (entropy_pallas.LANES, _MAX_GROUP_OUT_BYTES). The port has no lanes; it
#: keeps the bound so that both packages accept exactly the same streams.
_LANES = 128
_MAX_GROUP_OUT_BYTES = 512 << 20
_INVALID = 0x1FF


def _segments_too_long(ri: int, n_units: int) -> bool:
    return ri * n_units * 64 * _LANES * 2 * 8 > _MAX_GROUP_OUT_BYTES


def pack_scan(structure, scan, total_mcus: int, n_units: int):
    """Check a scan against the backend's guards and unstuff its restart
    segments: returns (ri, stream uint8 [nbytes + 8], seg_off int64
    [n_segs + 1]); segment s is stream[seg_off[s]:seg_off[s + 1]]."""
    _check_segments(scan, total_mcus)
    if scan.restart_interval == 0 and total_mcus > 256:
        raise JpegUnsupportedError(
            "device entropy backend needs restart intervals (one thread per"
            " restart segment); use the native backend for restart-free"
            " streams"
        )
    ri = scan.restart_interval or total_mcus
    if _segments_too_long(ri, n_units):
        raise JpegUnsupportedError(
            f"restart segments too long for the device entropy backend"
            f" ({ri} MCUs/segment); use the native backend"
        )
    segs = [bsio.unstuff(structure.data, s, e)[0]
            for s, e in scan.span.segment_bounds()]
    seg_off = np.zeros(len(segs) + 1, dtype=np.int64)
    np.cumsum([x.shape[0] for x in segs], out=seg_off[1:])
    # 8 zero bytes of tail keep the buffer non-empty for the plain version's
    # clamped gathers; every read past a segment's end is masked to zero.
    stream = np.concatenate(segs + [np.zeros(8, dtype=np.uint8)])
    return ri, stream, seg_off


def check_status(status: torch.Tensor, seg_off: np.ndarray) -> None:
    """Raise as the JAX backend does from the per-segment (bad, consumed
    bits) status: a bad code first, then truncation."""
    st = status.cpu().numpy()
    if st[:, 0].any():
        raise JpegEntropyError("device entropy decode hit an invalid Huffman code")
    if (st[:, 1] > 8 * np.diff(seg_off) + 7).any():
        raise JpegTruncatedError(
            "entropy data truncated (device decode consumed fabricated bits)"
        )


def _symbol_lut(tables):
    """The ladder tables as direct 16-bit lookups: [n_specs, 65536] int64,
    symbol | code length << 9, indexed by the next 16 bits."""
    code16 = torch.arange(1 << 16, device=tables.device)
    out = []
    for tab in tables.to(torch.int64):
        ln = torch.clamp(
            1 + torch.searchsorted(tab[:16].contiguous(), code16, right=True),
            max=16,
        )
        idx = (code16 >> (16 - ln)) + tab[16:32][ln - 1]
        ok = (idx >= 0) & (idx <= 1023)
        sym = torch.where(ok, tab[32:][torch.clamp(idx, 0, 1023)], _INVALID)
        out.append(sym | (ln << 9))
    return torch.stack(out)


def _windows(stream, seg_off):
    """Every segment followed by 8 zero bytes, as 40-bit big-endian windows:
    returns (w40 int64 [padded bytes], base int64 [n_segs]) with bytes
    p..p+4 of segment s at w40[base[s] + p], for p <= its length."""
    dev = stream.device
    n = seg_off.numel() - 1
    lens = seg_off[1:] - seg_off[:-1]
    plen = lens + 8
    base = torch.cumsum(plen, 0) - plen
    owner = torch.repeat_interleave(torch.arange(n, device=dev), plen)
    rel = torch.arange(owner.numel(), device=dev) - base[owner]
    src = torch.clamp(seg_off[:-1][owner] + rel, max=stream.numel() - 1)
    padded = torch.where(rel < lens[owner], stream[src].to(torch.int64), 0)
    padded = torch.cat([padded, padded.new_zeros(4)])
    w40 = sum(padded[t : t + owner.numel()] << (32 - 8 * t) for t in range(5))
    return w40, base


def _decode_segments_plain(stream, seg_off, ri, total_mcus, units, tables,
                           planes):
    """Lockstep torch version of K2: one lane per segment, one symbol per
    step, table lookups by indexing. Returns int64 [n_segs, 2] (bad,
    consumed bits)."""
    dev = stream.device
    i64 = torch.int64
    n = seg_off.numel() - 1
    nbytes = seg_off[1:] - seg_off[:-1]
    w40, wbase = _windows(stream, seg_off)
    luts = _symbol_lut(tables)
    lane = torch.arange(n, device=dev)
    mcu_count = torch.clamp(total_mcus - lane * ri, max=ri)
    pos = torch.zeros(n, dtype=i64, device=dev)       # consumed bits
    preds = torch.zeros((n, 4), dtype=torch.int32, device=dev)
    bad = torch.zeros(n, dtype=torch.bool, device=dev)

    def next_symbol(lut):
        """(sym, code length, EXTENDed value of its size bits) per lane,
        read at `pos` (bits past a segment's end read as zero)."""
        pk = (w40[wbase + torch.minimum(pos >> 3, nbytes)] >> (8 - (pos & 7))) & 0xFFFFFFFF
        e = lut[pk >> 16]
        sym = e & 0x1FF
        ln = e >> 9
        size = sym & 15
        v = ((pk << ln) & 0xFFFFFFFF) >> (32 - size)
        half = (1 << size) >> 1
        return sym, ln, torch.where(v < half, v - 2 * half + 1, v)

    flat = [p.view(-1, 64) for p in planes]
    du = torch.zeros((n, 65), dtype=i64, device=dev)  # column 64: write sink
    for m in range(ri):
        live = (m < mcu_count) & ~bad
        if not bool(live.any()):
            break
        mg = lane * ri + m
        for pl, sci, dci, aci, h, v, j, k, wrap, bw, bh in units.tolist():
            dc_lut, ac_lut = luts[dci], luts[aci]
            act = live & ~bad
            base = mg * h + k
            bx = base % wrap
            by = (base // wrap) * v + j
            store = act & (by < bh) & (bx < bw)
            du.zero_()
            # DC: the size is the symbol itself; above 15 is a bad code
            sym, ln, diff = next_symbol(dc_lut)
            dc_bad = act & (sym > 15)
            bad |= dc_bad
            act &= ~dc_bad
            pos += torch.where(act, ln + sym, 0)
            preds[:, sci] += torch.where(act, diff, 0).to(torch.int32)
            du[:, 0] = preds[:, sci]
            # AC
            ci = torch.ones(n, dtype=i64, device=dev)
            run = act.clone()
            while bool(run.any()):
                sym, ln, val = next_symbol(ac_lut)
                size = sym & 15
                kt = ci + (sym >> 4)
                eob = sym == 0
                zrl = sym == 0xF0
                # invalid prefix, or a coefficient run past 63
                err = run & ((sym == _INVALID) | (~eob & ~zrl & (kt > 63)))
                bad |= err
                run &= ~err
                pos += torch.where(run, ln + size, 0)
                dst = torch.where(run & (size > 0) & ~zrl, kt, 64)
                du.scatter_(1, dst[:, None], val[:, None])
                ci = torch.where(zrl, ci + 16, kt + 1)
                run &= ~eob & (ci <= 63)
            flat[pl][by[store] * bw + bx[store]] = du[store, :64].to(torch.int16)
    return torch.stack([bad.to(i64), pos], dim=1)


def decode_segments(stream, seg_off, ri: int, total_mcus: int, units,
                    tables, planes) -> torch.Tensor:
    """Decode every restart segment of one scan into `planes` (int16
    [by, bx, 64] per frame component, zeroed). Returns the int64
    [n_segs, 2] status (bad flag, consumed bits). CPU tensors: the plain
    version. CUDA tensors: K2."""
    units_h = units.cpu().numpy()
    n_units, n_specs = units_h.shape[0], tables.shape[0]
    for pl, sci, dci, aci, _h, _v, _j, _k, wrap, bw, bh in units_h.tolist():
        if not (0 <= pl < len(planes) and 0 <= sci < 4 and wrap > 0
                and 0 <= dci < n_specs and 0 <= aci < n_specs
                and tuple(planes[pl].shape) == (bh, bw, 64)):
            raise ValueError("decode_segments: unit layout does not match the planes")
    dev = stream.device
    if dev.type == "cpu":
        return _decode_segments_plain(stream, seg_off, ri, total_mcus, units,
                                      tables, planes)
    if not stream.is_cuda:
        raise ValueError(f"decode_segments: no kernel for {dev}")
    if len(planes) > 4 or n_units > 10 or n_specs > 8:
        raise ValueError("decode_segments: more planes, units or tables than JPEG allows")
    for t, dtype in ((stream, torch.uint8), (seg_off, torch.int64),
                     (units, torch.int32), (tables, torch.int32)):
        if t.dtype != dtype or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"decode_segments: expected contiguous {dtype} on {dev}")
    if tables.shape[1] != convert.TABLE_INTS:
        raise ValueError("decode_segments: bad Huffman table layout")
    for p in planes:
        if p.dtype != torch.int16 or not p.is_contiguous() or p.device != dev:
            raise ValueError("decode_segments: planes must be contiguous int16 on the device")
    n = seg_off.numel() - 1
    status = torch.empty((n, 2), dtype=torch.int64, device=dev)
    pptrs = [_build.ptr(p) for p in planes] + [_build.ptr(None)] * (4 - len(planes))
    _build.launch(
        "jdtc_entropy_decode", _build.ptr(stream), _build.ptr(seg_off), n, ri,
        total_mcus, _build.ptr(units), n_units, _build.ptr(tables), n_specs,
        *pptrs, _build.ptr(status), _build.stream_of(status),
    )
    return status


def decode_scan(structure, scan, planes) -> None:
    """One sequential scan -> `planes` (device tensors), raising on a bad
    or truncated stream."""
    dev = planes[0].device
    tabs = convert.tables_to_device(structure.frame, scan, dev)
    ri, stream, seg_off = pack_scan(structure, scan, tabs.total_mcus,
                                    tabs.units.shape[0])
    status = decode_segments(
        torch.from_numpy(stream).to(dev), torch.from_numpy(seg_off).to(dev),
        ri, tabs.total_mcus, tabs.units, tabs.huffman, planes,
    )
    check_status(status, seg_off)


def batchable(structure) -> bool:
    """True for a single-scan sequential stream whose restart segments the
    backend takes (entropy_pallas.batchable's guards, without raising)."""
    frame = structure.frame
    if frame.process == Encoding.PROGRESSIVE_DCT or len(structure.scans) != 1:
        return False
    scan = structure.scans[0]
    try:
        total_mcus, params, _ = scan_layout(structure, scan)
        _check_segments(scan, total_mcus)
    except JpegError:
        return False
    if scan.restart_interval == 0 and total_mcus > 256:
        return False
    ri = scan.restart_interval or total_mcus
    return not _segments_too_long(ri, params.shape[0])


def entropy_decode(structure, cfg: DecodeConfig, planes):
    """All scans -> (planes, qtid -> natural-order table). `planes` are the
    zeroed device tensors to decode into (convert.zero_planes); their
    device picks K2 or the plain version. Sequential scans only."""
    del cfg  # the device decode has no tunable; kept for the JAX signature
    if structure.frame.process == Encoding.PROGRESSIVE_DCT:
        raise JpegUnsupportedError(
            "device entropy backend does not decode progressive scans"
        )
    qts = run_scans(structure, planes, decode_scan)
    return planes, qts
