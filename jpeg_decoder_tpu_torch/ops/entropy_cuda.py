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
its layout tricks. A launch takes the segments of a group of images that
share (ri, P, unit schedule, Huffman tables): `entropy_decode_batch`
decodes a batch in one launch per group, and a single scan is a group of
one.

Guards and errors are the JAX backend's, so both packages accept the same
streams: progressive scans, restart-free scans over 256 MCUs and segments
whose lockstep output would pass 512 MB are rejected with
JpegUnsupportedError; an invalid code raises JpegEntropyError, checked
before truncation; a segment that consumed more than 8 * nbytes + 7 bits
raises JpegTruncatedError.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.driver import run_scans
from ..io import bitstream as bsio
from ..io.markers import Encoding
from ..native.runtime import _check_segments, scan_layout
from ..utils.config import DecodeConfig
from ..utils.errors import (
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


def _decode_segments_plain(stream, seg_off, seg_img, seg_idx, ri, total_mcus,
                           units, tables, planes):
    """Lockstep torch version of K2: one lane per segment of any image of
    the group, one symbol per step, table lookups by indexing -- what the
    TPU kernel's lanes are. Returns int64 [n_segs, 2] (bad, consumed
    bits)."""
    dev = stream.device
    i64 = torch.int64
    n = seg_off.numel() - 1
    nbytes = seg_off[1:] - seg_off[:-1]
    w40, wbase = _windows(stream, seg_off)
    luts = _symbol_lut(tables).reshape(-1)            # [n_specs * 65536]
    img = seg_img.to(i64)
    sidx = seg_idx.to(i64)
    lane = torch.arange(n, device=dev)
    units_h = units.tolist()                          # [n_img][P][11]
    # per unit, each lane's columns of its image's layout; the tables as
    # offsets into `luts`, the predictor as an index into `preds`
    cols = []
    for lane_unit in units.to(i64)[img].unbind(1):
        _pl, sci, dci, aci, h, v, j, k, wrap, bw, bh = lane_unit.unbind(1)
        cols.append((lane * 4 + sci, dci << 16, aci << 16, h, v, j, k, wrap, bw, bh))
    in_img = [img == i for i in range(len(planes))]
    mcu_count = torch.clamp(total_mcus.to(i64)[img] - sidx * ri, max=ri)
    pos = torch.zeros(n, dtype=i64, device=dev)       # consumed bits
    preds = torch.zeros(n * 4, dtype=torch.int32, device=dev)
    bad = torch.zeros(n, dtype=torch.bool, device=dev)

    def next_symbol(lut_base):
        """(sym, code length, EXTENDed value of its size bits) per lane,
        read at `pos` through each lane's table (bits past a segment's
        end read as zero)."""
        pk = (w40[wbase + torch.minimum(pos >> 3, nbytes)] >> (8 - (pos & 7))) & 0xFFFFFFFF
        e = luts[lut_base + (pk >> 16)]
        sym = e & 0x1FF
        ln = e >> 9
        size = sym & 15
        v = ((pk << ln) & 0xFFFFFFFF) >> (32 - size)
        half = (1 << size) >> 1
        return sym, ln, torch.where(v < half, v - 2 * half + 1, v)

    flat = [[p.view(-1, 64) for p in img_planes] for img_planes in planes]
    du = torch.zeros((n, 65), dtype=i64, device=dev)  # column 64: write sink
    for m in range(ri):
        live = (m < mcu_count) & ~bad
        if not bool(live.any()):
            break
        mg = sidx * ri + m
        for u, (pred_i, dc_base, ac_base, h, v, j, k, wrap, bw, bh) in enumerate(cols):
            act = live & ~bad
            base = mg * h + k
            bx = base % wrap
            by = (base // wrap) * v + j
            store = act & (by < bh) & (bx < bw)
            du.zero_()
            # DC: the size is the symbol itself; above 15 is a bad code
            sym, ln, diff = next_symbol(dc_base)
            dc_bad = act & (sym > 15)
            bad |= dc_bad
            act &= ~dc_bad
            pos += torch.where(act, ln + sym, 0)
            preds.index_add_(0, pred_i, torch.where(act, diff, 0).to(torch.int32))
            du[:, 0] = preds[pred_i]
            # AC
            ci = torch.ones(n, dtype=i64, device=dev)
            run = act.clone()
            while bool(run.any()):
                sym, ln, val = next_symbol(ac_base)
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
            for i, mask in enumerate(in_img):
                sel = store & mask
                if bool(sel.any()):
                    plane = flat[i][units_h[i][u][0]]
                    plane[by[sel] * bw[sel] + bx[sel]] = du[sel, :64].to(torch.int16)
    return torch.stack([bad.to(i64), pos], dim=1)


def decode_segments(stream, seg_off, seg_img, seg_idx, ri: int, total_mcus,
                    units, tables, planes) -> torch.Tensor:
    """Decode every restart segment of a group of scans (one per image, see
    convert.group_tables) into `planes` (per image, its int16 [by, bx, 64]
    planes per frame component, zeroed): segment s is
    stream[seg_off[s]:seg_off[s + 1]], segment seg_idx[s] of image
    seg_img[s]. Returns the int64 [n_segs, 2] status (bad flag, consumed
    bits). CPU tensors: the plain version. CUDA tensors: K2, one launch for
    the whole group."""
    units_h = units.cpu().numpy()
    if (units_h.ndim != 3 or len(planes) != units_h.shape[0]
            or tuple(total_mcus.shape) != units_h.shape[:1]):
        raise ValueError("decode_segments: units, total_mcus and planes disagree on the images")
    n_img, n_units, n_specs = units_h.shape[0], units_h.shape[1], tables.shape[0]
    for img_units, img_planes in zip(units_h.tolist(), planes):
        for pl, sci, dci, aci, _h, _v, _j, _k, wrap, bw, bh in img_units:
            if not (0 <= pl < len(img_planes) and 0 <= sci < 4 and wrap > 0
                    and 0 <= dci < n_specs and 0 <= aci < n_specs
                    and tuple(img_planes[pl].shape) == (bh, bw, 64)):
                raise ValueError("decode_segments: unit layout does not match the planes")
    seg_img_h = seg_img.cpu().numpy()
    if seg_img_h.size and not (0 <= seg_img_h.min() and seg_img_h.max() < n_img):
        raise ValueError("decode_segments: segment of no image")
    dev = stream.device
    if dev.type == "cpu":
        return _decode_segments_plain(stream, seg_off, seg_img, seg_idx, ri,
                                      total_mcus, units, tables, planes)
    if not stream.is_cuda:
        raise ValueError(f"decode_segments: no kernel for {dev}")
    if n_units > 10 or n_specs > 8 or any(len(p) > 4 for p in planes):
        raise ValueError("decode_segments: more planes, units or tables than JPEG allows")
    for t, dtype in ((stream, torch.uint8), (seg_off, torch.int64),
                     (seg_img, torch.int32), (seg_idx, torch.int32),
                     (total_mcus, torch.int64), (units, torch.int32),
                     (tables, torch.int32)):
        if t.dtype != dtype or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"decode_segments: expected contiguous {dtype} on {dev}")
    if tables.shape[1] != convert.TABLE_INTS:
        raise ValueError("decode_segments: bad Huffman table layout")
    for img_planes in planes:
        for p in img_planes:
            if p.dtype != torch.int16 or not p.is_contiguous() or p.device != dev:
                raise ValueError("decode_segments: planes must be contiguous int16 on the device")
    n = seg_off.numel() - 1
    status = torch.empty((n, 2), dtype=torch.int64, device=dev)
    addresses = convert.plane_addresses(planes, dev)
    if n:
        _build.launch(
            "jdtc_entropy_decode", _build.ptr(stream), _build.ptr(seg_off),
            _build.ptr(seg_img), _build.ptr(seg_idx), n, ri,
            _build.ptr(total_mcus), _build.ptr(units), n_units,
            _build.ptr(tables), n_specs, _build.ptr(addresses),
            _build.ptr(status), _build.stream_of(status),
        )
    return status


class ScanPack(NamedTuple):
    """One image's scan, checked and unstuffed: its part of a K2 launch."""

    key: tuple            # group key (convert.group_key)
    ri: int
    total_mcus: int
    units: np.ndarray     # int32 [P, 11]
    tables: np.ndarray    # int32 [n_specs, TABLE_INTS]
    stream: np.ndarray    # uint8: the unstuffed segments + 8 zero bytes
    seg_off: np.ndarray   # int64 [n_segs + 1]


def prepare_scan(structure, scan) -> ScanPack:
    """Unit layout, tables and group key of a sequential scan, then
    pack_scan's guards and unstuffing."""
    key, total_mcus, units, tabs = convert.group_key(structure.frame, scan)
    ri, stream, seg_off = pack_scan(structure, scan, total_mcus, units.shape[0])
    return ScanPack(key, ri, total_mcus, units, tabs, stream, seg_off)


def host_args(packs):
    """ScanPacks of one group (equal keys), one per image, as the host
    arrays of decode_segments' arguments before `planes`: (stream, seg_off,
    seg_img, seg_idx, ri, total_mcus, units, tables)."""
    if any(p.key != packs[0].key for p in packs):
        raise ValueError("host_args: scans of different groups")
    counts = [p.seg_off.shape[0] - 1 for p in packs]
    seg_off = np.zeros(sum(counts) + 1, dtype=np.int64)
    at, byte0 = 0, 0
    for p, c in zip(packs, counts):
        seg_off[at + 1 : at + c + 1] = p.seg_off[1:] + byte0
        at, byte0 = at + c, byte0 + int(p.seg_off[-1])
    stream = np.concatenate([p.stream[: p.seg_off[-1]] for p in packs]
                            + [np.zeros(8, dtype=np.uint8)])
    seg_img = np.repeat(np.arange(len(packs), dtype=np.int32), counts)
    seg_idx = np.concatenate([np.arange(c, dtype=np.int32) for c in counts])
    total_mcus, units, tables = convert.group_tables(
        [(p.total_mcus, p.units, p.tables) for p in packs])
    return stream, seg_off, seg_img, seg_idx, packs[0].ri, total_mcus, units, tables


def to_device(args, device):
    """host_args' arrays as tensors on `device` (ri stays an int)."""
    return tuple(torch.from_numpy(a).to(device) if isinstance(a, np.ndarray) else a
                 for a in args)


def launch_args(packs, device):
    """(decode_segments' arguments before `planes` on `device`, the host
    seg_off that check_status reads) for ScanPacks of one group."""
    args = host_args(packs)
    return to_device(args, device), args[1]


def decode_scan(structure, scan, planes) -> None:
    """One sequential scan -> `planes` (device tensors), raising on a bad
    or truncated stream: a group of one image."""
    args, seg_off = launch_args([prepare_scan(structure, scan)], planes[0].device)
    check_status(decode_segments(*args, [planes]), seg_off)


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


def entropy_decode_batch(structures, cfg: DecodeConfig, planes):
    """Batched serving path (counterpart of entropy_pallas.
    entropy_decode_batch): the restart segments of many images decode in
    one K2 launch per group of images that share (ri, P, unit schedule,
    Huffman table content), with no cap on the segments per launch.
    `planes` holds each structure's zeroed planes (a list of tensors per
    structure, e.g. views into a stacked batch tensor); returns
    [(planes, qts)] aligned with `structures`. Every stream must be a
    single-scan sequential one that the backend takes (batchable); each
    group's status is checked in group order, a bad code before
    truncation."""
    del cfg  # the device decode has no tunable; kept for the JAX signature
    results = [None] * len(structures)
    groups: dict = {}
    for i, structure in enumerate(structures):
        if (structure.frame.process == Encoding.PROGRESSIVE_DCT
                or len(structure.scans) != 1):
            raise JpegUnsupportedError(
                "device batched decode handles single-scan sequential streams"
            )
        scan = structure.scans[0]
        pack = prepare_scan(structure, scan)
        results[i] = (planes[i], {tid: qt.values for tid, qt in scan.quant_tables.items()})
        group = groups.setdefault(pack.key, ([], []))
        group[0].append(pack)
        group[1].append(planes[i])
    launched = []
    for packs, group_planes in groups.values():
        args, seg_off = launch_args(packs, group_planes[0][0].device)
        launched.append((decode_segments(*args, group_planes), seg_off))
    for status, seg_off in launched:
        check_status(status, seg_off)
    return results


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
