"""Entropy (Huffman) decode of sequential scans on the device (counterpart of
jpeg_decoder_tpu/ops/entropy_pallas.py).

The host parses a stream and finds the raw bounds of its restart segments;
the raw entropy-coded bytes of a group of scans go to the device as they
lie in their files, one copy per image. `unstuff_segments` (kernel K2u,
csrc/unstuff.cu, one pass over the raw bytes) drops the stuffed zeros and
the restart markers there and leaves one flat byte buffer with per-segment
offsets -- what the JAX backend's _pack_group builds on the host -- and
K2's record layout, all on the device; `decode_segments` (kernel K2,
csrc/entropy_decode.cu) follows without the host reading anything back (it
sizes its scratch by the raw lengths, which bound the unstuffed ones) and
turns the buffer into int16 zigzag data units written straight into the
zeroed coefficient planes. K2 cuts every segment into subsequences of
SUB_BYTES bytes, one thread each: the threads decode from guessed states,
hand each other their end states until nothing changes (Huffman streams
resynchronise), a prefix sum places every subsequence's data units, a last
decode stores them, and the DC predictions are summed afterwards. For a CPU tensor both functions
run their plain versions below: for K2 a torch loop over segments in
lockstep -- one tensor lane per segment, one symbol per step, table
lookups by indexing -- which is what the TPU kernel computes, without its
layout tricks. `_decode_segments_subseq_plain` is a model of K2's schedule
for the tests, never a decode path. A launch takes the segments of a group
of images that share (ri, P, unit schedule, Huffman tables):
`entropy_decode_batch` decodes a batch in one launch per group, and a
single scan is a group of one.

Two routes share these kernels, each with its JAX backend's guards, so
that both packages accept the same streams. PALLAS (this module's
entropy_decode, entropy_decode_batch; check_scan, batchable) keeps the
Mosaic kernel's lane guards: progressive scans, restart-free scans over
256 MCUs and segments whose lockstep output would pass 512 MB are
rejected with JpegUnsupportedError. DEVICE (ops/entropy_device.py;
check_scan_device) refuses progressive scans alone: a restart-free scan
of any length is one segment, which K2 cuts into subsequences like any
other. Errors are the same on both: an invalid code raises
JpegEntropyError, checked before truncation; a segment that consumed more
than 8 * nbytes + 7 bits raises JpegTruncatedError.
"""

from __future__ import annotations

import ctypes
import warnings
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
#: Bytes of a subsequence, K2's unit of parallel work (kSubBytes in
#: csrc/entropy_decode.cu; the wrapper refuses a library built with another).
SUB_BYTES = 128
#: Bits that index K2's first-level tables (kLutBits).
_LUT_BITS = 10
#: Records a block of K2's scan pass takes, and data units a block of its
#: dc pass takes (kScanChunk, kDcChunk; the wrapper refuses a library built
#: with others): a segment longer than that is several chunks chained by
#: look-back.
SCAN_CHUNK = 2048
DC_CHUNK = 4096
#: A K2 record as one 64-bit word: bits 63..32 the bit position p, 31..16
#: the data units completed, 15..12 the unit u, 11..6 the zigzag position k,
#: bit 0 invalid. A state is a record with the count cleared.
_COUNT_MASK = 0xFFFF << 16


def _segments_too_long(ri: int, n_units: int) -> bool:
    return ri * n_units * 64 * _LANES * 2 * 8 > _MAX_GROUP_OUT_BYTES


def check_scan(scan, total_mcus: int, n_units: int) -> int:
    """Check a scan against the PALLAS route's guards (the JAX backend's
    lanes); returns its restart interval in MCUs (the whole scan for a
    restart-free one)."""
    _check_segments(scan, total_mcus)
    if scan.restart_interval == 0 and total_mcus > 256:
        raise JpegUnsupportedError(
            "device entropy backend needs restart intervals (it keeps the"
            " JAX backend's guard: a restart-free scan of at most 256"
            " MCUs); use the native backend for restart-free streams"
        )
    ri = scan.restart_interval or total_mcus
    if _segments_too_long(ri, n_units):
        raise JpegUnsupportedError(
            f"restart segments too long for the device entropy backend"
            f" ({ri} MCUs/segment); use the native backend"
        )
    return ri


def check_scan_device(scan, total_mcus: int, n_units: int) -> int:
    """check_scan for the DEVICE route (the JAX backend's lane-per-segment
    loop, which has no lane guard): only the segment count is checked."""
    del n_units  # a segment of any length decodes
    _check_segments(scan, total_mcus)
    return scan.restart_interval or total_mcus


def pack_scan(structure, scan, total_mcus: int, n_units: int):
    """The host's unstuffing, which `unstuff_segments` is held against:
    check_scan's guards, then (ri, stream uint8 [nbytes + 8], seg_off int64
    [n_segs + 1]); segment s is stream[seg_off[s]:seg_off[s + 1]]."""
    ri = check_scan(scan, total_mcus, n_units)
    segs = [bsio.unstuff(structure.data, s, e)[0]
            for s, e in scan.span.segment_bounds()]
    seg_off = np.zeros(len(segs) + 1, dtype=np.int64)
    np.cumsum([x.shape[0] for x in segs], out=seg_off[1:])
    # 8 zero bytes of tail keep the buffer non-empty for the plain version's
    # clamped gathers; every read past a segment's end is masked to zero.
    stream = np.concatenate(segs + [np.zeros(8, dtype=np.uint8)])
    return ri, stream, seg_off


def check_status(status: torch.Tensor, seg_off) -> None:
    """Raise as the JAX backend does from the per-segment (bad, consumed
    bits) status: a bad code first, then truncation. `seg_off` (the
    unstuffed offsets) may lie on the device: it comes back in one copy
    with the status."""
    n = status.shape[0]
    if isinstance(seg_off, torch.Tensor):
        both = torch.cat([status.reshape(-1), seg_off.to(status.device)]).cpu().numpy()
        st, seg_off = both[: 2 * n].reshape(n, 2), both[2 * n:]
    else:
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


def sub_layout(seg_off: np.ndarray, sub_bytes: int = SUB_BYTES) -> np.ndarray:
    """int64 [n_segs + 1]: the index of each segment's first subsequence
    among all subsequences of a launch. A segment has one subsequence per
    `sub_bytes` bytes, and at least one."""
    nsub = np.maximum(1, -(-np.diff(seg_off) // sub_bytes))
    return np.concatenate([[0], np.cumsum(nsub)]).astype(np.int64)


def _sub_base_plain(seg_off: torch.Tensor, sub_bytes: int = SUB_BYTES) -> torch.Tensor:
    """sub_layout on tensors, on seg_off's device: what K2u's second kernel
    computes for K2."""
    nsub = torch.clamp((seg_off[1:] - seg_off[:-1] + sub_bytes - 1) // sub_bytes, min=1)
    return torch.cat([seg_off.new_zeros(1), torch.cumsum(nsub, 0)])


def _decode_segments_subseq_plain(stream, seg_off, seg_img, seg_idx, ri, total_mcus,
                                  units, tables, planes, sub_bytes: int = SUB_BYTES,
                                  capacity: int | None = None, scan_chunk: int = SCAN_CHUNK,
                                  dc_chunk: int = DC_CHUNK):
    """A model of K2's schedule (csrc/entropy_decode.cu) in Python integers,
    for the tests and the card check at small sizes; never a decode path.
    The same passes over the same records: pass 1 from guessed states, the
    rounds of pass 2 (here every subsequence takes its predecessor's record
    of the round before; the kernel's blocks also iterate among themselves,
    so it needs no more launches than this needs rounds), the prefix sum
    over chunks of `scan_chunk` records, the write pass and the DC sums
    over chunks of `dc_chunk` data units. A chunk's prefix is the sum of
    the aggregates of every chunk before it in its segment: the look-back
    when none of them has published its inclusive prefix yet, which gives
    what any order of the blocks gives. Returns (status int64 [n_segs, 2],
    records) with records = dict(rec, used, first_du: int64 / int64 / int64
    arrays over all subsequences; sub_base; rounds; changed: the records
    each round replaced; scan_chunks, dc_chunks: the chunks of the scan and
    dc passes that held work); `planes` are written in place. `capacity`:
    the records' length, as K2's wrapper sizes them from the raw lengths
    when the layout comes from the device (entries past sub_base[-1] stay
    0); by default sub_base[-1]."""
    st = stream.cpu().numpy()
    so = seg_off.cpu().numpy().astype(np.int64)
    img_h = seg_img.cpu().numpy()
    idx_h = seg_idx.cpu().numpy()
    tm_h = total_mcus.cpu().numpy()
    units_h = units.cpu().numpy().astype(np.int64)
    luts = _symbol_lut(tables.cpu()).numpy()
    n = so.shape[0] - 1
    n_units = units_h.shape[1]
    sub_base = sub_layout(so, sub_bytes)
    n_subs = int(sub_base[-1]) if capacity is None else capacity
    if n_subs < sub_base[-1]:
        raise ValueError("_decode_segments_subseq_plain: capacity below the layout")
    rec = [0] * n_subs
    used = [0] * n_subs
    first_du = [0] * n_subs
    status = np.zeros((n, 2), dtype=np.int64)
    flat = [[p.view(-1, 64) for p in img_planes] for img_planes in planes]
    changed: list[int] = []   # per round of pass 2, the records it replaced
    n_chunks = [0, 0]         # chunks of the scan and dc passes that held work

    def address(ul, m):
        """Row of data unit (m, unit ul) in its plane, or None outside."""
        pl, _sci, _dc, _ac, h, v, j, k, wrap, bw, bh = ul
        base = m * h + k
        bx, by = base % wrap, (base // wrap) * v + j
        return (pl, by * bw + bx) if by < bh and bx < bw else None

    for s in range(n):
        img = int(img_h[s])
        ul_of = [tuple(int(x) for x in row) for row in units_h[img]]
        nbytes = int(so[s + 1] - so[s])
        big = int.from_bytes(st[so[s]:so[s + 1]].tobytes(), "big")
        nbits = 8 * nbytes
        m_lo = int(idx_h[s]) * ri
        total_du = max(0, min(ri, int(tm_h[img]) - m_lo)) * n_units
        b0 = int(sub_base[s])
        nsub = int(sub_base[s + 1]) - b0
        dcdiff = [0] * total_du

        def window(p):
            """The 32 bits at position p; zero past the segment's end."""
            sh = nbits - p - 32
            return (big >> sh if sh >= 0 else big << -sh) & 0xFFFFFFFF

        def end_bit(local, write=False):
            """The last subsequence ends with the segment's bytes while the
            chains are sought, and at the MCU count in the write pass."""
            if local + 1 < nsub:
                return (local + 1) * sub_bytes * 8
            return 1 << 62 if write else nbits

        def decode(state, end, max_du, first=None):
            """decode_sub of the kernel: the record reached from `state`;
            with `first` (the write pass) it stores and sets the status."""
            if state & 1:
                return 1
            p, u, k, count = state >> 32, (state >> 12) & 15, (state >> 6) & 63, 0
            write = first is not None
            if write:
                m = m_lo + first // n_units
                at = address(ul_of[u], m)
            while count < max_du and p < end:
                ul = ul_of[u]
                w = window(p)
                if k == 0:
                    e = int(luts[ul[2], w >> 16])
                    sym, ln = e & 0x1FF, e >> 9
                    if sym > 15:
                        if write:
                            status[s, 0] = 1
                        return 1 | count << 16
                    v = ((w << ln) & 0xFFFFFFFF) >> (32 - sym) if sym else 0
                    p += ln + sym
                    if write:
                        dcdiff[first + count] = bsio.receive_extend(v, sym)
                    k = 1
                    continue
                e = int(luts[ul[3], w >> 16])
                sym, ln = e & 0x1FF, e >> 9
                bad = sym == _INVALID
                if sym == 0x00:
                    k, p = 64, p + ln
                elif sym == 0xF0:
                    k, p = k + 16, p + ln
                elif not bad:
                    k += sym >> 4
                    size = sym & 15
                    # A run past 63 is a bad code only in the write pass: from
                    # a wrong start it is expected, and the data unit ends
                    # there so that the chain lives on and can fall into step.
                    bad = write and k > 63
                    if not bad:
                        p += ln + size
                        if size and write and at is not None:
                            v = ((w << ln) & 0xFFFFFFFF) >> (32 - size)
                            flat[img][at[0]][at[1], k] = bsio.receive_extend(v, size)
                    k += 1
                if bad:
                    if write:
                        status[s, 0] = 1
                    return 1 | count << 16
                if k > 63:
                    k, count, u = 0, count + 1, u + 1
                    if u == n_units:
                        u = 0
                        if write:
                            m += 1
                    if write and count < max_du:
                        at = address(ul_of[u], m)
            if write and count == max_du:
                status[s, 1] = p
            return p << 32 | count << 16 | u << 12 | k << 6

        # pass 1
        for local in range(nsub):
            used[b0 + local] = (local * sub_bytes * 8) << 32
            rec[b0 + local] = decode(used[b0 + local], end_bit(local), total_du)
        # pass 2, to the fixed point
        seg_rounds = 0
        while True:
            seg_rounds += 1
            before = rec[b0:b0 + nsub]
            for local in range(1, nsub):
                state = before[local - 1] & ~_COUNT_MASK
                # an invalid predecessor says nothing: keep the own chain
                if not state & 1 and state != used[b0 + local]:
                    used[b0 + local] = state
                    rec[b0 + local] = decode(state, end_bit(local), total_du)
            n_changed = sum(a != b for a, b in zip(rec[b0:b0 + nsub], before))
            if len(changed) < seg_rounds:
                changed.append(0)
            changed[seg_rounds - 1] += n_changed
            if not n_changed:
                break
        # scan: each chunk's own exclusive sums, offset by the aggregates of
        # the chunks before it
        counts = [(r >> 16) & 0xFFFF for r in rec[b0:b0 + nsub]]
        aggregates = [sum(counts[c0:c0 + scan_chunk]) for c0 in range(0, nsub, scan_chunk)]
        n_chunks[0] += len(aggregates)
        for chunk, c0 in enumerate(range(0, nsub, scan_chunk)):
            run = sum(aggregates[:chunk]) & 0xFFFFFFFF
            for local in range(c0, min(c0 + scan_chunk, nsub)):
                first_du[b0 + local] = run
                run += counts[local]
        # write
        for local in range(nsub):
            state = 0 if local == 0 else rec[b0 + local - 1] & ~_COUNT_MASK
            first = first_du[b0 + local]
            if not state & 1 and first < total_du:
                decode(state, end_bit(local, True), total_du - first, first)
        # dc: running sums per scan component, modulo 2^16, a chunk of
        # data units at a time, each from the aggregates of the chunks
        # before it
        if not status[s, 0]:
            aggregates = []
            for c0 in range(0, total_du, dc_chunk):
                agg = [0, 0, 0, 0]
                for d in range(c0, min(c0 + dc_chunk, total_du)):
                    agg[ul_of[d % n_units][1]] += dcdiff[d]
                aggregates.append([a & 0xFFFF for a in agg])
            n_chunks[1] += len(aggregates)
            for chunk, c0 in enumerate(range(0, total_du, dc_chunk)):
                preds = [sum(a[k] for a in aggregates[:chunk]) & 0xFFFF for k in range(4)]
                for d in range(c0, min(c0 + dc_chunk, total_du)):
                    ul = ul_of[d % n_units]
                    preds[ul[1]] = (preds[ul[1]] + dcdiff[d]) & 0xFFFF
                    at = address(ul, m_lo + d // n_units)
                    if at is not None:
                        v = preds[ul[1]]
                        flat[img][at[0]][at[1], 0] = v - 0x10000 if v >= 0x8000 else v
    records = dict(rec=np.array(rec, dtype=np.int64), used=np.array(used, dtype=np.int64),
                   first_du=np.array(first_du, dtype=np.int64), sub_base=sub_base,
                   rounds=max(1, len(changed)), changed=changed, scan_chunks=n_chunks[0],
                   dc_chunks=n_chunks[1])
    return torch.from_numpy(status), records


class HostArrays(NamedTuple):
    """What decode_segments' wrapper needs on the host (it validates its
    arguments and sizes the records by the segments' lengths): launch_args
    hands it over as it built it, so that the wrapper reads nothing back
    from the device."""

    #: int64 [n_segs + 1]: segment s has at most seg_bound[s + 1] -
    #: seg_bound[s] bytes -- exactly that many (the segments' offsets) when
    #: sub_base is None, else the raw lengths, which launch_args knows
    #: before K2u runs
    seg_bound: np.ndarray
    seg_img: np.ndarray     # int32 [n_segs]
    total_mcus: np.ndarray  # int64 [n_img]
    units: np.ndarray       # int32 [n_img, P, 11]
    #: K2's record layout on the device (unstuff_segments' sub_base), or
    #: None: the host lays the records out by seg_bound
    sub_base: torch.Tensor | None = None


def decode_segments(stream, seg_off, seg_img, seg_idx, ri: int, total_mcus,
                    units, tables, planes, records: dict | None = None,
                    host: HostArrays | None = None, count_as: str = "jdtc_entropy_decode",
                    earlier_tail: bool = False) -> torch.Tensor:
    """Decode every restart segment of a group of scans (one per image, see
    convert.group_tables) into `planes` (per image, its int16 [by, bx, 64]
    planes per frame component, zeroed: the kernel stores nonzero
    coefficients only): segment s is stream[seg_off[s]:seg_off[s + 1]],
    segment seg_idx[s] of image seg_img[s]. Returns the int64 [n_segs, 2]
    status (bad flag, consumed bits). CPU tensors: the plain version. CUDA
    tensors: K2, one call for the whole group (several kernels: tables,
    pass 1, pass 2 until no record changes, scan, write, dc), counted
    under `count_as` (the DEVICE route counts its own). A segment may be
    of any length up to 256 MB: the dc pass takes it in chunks of DC_CHUNK
    data units, the scan pass, where a segment has more than SCAN_CHUNK
    records, in chunks of SCAN_CHUNK, chained by look-back. `earlier_tail`,
    for measurement only (no decode path sets it): the earlier scan and dc
    passes, a block per segment, whatever its length.

    The status's bad flags equal the plain version's on every stream; the
    consumed bits and the planes equal them bitwise whenever no segment of
    the call is bad (check_status raises on a bad one before it looks at
    anything else).

    `host`: see HostArrays; without it the wrapper reads seg_off, seg_img,
    total_mcus and units back from the device.

    `records`, for checks and timing on the card: a dict that receives the
    launch's scratch (rec, used, first_du up to the layout's end; sub_base
    on the host, read back when it came from the device), the launches of pass 2
    (rounds), the steps inside them that replaced records (steps: the most
    of any block, summed over the launches; the model's rounds bound them)
    and the milliseconds of each pass (pass_ms: tables + pass 1,
    pass 2, scan, write, dc)."""
    if host is None:
        host = HostArrays(seg_off.cpu().numpy(), seg_img.cpu().numpy(),
                          total_mcus.cpu().numpy(), units.cpu().numpy())
    seg_bound_h, seg_img_h, total_h, units_h, sub_base_dev = host
    if (seg_bound_h.shape != tuple(seg_off.shape) or seg_img_h.shape != tuple(seg_img.shape)
            or total_h.shape != tuple(total_mcus.shape)
            or units_h.shape != tuple(units.shape)):
        raise ValueError("decode_segments: the host's copies disagree with the arguments")
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
    if not n:
        return status
    # The records are sized by the segments' lengths, or by bounds of them
    # (the raw lengths) when the layout itself comes from the device.
    seg_len = np.diff(seg_bound_h)
    if ((seg_len < 0).any() or seg_bound_h[0] < 0
            or seg_bound_h[-1] + 3 > stream.numel() or stream.data_ptr() % 4):
        raise ValueError("decode_segments: segment offsets outside the stream, or the"
                         " stream lacks its tail or its alignment")
    if (seg_len >= 1 << 28).any():  # a record holds a bit position in 32 bits
        raise ValueError("decode_segments: a segment of 256 MB or more")
    # a segment's data units are counted in 32 bits
    if (not 0 < ri * n_units < 1 << 32 or (total_h < 0).any()
            or (total_h >= 1 << 28).any()):
        raise ValueError("decode_segments: restart interval or MCU count out of range")
    lib = _build.library()
    if (lib.jdtc_entropy_sub_bytes() != SUB_BYTES or lib.jdtc_entropy_chunk(0) != SCAN_CHUNK
            or lib.jdtc_entropy_chunk(1) != DC_CHUNK):
        raise RuntimeError("decode_segments: the kernel library was built with another"
                           " subsequence or chunk size")
    if sub_base_dev is not None and (sub_base_dev.dtype != torch.int64
                                     or not sub_base_dev.is_contiguous()
                                     or sub_base_dev.device != dev
                                     or tuple(sub_base_dev.shape) != (n + 1,)):
        raise ValueError(f"decode_segments: sub_base must be contiguous int64 [{n + 1}] on {dev}")
    sub_base = sub_layout(seg_bound_h)   # exact, or a bound per segment
    n_subs = int(sub_base[-1])
    max_subs = int(np.diff(sub_base).max())
    # the scan and dc passes' look-back words: two chunk counters, then a
    # word per scan chunk and four (a scan component each) per dc chunk
    chain = torch.empty(2 + n * (-(-max_subs // SCAN_CHUNK) + 4 * -(-ri * n_units // DC_CHUNK)),
                        dtype=torch.int64, device=dev)
    du_base_img = np.concatenate([[0], np.cumsum(total_h * n_units)]).astype(np.int64)
    # non-blocking uploads: nothing between the raw bytes' upload and K2's
    # first kernel waits for the device (a pageable source is staged before
    # the call returns)
    if sub_base_dev is None:
        aux = torch.from_numpy(np.concatenate([sub_base, du_base_img])).to(
            dev, non_blocking=True)
        sub_base_dev, du_base_dev = aux[: n + 1], aux[n + 1:]
    else:
        du_base_dev = torch.from_numpy(du_base_img).to(dev, non_blocking=True)
    rec = torch.empty(n_subs, dtype=torch.int64, device=dev)
    used = torch.empty(n_subs, dtype=torch.int64, device=dev)
    first_du = torch.empty(n_subs, dtype=torch.int32, device=dev)
    dcdiff = torch.empty(max(1, int(du_base_img[-1])), dtype=torch.int16, device=dev)
    lut = torch.empty((n_specs, 1 << _LUT_BITS), dtype=torch.int16, device=dev)
    flag = torch.empty(1, dtype=torch.int32, device=dev)
    addresses = convert.plane_addresses(planes, dev)
    rounds = (ctypes.c_int * 2)()
    pass_ms = (ctypes.c_float * 5)() if records is not None else None
    _build.launch_as(
        count_as, "jdtc_entropy_decode", _build.ptr(stream), _build.ptr(seg_off),
        _build.ptr(seg_img), _build.ptr(seg_idx), n, ri,
        _build.ptr(total_mcus), _build.ptr(units), n_units,
        _build.ptr(tables), n_specs, _build.ptr(addresses), _build.ptr(status),
        _build.ptr(sub_base_dev), _build.ptr(du_base_dev), max_subs,
        _build.ptr(rec), _build.ptr(used), _build.ptr(first_du), _build.ptr(dcdiff),
        _build.ptr(lut), _build.ptr(flag), _build.ptr(chain), chain.numel(), int(earlier_tail),
        ctypes.c_void_p(ctypes.addressof(rounds)),
        None if pass_ms is None else ctypes.c_void_p(ctypes.addressof(pass_ms)),
        _build.stream_of(status),
    )
    if records is not None:
        layout = sub_base_dev.cpu().numpy()
        end = int(layout[-1])
        records.update(rec=rec[:end], used=used[:end], first_du=first_du[:end],
                       sub_base=layout, rounds=rounds[0], steps=rounds[1],
                       pass_ms=list(pass_ms))
    return status


# ---------------------------------------------------------------------------
# Unstuffing (K2u)
# ---------------------------------------------------------------------------


class Unstuffed(NamedTuple):
    """unstuff_segments' result, all on the raw bytes' device."""

    #: uint8 [n_raw + 8]: the unstuffed segments back to back, then 8 zero
    #: bytes: stream[: seg_off[-1] + 8]; the bytes past those are undefined
    #: (K2 never reads them)
    stream: torch.Tensor
    seg_off: torch.Tensor   # int64 [n_segs + 1]
    sub_base: torch.Tensor  # int64 [n_segs + 1]: K2's record layout, sub_layout(seg_off)


def _keep_mask(raw, lo, hi):
    """K2u's rule: a byte is kept iff it lies in a segment [lo[s], hi[s])
    and is not the 0x00 after a 0xFF of the same segment."""
    j = torch.arange(raw.numel(), device=raw.device)
    if not lo.numel():
        return torch.zeros_like(j, dtype=torch.bool)
    s = torch.searchsorted(lo, j, right=True) - 1      # last segment starting at or before j
    sc = torch.clamp(s, min=0)
    inside = (s >= 0) & (j < hi[sc])
    prev_ff = torch.cat([raw.new_zeros(1, dtype=torch.bool), raw[:-1] == 0xFF])
    return inside & ~((raw == 0) & prev_ff & (j - 1 >= lo[sc]))


def _unstuff_plain(raw, lo, hi) -> Unstuffed:
    """K2u in torch ops (mask, cumsum, index); the bytes past the tail are
    zeros here."""
    keep = _keep_mask(raw, lo, hi)
    before = torch.cat([keep.new_zeros(1, dtype=torch.int64), torch.cumsum(keep, 0)])
    seg_off = torch.cat([before[lo], before[-1:]])
    kept = raw[keep]
    stream = torch.cat([kept, raw.new_zeros(raw.numel() + 8 - kept.numel())])
    return Unstuffed(stream, seg_off, _sub_base_plain(seg_off))


def _unstuff_tiled_plain(raw, lo, hi, tile_bytes: int) -> Unstuffed:
    """A model of K2u's schedule (csrc/unstuff.cu) on the host, for the
    tests; never a decode path. Tile by tile in the order of their ids:
    the segments that touch the tile (none cut it: every byte is inside
    the one before; else the listed bounds decide), the keep mask from the
    0x00 and 0xFF bytes and the byte before the tile, the tile's output
    offset from the look-back (the sum of its predecessors' counts: in tile
    order every predecessor has published its prefix), the compaction, the
    offsets of the segments that start in the tile, and from the last tile
    seg_off[n_segs] and the tail."""
    r = raw.cpu().numpy()
    lo_h, hi_h = lo.cpu().numpy(), hi.cpu().numpy()
    n_raw, n = r.shape[0], lo_h.shape[0]
    n_tiles = n_raw // tile_bytes + 1          # byte n_raw belongs to the last tile
    out = np.zeros(n_raw + 8, dtype=np.uint8)
    seg_off = np.zeros(n + 1, dtype=np.int64)
    offset = 0                                 # the look-back's result
    for tile in range(n_tiles):
        t0, t1 = tile * tile_bytes, (tile + 1) * tile_bytes
        j = np.arange(t0, t1)
        b = np.zeros(tile_bytes, dtype=np.uint8)
        b[: max(0, min(t1, n_raw) - t0)] = r[t0:t1]
        sb, se = np.searchsorted(lo_h, t0), np.searchsorted(lo_h, t1)
        starts = np.zeros(tile_bytes, dtype=bool)
        if sb == se and sb > 0 and hi_h[sb - 1] >= t1:
            inside = np.ones(tile_bytes, dtype=bool)
        else:
            inside = np.zeros(tile_bytes, dtype=bool)
            for s in range(max(sb - 1, 0), se):
                inside |= (j >= lo_h[s]) & (j < hi_h[s])
                if lo_h[s] >= t0:
                    starts[lo_h[s] - t0] = True
        prev = np.concatenate([[r[t0 - 1] if 0 < t0 <= n_raw else 0], b[:-1]])
        keep = inside & ~((b == 0) & (prev == 0xFF) & ~starts)
        before = np.concatenate([[0], np.cumsum(keep)])
        kept = b[keep]
        out[offset : offset + kept.shape[0]] = kept
        for s in range(sb, se):
            seg_off[s] = offset + before[lo_h[s] - t0]
        offset += kept.shape[0]
    seg_off[n] = offset                        # the tail stays zero
    seg_off_t = torch.from_numpy(seg_off)
    return Unstuffed(torch.from_numpy(out), seg_off_t, _sub_base_plain(seg_off_t))


def _check_unstuff_args(raw, lo, hi) -> None:
    dev = raw.device
    for t, dtype in ((raw, torch.uint8), (lo, torch.int64), (hi, torch.int64)):
        if t.dtype != dtype or not t.is_contiguous() or t.device != dev or t.dim() != 1:
            raise ValueError(f"unstuff_segments: expected contiguous 1-d {dtype} on {dev}")
    if lo.shape != hi.shape or raw.data_ptr() % 16:
        raise ValueError("unstuff_segments: bounds disagree, or the bytes are not 16-byte aligned")


def unstuff_segments(raw, lo, hi) -> Unstuffed:
    """The raw entropy-coded bytes of a group's scans (uint8) and the raw
    bounds of its restart segments (int64 [n_segs] each, ascending; the
    markers lie between them) -> the unstuffed stream and its offsets, as
    pack_scan builds them on the host, and K2's record layout. CPU tensors:
    the plain version. CUDA tensors: K2u, one call (a memset of its
    look-back scratch, the single pass, then a one-block kernel for
    sub_base); nothing is read back, so K2 can be queued straight after
    it."""
    dev = raw.device
    if dev.type == "cpu":
        return _unstuff_plain(raw, lo, hi)
    if not raw.is_cuda:
        raise ValueError(f"unstuff_segments: no kernel for {dev}")
    _check_unstuff_args(raw, lo, hi)
    n_raw, n = raw.numel(), lo.numel()
    out = torch.empty(n_raw + 8, dtype=torch.uint8, device=dev)
    seg_off = torch.empty(n + 1, dtype=torch.int64, device=dev)
    sub_base = torch.empty(n + 1, dtype=torch.int64, device=dev)
    # a look-back word a tile and the tile counter; the C function clears them
    scratch = torch.empty(n_raw // _build.library().jdtc_unstuff_tile_bytes() + 2,
                          dtype=torch.int64, device=dev)
    _build.launch("jdtc_unstuff", _build.ptr(raw), n_raw, _build.ptr(lo), _build.ptr(hi),
                  n, _build.ptr(scratch), _build.ptr(out), _build.ptr(seg_off),
                  _build.ptr(sub_base), SUB_BYTES, _build.stream_of(out))
    return Unstuffed(out, seg_off, sub_base)


def _unstuff_3pass(raw, lo, hi):
    """The earlier K2u design (three kernels), for measurement only: (out [n_raw + 8],
    seg_off) on the card, as unstuff_segments' first two. No decode path
    calls it."""
    _check_unstuff_args(raw, lo, hi)
    n_raw, n = raw.numel(), lo.numel()
    out = torch.empty(n_raw + 8, dtype=torch.uint8, device=raw.device)
    seg_off = torch.empty(n + 1, dtype=torch.int64, device=raw.device)
    block_sum = torch.empty((n_raw + 1 + 4095) // 4096, dtype=torch.int64, device=raw.device)
    _build.launch("jdtc_unstuff_3pass", _build.ptr(raw), n_raw, _build.ptr(lo), _build.ptr(hi),
                  n, _build.ptr(block_sum), _build.ptr(out), _build.ptr(seg_off),
                  _build.stream_of(out))
    return out, seg_off


class ScanPack(NamedTuple):
    """One image's scan, checked: its part of a K2u and a K2 launch."""

    key: tuple            # group key (convert.group_key)
    ri: int
    total_mcus: int
    units: np.ndarray     # int32 [P, 11]
    tables: np.ndarray    # int32 [n_specs, TABLE_INTS]
    raw: np.ndarray       # uint8: the scan's entropy-coded bytes, as in the file
    bounds: np.ndarray    # int64 [n_segs, 2]: each segment's [lo, hi) in `raw`


def prepare_scan(structure, scan, guard=check_scan) -> ScanPack:
    """Unit layout, tables and group key of a sequential scan, the route's
    guards (check_scan for PALLAS, check_scan_device for DEVICE), and the
    scan's raw bytes with its segments' bounds."""
    key, total_mcus, units, tabs = convert.group_key(structure.frame, scan)
    ri = guard(scan, total_mcus, units.shape[0])
    span = scan.span
    bounds = span.segment_bounds_flat().reshape(-1, 2) - span.start
    return ScanPack(key, ri, total_mcus, units, tabs,
                    structure.data[span.start : span.end], bounds)


def host_args(packs):
    """ScanPacks of one group (equal keys), one per image, as host arrays:
    (raws, lo, hi, seg_img, seg_idx, ri, total_mcus, units, tables). `raws`
    lists each image's raw bytes as they lie in its file (views, no copy);
    `lo` and `hi` bound the segments in those bytes laid back to back. The
    first three, on the device, are unstuff_segments' arguments, the rest
    decode_segments' after `stream` and `seg_off`."""
    if any(p.key != packs[0].key for p in packs):
        raise ValueError("host_args: scans of different groups")
    counts = [p.bounds.shape[0] for p in packs]
    byte0 = np.cumsum([0] + [p.raw.shape[0] for p in packs[:-1]])
    bounds = np.concatenate([p.bounds + b for p, b in zip(packs, byte0)])
    seg_img = np.repeat(np.arange(len(packs), dtype=np.int32), counts)
    seg_idx = np.concatenate([np.arange(c, dtype=np.int32) for c in counts])
    total_mcus, units, tables = convert.group_tables(
        [(p.total_mcus, p.units, p.tables) for p in packs])
    return ([p.raw for p in packs], np.ascontiguousarray(bounds[:, 0]),
            np.ascontiguousarray(bounds[:, 1]), seg_img, seg_idx, packs[0].ri,
            total_mcus, units, tables)


def _bytes_to_device(raws, device):
    """The byte arrays back to back in one uint8 tensor on `device`: one
    copy per array, straight from where it lies (the host concatenates
    nothing: eight 4K scans are 65 MB)."""
    with warnings.catch_warnings():
        # views of a file's bytes may be read-only; they are only read
        warnings.simplefilter("ignore", UserWarning)
        parts = [torch.from_numpy(r) for r in raws]
    if len(parts) == 1:
        return parts[0].to(device, non_blocking=True)
    out = torch.empty(sum(p.numel() for p in parts), dtype=torch.uint8, device=device)
    at = 0
    for p in parts:
        out[at : at + p.numel()].copy_(p, non_blocking=True)
        at += p.numel()
    return out


def to_device(args, device):
    """host_args' arrays as tensors on `device` (ri stays an int; the list
    of raw byte arrays becomes one tensor, see _bytes_to_device). The
    copies do not wait for the device: from pageable memory the source is
    staged before each call returns, so the host arrays may go at once."""
    return tuple(_bytes_to_device(a, device) if isinstance(a, list)
                 else torch.from_numpy(a).to(device, non_blocking=True)
                 if isinstance(a, np.ndarray) else a
                 for a in args)


def raw_bound(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """HostArrays.seg_bound from the segments' raw bounds: the raw lengths,
    which bound the unstuffed ones, back to back."""
    return np.concatenate([[0], np.cumsum(hi - lo)]).astype(np.int64)


def launch_args(packs, device):
    """(decode_segments' arguments before `planes` on `device`, their
    HostArrays) for ScanPacks of one group: each image's raw bytes copied
    to the device, then unstuff_segments there; nothing is read back. The
    HostArrays go to decode_segments as `host` (the raw lengths bound the
    segments', and K2u's sub_base is K2's layout); check_status takes the
    device seg_off, args[1]."""
    on_host = host_args(packs)
    raw, lo, hi, *rest = to_device(on_host, device)
    un = unstuff_segments(raw, lo, hi)
    _raws, lo_h, hi_h, seg_img, _seg_idx, _ri, total_mcus, units, _tables = on_host
    return ((un.stream, un.seg_off, *rest),
            HostArrays(raw_bound(lo_h, hi_h), seg_img, total_mcus, units, un.sub_base))


def decode_scan(structure, scan, planes) -> None:
    """One sequential scan -> `planes` (device tensors), raising on a bad
    or truncated stream: a group of one image."""
    args, host = launch_args([prepare_scan(structure, scan)], planes[0].device)
    check_status(decode_segments(*args, [planes], host=host), args[1])


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
        args, host = launch_args(packs, group_planes[0][0].device)
        launched.append((decode_segments(*args, group_planes, host=host), args[1]))
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
