"""The DEVICE entropy backend: every sequential scan decoded on the torch
device (counterpart of jpeg_decoder_tpu/ops/entropy_device.py).

The JAX backend runs one lane per restart segment in a lax.while_loop, one
symbol a step, and so takes every sequential stream: a restart-free scan of
any length is one lane, a segment of any length decodes, several scans
accumulate scan by scan. Only progressive frames are refused. Here the same
streams go through the PALLAS route's kernels with none of that route's
lane guards (entropy_cuda.check_scan_device): K2u (csrc/unstuff.cu) drops
the stuffing on the card, then K2 (csrc/entropy_decode.cu) cuts each
segment into subsequences of entropy_cuda.SUB_BYTES bytes, one thread each,
whatever the segment's length, and its scan and dc passes take a long
segment in chunks chained by look-back. A restart-free camera JPEG is one
segment of tens of thousands of subsequences: what the JAX lane decodes
serially, K2 decodes across the card. The launch counts under "K2d" (K2
on the DEVICE route), K2u's under its own name.

On CPU tensors (device="cpu") both run their plain versions:
entropy_cuda._decode_segments_plain is the JAX while_loop's algorithm, a
lane per segment in lockstep, one symbol a step.

Errors are the JAX backend's, in its order: JpegUnsupportedError on a
progressive frame; JpegEntropyError on an invalid code, a DC size over 15
or an AC coefficient past 63, checked before JpegTruncatedError, raised
when a segment consumed more than 8 * nbytes + 7 bits. Where the JAX
backend returns the planes as numpy arrays, this one returns the zeroed
device tensors it decoded into (ROADMAP §3), as the PALLAS route does.

A request (models/decoder._decode) first tries `decode_request`: the host
parses the header alone (io/parser.parse_headers_cached) and K2u finds the
segments on the card (entropy_cuda.find_segments), so the host never scans
the entropy bytes nor builds a JpegStructure. The unit layout and tables
depend on the header alone and are kept on the cached HeaderParse
(`header_layout`). The result stands only when K2u found the header's
segment count, the scan ended at EOI and K2's status is clean; anything
else (a second scan, DNL, a marker after the scan, a truncated stream, a
bad code) returns None and the caller decodes the request as above, which
raises what it always raised. A first scan that codes only some of the
frame's components needs another scan: its header sends it to the full
parse before any upload.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..core.driver import run_scans
from ..core.types import JpegStructure, Scan
from ..io.markers import Encoding, Marker
from ..utils.config import DecodeConfig
from ..utils.errors import JpegError, JpegUnsupportedError
from ..utils.metrics import span

from .. import convert
from . import entropy_cuda

#: The launch-count name of K2 on this route (_build.LAUNCHES).
COUNT_AS = "K2d"


def decode_scan_device(structure: JpegStructure, scan, planes, cfg: DecodeConfig | None = None,
                       records: dict | None = None) -> None:
    """One sequential scan -> `planes` (zeroed int16 [by, bx, 64] tensors,
    one per frame component, on one device; the scan writes the blocks it
    covers), raising on a bad or truncated stream. `records` as
    entropy_cuda.decode_segments takes it (card checks and timing);
    `cfg.collect_metrics` opens the spans' profiler ranges."""
    on = cfg is not None and cfg.collect_metrics
    with span("entropy_prepare", on):
        on_host = entropy_cuda.host_args(
            [entropy_cuda.prepare_scan(structure, scan, entropy_cuda.check_scan_device)])
    status, seg_off = entropy_cuda.decode_group(on_host, [planes], on, records=records,
                                                count_as=COUNT_AS)
    with span("entropy_check", on):
        entropy_cuda.check_status(status, seg_off)


def entropy_decode(structure: JpegStructure, cfg: DecodeConfig, planes=None, device="cuda"):
    """All scans -> (planes, qtid -> natural-order table), scan by scan
    (core/driver.run_scans). `planes`: the zeroed device tensors to decode
    into (convert.zero_planes); by default new ones on `device`."""
    frame = structure.frame
    if frame.process == Encoding.PROGRESSIVE_DCT:
        raise JpegUnsupportedError(
            "device entropy backend does not decode progressive scans; use"
            " the native or numpy backend"
        )
    if planes is None:
        planes = convert.zero_planes(frame, convert.resolve_device(device))
    qts = run_scans(structure, planes,
                    lambda s, scan, p: decode_scan_device(s, scan, p, cfg))
    return planes, qts


class HeaderLayout(NamedTuple):
    """What a one-scan request's DEVICE decode takes from its header alone:
    the segment count the header implies and decode_segments' host arrays
    after `stream` and `seg_off` (seg_img, seg_idx, ri, total_mcus, units,
    tables, as entropy_cuda.host_args gives them for a group of one)."""

    n_segs: int
    args: tuple


def header_layout(hp) -> HeaderLayout | None:
    """The HeaderParse's DEVICE layout, computed once per cached header (as
    the NATIVE path keeps `layout`); None where the header alone cannot
    give it (a JpegError from the tables or components, or a frame of no
    MCU: the caller then parses the whole stream, which raises in its own
    order) or where another scan must follow (a first scan that codes only
    some of the frame's components): the request then takes the full parse
    without the first try."""
    if hp.device_layout is None:
        scan = Scan(header=hp.scan_header, span=None, restart_interval=hp.restart_interval,
                    dc_tables=hp.dc_tables, ac_tables=hp.ac_tables,
                    quant_tables=hp.quant_tables)
        try:
            total_mcus, units, tables = convert.scan_tables(hp.frame, scan)
        except JpegError:
            total_mcus = 0
        if total_mcus < 1 or hp.scan_header.nics < len(hp.frame.components):
            hp.device_layout = False
        else:
            ri = hp.restart_interval or total_mcus
            n_segs = -(-total_mcus // ri)
            hp.device_layout = HeaderLayout(n_segs, (
                np.zeros(n_segs, dtype=np.int32), np.arange(n_segs, dtype=np.int32), ri,
                *convert.group_tables([(total_mcus, units, tables)])))
    return hp.device_layout or None


def decode_request(data: np.ndarray, hp, layout: HeaderLayout, cfg: DecodeConfig, device):
    """One request's scan from its header parse alone -> (planes, qtid ->
    natural-order table), or None when the result does not stand (see the
    module's doc). Uploads the bytes from the first entropy byte to the end
    of the file (one copy, span "entropy_upload"), then in "entropy_launch":
    K2u finds the segments (find_segments), one small read-back (the
    offsets, the segments found, where the scan ended), and K2
    (entropy_cuda.decode_segments) with its records sized exactly by those
    offsets."""
    on = cfg.collect_metrics
    n = layout.n_segs
    with span("entropy_device", on):
        with span("entropy_prepare", on):
            raw = data[hp.entropy_start:]
            if not 2 <= raw.shape[0] <= entropy_cuda.FIND_MAX_BYTES:
                return None
        with span("entropy_upload", on):
            raw_dev = entropy_cuda.to_device(([raw],), device)[0]
        with span("entropy_launch", on):
            un, ends = entropy_cuda.find_segments(raw_dev, n)
            planes = convert.zero_planes(hp.frame, device)
            ends = ends.cpu().numpy()
            found, end = int(ends[n + 1]), hp.entropy_start + int(ends[n + 2])
            # a segment of 256 MB or more: K2's wrapper refuses it by its raw
            # length, which only the full parse gives
            if (found != n or end + 2 > data.shape[0] or data[end] != 0xFF
                    or data[end + 1] != Marker.EOI or end - hp.entropy_start >= 1 << 28):
                return None
            seg_img, _idx, _ri, total_mcus, units, _tables = layout.args
            try:
                status = entropy_cuda.decode_segments(
                    un.stream, un.seg_off, *entropy_cuda.to_device(layout.args, device),
                    [planes], host=entropy_cuda.HostArrays(ends[: n + 1], seg_img, total_mcus,
                                                           units, un.sub_base),
                    count_as=COUNT_AS)
            except ValueError:  # a geometry K2 refuses: the full parse raises in its order
                return None
        with span("entropy_check", on):
            try:
                entropy_cuda.check_status(status, ends[: n + 1])
            except JpegError:
                return None
    return planes, hp.qts
