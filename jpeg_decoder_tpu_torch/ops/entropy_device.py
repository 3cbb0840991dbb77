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
"""

from __future__ import annotations

from ..core.driver import run_scans
from ..core.types import JpegStructure
from ..io.markers import Encoding
from ..utils.config import DecodeConfig
from ..utils.errors import JpegUnsupportedError
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
