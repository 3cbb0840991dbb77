"""The host half of the decoder: parse, entropy backends, the fused native
path and the pipelined host stages.

A JAX-free copy of jpeg_decoder_tpu/models/decoder.py (PlanePool through
host_decode_batch), which cannot be imported without JAX. The code is the
JAX package's; what differs is the entropy dispatch: PALLAS and DEVICE
decode on the torch device (ops/entropy_cuda.py and ops/entropy_device.py,
kernels K2u and K2) into device tensors.
"""

from __future__ import annotations

import numpy as np

from ..core import oracle
from ..core.types import (
    CoefficientPlanes,
    FrameHeader,
    JpegStructure,
)
from ..io.markers import Encoding
from ..io.parser import parse
from ..utils.config import DecodeConfig, EntropyBackend
from ..utils.logging import get_logger
from ..utils.metrics import GLOBAL_METRICS as metrics

log = get_logger("torch.host")


class PlanePool:
    """Reusable CoefficientPlanes, keyed by frame geometry.

    Fresh planes cost ~5 ms of page faults per 4K image (lazy-zeroed
    calloc touched during decode); reuse removes that in steady-state
    serving. Skipping the re-zero on reuse is only sound when the incoming
    stream provably overwrites EVERY plane block: a single-scan sequential
    frame with all components interleaved (the common baseline shape —
    interleaved wrap == plane width, so the MCU walk covers the whole
    padded grid). Everything else (progressive accumulation, partial or
    non-interleaved scans, which skip MCU-padding block columns) gets
    explicitly zeroed planes — otherwise a reused buffer could leak the
    PREVIOUS image's coefficients into this one's padding regions.
    """

    def __init__(self) -> None:
        import threading

        self._pool: dict[FrameHeader, list[CoefficientPlanes]] = {}
        self._lock = threading.Lock()

    @staticmethod
    def _full_coverage(structure: JpegStructure) -> bool:
        frame = structure.frame
        if frame.process == Encoding.PROGRESSIVE_DCT:
            return False
        if not all(scan.header.nics == frame.ncs for scan in structure.scans):
            return False
        if frame.ncs == 1:
            # A single-component scan is non-interleaved by definition: it
            # covers the component's own ceil(x/8) x ceil(y/8) grid, which
            # equals the (hsf,vsf)-padded plane grid only for 1x1 sampling.
            c = frame.components[0]
            return (
                c.blocks_x == -(-c.x // 8) and c.blocks_y == -(-c.y // 8)
            )
        return True

    def acquire(self, structure: JpegStructure) -> CoefficientPlanes:
        return self.acquire_for(
            structure.frame, self._full_coverage(structure)
        )

    def acquire_for(
        self, frame: FrameHeader, full_coverage: bool
    ) -> CoefficientPlanes:
        """Pool acquire with the coverage decision precomputed (the fused
        host path knows it from the header parse alone)."""
        with self._lock:
            free = self._pool.get(frame)
            planes = free.pop() if free else None
        if planes is None:
            return CoefficientPlanes(frame)
        if not full_coverage:
            for p in planes.planes:
                p.fill(0)
        return planes

    def release(self, planes: CoefficientPlanes) -> None:
        with self._lock:
            self._pool.setdefault(planes.frame, []).append(planes)


def _entropy_decode(
    structure: JpegStructure,
    cfg: DecodeConfig,
    planes: CoefficientPlanes | None = None,
    device=None,
):
    """Run every scan's entropy decode into coefficient planes on the chosen
    backend; returns (planes, qtid -> natural-order table). `planes` may be
    a reusable buffer from PlanePool (serving path). The PALLAS and DEVICE
    backends decode on `device` (default "cuda") into device tensors
    instead."""
    frame = structure.frame
    backend = cfg.entropy_backend

    if backend == EntropyBackend.NATIVE:
        from ..native import runtime as native_runtime

        if native_runtime.available():
            with metrics.timer("entropy_native"):
                return native_runtime.entropy_decode(structure, cfg, planes)
        log.warning("native runtime unavailable; falling back to NumPy")
        backend = EntropyBackend.NUMPY

    if backend == EntropyBackend.NUMPY:
        from ..core import entropy_np

        with metrics.timer("entropy_numpy"):
            return entropy_np.entropy_decode(structure, cfg, planes)

    if backend == EntropyBackend.DEVICE:
        from .. import convert
        from ..ops import entropy_device

        dev = convert.resolve_device("cuda" if device is None else device)
        with metrics.timer("entropy_device"):
            return entropy_device.entropy_decode(
                structure, cfg, convert.zero_planes(frame, dev)
            )

    if backend == EntropyBackend.PALLAS:
        from .. import convert
        from ..ops import entropy_cuda

        dev = convert.resolve_device("cuda" if device is None else device)
        with metrics.timer("entropy_pallas"):
            return entropy_cuda.entropy_decode(
                structure, cfg, convert.zero_planes(frame, dev)
            )

    from ..core.driver import run_scans

    if planes is None:
        planes = CoefficientPlanes(frame)

    def _decode_scan(s, scan, p):
        if frame.process == Encoding.PROGRESSIVE_DCT:
            oracle.decode_progressive_scan(s, scan, p)
        else:
            oracle.decode_sequential_scan(s, scan, p)

    with metrics.timer("entropy_oracle"):
        qts = run_scans(structure, planes, _decode_scan)
    return planes, qts


# ---------------------------------------------------------------------------
# Fused host path (header-prefix cache + one-call native prescan+decode)
# ---------------------------------------------------------------------------


def _tail_clean(data: np.ndarray, p: int) -> bool:
    """True iff the markers after the first scan's entropy span are only
    what parse() would record-or-ignore without affecting decode output:
    EOI / end of stream, fill bytes, stray non-FF bytes, TEM/SOI/RSTn,
    reserved 0x02-0xBF, and length-skipped APPn/COM/DAC/JPG/DHP/EXP
    segments (parse keeps APPn payloads in structure.app_segments, which
    DecodedImage does not carry). Anything structural — a second SOS, DHT,
    DQT, DRI, DNL, SOFn — means the stream is multi-scan or redefines
    state, and the caller falls back to the classic full parse."""
    from ..io.markers import Marker, is_app, is_rst

    n = data.shape[0]
    while p < n:
        if data[p] != 0xFF:
            p += 1
            continue
        while p + 1 < n and data[p + 1] == 0xFF:
            p += 1
        if p + 1 >= n:
            return True
        marker = int(data[p + 1])
        seg = p + 2
        if marker == Marker.EOI:
            return True
        if marker == Marker.SOI or is_rst(marker) or marker == Marker.TEM:
            p = seg
        elif 0x02 <= marker <= 0xBF:
            p = seg
        elif is_app(marker) or marker in (
            Marker.COM, Marker.DAC, Marker.DHP, Marker.EXP
        ) or (Marker.JPG0 <= marker <= Marker.JPG13):
            if seg + 2 > n:
                return False  # truncated length field: let parse() raise
            length = int(data[seg]) << 8 | int(data[seg + 1])
            if length < 2 or seg + length > n:
                return False  # malformed: classic path raises the error
            p = seg + length
        else:
            return False  # SOS/DHT/DQT/DRI/DNL/SOFn/JPG or unknown marker
    return True


def _fast_prepare(
    data: np.ndarray, cfg: DecodeConfig, pool: "PlanePool | None" = None
):
    """The SERIAL-PYTHON half of the fused host path: cached header parse,
    scan layout/LUT resolution, plane-pool acquire. Returns the prepared
    call bundle for _fast_execute, or None when the stream/config needs the
    classic parse+decode path (which handles everything). Split from the
    native half so host_decode_stream can run image k+1's Python under
    image k's GIL-released native decode."""
    if cfg.entropy_backend != EntropyBackend.NATIVE:
        return None
    from ..native import runtime as native_runtime

    if not native_runtime.available():
        return None
    from ..io import parser as parser_mod

    with metrics.timer("parse"):
        hp = parser_mod.parse_headers_cached(data, cfg)
    if hp is None:
        return None
    frame = hp.frame
    if hp.layout is None:
        # Lazily computed per cached header: unit params + decode LUTs
        # (flat_lut_for_spec content-caches the tables themselves).
        from ..core.types import Scan

        scan = Scan(
            header=hp.scan_header,
            span=None,  # layout never touches the span
            restart_interval=hp.restart_interval,
            dc_tables=hp.dc_tables,
            ac_tables=hp.ac_tables,
            quant_tables=hp.quant_tables,
        )
        structure_shim = _StructureShim(frame)
        hp.layout = native_runtime.scan_layout(structure_shim, scan)
    total_mcus, params, luts = hp.layout
    if pool is not None:
        planes = pool.acquire_for(frame, hp.full_coverage)
    else:
        planes = CoefficientPlanes(frame)
    allow_spec = (
        hp.restart_interval == 0
        and cfg.num_threads != 1
        and total_mcus * params.shape[0] >= 4096
    )
    return (data, cfg, pool, hp, frame, total_mcus, params, luts, planes,
            allow_spec)


def _fast_execute(prep):
    """The NATIVE half of the fused host path: one GIL-released
    prescan+decode call + the tail-marker check. Returns (frame, planes,
    qts) or None when the tail shows a multi-scan/DNL stream (caller falls
    back to the classic path)."""
    (data, cfg, pool, hp, frame, total_mcus, params, luts, planes,
     allow_spec) = prep
    from ..native import runtime as native_runtime

    with metrics.timer("entropy_native"):
        end, _n_segs = native_runtime.scan_decode_fused(
            data, hp.entropy_start, total_mcus, hp.restart_interval,
            params, luts, planes, cfg, allow_spec,
        )
    if not _tail_clean(data, end):
        # Multi-scan / DNL / trailing table stream (rare): the planes are
        # partially or fully written, but the classic path re-acquires and
        # zero-fills when coverage requires it, then re-decodes every scan.
        if pool is not None:
            pool.release(planes)
        return None
    return frame, planes, hp.qts


def _fast_host_decode(
    data: np.ndarray, cfg: DecodeConfig, pool: "PlanePool | None" = None
):
    """One-scan sequential native decode without building a JpegStructure:
    cached header parse + fused native prescan+decode + a tail-marker check.
    Returns (frame, planes, qts) or None when the stream/config needs the
    classic parse+decode path (which handles everything). Bit-identical to
    the classic path by construction — same LUTs, same segment rules, same
    native kernels (differential test: tests/test_fused_path.py)."""
    prep = _fast_prepare(data, cfg, pool)
    if prep is None:
        return None
    return _fast_execute(prep)


class _StructureShim:
    """Minimal stand-in for JpegStructure in scan_layout (which reads only
    .frame); the fused path has no full structure to give it."""

    __slots__ = ("frame",)

    def __init__(self, frame: FrameHeader):
        self.frame = frame


def host_decode(
    data: bytes | np.ndarray,
    cfg: DecodeConfig | None = None,
    pool: "PlanePool | None" = None,
    device=None,
) -> tuple[FrameHeader, CoefficientPlanes, dict[int, np.ndarray]]:
    """The HOST stage of the serving pipeline: parse + entropy decode only,
    returning (frame, coefficient planes, qtid -> natural-order tables) —
    exactly what the device stage consumes. Uses the fused native path when
    the stream is a one-scan sequential JPEG (the serving shape), else the
    classic parse + per-scan decode. `pool` enables plane reuse. Under the
    PALLAS and DEVICE backends the planes are tensors on `device` (default
    "cuda"), never the pool's."""
    cfg = cfg or DecodeConfig()
    from ..io import bitstream as bs

    data = bs.as_byte_array(data)
    fast = _fast_host_decode(data, cfg, pool)
    if fast is not None:
        return fast
    with metrics.timer("parse"):
        structure = parse(data, cfg)
    on_device = cfg.entropy_backend in (EntropyBackend.PALLAS, EntropyBackend.DEVICE)
    planes = pool.acquire(structure) if pool is not None and not on_device else None
    planes, qts = _entropy_decode(structure, cfg, planes, device)
    return structure.frame, planes, qts


def host_decode_stream(
    datas,
    cfg: DecodeConfig | None = None,
    pool: "PlanePool | None" = None,
):
    """Pipelined host stage over a stream of JPEGs: yields (frame, planes,
    qts) per input, in order — the sustained-serving form of host_decode.

    While image k's segment-parallel native decode runs in a worker thread
    (the ctypes call releases the GIL), the MAIN thread already runs image
    k+1's serial Python: the cached header parse, scan-layout/LUT
    resolution, plane-pool acquire, and ctypes marshalling. In steady
    state the serial Python disappears under the native stage, so the
    sustained per-image cost approaches the native decode alone (measured
    in bench.py as host_stream_ms; single-image latency stays host_ms).
    Results are identical to per-image host_decode calls
    (tests/test_pipeline.py::test_host_decode_stream_matches_host_decode).

    Inputs that the fused path cannot take (progressive, multi-scan, DNL,
    non-native backends) fall back to the classic host_decode inside the
    same worker, preserving order and the overlap of the NEXT image's
    prepare."""
    import concurrent.futures as cf

    from ..io import bitstream as bs

    cfg = cfg or DecodeConfig()

    def _classic(d):
        return host_decode(d, cfg, pool)

    def _finish(fut, d):
        res = fut.result()
        # _fast_execute returns None on an unclean tail (multi-scan/DNL):
        # re-decode through the classic path, like host_decode does.
        return res if res is not None else _classic(d)

    with cf.ThreadPoolExecutor(max_workers=1) as ex:
        pending = None  # (future, raw data for the tail fallback)
        for data_in in datas:
            data = bs.as_byte_array(data_in)
            prep = _fast_prepare(data, cfg, pool)  # overlaps pending decode
            if pending is not None:
                yield _finish(*pending)
            pending = (
                ex.submit(_fast_execute, prep)
                if prep is not None
                else ex.submit(_classic, data),
                data,
            )
        if pending is not None:
            yield _finish(*pending)


def host_decode_batch(
    datas,
    cfg: DecodeConfig | None = None,
    pool: "PlanePool | None" = None,
    max_workers: int = 0,
    device=None,
):
    """Concurrent host stage ACROSS images: yields (frame, planes, qts) per
    input, in input order, with up to `max_workers` images decoding at once.

    host_decode_stream pipelines the serial Python under the native decode —
    the right shape when each image's native stage already saturates the
    host's cores (sequential DRI streams, segment-parallel). When one image
    CANNOT fill the cores — progressive and restart-free scans are bit-serial
    chains, so a 4K progressive decode keeps only its scan-DAG's few
    independent chains busy (core/driver.run_scans_parallel) — the remaining
    throughput axis is across images: several images' serial chains run
    concurrently and fill the idle cores. Results are bit-identical to
    per-image host_decode (same code path; PlanePool is thread-safe;
    differential test tests/test_pipeline.py::test_host_decode_batch).

    The failure contract matches stream order: the first-in-order failing
    image's error is raised from its yield position; decodes already in
    flight for later images are completed and discarded. `device`: where
    the PALLAS and DEVICE backends decode (host_decode's).
    """
    import collections
    import concurrent.futures as cf
    import os

    from ..io import bitstream as bs

    cfg = cfg or DecodeConfig()
    if max_workers <= 0:
        max_workers = os.cpu_count() or 1

    it = iter(datas)
    with cf.ThreadPoolExecutor(max_workers=max_workers) as ex:
        window: collections.deque = collections.deque()

        def _submit_next() -> bool:
            try:
                d = next(it)
            except StopIteration:
                return False
            window.append(
                ex.submit(host_decode, bs.as_byte_array(d), cfg, pool, device)
            )
            return True

        # Keep one extra image queued beyond the worker count so a finishing
        # worker never idles waiting on the consumer.
        for _ in range(max_workers + 1):
            if not _submit_next():
                break
        while window:
            fut = window.popleft()
            res = fut.result()  # raises the first-in-order failure
            _submit_next()
            yield res
