"""The decode pipeline on a torch device: parse -> entropy decode -> pixel
stage (counterpart of jpeg_decoder_tpu/models/decoder.py).

  host:    marker walk + table parse              (io/parser.py; a DEVICE
           request parses its header alone, parse_headers_cached, and K2u
           finds the scan's segments on the card: _device_request)
  entropy: NATIVE/NUMPY/ORACLE on the host, or PALLAS or DEVICE on the
           device (models/host.py; ops/entropy_cuda.py and
           ops/entropy_device.py, kernels K2u and K2)
  device:  one PixelStage per (geometry, tables, config). A 3-component
           nearest-neighbour frame whose samples stay in their MCUs runs as
           one step (ops/pixel.py; K03 for EXACT, K13 for FLOAT32);
           otherwise dequant + IDCT + block scatter per component
           (ops/idct.py; K0 for EXACT, K1 for FLOAT32; at scale < 8 one K5
           launch for all components), then chroma upsample + colour
           conversion (ops/color.py; K3 for
           nearest-neighbour, named K3c on 4 components, K3f for fancy
           upsampling)
  host:    with use_device=False, the pixel stage on the host instead
           (core/oracle.py: the EXACT IDCT and colour conversion in NumPy)

Host-decoded planes go to the device in one copy per image; PALLAS and
DEVICE planes are born there. `decode` reads back the RGB and the pixel
planes, one copy each, into pageable memory; `decode_rgb` asks the stage
for RGB alone, and reads it back into pinned host memory on a CUDA device
while convert.to_host's budget allows. The batch serving path
(parallel/batch.py) runs the same PixelStage over stacked [B, by, bx, 64]
planes and asks for RGB alone.

The port covers what the JAX package's pixel stage takes: 1, 3 and 4
components (YCbCr, YCCK, raw Adobe CMYK), 8- and 12-bit samples, both
Quirks, nearest-neighbour and fancy upsampling, the EXACT and FLOAT32 IDCT
contracts, scale 1, 2, 4 and 8, and use_device=False; and every entropy
backend of the JAX package, each on the streams that package's backend
takes (PALLAS keeps its lane guards; DEVICE takes every sequential scan).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from ..core import numerics, oracle
from ..core.types import CoefficientPlanes, DecodedImage, FrameHeader, JpegStructure
from ..io.parser import parse
from ..utils.config import DecodeConfig, EntropyBackend, IdctPrecision, Quirks
from ..utils.errors import JpegConfigError, JpegFormatError
from ..utils.metrics import GLOBAL_METRICS as metrics
from ..utils.metrics import count, span

from .. import convert
from ..ops import color as color_ops
from ..ops import idct as idct_ops
from ..ops import pixel as pixel_ops
from . import host


def qt_by_comp_bytes(frame: FrameHeader, qtid_tables) -> tuple[bytes, ...]:
    """Per-component quant-table bytes: the table half of the stage key."""
    return tuple(
        np.ascontiguousarray(qtid_tables[c.qtid], dtype=np.uint16).tobytes()
        for c in frame.components
    )


def _stage_key(frame: FrameHeader, qt_by_comp: tuple[bytes, ...], cfg: DecodeConfig):
    return (
        frame,
        qt_by_comp,
        cfg.idct_precision,
        cfg.quirks,
        cfg.upsample,
        cfg.scale,
    )


class PixelStage(nn.Module):
    """Coefficient planes -> (RGB uint8 [h, w, 3], pixel planes) for one
    (geometry, tables, config) key: the counterpart of build_stage_raw.
    Stacked planes [B, by, bx, 64] give [B, h, w, 3] and [B, rows, stride]
    planes (the counterpart of parallel/batch._batched_stage's vmap). At
    scale k < 8, h and w are ceil(height * k / 8) and ceil(width * k / 8)
    and a plane is [by*k, bx*k].

    The route is fixed by the key. `fused`: a 3-component frame with
    nearest-neighbour upsampling at full size that ops/pixel.fits (its
    planes on the MCU grid, every sample inside its pixel's MCU) runs
    ops/pixel.pixel_exact (EXACT) or pixel_float (FLOAT32), one K03 or K13
    launch on the card. Any other runs one IDCT launch per component (K0 or
    K1), or at scale < 8 one K5 launch for all components under either
    contract, and one colour launch: K3 (nearest-neighbour; K3c on 4
    components) or K3f (fancy). `want_planes=False` gives None for the
    planes (K03 and K13 then store none)."""

    def __init__(self, key, device):
        super().__init__()
        frame, qt_by_comp, precision, quirks, upsample, scale = key
        if frame.ncs not in (1, 3, 4):
            raise ValueError(f"no color transform for {frame.ncs} components")
        self.frame = frame
        self.precision = precision
        self.quirks = quirks
        self.upsample = upsample
        self.scale = scale
        self.h = -(-frame.height * scale // 8)
        self.w = -(-frame.width * scale // 8)
        self.bits12 = frame.precision == 12
        self.factors = tuple((c.hsf, c.vsf) for c in frame.components)
        # build_stage_raw: raw CMYK only for APP14 transform 0 under CORRECT
        self.raw_cmyk = (frame.ncs == 4 and quirks != Quirks.REFERENCE
                         and frame.adobe_transform == 0)
        self.fused = (frame.ncs == 3 and upsample == "nn" and scale == 8
                      and pixel_ops.fits(frame))
        # K5 folds its tables on the host (ops/idct.folded_band)
        self.qt_host = [np.frombuffer(q, np.uint16) for q in qt_by_comp]
        for ci, q in enumerate(qt_by_comp):
            self.register_buffer(
                f"qt{ci}",
                convert.quant_table_to_device(np.frombuffer(q, np.uint16), device),
            )

    def forward(self, *coeff_planes: torch.Tensor, want_planes: bool = True):
        qts = [getattr(self, f"qt{ci}") for ci in range(len(coeff_planes))]
        if self.fused:
            fused = (pixel_ops.pixel_exact if self.precision == IdctPrecision.EXACT
                     else pixel_ops.pixel_float)
            return fused(coeff_planes, qts, self.frame, self.quirks, want_planes)
        if self.scale < 8:
            pixel = idct_ops.idct_planes_scaled(list(coeff_planes), self.qt_host, self.scale,
                                                self.bits12)
        else:
            pixel = [idct_ops.idct_plane(p, qt, self.bits12, self.precision)
                     for p, qt in zip(coeff_planes, qts)]
        rgb = color_ops.planes_to_rgb(
            pixel, self.h, self.w, self.factors, self.quirks, self.upsample,
            exact=self.precision == IdctPrecision.EXACT, raw_cmyk=self.raw_cmyk,
            # the REFERENCE gray shear replicates a full-size store only
            gray_shear=self.quirks == Quirks.REFERENCE and self.scale == 8,
        )
        return rgb, (pixel if want_planes else None)


@functools.lru_cache(maxsize=256)
def _build_pixel_stage(key, device: torch.device) -> PixelStage:
    return PixelStage(key, device)


def device_stage_for(frame: FrameHeader, qtid_tables, cfg: DecodeConfig,
                     device) -> PixelStage:
    """Resolve per-component quant tables and return the cached stage."""
    for c in frame.components:
        if c.qtid not in qtid_tables:
            raise JpegFormatError(
                f"component {c.id} references undefined quant table {c.qtid}"
            )
    key = _stage_key(frame, qt_by_comp_bytes(frame, qtid_tables), cfg)
    return _build_pixel_stage(key, torch.device(device))


def _host_fancy_convert(frame: FrameHeader, pixel_planes, quirks):
    """The host's fancy colour path for use_device=False (the JAX package's
    models/decoder._host_fancy_convert): the triangular 2x passes in NumPy
    (oracle.fancy_upsample_np), nearest-neighbour for any ratio that
    remains, then the float64 channel conversions."""
    h, w = frame.height, frame.width
    mh, mv = frame.max_hsf, frame.max_vsf
    chans = []
    for p, c in zip(pixel_planes, frame.components):
        x = oracle.fancy_upsample_np(p, c.hsf, c.vsf, mh, mv)
        _, _, eh, ev = color_ops.fancy_passes(c.hsf, c.vsf, mh, mv)
        if eh == mh and ev == mv:
            chans.append(x[:h, :w])
        else:
            rows = np.asarray(numerics._nn_index_f32(h, np.float32(ev) / np.float32(mv)))
            cols = np.asarray(numerics._nn_index_f32(w, np.float32(eh) / np.float32(mh)))
            chans.append(x[rows[:, None], cols[None, :]])
    if frame.ncs == 3:
        return numerics.ycbcr_channels_to_rgb(*chans, quirks)
    if quirks != Quirks.REFERENCE and frame.adobe_transform == 0:
        return numerics.cmyk_channels_to_rgb(*chans, quirks)
    return numerics.ycck_channels_to_rgb(*chans, quirks)


def _host_pixel_stage(frame: FrameHeader, planes, qts, cfg: DecodeConfig) -> DecodedImage:
    """use_device=False: the pixel stage on the host (core/oracle.py), as
    the JAX package runs it. PALLAS and DEVICE planes come back from the
    device first."""
    if cfg.scale != 8:
        raise JpegConfigError(
            "scaled decode (scale != 8) runs on the device pixel path; "
            "set use_device=True (under JAX_PLATFORMS=cpu it executes on "
            "the host via XLA)"
        )
    if isinstance(planes, list):
        planes = convert.planes_from(frame, [p.cpu().numpy() for p in planes])
    with metrics.timer("pixel_host"):
        pixel_planes = oracle.pixels_from_coeffs(frame, planes, qts)
        if cfg.upsample == "fancy" and frame.ncs in (3, 4):
            rgb = _host_fancy_convert(frame, pixel_planes, cfg.quirks)
        else:
            rgb = oracle.color_convert(frame, pixel_planes, cfg.quirks)
    return DecodedImage(frame=frame, planes=pixel_planes, rgb=rgb)


def _pixel_stage(frame: FrameHeader, planes: CoefficientPlanes | list, qts,
                 cfg: DecodeConfig, device, want_planes: bool = True) -> DecodedImage:
    """Coefficient planes (host CoefficientPlanes or device tensors) ->
    DecodedImage with host RGB and pixel planes; with `want_planes` false
    the stage makes none and only the RGB comes back (planes empty), into
    pinned memory where convert.to_host's budget allows. With planes, every
    array comes back pageable, as the caller of `decode` may keep many.
    `copy_out` counts `readback_mb`, the MB read back, and
    `readback_pinned_pct`, 100 where the RGB landed in pinned memory, else 0."""
    if not cfg.use_device:
        return _host_pixel_stage(frame, planes, qts, cfg)
    on = cfg.collect_metrics
    with span("stage_lookup", on):
        stage = device_stage_for(frame, qts, cfg, device)
    with span("device_stage", on, items=frame.width * frame.height):
        if not isinstance(planes, list):
            planes = convert.planes_to_device(planes, device)
        rgb_dev, planes_dev = stage(*planes, want_planes=want_planes)
        with span("copy_out", on):
            planes_dev = planes_dev or []
            rgb, pinned = convert.to_host(rgb_dev, pin=not want_planes)
            host_planes = [p.cpu().numpy() for p in planes_dev]
            count("readback_mb", sum(t.nbytes for t in [rgb_dev, *planes_dev]) / 1e6)
            count("readback_pinned_pct", 100.0 if pinned else 0.0)
    return DecodedImage(frame=frame, planes=host_planes, rgb=rgb)


def _decode_structure(structure: JpegStructure, cfg: DecodeConfig, device,
                      want_planes: bool) -> DecodedImage:
    planes, qts = host._entropy_decode(structure, cfg, device=device)
    return _pixel_stage(structure.frame, planes, qts, cfg, device, want_planes)


def decode_structure(structure: JpegStructure, cfg: DecodeConfig | None = None,
                     device="cuda") -> DecodedImage:
    """Decode an already-parsed stream."""
    return _decode_structure(structure, cfg or DecodeConfig(),
                             convert.resolve_device(device), True)


def _device_request(data: np.ndarray, cfg: DecodeConfig, device):
    """A DEVICE request from its header alone (ops/entropy_device.
    decode_request): the header-prefix cache's parse and the layout kept on
    it, in the `parse` span, then K2u finds the segments on the card.
    Returns (frame, planes, qts), or None where the caller must parse the
    whole stream (no one-scan sequential header, or a result that does not
    stand)."""
    from ..io.parser import parse_headers_cached
    from ..ops import entropy_device

    with span("parse", cfg.collect_metrics):
        hp = parse_headers_cached(data, cfg)
        layout = None if hp is None else entropy_device.header_layout(hp)
    if layout is None:
        return None
    got = entropy_device.decode_request(data, hp, layout, cfg, device)
    return None if got is None else (hp.frame, *got)


def _decode(data: bytes | np.ndarray, cfg: DecodeConfig, device,
            want_planes: bool) -> DecodedImage:
    """One request. NATIVE tries the fused host path first, DEVICE the
    header-only route (_device_request; the `card_span_pct` counter: 100
    where it stood, 0 where the request took the full parse); then the full
    parse and the backend's decode."""
    from ..io import bitstream as bs

    data_arr = bs.as_byte_array(data)
    fast = host._fast_host_decode(data_arr, cfg)
    if fast is None and cfg.entropy_backend == EntropyBackend.DEVICE:
        try:
            fast = _device_request(data_arr, cfg, device)
        finally:  # a header that raises counts too: the full parse raises it
            count("card_span_pct", 0.0 if fast is None else 100.0)
    if fast is not None:
        frame, planes, qts = fast
        return _pixel_stage(frame, planes, qts, cfg, device, want_planes)
    with span("parse", cfg.collect_metrics):
        structure = parse(data_arr, cfg)
    return _decode_structure(structure, cfg, device, want_planes)


def decode(data: bytes | np.ndarray, cfg: DecodeConfig | None = None,
           device="cuda") -> DecodedImage:
    """Decode one JPEG byte stream end to end on `device`."""
    return _decode(data, cfg or DecodeConfig(), convert.resolve_device(device), True)


def decode_rgb(data: bytes | np.ndarray, cfg: DecodeConfig | None = None,
               device="cuda") -> np.ndarray:
    """Decode straight to an [H, W, 3] uint8 RGB array. The pixel stage
    makes no sample planes, and only the RGB is read back. From a CUDA
    device the array lives in pinned host memory (torch's caching host
    allocator): the caller owns it, and the allocator takes the block back
    when the caller drops the array. Past convert.PINNED_BUDGET_BYTES held
    at once (a gigapixel frame, or many outputs kept) it is pageable."""
    return _decode(data, cfg or DecodeConfig(), convert.resolve_device(device), False).rgb


def decode_file(path, cfg: DecodeConfig | None = None, device="cuda") -> DecodedImage:
    """Decode a JPEG file through an np.memmap view (zero-copy input, as
    jpeg_decoder_tpu.models.decoder.decode_file)."""
    try:
        mm = np.memmap(path, dtype=np.uint8, mode="r")
    except (ValueError, OSError) as e:
        raise JpegFormatError(f"cannot map {path}: {e}") from e
    try:
        return decode(mm, cfg, device)
    finally:
        del mm


class JpegDecoder:
    """Reusable decoder handle: holds config and device, and shares the
    pixel-stage cache across calls (same-geometry JPEGs reuse one stage)."""

    def __init__(self, cfg: DecodeConfig | None = None, device="cuda"):
        self.cfg = cfg or DecodeConfig()
        self.device = convert.resolve_device(device)

    def parse(self, data) -> JpegStructure:
        return parse(data, self.cfg)

    def decode(self, data) -> DecodedImage:
        return decode(data, self.cfg, self.device)

    def decode_rgb(self, data) -> np.ndarray:
        return decode_rgb(data, self.cfg, self.device)
