"""The decode pipeline on a torch device: parse -> entropy decode -> pixel
stage (counterpart of jpeg_decoder_tpu/models/decoder.py).

  host:    marker walk + table parse              (shared io/parser.py)
  entropy: NATIVE/NUMPY/ORACLE on the host, or PALLAS on the device
           (models/host.py; ops/entropy_cuda.py, kernel K2)
  device:  one PixelStage per (geometry, tables, config): dequant + IDCT +
           block scatter (ops/idct.py, K0), then chroma upsample + colour
           conversion (ops/color.py, K3)

Host-decoded planes go to the device in one copy per image; PALLAS planes
are born there. RGB and the pixel planes come back in one copy each.

The slice covers 1 and 3 components, 8- and 12-bit samples, both Quirks,
nearest-neighbour upsampling, the EXACT IDCT and full-size output; the rest
raises JpegUnsupportedError naming the ROADMAP item that ports it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from jpeg_decoder_tpu.core.types import DecodedImage, FrameHeader, JpegStructure
from jpeg_decoder_tpu.io.parser import parse
from jpeg_decoder_tpu.utils.config import DecodeConfig, IdctPrecision
from jpeg_decoder_tpu.utils.errors import JpegFormatError, JpegUnsupportedError
from jpeg_decoder_tpu.utils.metrics import GLOBAL_METRICS as metrics

from .. import convert
from ..ops import color as color_ops
from ..ops import idct as idct_ops
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


def _check_config(cfg: DecodeConfig) -> None:
    """Reject what the port does not run yet, before any decode work."""
    if cfg.idct_precision != IdctPrecision.EXACT:
        raise JpegUnsupportedError(
            "FLOAT32 IDCT is not ported yet (ROADMAP: K1 with FLOAT32)"
        )
    if cfg.upsample != "nn":
        raise JpegUnsupportedError(
            "fancy upsampling is not ported yet (ROADMAP: fancy upsampling,"
            " YCCK and CMYK, and scale < 8)"
        )
    if cfg.scale != 8:
        raise JpegUnsupportedError(
            "scaled decode is not ported yet (ROADMAP: fancy upsampling,"
            " YCCK and CMYK, and scale < 8)"
        )
    if not cfg.use_device:
        raise JpegUnsupportedError(
            "use_device=False (the all-host pixel path) is the JAX package's;"
            " the port runs the pixel stage on its torch device"
        )


def _check_frame(frame: FrameHeader) -> None:
    if frame.ncs not in (1, 3):
        raise JpegUnsupportedError(
            f"{frame.ncs}-component frames are not ported yet (ROADMAP:"
            " fancy upsampling, YCCK and CMYK, and scale < 8)"
        )


class PixelStage(nn.Module):
    """Coefficient planes -> (RGB uint8 [H, W, 3], pixel planes) for one
    (geometry, tables, config) key: the counterpart of build_stage_raw."""

    def __init__(self, key, device):
        super().__init__()
        frame, qt_by_comp, precision, quirks, upsample, scale = key
        _check_frame(frame)
        self.frame = frame
        self.quirks = quirks
        self.bits12 = frame.precision == 12
        self.factors = tuple((c.hsf, c.vsf) for c in frame.components)
        for ci, q in enumerate(qt_by_comp):
            self.register_buffer(
                f"qt{ci}",
                convert.quant_table_to_device(np.frombuffer(q, np.uint16), device),
            )

    def forward(self, *coeff_planes: torch.Tensor):
        pixel = [
            idct_ops.idct_plane(p, getattr(self, f"qt{ci}"), self.bits12)
            for ci, p in enumerate(coeff_planes)
        ]
        rgb = color_ops.planes_to_rgb(
            pixel, self.frame.height, self.frame.width, self.factors,
            self.quirks,
        )
        return rgb, pixel


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


def _pixel_stage(frame: FrameHeader, planes, qts, cfg: DecodeConfig,
                 device) -> DecodedImage:
    """Coefficient planes (host CoefficientPlanes or device tensors) ->
    DecodedImage with host RGB and pixel planes."""
    stage = device_stage_for(frame, qts, cfg, device)
    with metrics.timer("device_stage", items=frame.width * frame.height):
        if not isinstance(planes, list):
            planes = convert.planes_to_device(planes, device)
        rgb_dev, planes_dev = stage(*planes)
        rgb = rgb_dev.cpu().numpy()
    host_planes = [p.cpu().numpy() for p in planes_dev]
    return DecodedImage(frame=frame, planes=host_planes, rgb=rgb)


def decode_structure(structure: JpegStructure, cfg: DecodeConfig | None = None,
                     device="cuda") -> DecodedImage:
    """Decode an already-parsed stream."""
    cfg = cfg or DecodeConfig()
    _check_config(cfg)
    device = convert.resolve_device(device)
    _check_frame(structure.frame)
    planes, qts = host._entropy_decode(structure, cfg, device=device)
    return _pixel_stage(structure.frame, planes, qts, cfg, device)


def decode(data: bytes | np.ndarray, cfg: DecodeConfig | None = None,
           device="cuda") -> DecodedImage:
    """Decode one JPEG byte stream end to end on `device`."""
    cfg = cfg or DecodeConfig()
    _check_config(cfg)
    device = convert.resolve_device(device)
    from jpeg_decoder_tpu.io import bitstream as bs

    data_arr = bs.as_byte_array(data)
    fast = host._fast_host_decode(data_arr, cfg)
    if fast is not None:
        frame, planes, qts = fast
        return _pixel_stage(frame, planes, qts, cfg, device)
    with metrics.timer("parse"):
        structure = parse(data_arr, cfg)
    return decode_structure(structure, cfg, device)


def decode_rgb(data: bytes | np.ndarray, cfg: DecodeConfig | None = None,
               device="cuda") -> np.ndarray:
    """Decode straight to an [H, W, 3] uint8 RGB array."""
    return decode(data, cfg, device).rgb


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
        _check_config(self.cfg)
        self.device = convert.resolve_device(device)

    def parse(self, data) -> JpegStructure:
        return parse(data, self.cfg)

    def decode(self, data) -> DecodedImage:
        return decode(data, self.cfg, self.device)

    def decode_rgb(self, data) -> np.ndarray:
        return decode_rgb(data, self.cfg, self.device)
