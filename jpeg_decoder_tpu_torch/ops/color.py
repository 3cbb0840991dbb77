"""Chroma upsample + colour conversion + RGB store (counterpart of
jpeg_decoder_tpu/ops/color.py, nearest-neighbour upsampling, 1 and 3
components).

The plain PyTorch functions are device-agnostic and keep the JAX package's
arithmetic: the reference's (uint32)(i * float32(sf / max_sf)) index rule
(core/numerics._nn_index_f32, computed on the host), YCbCr -> RGB in plain
float32 (proven byte-exact against the reference's float64 chain for every
input, ops/color.py ycbcr_to_rgb), and the truncating (REFERENCE) or
rounding (CORRECT) saturated store.

`planes_to_rgb` is the wrapper the decoder calls: for CPU tensors it runs
the plain versions, for CUDA tensors it launches kernel K3 (csrc/color.cu).
Planes may carry a leading batch dimension ([B, rows, stride], the batch
path's stacked images); one launch then makes [B, h, w, 3].
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.numerics import _nn_index_f32
from ..utils.config import Quirks

from .. import _build

F32 = torch.float32

# BT.601 constants exactly as spelled in the reference (colour_conversion.c:71-74),
# rounded to float32 (exact as Python floats, so a float32 op keeps them).
_K_RV = float(np.float32(1.402))
_K_GU = float(np.float32(0.34414))
_K_GV = float(np.float32(0.71414))
_K_BU = float(np.float32(1.772))


def nn_upsample(plane: torch.Tensor, out_h: int, out_w: int, hsf: int,
                vsf: int, max_hsf: int, max_vsf: int) -> torch.Tensor:
    """Nearest-neighbour upsample of one component plane [..., rows, stride]
    to [..., out_h, out_w] with the reference's (uint32)(i *
    float32(sf/max_sf)) index rule."""
    rows = _nn_index_f32(out_h, np.float32(vsf) / np.float32(max_vsf))
    cols = _nn_index_f32(out_w, np.float32(hsf) / np.float32(max_hsf))
    rows_t = torch.from_numpy(rows).to(plane.device)
    cols_t = torch.from_numpy(cols).to(plane.device)
    return plane[..., rows_t[:, None], cols_t[None, :]]


def _store_rgb(r, g, b, quirks: Quirks) -> torch.Tensor:
    """Float channels -> uint8 RGB: truncate (REFERENCE) or round half up
    (CORRECT), then saturate to [0, 255] before the uint8 conversion."""
    chans = []
    for ch in (r, g, b):
        if quirks == Quirks.REFERENCE:
            q = torch.trunc(ch)
        else:
            q = torch.floor(ch + 0.5)
        chans.append(torch.clamp(q, 0.0, 255.0).to(torch.uint8))
    return torch.stack(chans, dim=-1)


def _ycbcr_channels_f32(y8, cb8, cr8):
    y = y8.to(F32)
    cb = cb8.to(F32) - 128.0
    cr = cr8.to(F32) - 128.0
    r = y + cr * _K_RV
    g = y - cb * _K_GU - cr * _K_GV
    b = y + cb * _K_BU
    return r, g, b


def ycbcr_to_rgb(y8, cb8, cr8, quirks: Quirks = Quirks.REFERENCE) -> torch.Tensor:
    """[H, W] uint8 Y/Cb/Cr (already upsampled) -> [H, W, 3] uint8 RGB
    (ycbcr_rgb, colour_conversion.c:30-83), plain float32."""
    return _store_rgb(*_ycbcr_channels_f32(y8, cb8, cr8), quirks)


def gray_to_rgb(y8: torch.Tensor) -> torch.Tensor:
    """[H, W] uint8 -> [H, W, 3] replicate (y_rgb, colour_conversion.c:5-28)."""
    return y8[..., None].expand(*y8.shape, 3).contiguous()


def _gray_source(plane: torch.Tensor, h: int, w: int, quirks: Quirks):
    """The [..., h, w] gray samples. REFERENCE indexes the padded plane at
    the IMAGE width stride (colour_conversion.c:20), which shears widths
    that are not a multiple of 8; CORRECT crops."""
    lead = plane.shape[:-2]
    if quirks == Quirks.REFERENCE:
        return plane.reshape(*lead, -1)[..., : h * w].reshape(*lead, h, w)
    return plane[..., :h, :w]


def _planes_to_rgb_plain(planes, h, w, factors, quirks):
    if len(planes) == 1:
        return gray_to_rgb(_gray_source(planes[0], h, w, quirks))
    mh = max(f[0] for f in factors)
    mv = max(f[1] for f in factors)
    y, cb, cr = (
        nn_upsample(p, h, w, fh, fv, mh, mv) for p, (fh, fv) in zip(planes, factors)
    )
    return ycbcr_to_rgb(y, cb, cr, quirks)


def planes_to_rgb(planes, h: int, w: int, factors, quirks: Quirks) -> torch.Tensor:
    """uint8 pixel planes [rows, stride], or [B, rows, stride] for a batch
    (1 or 3 components, sampling `factors` = ((hsf, vsf), ...)) -> [h, w, 3]
    or [B, h, w, 3] uint8 RGB: the device stage after the IDCT. CPU
    tensors: the plain versions. CUDA: K3, one launch for the batch (one
    per 65,535 images, _build.image_chunks)."""
    if len(planes) not in (1, 3):
        raise ValueError(f"planes_to_rgb: {len(planes)} components")
    lead = planes[0].shape[:-2]
    if len(lead) > 1 or any(p.dim() != planes[0].dim() or p.shape[:-2] != lead
                            for p in planes):
        raise ValueError("planes_to_rgb: planes must be [rows, stride] or [B, rows, stride], one B")
    dev = planes[0].device
    if dev.type == "cpu":
        return _planes_to_rgb_plain(planes, h, w, factors, quirks)
    if not planes[0].is_cuda:
        raise ValueError(f"planes_to_rgb: no kernel for {dev}")
    for p in planes:
        if p.dtype != torch.uint8 or not p.is_contiguous() or p.device != dev:
            raise ValueError("planes_to_rgb: planes must be contiguous uint8 on one device")
    n_images = lead[0] if lead else 1
    mh = max(f[0] for f in factors)
    mv = max(f[1] for f in factors)
    strides, img_strides, hr, vr = [0, 0, 0], [0, 0, 0], [0.0] * 3, [0.0] * 3
    for c, (p, (fh, fv)) in enumerate(zip(planes, factors)):
        rows, cols = p.shape[-2:]
        hr[c] = float(np.float32(fh) / np.float32(mh))
        vr[c] = float(np.float32(fv) / np.float32(mv))
        strides[c] = cols
        img_strides[c] = rows * cols
        # Memory safety: the kernel gathers without bounds checks, so the
        # last row and column it will index must lie inside every image's
        # plane.
        if len(planes) == 3 and h and w and (
            int(_nn_index_f32(h, np.float32(vr[c]))[-1]) >= rows
            or int(_nn_index_f32(w, np.float32(hr[c]))[-1]) >= cols
        ):
            raise ValueError("planes_to_rgb: plane smaller than its upsampled extent")
    if len(planes) == 1:
        rows, cols = planes[0].shape[-2:]
        if rows < h or cols < w:
            raise ValueError("planes_to_rgb: gray plane smaller than the image")
        strides[0] = w if quirks == Quirks.REFERENCE else cols
    out = torch.empty((*lead, h, w, 3), dtype=torch.uint8, device=dev)
    if h * w:
        padded = [*planes, *[None] * (3 - len(planes))]
        for _first, count, ptrs in _build.image_chunks(n_images, *padded, out):
            _build.launch(
                "jdtc_color", *ptrs[:3], count, *img_strides, len(planes), h, w,
                *strides, *hr, *vr, int(quirks != Quirks.REFERENCE),
                ptrs[3], _build.stream_of(out),
            )
    return out
