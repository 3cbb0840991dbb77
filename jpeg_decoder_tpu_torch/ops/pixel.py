"""The pixel stage of a 3-component frame as one step: dequant + IDCT +
block scatter of every component, nearest-neighbour upsample, YCbCr -> RGB
and the RGB store (counterpart of jpeg_decoder_tpu/models/decoder.py
build_stage_raw, :72-165), under either IDCT contract.

`pixel_exact` (EXACT) and `pixel_float` (FLOAT32) are the wrappers the
decoder calls. For CPU tensors they run the plain composition,
`_pixel_exact_plain` / `_pixel_float_plain`: ops/idct.idct_exact or
idct_float and blocks_to_plane per component, then
ops/color._planes_to_rgb_plain, which is what the pixel stage ran before.
For CUDA tensors they launch kernel K03 (csrc/pixel_exact.cu) or K13
(csrc/pixel_float.cu), one launch for a batch, in place of K0 or K1 per
component and K3.

Both kernels give each block of threads one strip of G MCUs of one MCU row
and build the strip's RGB from the strip's coefficient blocks alone. That
rests on a property of nearest-neighbour upsampling: every output pixel's
sample of every component lies in the pixel's own MCU. The reference's
float32 index rule could break it where a ratio sf / max_sf rounds down, so
`tile_local` checks it for the geometry, and `fits` is the route's guard:
a frame that fails it keeps the K0 + K3 (or K1 + K3) launches.
`_pixel_tiled_plain` runs the kernels' schedule on the CPU, strip by strip,
and raises if a pixel would read outside its strip.

Striped and streamed decode (parallel/stripes.py) pass `stripes`
(ops/color.Stripes): `frame` is then the chunk's, or the whole padded
frame's, and the index rule runs on the padded frame's rows, each source
made local to its stripe (ops/color.nn_rows, the kernels' colour::nn_row).
The guard is taken on the padded frame's rows up to the launch's end, not
on the chunk's own.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.numerics import _nn_index_f32
from ..core.types import FrameHeader
from ..utils.config import IdctPrecision, Quirks

from .. import _build
from . import color as color_ops
from . import idct as idct_ops

EXACT = IdctPrecision.EXACT
FLOAT32 = IdctPrecision.FLOAT32

#: Coefficient blocks a strip aims at: G = STRIP_BLOCKS // (blocks a MCU).
#: K03: G = 4 at 4:2:0 (a 64x16-pixel tile, 192 threads), 8 at 4:4:4; the
#: sweep of G (benchmarks/pixel_sweep.py, PERF.md) put G = 2 and 4 at 4:2:0
#: within 2% of each other and 4-6% ahead of 8. K13: G = 8 at 4:2:0 (192
#: threads), 3% ahead of 16 and 10% ahead of 4 in its sweep.
STRIP_BLOCKS = {EXACT: 24, FLOAT32: 48}


def _factors(frame: FrameHeader):
    return tuple((c.hsf, c.vsf) for c in frame.components)


def default_strip(factors, precision: IdctPrecision = EXACT) -> int:
    """G, the MCUs of one strip of K03 (EXACT) or K13 (FLOAT32), for
    sampling `factors`."""
    return max(1, STRIP_BLOCKS[precision] // sum(fh * fv for fh, fv in factors))


def _ratio(sf: int, max_sf: int) -> np.float32:
    return np.float32(sf) / np.float32(max_sf)


@functools.lru_cache(maxsize=256)
def tile_local(factors, h: int, w: int) -> bool:
    """True when every output pixel (i < h, j < w) finds its sample of every
    component inside its own MCU under the reference's index rule
    (uint32)(i * float32(sf / max_sf)): for each component, row and column,
    source index // (8 * sf) == output index // (8 * max_sf)."""
    mh = max(f[0] for f in factors)
    mv = max(f[1] for f in factors)
    for fh, fv in factors:
        for n, sf, msf in ((h, fv, mv), (w, fh, mh)):
            src = _nn_index_f32(n, _ratio(sf, msf))
            if not np.array_equal(src // (8 * sf), np.arange(n) // (8 * msf)):
                return False
    return True


def fits(frame: FrameHeader) -> bool:
    """K03's and K13's guard for a frame: three components whose planes lie
    on the MCU grid (blocks_x = mcus_x * hsf, blocks_y = mcus_y * vsf) and a
    tile-local geometry."""
    if frame.ncs != 3:
        return False
    if any(c.blocks_x != frame.mcus_x * c.hsf or c.blocks_y != frame.mcus_y * c.vsf
           for c in frame.components):
        return False
    return tile_local(_factors(frame), frame.height, frame.width)


def _pixel_plain(coeff_planes, qts, frame: FrameHeader, quirks: Quirks,
                 want_planes: bool = True, precision: IdctPrecision = EXACT,
                 stripes: color_ops.Stripes | None = None):
    """The plain composition, on any device: per component the IDCT of
    `precision` and blocks_to_plane, then the colour stage (with the stripe
    rule under `stripes`). Planes [..., by, bx, 64] -> (RGB [..., h, w, 3],
    pixel planes [..., by*8, bx*8] or None)."""
    bits12 = frame.precision == 12
    pixel = []
    for p, qt in zip(coeff_planes, qts):
        *lead, by, bx, _ = p.shape
        rows = int(np.prod(lead, dtype=np.int64)) * by
        pix = idct_ops._PLAIN[precision](p.reshape(-1, 64), qt, bits12)
        pixel.append(idct_ops.blocks_to_plane(pix, rows, bx).reshape(*lead, by * 8, bx * 8))
    rgb = color_ops._planes_to_rgb_plain(pixel, frame.height, frame.width, _factors(frame),
                                         quirks, stripes=stripes)
    return rgb, (pixel if want_planes else None)


def _pixel_exact_plain(coeff_planes, qts, frame: FrameHeader, quirks: Quirks,
                       want_planes: bool = True, stripes: color_ops.Stripes | None = None):
    """K03's plain version: _pixel_plain under EXACT."""
    return _pixel_plain(coeff_planes, qts, frame, quirks, want_planes, EXACT, stripes)


def _pixel_float_plain(coeff_planes, qts, frame: FrameHeader, quirks: Quirks,
                       want_planes: bool = True, stripes: color_ops.Stripes | None = None):
    """K13's plain version: _pixel_plain under FLOAT32."""
    return _pixel_plain(coeff_planes, qts, frame, quirks, want_planes, FLOAT32, stripes)


def _pixel_tiled_plain(coeff_planes, qts, frame: FrameHeader, quirks: Quirks,
                       want_planes: bool = True, strip: int | None = None,
                       precision: IdctPrecision = EXACT,
                       stripes: color_ops.Stripes | None = None):
    """K03's and K13's schedule on the CPU: for each image, MCU row and
    strip of `strip` MCUs (the last one ragged), the IDCT of `precision` of
    that strip's blocks alone into one tile per component, then the RGB of
    the strip's pixels inside the image from those tiles alone, by the index
    rule on the global row and column (under `stripes`, the stripe rule's
    rows). Raises RuntimeError if a pixel's sample lies outside its strip's
    tile. The result of _pixel_plain (under FLOAT32 up to the order in
    which one product over other row counts may sum: within 1)."""
    factors = _factors(frame)
    strip = strip or default_strip(factors, precision)
    h, w = frame.height, frame.width
    mh = max(f[0] for f in factors)
    mv = max(f[1] for f in factors)
    mcus_x, mcus_y = frame.mcus_x, frame.mcus_y
    bits12 = frame.precision == 12
    lead = coeff_planes[0].shape[:-3]
    flat = [p.reshape(-1, *p.shape[-3:]) for p in coeff_planes]
    n_img = flat[0].shape[0]
    dev = flat[0].device
    rgb = torch.zeros((n_img, h, w, 3), dtype=torch.uint8, device=dev)
    planes = [torch.zeros((n_img, p.shape[1] * 8, p.shape[2] * 8), dtype=torch.uint8,
                          device=dev) for p in flat]
    src_rows = [color_ops.nn_rows(h, fv, mv, stripes) for _fh, fv in factors]
    src_cols = [_nn_index_f32(w, _ratio(fh, mh)) for fh, _fv in factors]
    for b in range(n_img):
        for mr in range(mcus_y):
            for m0 in range(0, mcus_x, strip):
                gm = min(strip, mcus_x - m0)
                tiles = []
                for c, (fh, fv) in enumerate(factors):
                    blocks = flat[c][b, mr * fv:(mr + 1) * fv, m0 * fh:(m0 + gm) * fh]
                    pix = idct_ops._PLAIN[precision](blocks.reshape(-1, 64), qts[c], bits12)
                    tile = idct_ops.blocks_to_plane(pix, fv, gm * fh)
                    tiles.append(tile)
                    planes[c][b, mr * fv * 8:(mr + 1) * fv * 8,
                              m0 * fh * 8:(m0 + gm) * fh * 8] = tile
                i0, j0 = mr * 8 * mv, m0 * 8 * mh
                i1, j1 = min(i0 + 8 * mv, h), min(j0 + gm * 8 * mh, w)
                if i0 >= i1 or j0 >= j1:
                    continue
                chans = []
                for c, (fh, fv) in enumerate(factors):
                    sr = src_rows[c][i0:i1] - mr * 8 * fv
                    sc = src_cols[c][j0:j1] - m0 * 8 * fh
                    if (sr.min() < 0 or sr.max() >= tiles[c].shape[0]
                            or sc.min() < 0 or sc.max() >= tiles[c].shape[1]):
                        raise RuntimeError(
                            f"component {c}: a sample of MCU row {mr}, strip at MCU {m0}"
                            " lies outside the strip")
                    sr_t = torch.from_numpy(sr).to(dev)
                    sc_t = torch.from_numpy(sc).to(dev)
                    chans.append(tiles[c][sr_t[:, None], sc_t[None, :]])
                rgb[b, i0:i1, j0:j1] = color_ops.ycbcr_to_rgb(*chans, quirks)
    rgb = rgb.reshape(*lead, h, w, 3)
    if not want_planes:
        return rgb, None
    return rgb, [p.reshape(*lead, *p.shape[1:]) for p in planes]


@functools.lru_cache(maxsize=256)
def _geometry(frame: FrameHeader):
    """(the planes' [by, bx, 64] shapes, the uint8 planes' shapes, the
    kernel's geometry arguments from h to mcus_y) of a frame that fits, or
    None: computed once a frame, the wrapper's host time being a share of
    the kernel's."""
    if not fits(frame):
        return None
    factors = _factors(frame)
    mh = max(f[0] for f in factors)
    mv = max(f[1] for f in factors)
    mx, my = frame.mcus_x, frame.mcus_y
    args = (frame.height, frame.width, *(fh for fh, _ in factors), *(fv for _, fv in factors),
            *(float(_ratio(fh, mh)) for fh, _ in factors),
            *(float(_ratio(fv, mv)) for _, fv in factors), mx, my)
    return (tuple((my * fv, mx * fh, 64) for fh, fv in factors),
            tuple((my * fv * 8, mx * fh * 8) for fh, fv in factors), args)


def _launch(entry: str, coeff_planes, qts, frame: FrameHeader, quirks: Quirks,
            want_planes: bool, strip: int | None, precision: IdctPrecision,
            stripes: color_ops.Stripes | None = None):
    """Check the arguments and launch K03 or K13 (`entry`), one launch per
    65,535 images (_build.image_chunks); under `stripes`, one image, the
    launch counted as K6n."""
    name = entry[len("jdtc_"):]
    if len(coeff_planes) != 3 or len(qts) != 3:
        raise ValueError(f"{name}: three components")
    dev = coeff_planes[0].device
    if not coeff_planes[0].is_cuda:
        raise ValueError(f"{name}: no kernel for {dev}")
    geometry = _geometry(frame)
    if geometry is None or (stripes is not None and not tile_local(
            _factors(frame), stripes.row0 + frame.height, frame.width)):
        raise ValueError(f"{name}: the frame's geometry is not tile-local")
    shapes, plane_shapes, args = geometry
    lead = coeff_planes[0].shape[:-3]
    if len(lead) > 1 or (stripes is not None and lead):
        raise ValueError(f"{name}: planes must be [by, bx, 64] or [B, by, bx, 64]"
                         " ([by, bx, 64] under stripes)")
    for p, q, shape in zip(coeff_planes, qts, shapes):
        if (p.shape[-3:] != shape or p.shape[:-3] != lead or p.dtype != torch.int16
                or not p.is_contiguous() or p.device != dev or p.data_ptr() % 16):
            raise ValueError(f"{name}: coefficients must be contiguous int16"
                             " [..., mcus_y * vsf, mcus_x * hsf, 64], 16-byte aligned,"
                             " on one device")
        if (q.dtype != torch.int32 or q.numel() != 64 or not q.is_contiguous()
                or q.device != dev or q.data_ptr() % 16):
            raise ValueError(f"{name}: tables must be contiguous int32 [64],"
                             " 16-byte aligned, on the planes' device")
    n_images = lead[0] if lead else 1
    rgb = torch.empty((*lead, frame.height, frame.width, 3), dtype=torch.uint8, device=dev)
    planes = [torch.empty((*lead, *s), dtype=torch.uint8, device=dev)
              for s in plane_shapes] if want_planes else None
    if rgb.numel():
        kmat = (_build.ptr(idct_ops.idct_matrix_on(dev)),) if precision == FLOAT32 else ()
        strip = strip or default_strip(_factors(frame), precision)
        row0, stripe_h = stripes if stripes is not None else (0, 0)
        launch = (_build.launch if stripes is None
                  else functools.partial(_build.launch_as, "K6n"))
        for _first, count, ptrs in _build.image_chunks(
                n_images, *coeff_planes, rgb, *(planes or [None] * 3)):
            launch(
                entry, *ptrs[:3], *map(_build.ptr, qts), *kmat, count, *args, strip,
                int(frame.precision == 12), int(quirks != Quirks.REFERENCE), row0, stripe_h,
                *ptrs[3:], _build.stream_of(rgb),
            )
    return rgb, planes


def pixel_exact(coeff_planes, qts, frame: FrameHeader, quirks: Quirks,
                want_planes: bool = True, strip: int | None = None,
                stripes: color_ops.Stripes | None = None):
    """int16 zigzag coefficient planes [by, bx, 64] or [B, by, bx, 64], one
    per component of a 3-component frame, and their int32 natural-order
    quantisation tables [64] -> (uint8 RGB [..., h, w, 3], uint8 pixel
    planes [..., by*8, bx*8] per component, or None unless `want_planes`),
    under the EXACT contract; `stripes`: a chunk or a padded frame of
    striped decode (module docstring).

    CPU tensors: the plain composition. CUDA tensors: K03, one launch for
    the batch, `strip` MCUs a block of threads (default_strip)."""
    if len(coeff_planes) == 3 and coeff_planes[0].device.type == "cpu":
        return _pixel_exact_plain(coeff_planes, qts, frame, quirks, want_planes, stripes)
    return _launch("jdtc_pixel_exact", coeff_planes, qts, frame, quirks, want_planes, strip,
                   EXACT, stripes)


def pixel_float(coeff_planes, qts, frame: FrameHeader, quirks: Quirks,
                want_planes: bool = True, strip: int | None = None,
                stripes: color_ops.Stripes | None = None):
    """pixel_exact under the FLOAT32 contract: the IDCT is ops/idct.idct_float
    (a 64-term float32 dot product a pixel).

    CPU tensors: the plain composition. CUDA tensors: K13, one launch for
    the batch, `strip` MCUs a strip (default_strip)."""
    if len(coeff_planes) == 3 and coeff_planes[0].device.type == "cpu":
        return _pixel_float_plain(coeff_planes, qts, frame, quirks, want_planes, stripes)
    return _launch("jdtc_pixel_float", coeff_planes, qts, frame, quirks, want_planes, strip,
                   FLOAT32, stripes)
