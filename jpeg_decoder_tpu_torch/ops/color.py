"""Chroma upsample + colour conversion + RGB store (counterpart of
jpeg_decoder_tpu/ops/color.py): nearest-neighbour and fancy (libjpeg's
triangular 2x) upsampling; gray, YCbCr, YCCK and raw Adobe CMYK.

The plain PyTorch functions are device-agnostic and keep the JAX package's
arithmetic: the reference's (uint32)(i * float32(sf / max_sf)) index rule
(core/numerics._nn_index_f32, computed on the host), YCbCr -> RGB in plain
float32 (proven byte-exact against the reference's float64 chain for every
input, ops/color.py ycbcr_to_rgb), YCCK in the reference's float64 chain
(EXACT; core/numerics.ycck_channels_to_rgb, which the JAX package emulates
with double-float pairs) or in float32 (FLOAT32), CMYK in int32, and the
truncating (REFERENCE) or rounding (CORRECT) saturated store. Every
division divides by a tensor, never by a Python number: PyTorch may turn
`x / 255.0` into a product by the reciprocal, which rounds otherwise.

`planes_to_rgb` is the wrapper the decoder calls: for CPU tensors it runs
the plain versions; for CUDA tensors it launches kernel K3 (csrc/color.cu
jdtc_color: 1, 3 or 4 components, nearest-neighbour; named K3c on 4) or
K3f (the same file's jdtc_fancy: fancy, 3 or 4 components). Planes may
carry a leading batch dimension ([B, rows, stride], the batch path's
stacked images); one launch then makes [B, h, w, 3].

Striped and streamed decode (parallel/stripes.py) pass `stripes`: the
launch covers a chunk of a padded frame, or the whole of it, cut in stripes
of MCU rows, and the nearest-neighbour rows follow the JAX package's stripe
rule (`nn_rows`); under fancy upsampling only the components that
`fancy_ok` takes get the triangular passes. A rank of a mesh's stripe axis
decodes one stripe and passes `halos`, the rows above and below its planes
that its neighbours sent: the launch is K6h (the same file's
jdtc_fancy_halo), whose vertical pass reads them at the planes' edges.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..core.numerics import _nn_index_f32
from ..utils.metrics import count
from ..utils.config import Quirks

from .. import _build

F32 = torch.float32
F64 = torch.float64

# BT.601 constants exactly as spelled in the reference (colour_conversion.c:71-74),
# rounded to float32 (exact as Python floats, so a float32 op keeps them).
_K_RV = float(np.float32(1.402))
_K_GU = float(np.float32(0.34414))
_K_GV = float(np.float32(0.71414))
_K_BU = float(np.float32(1.772))


class Stripes(NamedTuple):
    """A launch of striped or streamed decode: `row0`, the padded frame's
    row of the launch's first output row, a multiple of `height`, the output
    rows of a stripe (a whole number of MCU rows)."""

    row0: int
    height: int


def nn_rows(n: int, sf: int, max_sf: int, stripes: Stripes | None = None) -> np.ndarray:
    """The plane row each of a launch's n output rows samples under the
    reference's (uint32)(i * float32(sf/max_sf)) rule. With `stripes`, the
    JAX package's stripe rule (jpeg_decoder_tpu/parallel/stripes.py
    make_chunk_stage :354-380, make_shard_fn :160-163): the rule runs on the
    padded frame's row, its source is made local to that row's stripe of
    height * sf / max_sf plane rows and clamped into it, then placed among
    the launch's stripes (the kernels' colour::nn_row)."""
    ratio = np.float32(sf) / np.float32(max_sf)
    if stripes is None:
        return _nn_index_f32(n, ratio)
    row0, height = stripes
    src = _nn_index_f32(row0 + n, ratio)[row0:]
    local = height * sf // max_sf
    st = np.arange(row0, row0 + n, dtype=np.int64) // height
    return np.clip(src - st * local, 0, local - 1) + (st - row0 // height) * local


def fancy_ok(hsf: int, vsf: int, max_hsf: int, max_vsf: int) -> bool:
    """Whether striped decode gives a component the triangular passes
    (jpeg_decoder_tpu/parallel/stripes.py:139-144): at least one 2x pass,
    and the full factors after them. Every other component takes the
    nearest-neighbour rule at its own ratios, where whole-frame decode runs
    the passes it can and the rule after them (fancy_upsample)."""
    return ((hsf == max_hsf or 2 * hsf == max_hsf)
            and (vsf == max_vsf or 2 * vsf == max_vsf)
            and (2 * hsf == max_hsf or 2 * vsf == max_vsf))


def takes_halo(hsf: int, vsf: int, max_hsf: int, max_vsf: int) -> bool:
    """Whether a stripe's component reads a halo row under fancy
    upsampling: fancy_ok and a vertical 2x pass."""
    return fancy_ok(hsf, vsf, max_hsf, max_vsf) and 2 * vsf == max_vsf


def nn_upsample(plane: torch.Tensor, out_h: int, out_w: int, hsf: int,
                vsf: int, max_hsf: int, max_vsf: int,
                stripes: Stripes | None = None) -> torch.Tensor:
    """Nearest-neighbour upsample of one component plane [..., rows, stride]
    to [..., out_h, out_w] with the reference's (uint32)(i *
    float32(sf/max_sf)) index rule; rows by the stripe rule with
    `stripes` (nn_rows)."""
    rows = nn_rows(out_h, vsf, max_vsf, stripes)
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


def _gray_source(plane: torch.Tensor, h: int, w: int, shear: bool):
    """The [..., h, w] gray samples. With `shear` (REFERENCE at full size)
    the padded plane is indexed at the IMAGE width stride
    (colour_conversion.c:20), which shears widths that are not a multiple
    of 8; otherwise (CORRECT, or a scaled decode) it is cropped."""
    lead = plane.shape[:-2]
    if shear:
        return plane.reshape(*lead, -1)[..., : h * w].reshape(*lead, h, w)
    return plane[..., :h, :w]


# ---------------------------------------------------------------------------
# Fancy upsampling and the 4-component transforms
# ---------------------------------------------------------------------------


def fancy_h2x(xf: torch.Tensor) -> torch.Tensor:
    """Horizontal 2x triangular upsample of float32 [..., rows, cols]
    (libjpeg's h2v1 rule: the nearer-left phase gets the +1 rounding, the
    nearer-right +2), the edge columns replicated."""
    left = torch.cat([xf[..., :1], xf[..., :-1]], dim=-1)
    right = torch.cat([xf[..., 1:], xf[..., -1:]], dim=-1)
    even = (3.0 * xf + left + 1.0) * 0.25
    odd = (3.0 * xf + right + 2.0) * 0.25
    return torch.stack([even, odd], dim=-1).reshape(*xf.shape[:-1], -1)


def fancy_v2x(xf: torch.Tensor) -> torch.Tensor:
    """Vertical 2x triangular upsample (the same rule over rows)."""
    up = torch.cat([xf[..., :1, :], xf[..., :-1, :]], dim=-2)
    down = torch.cat([xf[..., 1:, :], xf[..., -1:, :]], dim=-2)
    even = (3.0 * xf + up + 1.0) * 0.25
    odd = (3.0 * xf + down + 2.0) * 0.25
    return torch.stack([even, odd], dim=-2).reshape(*xf.shape[:-2], -1, xf.shape[-1])


def fancy_passes(hsf: int, vsf: int, max_hsf: int, max_vsf: int):
    """(horizontal 2x pass, vertical 2x pass, the factors eh and ev after
    them): a pass runs where the component has half the maximum factor."""
    h2, v2 = 2 * hsf == max_hsf, 2 * vsf == max_vsf
    return h2, v2, (2 * hsf if h2 else hsf), (2 * vsf if v2 else vsf)


def fancy_upsample(plane: torch.Tensor, out_h: int, out_w: int, hsf: int, vsf: int,
                   max_hsf: int, max_vsf: int) -> torch.Tensor:
    """Triangular upsample of a uint8 plane [..., rows, stride] for 2x
    factors, nearest-neighbour for the ratios that remain, to [..., out_h,
    out_w] uint8. The edges replicated are the padded plane's. Every float32
    intermediate is exact (integer sums below 2^14 times 1/4 or 1/16); an
    all-255 neighbourhood gives 256, hence the clamp."""
    x = plane.to(F32)
    h2, v2, eh, ev = fancy_passes(hsf, vsf, max_hsf, max_vsf)
    if h2:
        x = fancy_h2x(x)
    if v2:
        x = fancy_v2x(x)
    x = torch.clamp(torch.floor(x), 0.0, 255.0).to(torch.uint8)
    if eh == max_hsf and ev == max_vsf:
        return x[..., :out_h, :out_w]
    return nn_upsample(x, out_h, out_w, eh, ev, max_hsf, max_vsf)


def cmyk_to_rgb(c8, m8, y8, k8) -> torch.Tensor:
    """Raw Adobe CMYK (APP14 transform 0, stored inverted): R = (c * k +
    127) // 255 in int32, and so for G and B."""
    k = k8.to(torch.int32)
    return torch.stack([((ch.to(torch.int32) * k + 127) // 255).to(torch.uint8)
                        for ch in (c8, m8, y8)], dim=-1)


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d, a division (by a tensor of d: a Python divisor may become a
    product by its reciprocal)."""
    return x / torch.full_like(x, d)


def ycck_channels(y8, cb8, cr8, k8, exact: bool):
    """YCCK's float32 R, G, B before the store: C/M/Y by the YCbCr chain,
    then 255 * (1 - X/255) * (K/255). EXACT: the reference's float64
    statements each stored to float32 (core/numerics.ycck_channels_to_rgb,
    colour_conversion.c:137-141). FLOAT32: the JAX package's float32 order
    (ops/color.py ycck_to_rgb)."""
    if exact:
        y = y8.to(F64)
        cb = cb8.to(F64) - 128.0
        cr = cr8.to(F64) - 128.0
        k = k8.to(F64)
        cmy = [(y + 1.402 * cr).to(F32).to(F64),
               (y - 0.34414 * cb - 0.71414 * cr).to(F32).to(F64),
               (y + 1.772 * cb).to(F32).to(F64)]
    else:
        cmy = _ycbcr_channels_f32(y8, cb8, cr8)
        k = k8.to(F32)
    kk = _div(k, 255.0)
    return [(255.0 * (1.0 - _div(x, 255.0)) * kk).to(F32) for x in cmy]


def ycck_to_rgb(y8, cb8, cr8, k8, exact: bool = True,
                quirks: Quirks = Quirks.REFERENCE) -> torch.Tensor:
    """4-component YCCK composite (yccb_rgb, colour_conversion.c:85-162) of
    full-resolution uint8 channels -> uint8 RGB [..., 3]."""
    return _store_rgb(*ycck_channels(y8, cb8, cr8, k8, exact), quirks)


#: The colour transform of a frame, as the kernels number it.
YCBCR, YCCK_EXACT, YCCK_FLOAT, CMYK, GRAY = range(5)


def colour_mode(n_comps: int, exact: bool, raw_cmyk: bool) -> int:
    """The transform build_stage_raw applies: YCbCr for 3 components; for 4,
    raw CMYK where the frame asks for it (`raw_cmyk`: an APP14 transform of
    0 under CORRECT), else YCCK under the IDCT's contract."""
    if n_comps == 3:
        return YCBCR
    if raw_cmyk:
        return CMYK
    return YCCK_EXACT if exact else YCCK_FLOAT


def _convert(chans, mode: int, quirks: Quirks) -> torch.Tensor:
    if mode == YCBCR:
        return ycbcr_to_rgb(*chans, quirks)
    if mode == CMYK:
        return cmyk_to_rgb(*chans)
    return ycck_to_rgb(*chans, mode == YCCK_EXACT, quirks)


def _planes_to_rgb_plain(planes, h, w, factors, quirks, upsample: str = "nn",
                         exact: bool = True, raw_cmyk: bool = False,
                         gray_shear: bool | None = None, stripes: Stripes | None = None,
                         halos=None):
    """The colour stage of build_stage_raw in plain PyTorch (the plain
    version of K3 and K3f). `gray_shear` (default: REFERENCE quirks)
    indexes a gray plane at the image width. With `stripes`, the stripe
    rule: nearest-neighbour rows by nn_rows, and under fancy upsampling the
    passes (over the whole padded plane, which on one card is the stripes'
    halo exchange) only where fancy_ok; with `halos` (one stripe), the
    passes over each plane between its halo rows."""
    if len(planes) == 1:
        shear = quirks == Quirks.REFERENCE if gray_shear is None else gray_shear
        return gray_to_rgb(_gray_source(planes[0], h, w, shear))
    mh = max(f[0] for f in factors)
    mv = max(f[1] for f in factors)
    chans = []
    for ci, (p, (fh, fv)) in enumerate(zip(planes, factors)):
        if upsample == "nn" or (stripes is not None and not fancy_ok(fh, fv, mh, mv)):
            chans.append(nn_upsample(p, h, w, fh, fv, mh, mv, stripes))
        elif halos is not None and halos[ci] is not None:
            top, bottom = halos[ci]
            ext = torch.cat([top.reshape(1, -1), p, bottom.reshape(1, -1)])
            chans.append(fancy_upsample(ext, 2 * ext.shape[0], w, fh, fv, mh, mv)[2:2 + h])
        else:
            chans.append(fancy_upsample(p, h, w, fh, fv, mh, mv))
    return _convert(chans, colour_mode(len(planes), exact, raw_cmyk), quirks)


def planes_to_rgb(planes, h: int, w: int, factors, quirks: Quirks, upsample: str = "nn",
                  exact: bool = True, raw_cmyk: bool = False,
                  gray_shear: bool | None = None,
                  stripes: Stripes | None = None, halos=None) -> torch.Tensor:
    """uint8 pixel planes [rows, stride], or [B, rows, stride] for a batch
    (1, 3 or 4 components, sampling `factors` = ((hsf, vsf), ...)) -> [h, w,
    3] or [B, h, w, 3] uint8 RGB: the device stage after the IDCT.
    `upsample` "nn" or "fancy"; `exact` the IDCT's contract, which picks
    YCCK's arithmetic; `raw_cmyk` a 4-component frame's raw CMYK transform;
    `gray_shear` as in _planes_to_rgb_plain. CPU tensors: the plain
    versions. CUDA: K3 (1, 3 or 4 components, nn) or K3f (fancy, 3 or 4
    components), one launch for the batch (one per 65,535 images,
    _build.image_chunks). A gray frame ignores `upsample`. `stripes`: a
    chunk or a whole padded frame of striped decode, one image (the
    launches count as K6n, or K6f under fancy upsampling). `halos`, with
    `stripes` and fancy upsampling: one stripe of a mesh, per component
    the (top, bottom) rows [1, stride] its vertical pass reads past the
    plane's edges, given exactly where takes_halo holds (None elsewhere):
    one K6h launch."""
    if len(planes) not in (1, 3, 4):
        raise ValueError(f"planes_to_rgb: {len(planes)} components")
    lead = planes[0].shape[:-2]
    if len(lead) > 1 or any(p.dim() != planes[0].dim() or p.shape[:-2] != lead
                            for p in planes):
        raise ValueError("planes_to_rgb: planes must be [rows, stride] or [B, rows, stride], one B")
    dev = planes[0].device
    if stripes is not None and lead:
        raise ValueError("planes_to_rgb: striped decode takes one image")
    if halos is not None:
        mh = max(f[0] for f in factors)
        mv = max(f[1] for f in factors)
        if stripes is None or upsample != "fancy" or len(halos) != len(planes):
            raise ValueError("planes_to_rgb: halos are one fancy stripe's, one a component")
        for p, hl, (fh, fv) in zip(planes, halos, factors):
            if (hl is not None) != takes_halo(fh, fv, mh, mv) or hl is not None and any(
                    r.dtype != torch.uint8 or r.device != dev or not r.is_contiguous()
                    or r.numel() != p.shape[-1] for r in hl):
                raise ValueError("planes_to_rgb: a halo row is a contiguous uint8 row of"
                                 " its plane, given where takes_halo holds")
    if dev.type == "cpu":
        return _planes_to_rgb_plain(planes, h, w, factors, quirks, upsample, exact, raw_cmyk,
                                    gray_shear, stripes, halos)
    if not planes[0].is_cuda:
        raise ValueError(f"planes_to_rgb: no kernel for {dev}")
    for p in planes:
        if p.dtype != torch.uint8 or not p.is_contiguous() or p.device != dev:
            raise ValueError("planes_to_rgb: planes must be contiguous uint8 on one device")
    shear = quirks == Quirks.REFERENCE if gray_shear is None else gray_shear
    fancy = upsample == "fancy" and len(planes) > 1
    mode = GRAY if len(planes) == 1 else colour_mode(len(planes), exact, raw_cmyk)
    entry = "jdtc_fancy_halo" if halos is not None else "jdtc_fancy" if fancy else "jdtc_color"
    return _launch(entry, planes, lead, h, w, factors, quirks, mode, shear, stripes, halos)


#: Bits of a component's flags in K3's and K3f's geometry (csrc/color.cu).
_H2X, _V2X, _NN = 1, 2, 4


def upsample_geometry(planes_shapes, h: int, w: int, factors, fancy: bool,
                      stripes: Stripes | None = None):
    """K3f's (`fancy`) or K3's geometry: per component (rows, stride,
    flags, plane rows a stripe) and (hratio, vratio) of its
    nearest-neighbour step. K3 indexes every plane below the full factors
    by the reference's rule; K3f runs the 2x passes first, and takes the
    rule where a ratio other than 2x remains; under `stripes` only the
    components fancy_ok takes get the passes, the others the rule alone. A
    component at the full factors is read in place. Raises if a kernel
    would read outside a plane."""
    mh = max(f[0] for f in factors)
    mv = max(f[1] for f in factors)
    geom, ratios = [], []
    for (rows, cols), (fh, fv) in zip(planes_shapes, factors):
        if fancy and (stripes is None or fancy_ok(fh, fv, mh, mv)):
            h2, v2, eh, ev = fancy_passes(fh, fv, mh, mv)
        else:
            h2 = v2 = False
            eh, ev = fh, fv
        nn = eh != mh or ev != mv
        flags = _H2X * h2 | _V2X * v2 | _NN * nn
        hr = np.float32(eh) / np.float32(mh)
        vr = np.float32(ev) / np.float32(mv)
        local = stripes.height * ev // mv if stripes is not None else 0
        # the extent of the passes' output, and the last row and column read
        xr, xc = rows * (2 if v2 else 1), cols * (2 if h2 else 1)
        last_r = int(nn_rows(h, ev, mv, stripes).max()) if nn and h else h - 1
        last_c = int(_nn_index_f32(w, hr)[-1]) if nn and w else w - 1
        if h and w and (last_r >= xr or last_c >= xc):
            raise ValueError("planes_to_rgb: plane smaller than its upsampled extent")
        geom.append((rows, cols, flags, local))
        ratios.append((float(hr), float(vr)))
    return geom, ratios


#: K3's and K3f's run (csrc/color.cu colour_run_kernel): the output pixels
#: of one row a thread converts, and the runs of a CTA's row segment.
RUN = 16
SEGMENT_RUNS = 16


def _vector_form(align: int, flags: int, hratio: float, fancy: bool) -> bool:
    """Whether color.cu `fetch_vector` loads a component's samples of a run
    as vectors: by its flags, its nearest-neighbour ratio across, and
    `align`, its plane's address, stride and halo rows' addresses or'ed."""
    if flags == 0 or fancy and flags == _V2X:
        return not align & 15
    if flags == _NN:
        return hratio == 1.0 and not align & 15 or hratio == 0.5 and not align & 7
    return fancy and flags in (_H2X, _H2X | _V2X) and not align & 7


def vector_share(g, r, addrs, fancy: bool) -> float:
    """The `colour_vector_pct` of a K3, K3f or K6h launch: the percent of its
    runs whose every component takes the vector loads. `g`, `r`: the
    launch's geometry (launch_geometry); `addrs`: per component its plane's
    address, or'ed with its halo rows' (K6h). Every run does, the row's
    partial last run included, where every component has a vector form
    (_vector_form), and none does otherwise: a stride that allows one is a
    multiple of its alignment, and so is rows * stride, so every image and
    row keeps the plane's alignment; the output's address does not enter
    (runs are placed by the source, the stores realigned)."""
    return 100.0 if all(_vector_form(a | int(g[c, 2]), int(g[c, 3]), float(r[c, 0]), fancy)
                        for c, a in enumerate(addrs)) else 0.0


def launch_geometry(shapes, h: int, w: int, factors, fancy: bool, shear: bool,
                    stripes: Stripes | None = None):
    """The geometry K3 (`fancy` False), K3f and K6h take for planes of
    `shapes` ([rows, stride] each): int64 [4, 5], per component (image
    stride, rows, stride, flags, plane rows a stripe), and float32 [4, 2],
    (hratio, vratio) (upsample_geometry); a gray plane's stride is the
    image width where `shear`."""
    geom, ratios = upsample_geometry(shapes, h, w, factors, fancy, stripes)
    g = np.zeros((4, 5), dtype=np.int64)
    r = np.zeros((4, 2), dtype=np.float32)
    for c, ((rows, cols, flags, local), ratio) in enumerate(zip(geom, ratios)):
        g[c] = (rows * cols, rows, w if len(shapes) == 1 and shear else cols, flags, local)
        r[c] = ratio
    return g, r


def _rule_samples(flat, rows: int, cols: int, flags: int, fancy: bool, r: int, qs):
    """color.cu `sample`, the per-pixel rule, at source row r (the output
    row, or its nearest-neighbour row) and source columns qs (int64 array),
    of one image's plane `flat` (1-D int64)."""
    if not fancy or not flags & (_H2X | _V2X):
        return flat[r * cols + qs]

    def hsum(base, q):
        s = q >> 1
        n = np.where(q & 1, np.minimum(s + 1, cols - 1), np.maximum(s - 1, 0))
        return 3 * flat[base + s] + flat[base + n] + np.where(q & 1, 2, 1)

    if not flags & _V2X:
        return hsum(r * cols, qs) >> 2
    t = r >> 1
    tn = min(t + 1, rows - 1) if r & 1 else max(t - 1, 0)
    bv = 2 if r & 1 else 1
    if not flags & _H2X:
        return (3 * flat[t * cols + qs] + flat[tn * cols + qs] + bv) >> 2
    return np.minimum((3 * hsum(t * cols, qs) + hsum(tn * cols, qs) + 4 * bv) >> 4, 255)


def _vector_samples(flat, head: int, rows: int, cols: int, flags: int, fancy: bool, hratio,
                    row: int, i: int, j0: int):
    """color.cu `fetch_vector`: a run's 16 samples at output row i from
    column j0 (j0 % 16 == 0, j0 < w) by the vector loads, or None where the
    kernel takes the per-pixel rule. `head`: the image's plane address
    modulo 16; `row`: the nearest-neighbour row of i. Raises RuntimeError
    where the loads would leave the row (the kernel relies on
    upsample_geometry's bounds to keep even a partial run's loads in it)."""
    if not _vector_form(head | cols, flags, hratio, fancy):
        return None
    span = 2 * cols if flags & _H2X or flags == _NN and hratio == 0.5 else cols
    if j0 + RUN > span:
        raise RuntimeError("a run's vector loads leave its row")
    if flags == 0:
        return flat[i * cols + j0:i * cols + j0 + RUN]
    if flags == _NN:
        if hratio == 1.0:
            return flat[row * cols + j0:row * cols + j0 + RUN]
        return np.repeat(flat[row * cols + j0 // 2:row * cols + j0 // 2 + 8], 2)
    t = i >> 1
    tn = min(t + 1, rows - 1) if i & 1 else max(t - 1, 0)
    bv = 2 if i & 1 else 1
    if flags == _V2X:
        x = flat[t * cols + j0:t * cols + j0 + RUN]
        y = flat[tn * cols + j0:tn * cols + j0 + RUN]
        return (3 * x + y + bv) >> 2
    s0 = j0 >> 1
    left, right = max(s0 - 1, 0), min(s0 + 8, cols - 1)
    k = np.arange(RUN)
    m = k >> 1

    def hsums(base):
        # the window X[-1..8] at positions 0..9: the left neighbour, the 8
        # bytes of the vector load, the right neighbour
        win = np.concatenate([flat[base + left:base + left + 1], flat[base + s0:base + s0 + 8],
                              flat[base + right:base + right + 1]])
        return 3 * win[m + 1] + np.where(k & 1, win[m + 2], win[m]) + np.where(k & 1, 2, 1)

    if flags == _H2X:
        return hsums(i * cols) >> 2
    return np.minimum((3 * hsums(t * cols) + hsums(tn * cols) + 4 * bv) >> 4, 255)


def _planes_to_rgb_runs_plain(planes, h: int, w: int, factors, quirks: Quirks,
                              upsample: str = "nn", exact: bool = True, raw_cmyk: bool = False,
                              gray_shear: bool | None = None, stripes: Stripes | None = None,
                              out_head: int = 0, plane_heads=None, paths=None, stores=None):
    """K3's and K3f's schedule (csrc/color.cu colour_run_kernel) on the CPU,
    with planes_to_rgb's arguments and the geometry _launch gives the
    kernel: each row's runs of RUN pixels from column 0, each component's
    samples of a run (the row's partial last run too) by the vector loads
    where its plane allows (`plane_heads`: each plane's address modulo 16,
    default 0) and by the per-pixel rule otherwise, the colour transform of
    the plain version, then the kernel's stores (_store_runs) into an output
    `out_head` bytes past a 16-byte boundary. `paths`, a Counter, receives
    the runs each way took: "vector" (every component by the vector loads)
    or "pixel" (some component by the per-pixel rule); `stores` the stores
    by width (16 or 1 bytes). The result of _planes_to_rgb_plain."""
    n = len(planes)
    lead = tuple(planes[0].shape[:-2])
    n_img = lead[0] if lead else 1
    shear = quirks == Quirks.REFERENCE if gray_shear is None else gray_shear
    fancy = upsample == "fancy" and n > 1
    g, r = launch_geometry([p.shape[-2:] for p in planes], h, w, factors, fancy, shear,
                           stripes)
    mv = max(f[1] for f in factors)
    heads = list(plane_heads) if plane_heads is not None else [0] * n
    comps = []
    for c in range(n):
        img_stride, rows, cols, flags = (int(v) for v in g[c, :4])
        hr = float(r[c, 0])
        ev = 2 * factors[c][1] if fancy and flags & _V2X else factors[c][1]
        nn_row = nn_rows(h, ev, mv, stripes) if flags & _NN else np.arange(h)
        nn_col = _nn_index_f32(w, r[c, 0]) if flags & _NN else np.arange(w)
        flat = planes[c].reshape(n_img, -1).to(torch.int64).numpy()
        comps.append((flat, rows, cols, flags, hr, nn_row, nn_col, img_stride))
    samples = np.zeros((n, n_img, h, -(-w // RUN) * RUN), dtype=np.int64)
    for img in range(n_img):
        for i in range(h):
            for j0 in range(0, w, RUN):
                # the per-pixel rule's columns past the row's end repeat its last
                js = np.minimum(np.arange(j0, j0 + RUN), w - 1)
                took = []
                for c, (flat, rows, cols, flags, hr, nn_row, nn_col, img_stride) in enumerate(comps):
                    one = flat[img]
                    got = _vector_samples(one, (heads[c] + img * img_stride) % 16, rows, cols,
                                          flags, fancy, hr, int(nn_row[i]), i, j0)
                    took.append(got is not None)
                    if got is None:
                        got = _rule_samples(one, rows, cols, flags, fancy, int(nn_row[i]),
                                            nn_col[js])
                    samples[c, img, i, j0:j0 + RUN] = got
                if paths is not None:
                    paths["vector" if all(took) else "pixel"] += 1
    chans = [torch.from_numpy(samples[c].astype(np.uint8)) for c in range(n)]
    rgb = gray_to_rgb(chans[0]) if n == 1 else _convert(chans, colour_mode(n, exact, raw_cmyk),
                                                        quirks)
    out = _store_runs(rgb.numpy(), w, out_head, stores)
    return torch.from_numpy(out).reshape(*lead, h, w, 3)


def _store_runs(rgb, w: int, out_head: int, stores=None) -> np.ndarray:
    """colour_run_kernel's stores: `rgb` [n_img, h, ceil(w / RUN) * RUN, 3],
    every run's 48 bytes (a partial run's pixels past the row's end as
    computed, never stored), into an output `out_head` bytes past a 16-byte
    boundary; returns the output's [n_img * h * w * 3] bytes. A run at a row head of 0
    stores 16-byte chunks (its valid bytes one by one where the row's end
    cuts it); elsewhere it stores the aligned chunks from `lead` = 16 - head
    bytes into its run, the next run's first 16 bytes taken from the lane
    after it (none past the CTA's row segment: what the shuffle brings there
    is never stored), and byte by byte what lies before the segment's first
    chunk or past its end. Raises RuntimeError for a 16-byte store off a
    16-byte boundary or an output byte stored other than once. `stores`, a
    Counter, receives the stores by width."""
    n_img, h = rgb.shape[:2]
    runs = -(-w // RUN)
    run_bytes = rgb.reshape(n_img, h, -1, 3 * RUN)
    size = out_head + n_img * h * w * 3
    out = np.zeros(size, dtype=np.uint8)
    written = np.zeros(size, dtype=np.int64)
    # what a lane's shuffle partner holds where the kernel never stores it
    junk = np.full(RUN, 0xEE, dtype=np.uint8)

    def put(addr: int, data) -> None:
        if len(data) == 16 and addr % 16:
            raise RuntimeError("a 16-byte store off a 16-byte boundary")
        out[addr:addr + len(data)] = data
        written[addr:addr + len(data)] += 1
        if stores is not None:
            stores[len(data)] += 1

    def put_bytes(addr: int, data) -> None:
        for k in range(len(data)):
            put(addr + k, data[k:k + 1])

    for img in range(n_img):
        for i in range(h):
            row = out_head + (img * h + i) * w * 3
            for m in range(runs):
                j0 = RUN * m
                dst = row + 3 * j0
                o = run_bytes[img, i, m]
                head = dst % 16
                if head == 0:
                    if j0 + RUN <= w:
                        for q in range(3):
                            put(dst + 16 * q, o[16 * q:16 * q + 16])
                    else:
                        put_bytes(dst, o[:3 * (w - j0)])
                    continue
                x = m % SEGMENT_RUNS
                if x + 1 < SEGMENT_RUNS:
                    nx = run_bytes[img, i, m + 1, :16] if m + 1 < runs else np.zeros(16, np.uint8)
                else:
                    nx = junk
                ext = np.concatenate([o, nx])
                lead = 16 - head
                lim = 3 * (min(w, (m - x + SEGMENT_RUNS) * RUN) - j0)
                if x == 0:
                    put_bytes(dst, o[:min(lead, lim)])
                for q in range(3):
                    b0 = lead + 16 * q
                    if b0 + 16 <= lim:
                        put(dst + b0, ext[b0:b0 + 16])
                    elif b0 < lim:
                        put_bytes(dst + b0, ext[b0:lim])
    if (written[:out_head] != 0).any() or (written[out_head:] != 1).any():
        raise RuntimeError("the runs store a byte other than once")
    return out[out_head:]


def _launch(entry: str, planes, lead, h: int, w: int, factors, quirks: Quirks,
            mode: int, shear: bool, stripes: Stripes | None = None,
            halos=None, out: torch.Tensor | None = None) -> torch.Tensor:
    """Launch K3 (`jdtc_color`), K3f (`jdtc_fancy`) or K6h
    (`jdtc_fancy_halo`, with `halos`) over `planes` into `out` (default a
    new [*lead, h, w, 3] uint8 tensor; the card tests pass views at every
    byte offset); a gray plane is read at the image width where `shear`.
    Each launch counts `colour_vector_pct` (vector_share)."""
    fancy = entry.startswith("jdtc_fancy")
    g, r = launch_geometry([p.shape[-2:] for p in planes], h, w, factors, fancy, shear, stripes)
    n = len(planes)
    row0, stripe_h = stripes if stripes is not None else (0, 0)
    count_as = (entry if stripes is None else "K6h" if halos is not None
                else "K6f" if fancy else "K6n")
    # K6h's halo rows: per component the device addresses of its top and
    # bottom rows, 0 where it reads none
    extra = ()
    hl = np.zeros((4, 2), dtype=np.int64)
    if halos is not None:
        hl = np.array([[t.data_ptr() for t in pair] if pair is not None else [0, 0]
                       for pair in [*halos, *[None] * (4 - n)]], dtype=np.int64)
        extra = (ctypes.c_void_p(hl.ctypes.data),)
    share = vector_share(
        g, r, [p.data_ptr() | int(hl[c, 0] | hl[c, 1]) for c, p in enumerate(planes)], fancy)
    shape = (*lead, h, w, 3)
    if out is None:
        out = torch.empty(shape, dtype=torch.uint8, device=planes[0].device)
    elif (out.shape != shape or out.dtype != torch.uint8 or out.device != planes[0].device
          or not out.is_contiguous()):
        raise ValueError(f"_launch: out must be contiguous uint8 {list(shape)} on the planes'"
                         " device")
    if h * w:
        n_images = lead[0] if lead else 1
        padded = [*planes, *[None] * (4 - n)]
        for _first, images, ptrs in _build.image_chunks(n_images, *padded, out):
            _build.launch_as(count_as, entry, *ptrs[:4], images, n, h, w,
                             ctypes.c_void_p(g.ctypes.data), ctypes.c_void_p(r.ctypes.data),
                             row0, stripe_h, mode, int(quirks != Quirks.REFERENCE), *extra,
                             ptrs[4], _build.stream_of(out))
            _build.add_units(count_as, images * h * w)
            count("colour_vector_pct", share)
    return out
