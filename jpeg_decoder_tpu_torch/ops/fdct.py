"""The encoder's device stage: RGB -> YCbCr, edge pad, box subsample, level
shift, forward DCT and quantization (counterpart of
jpeg_decoder_tpu/ops/fdct.py and of the program that
jpeg_decoder_tpu/models/encoder.py _build_device_stage composes from it).

`encode_planes` is the wrapper the encoder calls. For a CPU tensor it runs
the plain composition below; for a CUDA tensor it launches kernel K4
(csrc/fdct.cu), one launch per image for every component.

The arithmetic is pinned to what the JAX package's jitted functions compute
on the CPU, where XLA contracts and orders the float32 operations:
  * colour: y = fma(KB, b, fma(KR, r, KG * g)), cb = fma(b - y, CB, 128),
    cr = fma(r - y, CR, 128), with float32 constants (an op-by-op float32
    formula differs on millions of the 16.7 M RGB triples);
  * the box average sums each box row left to right, then the rows top to
    bottom -- or, for a 2x2 box of a plane whose subsampled width is over 64
    and not a power of two, the box as one chain in raster order
    (box_by_rows) -- then scales by 1 / (fh * fv), a power of two;
  * the FDCT of a block is, per zigzag coefficient z, a forward chain of
    fused multiply-adds over the raster index i = 0..63 of x_i * Kq[i, z],
    with x the level-shifted samples and Kq = fdct_matrix_zz() / qt[ZIGZAG]
    formed in float32 (a reversed or split sum, or a cuBLAS product, flips
    roundings); then sign(f) * floor(|f| + 0.5). A component of a single
    block takes XLA's matrix-vector order (eight interleaved chains added
    in a tree; _fdct_kq).
The plain versions compute each fused step exactly: the float32 operands'
product is exact in float64, the sum is taken in float64 with its error
(TwoSum) and rounded to odd, and the one cast to float32 then rounds as a
single fused operation does. The 64-step chain runs as 64 tensor
operations over [N, 64], never as a matmul, so the plain version gives the
kernel's bits on the CPU and on the card alike.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math

import numpy as np
import torch

from ..core.types import ZIGZAG

from .. import _build

F32 = torch.float32
F64 = torch.float64

# BT.601 forward constants (the JAX module's _KR, _KG, _KB), as the float32
# values its jitted colour step multiplies by.
_KR, _KG, _KB = 0.299, 0.587, 0.114
COLOR_CONSTANTS = np.array(
    [_KR, _KG, _KB, 0.5 / (1.0 - _KB), 0.5 / (1.0 - _KR)], dtype=np.float32)

#: Blocks a run of the plain FDCT chain takes on the CPU.
CPU_CHUNK = 4096

#: Calls of encode_planes that ran the plain version (a CPU tensor), so that
#: a run on the card can show it took none.
PLAIN_CALLS: collections.Counter = collections.Counter()


@functools.lru_cache(maxsize=None)
def dct8_matrix() -> np.ndarray:
    """(8, 8) orthonormal DCT-II basis: row u = c(u)/2 * cos((2x+1)u pi/16)."""
    u = np.arange(8)
    m = 0.5 * np.cos((2 * u[None, :] + 1) * u[:, None] * np.pi / 16)
    m[0] *= 1.0 / np.sqrt(2.0)
    return m.astype(np.float64)


@functools.lru_cache(maxsize=None)
def fdct_matrix_zz() -> np.ndarray:
    """[64, 64] float32 K with: coeffs_zigzag = pixels_raster @ K.

    Column z is the zigzag-z DCT coefficient's weight vector, built from the
    exact separable basis: F[u,v] = sum_{x,y} p[x,y] C[u,x] C[v,y]."""
    c = dct8_matrix()
    k = np.einsum("ux,vy->uvxy", c, c).reshape(64, 64)  # [uv, xy]
    out = k[ZIGZAG, :].T.astype(np.float32).copy()  # [xy, zz]
    out.flags.writeable = False
    return out


def fdct_table(qtable_natural) -> np.ndarray:
    """Kq = K / qt[ZIGZAG], float32 [64, 64] (raster i, zigzag z): the
    quantization folded into the transform, divided in float32 as the JAX
    function divides."""
    qt = np.asarray(qtable_natural, dtype=np.float32)[ZIGZAG]
    return fdct_matrix_zz() / qt[None, :]


def fdct_tables(qts, device) -> torch.Tensor:
    """float32 [len(qts), 64, 64] Kq tables on `device` (K4's tables)."""
    return torch.from_numpy(np.stack([fdct_table(q) for q in qts])).to(device)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _fma32(a, b, c) -> torch.Tensor:
    """float32 fma(a, b, c) rounded once, on float32 tensors (or numbers).

    a * b is exact in float64. s = p + c rounds in float64 and TwoSum
    recovers its error; where the sum was inexact, s is moved to the
    neighbour with an odd last bit (round to odd), so that the cast to
    float32, 29 bits shorter, rounds as if from the exact sum."""
    p = torch.as_tensor(a, dtype=F32).to(F64) * torch.as_tensor(b, dtype=F32).to(F64)
    c = torch.as_tensor(c, dtype=F32).to(F64)
    s = p + c
    t = s - p
    err = (p - (s - t)) + (c - t)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.copysign(torch.full_like(s, math.inf), err)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(F32)


def rgb_to_ycbcr(rgb: torch.Tensor):
    """[H, W, 3] uint8 -> three float32 [H, W] planes (Y, Cb, Cr), in the
    fused order of the jitted JAX function."""
    kr, kg, kb, cbs, crs = (torch.tensor(v, dtype=F32, device=rgb.device)
                            for v in COLOR_CONSTANTS)
    r, g, b = (rgb[..., i].to(F32) for i in range(3))
    y = _fma32(kb, b, _fma32(kr, r, kg * g))
    cb = _fma32(b - y, cbs, 128.0)
    cr = _fma32(r - y, crs, 128.0)
    return y, cb, cr


def pad_edge(plane: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Edge-replicate pad of an [h, w] plane to [out_h, out_w]."""
    h, w = plane.shape
    rows = torch.arange(out_h, device=plane.device).clamp_(max=h - 1)
    cols = torch.arange(out_w, device=plane.device).clamp_(max=w - 1)
    return plane[rows[:, None], cols[None, :]]


def box_by_rows(fh: int, fv: int, out_w: int) -> bool:
    """The order in which the JAX stage sums an fh x fv box whose
    subsampled plane is out_w wide: by rows (each box row left to right,
    then the rows top to bottom) where out_w is at most 64 or a power of
    two, otherwise as one chain in raster order. XLA:CPU picks the order by
    the shape; the two differ only for boxes of more than one row and more
    than one column (2x2)."""
    return out_w <= 64 or (out_w & (out_w - 1)) == 0


def box_subsample(plane: torch.Tensor, fh: int, fv: int, by_rows: bool | None = None
                  ) -> torch.Tensor:
    """Average fh x fv boxes of a float32 [H, W] plane (H % fv == W % fh
    == 0): the box summed by rows or in one raster chain (`by_rows`, by
    default box_by_rows), then the product by 1 / (fh * fv)."""
    if fh == 1 and fv == 1:
        return plane
    h, w = plane.shape
    if by_rows is None:
        by_rows = box_by_rows(fh, fv, w // fh)
    x = plane.reshape(h // fv, fv, w // fh, fh)
    total = None
    for j in range(fv):
        if by_rows:
            row = x[:, j, :, 0]
            for k in range(1, fh):
                row = row + x[:, j, :, k]
            total = row if total is None else total + row
        else:
            for k in range(fh):
                total = x[:, j, :, k] if total is None else total + x[:, j, :, k]
    return total * torch.tensor(1.0 / (fh * fv), dtype=F32, device=plane.device)


def plane_to_blocks(plane: torch.Tensor, blocks_y: int, blocks_x: int) -> torch.Tensor:
    """[by*8, bx*8] plane -> [by*bx, 64] raster-order blocks."""
    return (
        plane.reshape(blocks_y, 8, blocks_x, 8)
        .permute(0, 2, 1, 3)
        .reshape(blocks_y * blocks_x, 64)
    )


def _fdct_chain(x: torch.Tensor, kq: torch.Tensor, order) -> torch.Tensor:
    """acc = fma(x_i, kq[i], acc) for i in `order`, from 0, on float32
    [N, 64] level-shifted samples."""
    acc = torch.zeros((x.shape[0], 64), dtype=F32, device=x.device)
    for i in order:
        acc = _fma32(x[:, i : i + 1], kq[i], acc)
    return acc


def _fdct_kq(blocks: torch.Tensor, kq: torch.Tensor) -> torch.Tensor:
    """[N, 64] raster samples -> [N, 64] int32 zigzag coefficients, by the
    folded table kq (float32 [64, 64]): the forward chain over i = 0..63.
    A single block (N = 1) sums as the JAX stage's matrix-vector product
    does: eight interleaved chains (i = r, r + 8, ...) added in a tree,
    ((c0 + c1) + (c2 + c3)) + ((c4 + c5) + (c6 + c7))."""
    x = blocks.to(F32) - 128.0
    n = x.shape[0]
    if n == 1:
        chains = [_fdct_chain(x, kq, range(r, 64, 8)) for r in range(8)]
        while len(chains) > 1:
            chains = [chains[k] + chains[k + 1] for k in range(0, len(chains), 2)]
        acc = chains[0]
    else:
        # On the CPU the chain runs over runs of CPU_CHUNK blocks, which
        # stay in cache (5x faster than whole 4K planes); a block's chain
        # does not depend on the run it lies in.
        step = CPU_CHUNK if x.device.type == "cpu" else max(n, 1)
        acc = torch.cat([_fdct_chain(x[k : k + step], kq, range(64))
                         for k in range(0, max(n, 1), step)])
    return (torch.sign(acc) * torch.floor(acc.abs() + 0.5)).to(torch.int32)


def fdct_quantize(blocks: torch.Tensor, qtable_natural) -> torch.Tensor:
    """[N, 64] raster uint8/float32 pixel blocks -> [N, 64] int32 zigzag
    quantized coefficients: level shift, the FDCT chain by K / qt, then
    rounding half away from zero."""
    kq = torch.from_numpy(fdct_table(qtable_natural)).to(blocks.device)
    return _fdct_kq(blocks, kq)


# ---------------------------------------------------------------------------
# Geometry and the wrapper
# ---------------------------------------------------------------------------


def plane_layout(h: int, w: int, factors):
    """(mcus_x, mcus_y, [(blocks_y, blocks_x, box_h, box_v)] per component)
    of an h x w image under sampling `factors`: the MCU-padded planes and
    each component's box (hmax / fh by vmax / fv)."""
    hmax = max(f[0] for f in factors)
    vmax = max(f[1] for f in factors)
    mcus_x = -(-w // (8 * hmax))
    mcus_y = -(-h // (8 * vmax))
    comps = [(mcus_y * fv, mcus_x * fh, hmax // fh, vmax // fv) for fh, fv in factors]
    return mcus_x, mcus_y, comps


def _planes_plain(img: torch.Tensor, factors, kq: torch.Tensor):
    """The plain composition: colour (or the gray samples), edge pad, box
    subsample, blocks, FDCT + quantize; int16 [by, bx, 64] per component."""
    h, w = img.shape[:2]
    _, _, comps = plane_layout(h, w, factors)
    if img.dim() == 2:
        chans = [img.to(F32)]
    elif len(factors) == 1:
        chans = [rgb_to_ycbcr(img)[0]]
    else:
        chans = list(rgb_to_ycbcr(img))
    out = []
    for ci, (by, bx, box_h, box_v) in enumerate(comps):
        plane = pad_edge(chans[ci], by * 8 * box_v, bx * 8 * box_h)
        sub = box_subsample(plane, box_h, box_v)
        zz = _fdct_kq(plane_to_blocks(sub, by, bx), kq[min(ci, kq.shape[0] - 1)])
        out.append(zz.to(torch.int16).reshape(by, bx, 64))
    return out


def encode_planes(img: torch.Tensor, factors, kq: torch.Tensor,
                  out: torch.Tensor | None = None) -> list[torch.Tensor]:
    """uint8 [H, W, 3] RGB or [H, W] gray -> int16 [by, bx, 64] zigzag
    quantized coefficient planes, one per component of `factors` ((fh, fv)
    each; one component of an RGB image is its luma). `kq` is float32
    [n_tables, 64, 64] (fdct_tables): component 0 takes table 0, the others
    the last. The planes are views of `out`, int16 [sum(by * bx * 64)]
    (allocated when None), component after component.

    CPU tensor: the plain version. CUDA tensor: one launch of K4."""
    h, w = img.shape[:2]
    _, _, comps = plane_layout(h, w, factors)
    sizes = [by * bx * 64 for by, bx, _, _ in comps]
    if out is None:
        out = torch.empty(sum(sizes), dtype=torch.int16, device=img.device)
    if out.numel() != sum(sizes) or out.dtype != torch.int16 or not out.is_contiguous():
        raise ValueError(f"encode_planes: out must be contiguous int16 [{sum(sizes)}]")
    views = [v.view(by, bx, 64) for v, (by, bx, _, _) in zip(out.split(sizes), comps)]
    if img.device.type == "cpu":
        PLAIN_CALLS["encode_planes"] += 1
        for v, p in zip(views, _planes_plain(img, factors, kq)):
            v.copy_(p)
        return views
    if not img.is_cuda:
        raise ValueError(f"encode_planes: no kernel for {img.device}")
    if img.dtype != torch.uint8 or not img.is_contiguous() or img.dim() not in (2, 3) or (
            img.dim() == 3 and img.shape[2] != 3):
        raise ValueError("encode_planes: image must be contiguous uint8 [H, W] or [H, W, 3]")
    if len(factors) not in (1, 3) or (img.dim() == 2 and len(factors) != 1):
        raise ValueError(f"encode_planes: {len(factors)} components of a {img.dim()}-D image")
    if (kq.dtype != F32 or not kq.is_contiguous() or kq.dim() != 3
            or kq.shape[1:] != (64, 64) or kq.device != img.device):
        raise ValueError("encode_planes: kq must be contiguous float32 [n, 64, 64] on the"
                         " image's device")
    if out.device != img.device:
        raise ValueError("encode_planes: out must lie on the image's device")
    if sum(sizes) == 0:
        return views
    # per component: output address, blocks_y, blocks_x, box_h, box_v,
    # by_rows, table
    params = np.zeros((3, 7), dtype=np.int64)
    for ci, (v, (by, bx, box_h, box_v)) in enumerate(zip(views, comps)):
        params[ci] = (v.data_ptr(), by, bx, box_h, box_v,
                      box_by_rows(box_h, box_v, bx * 8), min(ci, kq.shape[0] - 1))
    _build.launch(
        "jdtc_fdct", _build.ptr(img), h, w, 1 if img.dim() == 2 else 3, len(factors),
        params.ctypes.data_as(ctypes.c_void_p), _build.ptr(kq),
        COLOR_CONSTANTS.ctypes.data_as(ctypes.c_void_p), _build.stream_of(img),
    )
    return views
