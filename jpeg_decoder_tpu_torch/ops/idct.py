"""Dequant + dezigzag + 8x8 IDCT over blocks (counterpart of
jpeg_decoder_tpu/ops/idct.py), in both numeric contracts.

EXACT: the plain PyTorch functions here are device-agnostic and follow
core/numerics._idct8_rows_exact / idct_2d_exact statement by statement:
each C statement of the reference's fast_idct_new (dct.c:296-341) is a
float64 expression of float32 values stored to float32, written here as
float64 and float32 torch ops with the same roundings. (The JAX package
emulates the float64 with double-float pairs, ops/df32.py, only because
TPUs lack float64; torch has it on every device.) PyTorch's eager
elementwise kernels do one operation each, so nothing is contracted.

FLOAT32: the whole transform as one [N, 64] @ [64, 64] float32 product with
the matrix K of idct_matrix_zz (re-derived here in NumPy: the JAX module
that holds it imports JAX), in idct_pallas's formula
(ops/pallas_kernels.py _kernel): dequantize in float32, multiply by K,
floor, then the output store. Within +-1 LSB of EXACT.

SCALED (scale k in {1, 2, 4}, under either contract, as the JAX package
runs it): a [N, 64] @ [64, k*k] float32 product by the truncated k-point
IDCT's matrix (idct_matrix_zz_scaled, copied from the JAX module) with the
table folded in, then the FLOAT32 store: idct_matmul_scaled.

`idct_plane` is the wrapper the decoder calls at full size: for a CPU
tensor it runs the plain version of the chosen contract, for a CUDA tensor
it launches kernel K0 (csrc/idct_exact.cu, EXACT) or K1 (csrc/idct_float.cu,
FLOAT32). At scale < 8 the decoder calls `idct_planes_scaled`, which
launches K5 (csrc/idct_scaled.cu) once for all of a call's components. Each
kernel fuses dequant, IDCT, output store and the block-to-plane scatter.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import numpy as np
import torch

from ..core.types import INV_ZIGZAG, ZIGZAG
from ..utils.config import IdctPrecision

from .. import _build

F32 = torch.float32
F64 = torch.float64

# AAN-family constants exactly as spelled in the reference (dct.c:296-341).
_C_SQRT2 = 1.414213562
_C_ISQRT2 = 0.707106781
_C_COS6 = 0.38268343236
_C_SIN6 = 0.92387953251
_C_A = 0.8314696123
_C_B = 0.55557023302
_C_C = 0.9807852804
_C_D = 0.19509032201
_C_OUT = _C_SQRT2 * 2


def _st(x: torch.Tensor) -> torch.Tensor:
    """The C's float32 store of a float64 value."""
    return x.to(F32)


def _idct8_rows_exact(v: torch.Tensor) -> torch.Tensor:
    """One fast_idct_new pass over the last axis of float32 `v`
    (core/numerics._idct8_rows_exact)."""
    d = v.to(F64)
    t0 = _st(_C_SQRT2 * d[..., 0])
    t1 = v[..., 4]
    t2 = v[..., 2]
    t3 = v[..., 6]
    t4 = _st(0.5 * (v[..., 1] - v[..., 7]).to(F64))
    t5 = _st(_C_ISQRT2 * d[..., 3])
    t6 = _st(_C_ISQRT2 * d[..., 5])
    t7 = _st(0.5 * (v[..., 1] + v[..., 7]).to(F64))

    u0 = _st(0.5 * (t0 + t1).to(F64))
    u1 = _st(0.5 * (t0 - t1).to(F64))
    u2 = _st(_C_ISQRT2 * (_C_COS6 * t2.to(F64) + -_C_SIN6 * t3.to(F64)))
    u3 = _st(_C_ISQRT2 * (_C_SIN6 * t2.to(F64) + _C_COS6 * t3.to(F64)))
    u4 = _st(0.5 * (t4 + t6).to(F64))
    u5 = _st(0.5 * (-t5 + t7).to(F64))
    u6 = _st(0.5 * (t4 - t6).to(F64))
    u7 = _st(0.5 * (t5 + t7).to(F64))

    w0 = _st(0.5 * (u0 + u3).to(F64))
    w1 = _st(0.5 * (u1 + u2).to(F64))
    w2 = _st(0.5 * (u1 - u2).to(F64))
    w3 = _st(0.5 * (u0 - u3).to(F64))
    w4 = _st(_C_A * u4.to(F64) + -_C_B * u7.to(F64))
    w5 = _st(_C_C * u5.to(F64) + -_C_D * u6.to(F64))
    w6 = _st(_C_D * u5.to(F64) + _C_C * u6.to(F64))
    w7 = _st(_C_B * u4.to(F64) + _C_A * u7.to(F64))

    return torch.stack(
        [
            _st(_C_OUT * (w0 + w7).to(F64)),
            _st(_C_OUT * (w1 + w6).to(F64)),
            _st(_C_OUT * (w2 + w5).to(F64)),
            _st(_C_OUT * (w3 + w4).to(F64)),
            _st(_C_OUT * (w3 - w4).to(F64)),
            _st(_C_OUT * (w2 - w5).to(F64)),
            _st(_C_OUT * (w1 - w6).to(F64)),
            _st(_C_OUT * (w0 - w7).to(F64)),
        ],
        dim=-1,
    )


def _quantize_output(pix_shifted: torch.Tensor, bits12: bool) -> torch.Tensor:
    """Reference output store: trunc + clamp (+ the 12->8 rescale).

    pix_shifted: float32 0.25-scaled IDCT values without the level shift
    (0.25 * x is exact in float32, so this is the model's 0.25 * d).
    8-bit: trunc(clamp(d + 128, 0, 255)) in float64, clamped before the
    uint8 conversion. 12-bit: +2048, CLAMP_16, the int16 wrap through an
    int32 mask, then (uint8)trunc(v / 4096 * 255) (dct.c:186-203,
    decode.c:520-525; core/numerics.idct_2d_exact and rescale_12bit)."""
    d = pix_shifted.to(F64)
    if not bits12:
        return torch.trunc(torch.clamp(d + 128.0, 0.0, 255.0)).to(torch.uint8)
    r = torch.trunc(torch.clamp(d + 2048.0, 0.0, 65535.0)).to(torch.int32)
    v16 = ((r & 0xFFFF) ^ 0x8000) - 0x8000
    resc = torch.trunc((v16.to(F64) / 4096.0) * 255.0).to(torch.int32)
    return (resc & 0xFF).to(torch.uint8)


def store_integer(x: np.ndarray, bits12: bool) -> np.ndarray:
    """The CPU model of the integer output store of K0 and K03
    (csrc/idct_exact.cuh `store`), bit for bit: float32 `x`, the IDCT's
    value before the 0.25 scale, clamped, then floor(0.25 y) by the fma
    rounded down to 1.5 * 2^23 + floor(0.25 y), read off the float32's bits
    (`floor_quarter`), the level shift, the clamp, and the tiny negative
    inputs that the float64 sum rounds up to the level shift. The tests
    hold it against the float64 form (_quantize_output)."""
    x = np.asarray(x, dtype=np.float32)
    lo, hi, shift, top, tiny = ((-8200.0, 262144.0, 2048, 65535, 2.0 ** -41) if bits12
                                else (-1024.0, 1024.0, 128, 255, 2.0 ** -45))
    y = np.minimum(np.maximum(x, np.float32(lo)), np.float32(hi))
    y = np.where(np.isnan(x), np.float32(lo), y)  # fmaxf(NaN, lo) is lo
    # __fmaf_rd(y, 0.25f, 1.5 * 2^23): the float32 at or below the exact sum
    t = (np.floor(0.25 * y.astype(np.float64)) + 12582912.0).astype(np.float32)
    v = t.view(np.int32).astype(np.int64) - 0x4B400000 + shift
    v = np.clip(v, 0, top)
    v = np.where((x < 0) & (x >= -tiny), shift, v)
    if not bits12:
        return v.astype(np.uint8)
    v16 = ((v & 0xFFFF) ^ 0x8000) - 0x8000
    q = np.trunc(v16 * 255 / 4096).astype(np.int64)  # C's (v * 255) / 4096
    return (q & 0xFF).astype(np.uint8)


def dequantize_blocks(coeffs_zz: torch.Tensor, qtable_natural) -> torch.Tensor:
    """Dequant + dezigzag: [N, 64] zigzag ints -> [N, 64] natural float32
    (dequant_data_unit, quant_table.c:131-152): natural[ZIGZAG[i]] =
    zz[i] * qt[ZIGZAG[i]], an exact int32 product, then the float32 cast."""
    if not isinstance(qtable_natural, torch.Tensor):
        qtable_natural = torch.from_numpy(
            np.asarray(qtable_natural, dtype=np.int32))
    qt = qtable_natural.to(device=coeffs_zz.device, dtype=torch.int32)
    inv = torch.as_tensor(INV_ZIGZAG, dtype=torch.long, device=coeffs_zz.device)
    return (coeffs_zz[..., inv].to(torch.int32) * qt).to(F32)


def idct_exact(coeffs_zz: torch.Tensor, qtable_natural,
               bits12: bool = False) -> torch.Tensor:
    """EXACT path, plain PyTorch: [N, 64] zigzag coefficients ->
    [N, 64] uint8 raster pixels."""
    cdu = dequantize_blocks(coeffs_zz, qtable_natural).reshape(-1, 8, 8)
    # Row/col 1/sqrt(2) pre-scale (dct.c:164-167); [0,0] scaled twice.
    cdu[:, 0, :] = _st(_C_ISQRT2 * cdu[:, 0, :].to(F64))
    cdu[:, :, 0] = _st(_C_ISQRT2 * cdu[:, :, 0].to(F64))
    cdu = _idct8_rows_exact(cdu)                   # row pass
    cdu = _idct8_rows_exact(cdu.transpose(1, 2))   # column pass
    cdu = cdu.transpose(1, 2)
    return _quantize_output(0.25 * cdu, bits12).reshape(-1, 64)


# ---------------------------------------------------------------------------
# FLOAT32 contract
# ---------------------------------------------------------------------------


def _idct8_f64(v: np.ndarray) -> np.ndarray:
    """The butterfly with no intermediate rounding (NumPy float64), used only
    to derive K (jpeg_decoder_tpu/ops/idct.py _idct8_f64, expression by
    expression)."""
    t0 = _C_SQRT2 * v[..., 0]
    t1, t2, t3 = v[..., 4], v[..., 2], v[..., 6]
    t4 = 0.5 * (v[..., 1] - v[..., 7])
    t5 = _C_ISQRT2 * v[..., 3]
    t6 = _C_ISQRT2 * v[..., 5]
    t7 = 0.5 * (v[..., 1] + v[..., 7])
    u0, u1 = 0.5 * (t0 + t1), 0.5 * (t0 - t1)
    u2 = _C_ISQRT2 * (_C_COS6 * t2 - _C_SIN6 * t3)
    u3 = _C_ISQRT2 * (_C_SIN6 * t2 + _C_COS6 * t3)
    u4, u5 = 0.5 * (t4 + t6), 0.5 * (-t5 + t7)
    u6, u7 = 0.5 * (t4 - t6), 0.5 * (t5 + t7)
    w0, w1 = 0.5 * (u0 + u3), 0.5 * (u1 + u2)
    w2, w3 = 0.5 * (u1 - u2), 0.5 * (u0 - u3)
    w4 = _C_A * u4 - _C_B * u7
    w5 = _C_C * u5 - _C_D * u6
    w6 = _C_D * u5 + _C_C * u6
    w7 = _C_B * u4 + _C_A * u7
    return np.stack(
        [
            _C_OUT * (w0 + w7), _C_OUT * (w1 + w6),
            _C_OUT * (w2 + w5), _C_OUT * (w3 + w4),
            _C_OUT * (w3 - w4), _C_OUT * (w2 - w5),
            _C_OUT * (w1 - w6), _C_OUT * (w0 - w7),
        ],
        axis=-1,
    )


@functools.lru_cache(maxsize=None)
def idct_matrix_zz() -> np.ndarray:
    """[64, 64] float32 K with pixels = dequantized zigzag coefficients @ K.

    Row z is the 2-D IDCT response (with the row/column 1/sqrt(2) pre-scale
    of dct.c:164-167 and the final 0.25 of dct.c:189) of the z-th zigzag
    coefficient; columns are raster-order pixels. Derived by pushing the 64
    unit blocks through the float64 butterfly, as the JAX package does."""
    eye = np.zeros((64, 8, 8), dtype=np.float64)
    for z in range(64):
        nat = int(ZIGZAG[z])
        eye[z, nat // 8, nat % 8] = 1.0
    eye[:, 0, :] *= _C_ISQRT2
    eye[:, :, 0] *= _C_ISQRT2
    out = _idct8_f64(eye)  # row pass
    out = np.swapaxes(out, 1, 2)
    out = _idct8_f64(out)  # column pass
    out = np.swapaxes(out, 1, 2)
    out = (0.25 * out.reshape(64, 64)).astype(np.float32)
    out.flags.writeable = False
    return out


@functools.lru_cache(maxsize=None)
def idct_matrix_on(device: torch.device) -> torch.Tensor:
    """K as a float32 [64, 64] tensor on `device` (one copy per device)."""
    return torch.from_numpy(idct_matrix_zz().copy()).to(device)


@contextlib.contextmanager
def _true_float32_matmul():
    """Pin float32 products to full float32 for the block: no TF32 (which
    keeps 10 mantissa bits; the same loss on the TPU's bf16 passes gave
    errors of up to 229 LSB, pallas_kernels.py:81-83). Restored after."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prec)
        torch.backends.cuda.matmul.allow_tf32 = tf32


def _quantize_output_float(y: torch.Tensor, bits12: bool) -> torch.Tensor:
    """The FLOAT32 contract's store of float32 `y` (jpeg_decoder_tpu/ops/
    idct.py _quantize_output): floor, +128 and a clamp to [0, 255] for
    8-bit; for 12-bit +2048, CLAMP_16, the int16 wrap through an int32
    mask and trunc(v16 * float32(255/4096)). Every float op is float32, and
    every float -> integer cast follows a clamp."""
    base = torch.floor(y)
    if not bits12:
        return torch.clamp(base + 128.0, 0.0, 255.0).to(torch.uint8)
    v = torch.clamp(base + 2048.0, 0.0, 65535.0).to(torch.int32)
    v16 = (((v & 0xFFFF) ^ 0x8000) - 0x8000).to(F32)
    resc = torch.trunc(v16 * (255.0 / 4096.0)).to(torch.int32)
    return (resc & 0xFF).to(torch.uint8)


def idct_float(coeffs_zz: torch.Tensor, qtable_natural,
               bits12: bool = False) -> torch.Tensor:
    """FLOAT32 path, plain PyTorch (the plain version of K1): [N, 64]
    zigzag coefficients -> [N, 64] uint8 raster pixels.

    x = float32(coeff) * float32(qt_zz) is exact for |coeff| <= 2^15 and
    qt <= 255; y = x @ K in true float32; then the store."""
    dev = coeffs_zz.device
    if not isinstance(qtable_natural, torch.Tensor):
        qtable_natural = torch.from_numpy(np.asarray(qtable_natural, dtype=np.int32))
    zz = torch.as_tensor(ZIGZAG, dtype=torch.long, device=dev)
    qt_zz = qtable_natural.to(device=dev)[zz].to(F32)
    x = coeffs_zz.to(F32) * qt_zz
    with _true_float32_matmul():
        y = x @ idct_matrix_on(dev)
    return _quantize_output_float(y, bits12)


#: K1's tile (csrc/idct_float.cu): K1_GROUPS groups of 16 threads, each
#: thread four pixels of K1_BLOCKS_PER_THREAD blocks.
K1_GROUPS = 8
K1_BLOCKS_PER_THREAD = 8
K1_TILE = K1_GROUPS * K1_BLOCKS_PER_THREAD


def idct_float_chain(x: torch.Tensor) -> torch.Tensor:
    """The FLOAT32 product in K1's and K13's order (csrc/idct_float.cuh):
    y[p] = fma(x[z], K[z][p], acc) for z = 0..63 in order from 0, each step
    rounded once (ops/fdct._fma32); float32 [N, 64] dequantised zigzag
    blocks -> float32 [N, 64] raster pixels before the store."""
    from .fdct import _fma32

    k = idct_matrix_on(x.device)
    acc = torch.zeros((x.shape[0], 64), dtype=F32, device=x.device)
    for z in range(64):
        acc = _fma32(x[:, z : z + 1], k[z], acc)
    return acc


def _idct_float_tiled_plain(coeff_plane: torch.Tensor, qtable_natural,
                            bits12: bool = False) -> torch.Tensor:
    """K1's schedule (csrc/idct_float.cu idct_float_kernel) on the CPU, with
    idct_plane's arguments: tiles of K1_TILE blocks, each dequantised into a
    float tile padded with zero blocks; each tile block's pixels by
    idct_float_chain and the store; then thread (g, q) of a tile stores
    pixels 4q..4q+3 (row q // 2, columns 4 (q % 2) ..) of its blocks g +
    K1_GROUPS j as one word. Raises RuntimeError unless every pixel is
    stored exactly once. The uint8 [..., by*8, bx*8] plane."""
    *lead, by, bx, _ = coeff_plane.shape
    n = int(np.prod(lead, dtype=np.int64)) * by * bx
    tiles = -(-n // K1_TILE)
    if not isinstance(qtable_natural, torch.Tensor):
        qtable_natural = torch.from_numpy(np.asarray(qtable_natural, dtype=np.int32))
    qt_zz = qtable_natural.to(torch.int64)[torch.as_tensor(ZIGZAG, dtype=torch.long)].to(F32)
    x = torch.zeros((tiles * K1_TILE, 64), dtype=F32)
    x[:n] = coeff_plane.reshape(-1, 64).to(F32) * qt_zz
    pix = _quantize_output_float(idct_float_chain(x), bits12).numpy()
    out = np.zeros((n // bx * 8, bx * 8), dtype=np.uint8)
    stored = np.zeros(out.shape, dtype=np.int64)
    t, g, q, j = np.meshgrid(np.arange(tiles), np.arange(K1_GROUPS), np.arange(16),
                             np.arange(K1_BLOCKS_PER_THREAD), indexing="ij")
    b = t * K1_TILE + g + K1_GROUPS * j
    live = b < n
    b, q = b[live], q[live]
    rows = (b // bx) * 8 + q // 2
    for d in range(4):
        cols = (b % bx) * 8 + 4 * (q % 2) + d
        out[rows, cols] = pix[b, 4 * q + d]
        np.add.at(stored, (rows, cols), 1)
    if (stored != 1).any():
        raise RuntimeError("K1's schedule stored a pixel other than once")
    return torch.from_numpy(out).reshape(*lead, by * 8, bx * 8)


# ---------------------------------------------------------------------------
# Scaled decode
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def idct_matrix_zz_scaled(k: int) -> np.ndarray:
    """[64, k*k] float32 M_k with pixels_kxk = dequantized zigzag
    coefficients @ M_k (jpeg_decoder_tpu/ops/idct.py idct_matrix_zz_scaled):
    the truncated k-point inverse DCT of the k lowest frequencies per axis,
    g = (k/8) B_k F[:k, :k] B_k^T with B_k[x, u] = sqrt(2/k) c_u cos((2x + 1)
    u pi / (2k)), c_0 = 1/sqrt(2), so that a DC-only block maps to the
    constant the full IDCT gives. Row z is the response of the z-th zigzag
    coefficient (zero above the band), columns raster-order pixels."""
    if k not in (1, 2, 4, 8):
        raise ValueError(f"scaled IDCT supports k in {{1, 2, 4, 8}}, got {k}")
    x = np.arange(k, dtype=np.float64)[:, None]
    u = np.arange(k, dtype=np.float64)[None, :]
    b = np.sqrt(2.0 / k) * np.cos((2.0 * x + 1.0) * u * np.pi / (2.0 * k))
    b[:, 0] *= 1.0 / np.sqrt(2.0)
    mat = np.zeros((64, k * k), dtype=np.float64)
    for z in range(64):
        nat = int(ZIGZAG[z])
        v_row, u_col = nat // 8, nat % 8
        if v_row >= k or u_col >= k:
            continue
        mat[z] = (k / 8.0) * np.outer(b[:, v_row], b[:, u_col]).reshape(-1)
    out = mat.astype(np.float32)
    out.flags.writeable = False
    return out


@functools.lru_cache(maxsize=None)
def idct_matrix_scaled_on(device: torch.device, k: int) -> torch.Tensor:
    """M_k as a float32 [64, k*k] tensor on `device`."""
    return torch.from_numpy(idct_matrix_zz_scaled(k).copy()).to(device)


def idct_matmul_scaled(coeffs_zz: torch.Tensor, qtable_natural, k: int,
                       bits12: bool = False) -> torch.Tensor:
    """The scaled decode's IDCT, plain PyTorch (the plain version of K5):
    [N, 64] zigzag coefficients -> [N, k*k] uint8 raster pixels of a k x k
    tile. As the JAX function: the table folded into M_k (one float32
    product an entry), float32(coeffs) @ it in true float32, the FLOAT32
    store."""
    dev = coeffs_zz.device
    if not isinstance(qtable_natural, torch.Tensor):
        qtable_natural = torch.from_numpy(np.asarray(qtable_natural, dtype=np.int32))
    zz = torch.as_tensor(ZIGZAG, dtype=torch.long, device=dev)
    qt_zz = qtable_natural.to(device=dev)[zz].to(F32)
    m = idct_matrix_scaled_on(dev, k) * qt_zz[:, None]
    with _true_float32_matmul():
        y = coeffs_zz.to(F32) @ m
    return _quantize_output_float(y, bits12)


#: K5's block of threads (csrc/idct_scaled.cu kThreads): one thread a
#: coefficient block; each component starts on a block of threads.
K5_THREADS = 256
#: The most components, and distinct tables, one K5 launch takes.
K5_MAX_COMPS = 4


@functools.lru_cache(maxsize=None)
def band_z(k: int) -> tuple[int, ...]:
    """The band of scale k: the zigzag positions whose natural position (v,
    u) has v < k and u < k, in increasing z (csrc/idct_scaled.cu kBand2,
    kBand4): the rows of M_k that are not zero."""
    return tuple(z for z in range(64) if ZIGZAG[z] // 8 < k and ZIGZAG[z] % 8 < k)


@functools.lru_cache(maxsize=256)
def folded_band(qt_bytes: bytes, k: int) -> np.ndarray:
    """K5's folded band for one natural-order table (int32 bytes): float32
    [k*k * k*k], entry j * k*k + p = M_k[z_j][p] * float32(qt_zz[z_j]) for
    band row j (band_z). One float32 product an entry, rounded to nearest:
    bitwise the torch fold of idct_matmul_scaled and the __fmul_rn of K5's
    earlier design. Read-only; cached per (table, k)."""
    qt = np.frombuffer(qt_bytes, dtype=np.int32)
    rows = np.asarray(band_z(k))
    mat = idct_matrix_zz_scaled(k)[rows]
    out = (mat * qt[ZIGZAG[rows]].astype(np.float32)[:, None]).astype(np.float32).reshape(-1)
    out.flags.writeable = False
    return out


def scaled_layout(planes, qts, k: int) -> tuple[np.ndarray, np.ndarray]:
    """K5's descriptor without the pointers, and its tables, from the
    planes' shapes [..., by, bx, 64] and their natural-order tables: int64
    [n, 4] rows (leading dimensions times by), blocks_x, table index and
    first block of threads of each component, in order, each component
    from the block of threads after the last one's; and float32 [t, k^4]
    the folded band of each distinct table, in order of first use
    (folded_band)."""
    desc = np.zeros((len(planes), 4), dtype=np.int64)
    tables: dict[bytes, int] = {}
    cta = 0
    for c, (p, q) in enumerate(zip(planes, qts)):
        *lead, by, bx, _ = p.shape
        rows = int(np.prod(lead, dtype=np.int64)) * by
        key = np.ascontiguousarray(q, dtype=np.int32).tobytes()
        desc[c] = (rows, bx, tables.setdefault(key, len(tables)), cta)
        cta += -(-rows * bx // K5_THREADS)
    return desc, np.stack([folded_band(key, k) for key in tables])


def _host_table(q) -> np.ndarray:
    """A natural-order table on the host (a CUDA tensor is copied back: a
    sync, which the decoder's own calls never make; PixelStage keeps its
    tables on the host as well)."""
    if isinstance(q, torch.Tensor):
        q = q.cpu().numpy()
    return np.asarray(q)


def idct_planes_scaled(planes, qts, k: int, bits12: bool = False) -> list[torch.Tensor]:
    """The scaled decode's IDCT over every component of a pixel-stage call:
    int16 [..., by, bx, 64] zigzag coefficient planes (one leading shape
    for all) and their natural-order tables -> uint8 [..., by*k, bx*k]
    planes, k in {1, 2, 4}. Either contract: the JAX package's scaled
    decode is its FLOAT32 product.

    CPU tensors: the plain version (idct_matmul_scaled, blocks_to_plane)
    plane by plane. CUDA tensors: one K5 launch for all of them, the
    folded tables in its parameters (scaled_layout)."""
    if not planes or k not in (1, 2, 4):
        raise ValueError(f"idct_planes_scaled: k in (1, 2, 4) and planes, got k = {k}")
    lead = planes[0].shape[:-3]
    if any(p.shape[:-3] != lead or p.shape[-1] != 64 for p in planes):
        raise ValueError("idct_planes_scaled: planes must share their leading shape")
    dev = planes[0].device
    if dev.type == "cpu":
        outs = []
        for p, q in zip(planes, qts):
            *_, by, bx, _ = p.shape
            rows = int(np.prod(lead, dtype=np.int64)) * by
            pix = idct_matmul_scaled(p.reshape(-1, 64), q, k, bits12)
            outs.append(blocks_to_plane(pix, rows, bx, k).reshape(*lead, by * k, bx * k))
        return outs
    if not all(p.is_cuda and p.device == dev for p in planes):
        raise ValueError(f"idct_planes_scaled: no kernel for {dev}, or planes on two devices")
    if len(planes) > K5_MAX_COMPS or len(qts) != len(planes):
        raise ValueError(f"idct_planes_scaled: 1 to {K5_MAX_COMPS} planes, a table each")
    for p in planes:
        if p.dtype != torch.int16 or not p.is_contiguous() or p.data_ptr() % 16:
            raise ValueError("idct_planes_scaled: coefficients must be contiguous, 16-byte"
                             " aligned int16")
    tables = [_host_table(q) for q in qts]
    if any(q.size != 64 for q in tables):
        raise ValueError("idct_planes_scaled: a table has 64 entries")
    layout, folded = scaled_layout(planes, tables, k)
    outs = [torch.empty((*lead, p.shape[-3] * k, p.shape[-2] * k), dtype=torch.uint8,
                        device=dev) for p in planes]
    blocks = int((layout[:, 0] * layout[:, 1]).sum())
    if blocks:
        desc = np.zeros((len(planes), 6), dtype=np.int64)
        desc[:, 0] = [p.data_ptr() for p in planes]
        desc[:, 1] = [o.data_ptr() for o in outs]
        desc[:, 2:] = layout
        _build.launch("jdtc_idct_scaled", desc.ctypes.data_as(ctypes.c_void_p),
                      folded.ctypes.data_as(ctypes.c_void_p), len(planes), len(folded), k,
                      int(bits12), _build.stream_of(outs[0]))
        _build.add_units("jdtc_idct_scaled", blocks)
    return outs


def _idct_scaled_walk_plain(planes, qts, k: int, bits12: bool = False) -> list[torch.Tensor]:
    """K5's one-launch walk (csrc/idct_scaled.cu idct_scaled_kernel) on the
    CPU, with idct_planes_scaled's arguments: every block of threads finds
    its component by comparing its index with the components' first blocks
    of threads (scaled_layout), thread t of it takes block (index - first) *
    K5_THREADS + t of that component, the band's coefficients as float32,
    each pixel the fmaf chain over the band in order from 0 (ops/fdct._fma32,
    each step rounded once) against the folded band of its table, the store,
    and the tile into the plane. Raises RuntimeError unless every block is
    taken and every pixel stored exactly once."""
    from .fdct import _fma32

    tables = [_host_table(q) for q in qts]
    layout, folded = scaled_layout(planes, tables, k)
    lead = planes[0].shape[:-3]
    k2 = k * k
    band = torch.as_tensor(band_z(k), dtype=torch.long)
    n_ctas = int(layout[-1, 3] + -(-layout[-1, 0] * layout[-1, 1] // K5_THREADS))
    # the first blocks of threads of components 1..3, INT_MAX past the last
    first = np.full(K5_MAX_COMPS - 1, np.iinfo(np.int32).max, dtype=np.int64)
    first[: len(planes) - 1] = layout[1:, 3]
    cta = np.arange(n_ctas)
    comp_of = (cta[:, None] >= first[None, :]).sum(axis=1)
    outs = [np.zeros((rows * k, bx * k), dtype=np.uint8) for rows, bx, _, _ in layout]
    stored = [np.zeros(o.shape, dtype=np.int64) for o in outs]
    for c, p in enumerate(planes):
        rows, bx, t, first_cta = (int(v) for v in layout[c])
        ctas = cta[comp_of == c]
        b = ((ctas[:, None] - first_cta) * K5_THREADS + np.arange(K5_THREADS)[None, :]).ravel()
        b = b[b < rows * bx]
        if b.size != rows * bx or (b.size and not np.array_equal(np.sort(b), np.arange(b.size))):
            raise RuntimeError("K5's walk took a block other than once")
        if not b.size:
            continue
        x = p.reshape(-1, 64)[torch.from_numpy(b)][:, band].to(F32)
        m = torch.from_numpy(folded[t].reshape(k2, k2).copy())
        acc = torch.zeros((b.size, k2), dtype=F32)
        for j in range(k2):
            acc = _fma32(x[:, j : j + 1], m[j], acc)
        pix = _quantize_output_float(acc, bits12).numpy().reshape(-1, k, k)
        by, bxx = b // bx, b % bx
        for r in range(k):
            for col in range(k):
                outs[c][by * k + r, bxx * k + col] = pix[:, r, col]
                np.add.at(stored[c], (by * k + r, bxx * k + col), 1)
    if any((s != 1).any() for s in stored):
        raise RuntimeError("K5's walk stored a pixel other than once")
    return [torch.from_numpy(o).reshape(*lead, p.shape[-3] * k, p.shape[-2] * k)
            for o, p in zip(outs, planes)]


# ---------------------------------------------------------------------------
# Block scatter and the dispatch
# ---------------------------------------------------------------------------


def blocks_to_plane(pixels: torch.Tensor, blocks_y: int, blocks_x: int,
                    tile: int = 8) -> torch.Tensor:
    """[by*bx, tile*tile] raster-order block pixels -> [by*tile, bx*tile]
    plane (write_data_unit's scatter, decode.c:508-533)."""
    return (
        pixels.reshape(blocks_y, blocks_x, tile, tile)
        .permute(0, 2, 1, 3)
        .reshape(blocks_y * tile, blocks_x * tile)
    )


_PLAIN = {IdctPrecision.EXACT: idct_exact, IdctPrecision.FLOAT32: idct_float}
_ENTRY = {IdctPrecision.EXACT: "jdtc_idct_exact",
          IdctPrecision.FLOAT32: "jdtc_idct_float"}


def idct_plane(coeff_plane: torch.Tensor, qtable_natural: torch.Tensor,
               bits12: bool = False,
               precision: IdctPrecision = IdctPrecision.EXACT,
               scale: int = 8) -> torch.Tensor:
    """int16 [..., by, bx, 64] zigzag coefficient planes -> uint8
    [..., by*k, bx*k] pixel planes, k = `scale`. Leading (batch) dimensions
    stack as block rows: [B, by, bx, 64] is [B*by, bx, 64] to the kernel.
    At scale < 8 `precision` is not read (the JAX package's scaled decode
    is its FLOAT32 product under either contract).

    CPU tensor: the plain version. CUDA tensor: K0 (EXACT), K1 (FLOAT32) or
    K5 (scale < 8)."""
    *lead, by, bx, _ = coeff_plane.shape
    rows = int(np.prod(lead, dtype=np.int64)) * by
    k = scale
    if k < 8:
        return idct_planes_scaled([coeff_plane], [qtable_natural], k, bits12)[0]
    if coeff_plane.device.type == "cpu":
        pix = _PLAIN[precision](coeff_plane.reshape(-1, 64), qtable_natural, bits12)
        return blocks_to_plane(pix, rows, bx).reshape(*lead, by * 8, bx * 8)
    if not coeff_plane.is_cuda:
        raise ValueError(f"idct_plane: no kernel for {coeff_plane.device}")
    if coeff_plane.dtype != torch.int16 or not coeff_plane.is_contiguous():
        raise ValueError("idct_plane: coefficients must be contiguous int16")
    if (qtable_natural.dtype != torch.int32 or qtable_natural.numel() != 64
            or not qtable_natural.is_contiguous()
            or qtable_natural.device != coeff_plane.device):
        raise ValueError("idct_plane: qtable must be contiguous int32 [64] on the same device")
    out = torch.empty((*lead, by * 8, bx * 8), dtype=torch.uint8,
                      device=coeff_plane.device)
    if rows * bx:
        extra = ()
        if precision == IdctPrecision.FLOAT32:
            extra = (_build.ptr(idct_matrix_on(coeff_plane.device)),)
        _build.launch(
            _ENTRY[precision], _build.ptr(coeff_plane),
            _build.ptr(qtable_natural), *extra, rows * bx, bx, int(bits12),
            _build.ptr(out), _build.stream_of(out),
        )
        _build.add_units(_ENTRY[precision], rows * bx)
    return out
