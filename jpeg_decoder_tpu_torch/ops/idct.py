"""Dequant + dezigzag + EXACT 8x8 IDCT over blocks (counterpart of
jpeg_decoder_tpu/ops/idct.py, EXACT contract only).

The plain PyTorch functions here are device-agnostic and follow
core/numerics._idct8_rows_exact / idct_2d_exact statement by statement:
each C statement of the reference's fast_idct_new (dct.c:296-341) is a
float64 expression of float32 values stored to float32, written here as
float64 and float32 torch ops with the same roundings. (The JAX package
emulates the float64 with double-float pairs, ops/df32.py, only because
TPUs lack float64; torch has it on every device.) PyTorch's eager
elementwise kernels do one operation each, so nothing is contracted.

`idct_plane` is the wrapper the decoder calls: for a CPU tensor it runs the
plain version, for a CUDA tensor it launches kernel K0
(csrc/idct_exact.cu), which fuses dequant, IDCT, output store and the
block-to-plane scatter.
"""

from __future__ import annotations

import numpy as np
import torch

from jpeg_decoder_tpu.core.types import INV_ZIGZAG

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


def blocks_to_plane(pixels: torch.Tensor, blocks_y: int, blocks_x: int,
                    tile: int = 8) -> torch.Tensor:
    """[by*bx, tile*tile] raster-order block pixels -> [by*tile, bx*tile]
    plane (write_data_unit's scatter, decode.c:508-533)."""
    return (
        pixels.reshape(blocks_y, blocks_x, tile, tile)
        .permute(0, 2, 1, 3)
        .reshape(blocks_y * tile, blocks_x * tile)
    )


def idct_plane(coeff_plane: torch.Tensor, qtable_natural: torch.Tensor,
               bits12: bool = False) -> torch.Tensor:
    """int16 [by, bx, 64] zigzag coefficient plane -> uint8 [by*8, bx*8]
    pixel plane, EXACT. CPU tensor: the plain version. CUDA tensor: K0."""
    by, bx, _ = coeff_plane.shape
    if coeff_plane.device.type == "cpu":
        return blocks_to_plane(
            idct_exact(coeff_plane.reshape(-1, 64), qtable_natural, bits12),
            by, bx,
        )
    if not coeff_plane.is_cuda:
        raise ValueError(f"idct_plane: no kernel for {coeff_plane.device}")
    if coeff_plane.dtype != torch.int16 or not coeff_plane.is_contiguous():
        raise ValueError("idct_plane: coefficients must be contiguous int16")
    if (qtable_natural.dtype != torch.int32 or qtable_natural.numel() != 64
            or not qtable_natural.is_contiguous()
            or qtable_natural.device != coeff_plane.device):
        raise ValueError("idct_plane: qtable must be contiguous int32 [64] on the same device")
    out = torch.empty((by * 8, bx * 8), dtype=torch.uint8,
                      device=coeff_plane.device)
    if by * bx:
        _build.launch(
            "jdtc_idct_exact", _build.ptr(coeff_plane),
            _build.ptr(qtable_natural), by * bx, bx, int(bits12),
            _build.ptr(out), _build.stream_of(out),
        )
    return out
