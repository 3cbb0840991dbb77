"""The benchmark's plain reference decoder: what a baseline JPEG of the
benchmark's traffic decodes to, worked out again from the inputs.

It imports numpy and torch and nothing of the program. Two halves:

- `parse` and `decode_coefficients`: a bit-serial Huffman decoder of
  baseline sequential streams in plain Python (restart markers included).
  It made `data/photo_blocks.npz` from the two source photographs, and the
  tests use it to show that the benchmark's packer writes what it was given.
- `rgb_nn` and `rgb_fancy`: dequantisation, the reference C decoder's IDCT
  (float32 storage, float64 arithmetic; `dct.c` `fast_2didct`,
  `fast_idct_new`), nearest-neighbour or triangular ("fancy") chroma
  upsampling and the BT.601 colour conversion with the C decoder's
  truncating store, under the REFERENCE quirks. Written with torch
  operations one at a time, so that every rounding falls where the C code
  puts it, on the CPU or on the card alike (float64 adds and multiplies are
  correctly rounded on both, and eager torch fuses none of them).

The arithmetic is a frozen copy of the program's EXACT numerics as they
stood when the benchmark was written; a later change to the program does
not move it.
"""

from __future__ import annotations

import re
import struct

import numpy as np
import torch


def _make_zigzag() -> np.ndarray:
    order = []
    for s in range(15):
        rows = range(s, -1, -1) if s % 2 == 0 else range(s + 1)
        order += [r * 8 + (s - r) for r in rows if r < 8 and s - r < 8]
    return np.array(order, dtype=np.int64)


#: ZIGZAG[i]: the natural (row-major) index of the i-th zigzag coefficient.
ZIGZAG = _make_zigzag()
#: INV_ZIGZAG[n]: the zigzag position of natural index n.
INV_ZIGZAG = np.argsort(ZIGZAG)


# ---------------------------------------------------------------------------
# Stream structure and the Huffman decode
# ---------------------------------------------------------------------------


def parse(data: bytes) -> dict:
    """The markers of a single-scan baseline stream: width, height,
    components (id, h, v, quant table), quant tables (zigzag order),
    Huffman tables ((class, id) -> (counts, symbols)), the restart
    interval, the scan's (component index, dc table, ac table) and the
    offset of its entropy-coded data."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG stream")
    info = {"qt": {}, "huff": {}, "ri": 0}
    i = 2
    while i < len(data):
        if data[i] != 0xFF:
            raise ValueError(f"marker expected at {i}")
        marker = data[i + 1]
        length = struct.unpack(">H", data[i + 2:i + 4])[0]
        body = data[i + 4:i + 2 + length]
        if marker == 0xDB:
            j = 0
            while j < len(body):
                pq, tq = body[j] >> 4, body[j] & 15
                if pq:
                    raise ValueError("16-bit quant tables are not baseline")
                info["qt"][tq] = np.frombuffer(body[j + 1:j + 65], np.uint8).astype(np.int32)
                j += 65
        elif marker == 0xC4:
            j = 0
            while j < len(body):
                tc, th = body[j] >> 4, body[j] & 15
                counts = list(body[j + 1:j + 17])
                n = sum(counts)
                info["huff"][(tc, th)] = (counts, list(body[j + 17:j + 17 + n]))
                j += 17 + n
        elif marker == 0xC0:
            precision, h, w, nc = struct.unpack(">BHHB", body[:6])
            if precision != 8:
                raise ValueError("8-bit baseline only")
            info["height"], info["width"] = h, w
            info["comps"] = [(body[6 + 3 * k], body[7 + 3 * k] >> 4, body[7 + 3 * k] & 15,
                              body[8 + 3 * k]) for k in range(nc)]
        elif marker == 0xDD:
            info["ri"] = struct.unpack(">H", body[:2])[0]
        elif marker == 0xDA:
            ns = body[0]
            ids = [c[0] for c in info["comps"]]
            info["scan"] = [(ids.index(body[1 + 2 * k]), body[2 + 2 * k] >> 4,
                             body[2 + 2 * k] & 15) for k in range(ns)]
            info["data_at"] = i + 2 + length
            return info
        elif marker in (0xC1, 0xC2, 0xC3) or 0xC5 <= marker <= 0xCF and marker != 0xC8:
            raise ValueError(f"not a baseline sequential stream (SOF {marker:#x})")
        i += 2 + length
    raise ValueError("no scan")


def mcu_layout(info: dict) -> tuple[int, int, list[tuple[int, int]]]:
    """(MCUs across, MCUs down, each component's (blocks down, blocks
    across) at MCU padding) of an interleaved frame."""
    hmax = max(c[1] for c in info["comps"])
    vmax = max(c[2] for c in info["comps"])
    mx = -(-info["width"] // (8 * hmax))
    my = -(-info["height"] // (8 * vmax))
    return mx, my, [(my * c[2], mx * c[1]) for c in info["comps"]]


def _lookup(counts, symbols) -> list:
    """A 16-bit lookup: for every 16-bit window, (symbol, code length), or
    None where no code starts the window."""
    lut: list = [None] * 65536
    code = k = 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            lo = code << (16 - length)
            lut[lo:lo + (1 << (16 - length))] = [(symbols[k], length)] * (1 << (16 - length))
            code += 1
            k += 1
        code <<= 1
    return lut


def _segments(data: bytes, start: int) -> list[str]:
    """The scan's restart segments from `start` to EOI, unstuffed, each as
    a string of '0'/'1' padded with ones."""
    end = data.index(b"\xff\xd9", start)
    parts = re.split(rb"\xff[\xd0-\xd7]", data[start:end])
    return ["".join(f"{b:08b}" for b in p.replace(b"\xff\x00", b"\xff")) + "1" * 32
            for p in parts]


def decode_coefficients(data: bytes) -> tuple[dict, list[np.ndarray]]:
    """Every component's quantised coefficients, int16 [blocks down,
    blocks across, 64] in zigzag order at MCU padding, of a single-scan
    interleaved baseline stream."""
    info = parse(data)
    mx, my, shapes = mcu_layout(info)
    planes = [np.zeros((by, bx, 64), np.int16) for by, bx in shapes]
    luts = {key: _lookup(*spec) for key, spec in info["huff"].items()}
    comps = info["comps"]
    scan = info["scan"]
    total = mx * my
    ri = info["ri"] or total
    segs = _segments(data, info["data_at"])
    if len(segs) != -(-total // ri):
        raise ValueError(f"{len(segs)} restart segments, {-(-total // ri)} expected")
    for s, bits in enumerate(segs):
        pos = 0
        pred = [0] * len(comps)
        for m in range(s * ri, min(total, (s + 1) * ri)):
            mcu_y, mcu_x = divmod(m, mx)
            for ci, td, ta in scan:
                _, h, v, _ = comps[ci]
                dc_lut, ac_lut = luts[(0, td)], luts[(1, ta)]
                for by in range(v):
                    for bx in range(h):
                        blk = planes[ci][mcu_y * v + by, mcu_x * h + bx]
                        sym, n = dc_lut[int(bits[pos:pos + 16], 2)]
                        pos += n
                        diff = 0
                        if sym:
                            diff = int(bits[pos:pos + sym], 2)
                            if diff < 1 << (sym - 1):
                                diff -= (1 << sym) - 1
                            pos += sym
                        pred[ci] += diff
                        blk[0] = pred[ci]
                        k = 1
                        while k < 64:
                            sym, n = ac_lut[int(bits[pos:pos + 16], 2)]
                            pos += n
                            run, size = sym >> 4, sym & 15
                            if size == 0:
                                if run != 15:
                                    break
                                k += 16
                                continue
                            k += run
                            val = int(bits[pos:pos + size], 2)
                            if val < 1 << (size - 1):
                                val -= (1 << size) - 1
                            pos += size
                            blk[k] = val
                            k += 1
    return info, planes


# ---------------------------------------------------------------------------
# Pixels (REFERENCE quirks, EXACT)
# ---------------------------------------------------------------------------

F32 = torch.float32
F64 = torch.float64


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(F32)


def _d(x: torch.Tensor) -> torch.Tensor:
    return x.to(F64)


def _idct8(v: torch.Tensor) -> torch.Tensor:
    """One `fast_idct_new` pass over the last axis of float32 `v`: a sum or
    difference of two floats is a float32 operation, a product with a
    double constant a float64 one, and every assignment stores float32."""
    d = _d(v)
    t0 = _f32(1.414213562 * d[..., 0])
    t1 = v[..., 4]
    t2 = v[..., 2]
    t3 = v[..., 6]
    t4 = _f32(0.5 * _d(v[..., 1] - v[..., 7]))
    t5 = _f32(0.707106781 * d[..., 3])
    t6 = _f32(0.707106781 * d[..., 5])
    t7 = _f32(0.5 * _d(v[..., 1] + v[..., 7]))
    u0 = _f32(0.5 * _d(t0 + t1))
    u1 = _f32(0.5 * _d(t0 - t1))
    u2 = _f32(0.707106781 * (0.38268343236 * _d(t2) + -0.92387953251 * _d(t3)))
    u3 = _f32(0.707106781 * (0.92387953251 * _d(t2) + 0.38268343236 * _d(t3)))
    u4 = _f32(0.5 * _d(t4 + t6))
    u5 = _f32(0.5 * _d(-t5 + t7))
    u6 = _f32(0.5 * _d(t4 - t6))
    u7 = _f32(0.5 * _d(t5 + t7))
    w0 = _f32(0.5 * _d(u0 + u3))
    w1 = _f32(0.5 * _d(u1 + u2))
    w2 = _f32(0.5 * _d(u1 - u2))
    w3 = _f32(0.5 * _d(u0 - u3))
    w4 = _f32(0.8314696123 * _d(u4) + -0.55557023302 * _d(u7))
    w5 = _f32(0.9807852804 * _d(u5) + -0.19509032201 * _d(u6))
    w6 = _f32(0.19509032201 * _d(u5) + 0.9807852804 * _d(u6))
    w7 = _f32(0.55557023302 * _d(u4) + 0.8314696123 * _d(u7))
    s = 1.414213562 * 2
    return torch.stack([
        _f32(s * _d(w0 + w7)), _f32(s * _d(w1 + w6)),
        _f32(s * _d(w2 + w5)), _f32(s * _d(w3 + w4)),
        _f32(s * _d(w3 - w4)), _f32(s * _d(w2 - w5)),
        _f32(s * _d(w1 - w6)), _f32(s * _d(w0 - w7)),
    ], dim=-1)


def idct_exact(natural: torch.Tensor) -> torch.Tensor:
    """`fast_2didct` over [N, 8, 8] dequantised natural-order coefficients:
    uint8 [N, 8, 8] samples."""
    x = natural.to(F32)
    x[:, 0, :] = _f32(0.707106781 * _d(x[:, 0, :]))
    x[:, :, 0] = _f32(0.707106781 * _d(x[:, :, 0]))
    x = _idct8(x)
    x = _idct8(x.transpose(1, 2).contiguous()).transpose(1, 2)
    r = 0.25 * _d(x) + 128.0
    return torch.trunc(torch.clamp(r, 0.0, 255.0)).to(torch.uint8)


def pixel_plane(zz: torch.Tensor, qt_zz: np.ndarray) -> torch.Tensor:
    """One component's uint8 samples [blocks down * 8, blocks across * 8]
    from its int16 zigzag coefficients [by, bx, 64] and its quant table in
    zigzag order."""
    by, bx, _ = zz.shape
    dev = zz.device
    inv = torch.as_tensor(INV_ZIGZAG, device=dev)
    qt = torch.as_tensor(np.asarray(qt_zz, np.int32)[INV_ZIGZAG], device=dev)
    natural = zz.reshape(-1, 64).to(torch.int32)[:, inv] * qt
    pix = idct_exact(natural.reshape(-1, 8, 8))
    return pix.reshape(by, bx, 8, 8).permute(0, 2, 1, 3).reshape(by * 8, bx * 8)


def _nn_index(n_out: int, ratio: np.float32) -> np.ndarray:
    """(uint32)(i * ratio) with a float32 multiply: the C decoder's
    nearest-neighbour index."""
    i = np.arange(n_out, dtype=np.uint32).astype(np.float32)
    return (i * ratio).astype(np.uint32).astype(np.int64)


def _store(ch: torch.Tensor) -> torch.Tensor:
    """The compiled C decoder's store: truncate, saturate to [0, 255]."""
    return torch.clamp(torch.trunc(ch), 0.0, 255.0).to(torch.uint8)


def ycbcr_to_rgb(y8: torch.Tensor, cb8: torch.Tensor, cr8: torch.Tensor) -> torch.Tensor:
    """BT.601 with the C decoder's double constants, float32 R, G, B."""
    y = _d(y8)
    cb = _d(cb8) - 128.0
    cr = _d(cr8) - 128.0
    r = _f32(y + 1.402 * cr)
    g = _f32(y - 0.34414 * cb - 0.71414 * cr)
    b = _f32(y + 1.772 * cb)
    return torch.stack([_store(r), _store(g), _store(b)], dim=-1)


def _sampling(comps) -> tuple[int, int]:
    return max(c[1] for c in comps), max(c[2] for c in comps)


def rgb_nn(width: int, height: int, comps, planes: list[torch.Tensor]) -> torch.Tensor:
    """uint8 [height, width, 3] of three components' sample planes under
    the C decoder's nearest-neighbour rule: row index (uint32)(i * v/vmax)
    and column index (uint32)(j * h/hmax) in float32, into the plane."""
    hmax, vmax = _sampling(comps)
    chans = []
    for (_, h, v, _), p in zip(comps, planes):
        rows = _nn_index(height, np.float32(v) / np.float32(vmax))
        cols = _nn_index(width, np.float32(h) / np.float32(hmax))
        rows_t = torch.as_tensor(rows, device=p.device)
        cols_t = torch.as_tensor(cols, device=p.device)
        chans.append(p[rows_t][:, cols_t])
    return ycbcr_to_rgb(*chans)


def fancy_upsample(plane: torch.Tensor, h: int, v: int, hmax: int, vmax: int) -> torch.Tensor:
    """libjpeg's triangular 2x upsampling of a whole sample plane, in
    float64 (every intermediate is an integer sum under 2**14 scaled by a
    power of two, so exact), edges replicated, floored once at the end."""
    x = _d(plane)
    if 2 * h == hmax:
        left = torch.cat([x[:, :1], x[:, :-1]], dim=1)
        right = torch.cat([x[:, 1:], x[:, -1:]], dim=1)
        even = (3.0 * x + left + 1.0) * 0.25
        odd = (3.0 * x + right + 2.0) * 0.25
        x = torch.stack([even, odd], dim=2).reshape(x.shape[0], -1)
    if 2 * v == vmax:
        up = torch.cat([x[:1], x[:-1]], dim=0)
        down = torch.cat([x[1:], x[-1:]], dim=0)
        even = (3.0 * x + up + 1.0) * 0.25
        odd = (3.0 * x + down + 2.0) * 0.25
        x = torch.stack([even, odd], dim=1).reshape(-1, x.shape[1])
    return torch.clamp(torch.floor(x), 0.0, 255.0).to(torch.uint8)


def rgb_fancy(width: int, height: int, comps, planes: list[torch.Tensor]) -> torch.Tensor:
    """uint8 [height, width, 3] of three components' sample planes with
    fancy upsampling of the 2x ratios, each upsampled plane cut to the
    frame, then the same colour conversion."""
    hmax, vmax = _sampling(comps)
    chans = []
    for (_, h, v, _), p in zip(comps, planes):
        if (2 * h != hmax and h != hmax) or (2 * v != vmax and v != vmax):
            raise ValueError("fancy upsampling of 1x and 2x ratios only")
        chans.append(fancy_upsample(p, h, v, hmax, vmax)[:height, :width])
    return ycbcr_to_rgb(*chans)


def decode_rgb(width: int, height: int, comps, coeffs: list[torch.Tensor],
               qts_zz: list[np.ndarray], upsample: str) -> torch.Tensor:
    """The RGB of one frame from its components' zigzag coefficient planes
    and quant tables (one a component, zigzag order)."""
    planes = [pixel_plane(c, q) for c, q in zip(coeffs, qts_zz)]
    if upsample == "fancy":
        return rgb_fancy(width, height, comps, planes)
    return rgb_nn(width, height, comps, planes)
