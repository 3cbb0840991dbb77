"""Inputs for the port's card checks and benchmarks, made without JAX or
Pillow, and what their blocks look like to an entropy decoder.

    python -m jpeg_decoder_tpu_torch.benchmarks.inputs [file.jpg ...]

Two kinds of stream, both packed by the port's native runtime with the
Annex K Huffman tables:

- `make_jpeg`: random coefficients. Every block is dense (about 50 nonzero
  coefficients, an end-of-block code in one block of eight), which no
  camera produces: the worst ground for a decoder that resynchronises.
- `photo_jpeg`: the quantised coefficients of a real photograph, read from
  its file by the port's native host decoder and tiled whole MCUs at a time
  to the size asked for, with the file's own sampling factors and
  quantisation tables. Nothing is modelled: every block is a block the
  photograph's encoder wrote.

`PHOTOS` are photographs that ship with the repository's test corpus
(tests/wild_files/SOURCES.txt): `sklearn_china.jpg` (640x427, 4:4:4) and
`matplotlib_grace_hopper.jpg` (512x600, 4:2:0), both foreign encodes;
`DRI_FILES` are libjpeg-turbo's re-encodes with restart markers, streams
that K2 takes as they are.

Run as a script it prints `block_stats` of each file named (default: the
files above), of `PHOTOS_420` tiled to 3840x2160, and of a `make_jpeg` frame:
nonzero AC coefficients per block, the share of blocks that end with an
end-of-block code, and entropy-coded bits per block. It needs no card.
"""

from __future__ import annotations

import json
import struct
import sys
from pathlib import Path

import numpy as np

_WILD = Path(__file__).resolve().parents[2] / "tests" / "wild_files"
PHOTOS = (_WILD / "sklearn_china.jpg", _WILD / "matplotlib_grace_hopper.jpg")
#: Files a foreign encoder wrote with restart markers, which K2 takes as
#: they are: the first photograph re-encoded (q85, 4:2:0, a marker per MCU
#: row) and a drawing (q85, 4:2:2, a marker every 7 MCUs).
DRI_FILES = (_WILD / "transcoded" / "china_dri_rows1_420.jpg",
             _WILD / "transcoded" / "flower_dri_blocks7_422.jpg")
#: The two 4:2:0 photographs that the card checks tile to 3840x2160.
PHOTOS_420 = (DRI_FILES[0], PHOTOS[1])
#: A 4-component photograph (512x600 4:4:4, Adobe APP14 transform 0: raw
#: CMYK, which the reference decodes as YCCK), re-encoded from
#: PHOTOS[1] (tests/wild_files/SOURCES.txt); the card checks tile it to
#: 3840x2160.
CMYK_FILE = _WILD / "transcoded" / "hopper_cmyk_adobe.jpg"
F420 = ((2, 2), (1, 1), (1, 1))
#: The repository's gigapixel frame (benchmarks/gigapixel_stripes.py's
#: default): 16384 x 32768, 0.537 gigapixels, 4:2:0.
GIGAPIXEL = (16384, 32768)


def adobe_app14(transform: int) -> bytes:
    """An Adobe APP14 segment (DCTEncode version 100, no flags) with colour
    transform `transform`: for a 4-component frame 0 is raw (inverted)
    CMYK and 2 YCCK (io/parser._attach_adobe)."""
    payload = b"Adobe" + struct.pack(">HHHB", 100, 0, 0, transform)
    return b"\xff\xee" + struct.pack(">H", 2 + len(payload)) + payload


def pack_jpeg(planes, w: int, h: int, factors, ri: int, qts,
              adobe_transform: int | None = None, precision: int = 8) -> bytes:
    """A baseline JPEG of the int16 zigzag block planes `planes` (per
    component [blocks_y, blocks_x, 64] at MCU padding): component 0 with the
    Annex K luminance Huffman tables and qts[0], the others (1 to 3 of
    them) with the chrominance tables and qts[1]; restart interval `ri`
    MCUs (0: none); an Adobe APP14 marker with `adobe_transform` unless it
    is None. `precision` 12 writes an extended sequential (SOF1) frame of
    12-bit samples (the Annex K tables take DC differences up to 2047 and
    AC values up to 1023)."""
    from ..core import huffman
    from ..io import writer
    from ..native import runtime

    if not runtime.available():
        raise RuntimeError("the native runtime did not build")
    hmax = max(f[0] for f in factors)
    vmax = max(f[1] for f in factors)
    mcus_x, mcus_y = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    # models/encoder._unit_layout: (comp, fh, fv, j, k, sci, dc, ac)
    rows = [(ci, fh, fv, j, k, ci, min(ci, 1), min(ci, 1))
            for ci, (fh, fv) in enumerate(factors)
            for j in range(fv) for k in range(fh)]
    n_tab = 1 if len(factors) == 1 else 2
    dc_specs = [huffman.annex_k_dc_luminance(), huffman.annex_k_dc_chrominance()][:n_tab]
    ac_specs = [huffman.annex_k_ac_luminance(), huffman.annex_k_ac_chrominance()][:n_tab]
    entropy = runtime.encode_scan_planes(
        [np.ascontiguousarray(p, dtype=np.int16) for p in planes],
        mcus_x, mcus_x * mcus_y, np.asarray(rows, dtype=np.int32),
        [huffman.build_encode_table(s) for s in dc_specs],
        [huffman.build_encode_table(s) for s in ac_specs], ri,
    )
    parts = [writer.soi()]
    if adobe_transform is not None:
        parts.append(adobe_app14(adobe_transform))
    parts += [writer.dqt(i, q) for i, q in enumerate(qts[:n_tab])]
    parts.append(writer.sof(
        w, h, [(ci + 1, fh, fv, min(ci, 1)) for ci, (fh, fv) in enumerate(factors)],
        precision=precision, marker=0xC0 if precision == 8 else 0xC1))
    parts += [writer.dht(s) for s in dc_specs + ac_specs]
    if ri:
        parts.append(writer.dri(ri))
    parts.append(writer.sos([(ci + 1, min(ci, 1), min(ci, 1))
                             for ci in range(len(factors))]))
    parts += [entropy, writer.eoi()]
    return b"".join(parts)


def _random_planes(w: int, h: int, factors, seed: int, gradient: bool = False):
    """make_jpeg's coefficient planes at MCU padding. `gradient`: a DC ramp
    across the block columns (+-2 of noise) and AC Laplace(1) in the first
    two zigzag positions alone, a few symbols a block."""
    rng = np.random.default_rng(seed)
    hmax = max(f[0] for f in factors)
    vmax = max(f[1] for f in factors)
    mcus_x, mcus_y = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    planes = []
    for fh, fv in factors:
        shape = (mcus_y * fv, mcus_x * fh, 64)
        if gradient:
            p = np.zeros(shape)
            p[..., 1:3] = np.clip(np.rint(rng.laplace(0.0, 1.0, shape[:2] + (2,))), -1023, 1023)
            ramp = np.rint(-60 + 120 * np.arange(shape[1]) / max(1, shape[1] - 1))
            p[..., 0] = np.clip(ramp[None, :] + rng.integers(-2, 3, shape[:2]), -60, 60)
        else:
            p = np.clip(np.rint(rng.laplace(0.0, 4.0, shape)), -1023, 1023)
            p[..., 0] = rng.integers(-60, 61, shape[:2])
        planes.append(p.astype(np.int16))
    return planes


def _standard_qts():
    from ..core import types

    return [types.standard_luminance_qtable(), types.standard_chrominance_qtable()]


def make_jpeg(w: int, h: int, factors, ri: int, seed: int,
              adobe_transform: int | None = None, precision: int = 8,
              gradient: bool = False) -> bytes:
    """A baseline JPEG of random coefficients: DC in [-60, 60], AC
    Laplace(4) rounded and clipped to +-1023, so every DC difference and AC
    value lies in the Annex K categories; the Annex K quantisation tables.
    1, 3 or 4 components (`factors`); an Adobe APP14 marker with
    `adobe_transform` unless it is None; 8- or 12-bit samples
    (`precision`). `gradient`: sparse blocks instead (a DC ramp, two small
    AC values), whose plain lockstep decode takes a few steps a block."""
    return pack_jpeg(_random_planes(w, h, factors, seed, gradient), w, h, factors, ri,
                     _standard_qts(), adobe_transform, precision)


def multiscan_jpeg(w: int, h: int, factors, seed: int, gradient: bool = False) -> bytes:
    """make_jpeg's coefficients (no restart markers, 8-bit, 3 components:
    component 0 with the Annex K luminance tables, the others with the
    chrominance ones) in a sequential frame of one non-interleaved scan a
    component, the multi-scan sequential shape (spec B.2.3): a scan codes
    its component's own ceil(x / 8) x ceil(y / 8) blocks and leaves the
    MCU padding zero."""
    from ..core import huffman
    from ..io import writer
    from ..native import runtime

    if not runtime.available():
        raise RuntimeError("the native runtime did not build")
    hmax = max(f[0] for f in factors)
    vmax = max(f[1] for f in factors)
    dc_specs = [huffman.annex_k_dc_luminance(), huffman.annex_k_dc_chrominance()]
    ac_specs = [huffman.annex_k_ac_luminance(), huffman.annex_k_ac_chrominance()]
    parts = [writer.soi(), *[writer.dqt(i, q) for i, q in enumerate(_standard_qts())],
             writer.sof(w, h, [(ci + 1, fh, fv, min(ci, 1))
                               for ci, (fh, fv) in enumerate(factors)]),
             *[writer.dht(s) for s in dc_specs + ac_specs]]
    for ci, ((fh, fv), plane) in enumerate(zip(factors, _random_planes(w, h, factors, seed,
                                                                        gradient))):
        t = min(ci, 1)
        bx = -(-(-(-w * fh // hmax)) // 8)
        by = -(-(-(-h * fv // vmax)) // 8)
        parts.append(writer.sos([(ci + 1, t, t)]))
        parts.append(runtime.encode_scan_planes(
            [np.ascontiguousarray(plane[:by, :bx])], bx, bx * by,
            np.array([(0, 1, 1, 0, 0, 0, 0, 0)], dtype=np.int32),
            [huffman.build_encode_table(dc_specs[t])],
            [huffman.build_encode_table(ac_specs[t])], 0))
    parts.append(writer.eoi())
    return b"".join(parts)


def photo_jpeg(path, w: int, h: int, ri: int, shift: int = 0) -> bytes:
    """The photograph in the file `path` (8-bit, gray or three or four
    components, the components after the first sharing their table) as a
    w x h baseline JPEG: its coefficient planes, as its encoder quantised
    them, cut to the whole MCUs that lie inside the picture and repeated to
    fill the frame; `shift` rolls the tiling by that many MCUs each way,
    which gives several requests of the same statistics. Its own sampling
    factors, quantisation tables and Adobe colour transform (a
    4-component file's APP14 marker, e.g. tests/wild_files/transcoded/
    hopper_cmyk_adobe.jpg); restart interval `ri` MCUs."""
    from .. import DecodeConfig
    from ..models import host

    frame, coeffs, qts = host.host_decode(Path(path).read_bytes(), DecodeConfig())
    comps = frame.components
    if (frame.precision != 8 or len(comps) not in (1, 3, 4)
            or len({c.qtid for c in comps[1:]}) > 1):
        raise ValueError(f"{path}: not an 8-bit photograph of 1, 3 or 4 components"
                         " whose components after the first share a table")
    factors = tuple((c.hsf, c.vsf) for c in comps)
    hmax, vmax = frame.max_hsf, frame.max_vsf
    src_x, src_y = frame.width // (8 * hmax), frame.height // (8 * vmax)
    mcus_x, mcus_y = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    planes = []
    for c, plane in zip(comps, coeffs.planes):
        tile = np.roll(plane[: src_y * c.vsf, : src_x * c.hsf],
                       (shift * c.vsf, shift * c.hsf), (0, 1))
        # the tiling in one allocation of the frame's size (a gigapixel
        # frame's planes are 1.6 GB)
        by, bx = mcus_y * c.vsf, mcus_x * c.hsf
        planes.append(np.pad(tile, ((0, max(0, by - tile.shape[0])),
                                    (0, max(0, bx - tile.shape[1])), (0, 0)),
                             mode="wrap")[:by, :bx])
    adobe = frame.adobe_transform if len(comps) == 4 else None
    return pack_jpeg(planes, w, h, factors, ri, [qts[c.qtid] for c in comps[:2]], adobe)


def gigapixel_jpeg(w: int = GIGAPIXEL[0], h: int = GIGAPIXEL[1]) -> bytes:
    """The gigapixel input of striped and streamed decode: the first 4:2:0
    photograph's coefficients (PHOTOS_420[0], china_dri_rows1_420.jpg)
    tiled to w x h by photo_jpeg, with a restart marker per MCU row (the
    restart interval is the MCU row's width, as benchmarks/
    gigapixel_stripes.py writes it), so that the host's entropy stage runs
    stripe by stripe."""
    return photo_jpeg(PHOTOS_420[0], w, h, -(-w // 16))


def block_stats(data: bytes) -> dict:
    """What a single-scan sequential stream's blocks ask of an entropy
    decoder: nonzero AC coefficients per block (mean and median), the share
    of blocks that end with an end-of-block code (their last zigzag
    coefficient is zero), and entropy-coded bits per block (the scan's
    bytes, stuffing and markers included)."""
    from .. import DecodeConfig
    from ..io.parser import parse
    from ..models import host

    frame, coeffs, _ = host.host_decode(data, DecodeConfig())
    span = parse(data).scans[0].span
    # the blocks the scan codes: every component at MCU padding
    nonzero = np.concatenate([np.count_nonzero(p[..., 1:], axis=-1).ravel()
                              for p in coeffs.planes])
    eob = np.concatenate([(p[..., 63] == 0).ravel() for p in coeffs.planes])
    return dict(width=frame.width, height=frame.height,
                sampling=[(c.hsf, c.vsf) for c in frame.components],
                blocks=int(nonzero.size), scan_bytes=int(span.end - span.start),
                nonzero_ac_per_block=round(float(nonzero.mean()), 2),
                median_nonzero_ac=float(np.median(nonzero)),
                share_blocks_with_eob=round(float(eob.mean()), 4),
                bits_per_block=round(8 * (span.end - span.start) / nonzero.size, 1))


def main(argv=None) -> None:
    paths = [Path(a) for a in (sys.argv[1:] if argv is None else argv)]
    for path in paths or PHOTOS + DRI_FILES:
        print(json.dumps(dict(input=path.name, **block_stats(path.read_bytes()))), flush=True)
    for path in paths or PHOTOS_420:
        print(json.dumps(dict(input=f"photo_jpeg({path.name}, 3840, 2160, 240)",
                              **block_stats(photo_jpeg(path, 3840, 2160, 240)))), flush=True)
    print(json.dumps(dict(input="make_jpeg(3840, 2160, 4:2:0, 240, seed 20261016)",
                          **block_stats(make_jpeg(3840, 2160, F420, 240, 20261016)))),
          flush=True)


if __name__ == "__main__":
    main()
