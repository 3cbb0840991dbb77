"""The benchmark's one traffic generator: a traffic file's parameters and a
seed in, the pool of JPEG streams a run sends out, with what the reference
and the roofline arithmetic need to know of each.

Every image is 4:2:0 and made of whole MCUs of the source photographs
(`photos.py`), tiled to the image's size with a roll drawn from the seed,
so that every image of a pool is distinct and every seed gives the same
sizes and the same statistics. `layout` says how the two photographs meet:

- "halves": the top half of the MCU rows from one photograph, the bottom
  half from the other, each rolled by its own offset; the quant tables of
  image i are photograph i % 2's (two stage keys, as two cameras give).
- "alternate": image i is photograph i % 2 alone, rolled; every image takes
  the quant tables of photograph `tables` (one stage key: a data set
  re-encoded at one quality).

Two keys make a pool mixed, as a loader's data set is:

- "sizes", a list of [width, height], with "size_weights", in place of
  width and height: each size is given to its weight's share of the pool
  (largest remainders), and the seed deals the sizes out to the images.
  Every seed so decodes the same pixels, in another order.
- "tables": "per_image" with "quality": "lo-hi": each image draws a whole
  quality in lo..hi from the seed, and its DQT holds the Annex K tables
  scaled by libjpeg's rule for that quality (`quality_tables`), whatever
  the layout. The coefficients stay the photographs' quantised blocks,
  tiled and rolled as above: only the tables that dequantise them change.

Each key draws from a generator stream of its own (`rng_for`: 0 the rolls,
1 the check's reservoir, 2 the sizes, 3 the qualities), so a traffic file
without them gives the pool it gave before they existed, byte for byte.
Each image is packed with its own header, one packer call per size and
table set.

Traffic keys read here: width, height or sizes and size_weights,
restart_interval (MCUs, 0: none), layout, tables, quality, pool (images
made), and under "rehearse" the smaller sizes and pool of a CPU rehearsal.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import packer, photos, reference

COMPS_420 = ((1, 2, 2, 0), (2, 1, 1, 1), (3, 1, 1, 1))


@dataclasses.dataclass
class Image:
    data: bytes
    #: int16 zigzag planes (Y, Cb, Cr) at MCU padding
    coeffs: list
    #: the two quant tables, zigzag order
    qts: np.ndarray
    #: Huffman symbols coded
    symbols: int
    #: bytes of entropy-coded data (stuffing and restart markers included)
    scan_bytes: int
    width: int
    height: int

    @property
    def blocks(self) -> int:
        """Coefficient blocks of the image."""
        return sum(c.shape[0] * c.shape[1] for c in self.coeffs)

    @property
    def pixels(self) -> int:
        return self.width * self.height


@dataclasses.dataclass
class Pool:
    #: the images' one size; None where the pool mixes sizes
    width: int | None
    height: int | None
    restart_interval: int
    images: list


def rng_for(seed: int, stream: int = 0) -> np.random.Generator:
    """The run's generator for one purpose (`stream`), from any whole seed."""
    return np.random.default_rng([seed % (1 << 64), stream])


def _tile(photo: photos.Photo, dy: int, dx: int, rows: int, cols: int) -> list:
    """The photograph's MCUs rolled by (dy, dx) MCUs and repeated to rows x
    cols MCUs: its three planes."""
    out = []
    for plane, f in zip(photo.planes, (2, 1, 1)):
        p = np.roll(plane, (dy * f, dx * f), (0, 1))
        reps = (-(-rows * f // p.shape[0]), -(-cols * f // p.shape[1]), 1)
        out.append(np.tile(p, reps)[:rows * f, :cols * f])
    return out


#: ITU-T T.81 Annex K, Tables K.1 (luminance) and K.2 (chrominance): the
#: example quantisation tables, natural (row-major) order.
ANNEX_K_QT = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
     14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
     18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
     49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99],
    [17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
     24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99] + [99] * 32,
], dtype=np.int32)


def jpeg_quality_scaling(quality: int) -> int:
    """libjpeg's percentage scale of the Annex K tables for a quality 1..100
    (`jcparam.c`, jpeg_quality_scaling)."""
    q = min(max(int(quality), 1), 100)
    return 5000 // q if q < 50 else 200 - 2 * q


def quality_tables(quality: int) -> np.ndarray:
    """The luma and chroma tables libjpeg writes at `quality` with baseline
    forced (`jcparam.c`, jpeg_add_quant_table): (base * scale + 50) // 100,
    clamped to 1..255; int32 [2, 64], zigzag order."""
    q = (ANNEX_K_QT * jpeg_quality_scaling(quality) + 50) // 100
    return np.ascontiguousarray(np.clip(q, 1, 255)[:, reference.ZIGZAG])


def _sizes(t: dict, seed: int) -> list:
    """Each image's (width, height): the traffic's one size, or its sizes in
    the shares of their weights (largest remainders), dealt out by the seed."""
    n = t["pool"]
    if "sizes" not in t:
        return [(t["width"], t["height"])] * n
    sizes = [(int(w), int(h)) for w, h in t["sizes"]]
    share = np.asarray(t["size_weights"], np.float64)
    share = share / share.sum() * n
    counts = np.floor(share).astype(np.int64)
    counts[np.argsort(counts - share, kind="stable")[:n - counts.sum()]] += 1
    order = np.repeat(np.arange(len(sizes)), counts)
    return [sizes[k] for k in rng_for(seed, 2).permutation(order)]


def _qualities(t: dict, seed: int) -> list | None:
    """Each image's quality, drawn from the seed, where the tables are per
    image; else None."""
    if t.get("tables") != "per_image":
        return None
    lo, hi = (int(v) for v in t["quality"].split("-"))
    return [int(q) for q in rng_for(seed, 3).integers(lo, hi + 1, size=t["pool"])]


def make_pool(traffic: dict, seed: int, rehearse: bool = False) -> Pool:
    t = {**traffic, **(traffic.get("rehearse", {}) if rehearse else {})}
    ri = t["restart_interval"]
    sizes = _sizes(t, seed)
    quality = _qualities(t, seed)
    srcs = photos.load()
    rng = rng_for(seed)
    images, tables = [], []
    for i, (width, height) in enumerate(sizes):
        mx, my = -(-width // 16), -(-height // 16)
        offs = [(int(rng.integers(s.mcus_y)), int(rng.integers(s.mcus_x))) for s in srcs]
        if t["layout"] == "halves":
            top = _tile(srcs[i % 2], *offs[i % 2], my // 2, mx)
            bottom = _tile(srcs[1 - i % 2], *offs[1 - i % 2], my - my // 2, mx)
            planes = [np.concatenate([a, b]) for a, b in zip(top, bottom)]
            qts = srcs[i % 2].qts
        elif t["layout"] == "alternate":
            planes = _tile(srcs[i % 2], *offs[i % 2], my, mx)
            qts = None if quality else srcs[t["tables"]].qts
        else:
            raise ValueError(f"unknown layout {t['layout']!r}")
        images.append(planes)
        tables.append(quality_tables(quality[i]) if quality else qts)
    pool: list = [None] * len(sizes)
    # one packer call per size and table set keeps each call's images alike
    groups: dict = {}
    for i, (size, q) in enumerate(zip(sizes, tables)):
        groups.setdefault((size, q.tobytes()), []).append(i)
    for (size, _), idx in groups.items():
        qts = tables[idx[0]]
        streams, symbols = packer.pack_420([images[i] for i in idx], *size, qts, ri)
        head = len(packer.header(*size, qts, ri))
        for i, s, n in zip(idx, streams, symbols):
            pool[i] = Image(s, images[i], qts, n, len(s) - head - 2, *size)
    width, height = sizes[0] if len(set(sizes)) == 1 else (None, None)
    return Pool(width, height, ri, pool)
