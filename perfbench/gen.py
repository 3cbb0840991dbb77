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

Traffic keys read here: width, height, restart_interval (MCUs, 0: none),
layout, tables, pool (images made), and under "rehearse" the smaller
width, height and pool of a CPU rehearsal.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import packer, photos

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


@dataclasses.dataclass
class Pool:
    width: int
    height: int
    restart_interval: int
    images: list

    @property
    def blocks(self) -> int:
        """Coefficient blocks of one image."""
        return sum(c.shape[0] * c.shape[1] for c in self.images[0].coeffs)


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


def make_pool(traffic: dict, seed: int, rehearse: bool = False) -> Pool:
    t = {**traffic, **(traffic.get("rehearse", {}) if rehearse else {})}
    width, height, ri = t["width"], t["height"], t["restart_interval"]
    mx, my = -(-width // 16), -(-height // 16)
    srcs = photos.load()
    rng = rng_for(seed)
    images, tables = [], []
    for i in range(t["pool"]):
        offs = [(int(rng.integers(s.mcus_y)), int(rng.integers(s.mcus_x))) for s in srcs]
        if t["layout"] == "halves":
            top = _tile(srcs[i % 2], *offs[i % 2], my // 2, mx)
            bottom = _tile(srcs[1 - i % 2], *offs[1 - i % 2], my - my // 2, mx)
            planes = [np.concatenate([a, b]) for a, b in zip(top, bottom)]
            qts = srcs[i % 2].qts
        elif t["layout"] == "alternate":
            planes = _tile(srcs[i % 2], *offs[i % 2], my, mx)
            qts = srcs[t["tables"]].qts
        else:
            raise ValueError(f"unknown layout {t['layout']!r}")
        images.append(planes)
        tables.append(qts)
    pool = []
    # one packer call per table set keeps each call's images alike
    for qkey in {q.tobytes() for q in tables}:
        idx = [i for i, q in enumerate(tables) if q.tobytes() == qkey]
        qts = tables[idx[0]]
        streams, symbols = packer.pack_420([images[i] for i in idx], width, height, qts, ri)
        head = len(packer.header(width, height, qts, ri))
        pool += [(i, Image(s, images[i], qts, n, len(s) - head - 2))
                 for i, s, n in zip(idx, streams, symbols)]
    return Pool(width, height, ri, [im for _, im in sorted(pool, key=lambda p: p[0])])
