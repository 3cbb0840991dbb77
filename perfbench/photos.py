"""The source blocks of the benchmark's traffic: the quantised coefficients
of two 4:2:0 photographs, decoded once by the benchmark's reference
(`reference.decode_coefficients`) and kept in `data/photo_blocks.npz`, with
each source file's sha256 beside them, so that no run decodes them again.

    python -m perfbench.photos FILE.jpg ...   # writes data/photo_blocks.npz

The photographs (the repository's test corpus, tests/wild_files/SOURCES.txt):
`matplotlib_grace_hopper.jpg` (512x600, foreign encode, optimised Huffman
tables) and `transcoded/china_dri_rows1_420.jpg` (640x427, libjpeg q85, a
restart marker per MCU row).
"""

from __future__ import annotations

import hashlib
import sys
from pathlib import Path

import numpy as np

from . import reference

DATA = Path(__file__).resolve().parent / "data" / "photo_blocks.npz"


def make(paths, out: Path = DATA) -> None:
    arrays = {}
    for i, p in enumerate(paths):
        raw = Path(p).read_bytes()
        info, planes = reference.decode_coefficients(raw)
        if [c[1:3] for c in info["comps"]] != [(2, 2), (1, 1), (1, 1)]:
            raise ValueError(f"{p}: not 4:2:0")
        arrays[f"p{i}_name"] = np.array(Path(p).name)
        arrays[f"p{i}_sha256"] = np.array(hashlib.sha256(raw).hexdigest())
        arrays[f"p{i}_size"] = np.array([info["width"], info["height"]])
        arrays[f"p{i}_qt"] = np.stack([info["qt"][c[3]] for c in info["comps"][:2]])
        for name, plane in zip("ybr", planes):
            arrays[f"p{i}_{name}"] = plane
    arrays["count"] = np.array(len(paths))
    np.savez_compressed(out, **arrays)


class Photo:
    """One source photograph: its whole MCUs' planes (Y, Cb, Cr int16
    zigzag) and its two quant tables (zigzag order)."""

    def __init__(self, z, i: int):
        self.name = str(z[f"p{i}_name"])
        self.sha256 = str(z[f"p{i}_sha256"])
        w, h = (int(v) for v in z[f"p{i}_size"])
        self.mcus_x, self.mcus_y = w // 16, h // 16
        self.qts = z[f"p{i}_qt"]
        self.planes = [z[f"p{i}_{n}"][:self.mcus_y * f, :self.mcus_x * f]
                       for n, f in (("y", 2), ("b", 1), ("r", 1))]


def load(path: Path = DATA) -> list[Photo]:
    with np.load(path) as z:
        return [Photo(z, i) for i in range(int(z["count"]))]


if __name__ == "__main__":
    make(sys.argv[1:])
    print(DATA)
