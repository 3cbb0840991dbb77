"""NumPy/LUT host entropy backend — no native toolchain required.

Same scan-loop logic as the oracle (core/oracle.py — the two share one
implementation via pluggable readers/tables), but each Huffman symbol
resolves through a flat 16-bit LUT with a byte-addressed reader
(io/bitstream.FastBitReader) instead of the reference-mirroring bit-by-bit
walk. Several times faster than the oracle; the native C++ runtime
(native/runtime.py) is faster still and is the default.
"""

from __future__ import annotations

import numpy as np

from ..io import bitstream as bsio
from ..io.markers import Encoding
from ..utils.config import DecodeConfig
from .huffman import flat_lut_for_spec
from .driver import run_scans
from .types import CoefficientPlanes, HuffTableSpec, JpegStructure
from . import oracle


def _lut_table(spec: HuffTableSpec):
    return flat_lut_for_spec(spec)  # content-cached across images


def _decode_scan(structure, scan, planes):
    fn = (
        oracle.decode_progressive_scan
        if structure.frame.process == Encoding.PROGRESSIVE_DCT
        else oracle.decode_sequential_scan
    )
    fn(structure, scan, planes,
       reader_cls=bsio.FastBitReader, make_table=_lut_table)


def entropy_decode(
    structure: JpegStructure,
    cfg: DecodeConfig,
    planes: CoefficientPlanes | None = None,
):
    """All scans -> (CoefficientPlanes, qtid -> natural-order table)."""
    if planes is None:
        planes = CoefficientPlanes(structure.frame)
    qts = run_scans(structure, planes, _decode_scan)
    return planes, qts
