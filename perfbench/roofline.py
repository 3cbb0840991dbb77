"""The least time one NVIDIA H100 could take for the work of a run's
images, layer by layer: the larger of the bytes over the memory's
bandwidth and the operations over their type's peak. Each input byte is
counted read once and each output byte written once, whatever a kernel
reads again; the work is counted on the run's own inputs.

Peaks: NVIDIA's data sheet for the H100 SXM (80 GB HBM3 at 3.35 TB/s,
67 TFLOP/s float32 outside the tensor cores, half that for float64; int32
a quarter, one operation an instruction), at the full power limit of 700 W.
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOAT64_PER_S = 33.5e12
PEAK_INT32_PER_S = 16.75e12

#: int32 operations a Huffman symbol costs a decoder: its table lookup,
#: shift, mask, length, extra bits, sign extension, run and store.
ENTROPY_OPS_PER_SYMBOL = 14
#: float64 operations of the EXACT IDCT of a block (the reference C
#: decoder's `fast_2didct`): 16 one-dimensional passes of 43, the 15
#: products of the first row's and column's scaling, and the 2 of each of
#: the 64 outputs' 0.25 * x + 128 (its float32 sums run beside them).
IDCT_OPS_PER_BLOCK = 16 * 43 + 15 + 2 * 64
#: float64 operations of BT.601 on a pixel: two offsets, four products,
#: four sums.
COLOUR_OPS_PER_PIXEL = 10
#: float64 operations a pixel adds under fancy 4:2:0 upsampling: per
#: chroma plane, the horizontal pass (four a sample, at half the rows) and
#: the vertical one (four a sample).
FANCY_OPS_PER_PIXEL = 2 * (2 + 4)


def entropy_bound_s(scan_bytes: int, blocks: int, symbols: int) -> float:
    """K2u + K2: the entropy-coded bytes read, the int16 coefficient
    planes written; the symbols decoded."""
    return max((scan_bytes + 128 * blocks) / PEAK_BYTES_PER_S,
               ENTROPY_OPS_PER_SYMBOL * symbols / PEAK_INT32_PER_S)


def pixel_bound_s(blocks: int, pixels: int, planes_out: bool, fancy: bool) -> float:
    """The pixel stage: the int16 coefficient planes read, the RGB written
    (and the uint8 sample planes, where the entry asks for them); the IDCT
    and colour operations."""
    nbytes = 128 * blocks + 3 * pixels + (64 * blocks if planes_out else 0)
    ops = IDCT_OPS_PER_BLOCK * blocks + (COLOUR_OPS_PER_PIXEL + (
        FANCY_OPS_PER_PIXEL if fancy else 0)) * pixels
    return max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_FLOAT64_PER_S)
