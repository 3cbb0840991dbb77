"""Carry decode state from the shared host layer onto a torch device.

A JPEG decoder has no learned weights: its "parameters" are the tables a
stream defines (Huffman and quantization) and its intermediate state is the
coefficient-plane IR (core/types.CoefficientPlanes, int16 [by, bx, 64]
zigzag). The host layers the port shares with jpeg_decoder_tpu (io/, core/,
native/, utils/) produce both as numpy arrays; this module turns them into
the tensors the port's kernels take, so the tests can feed one set of numpy
arrays to a JAX function and to its counterpart here.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from jpeg_decoder_tpu.core.huffman import build_canonical
from jpeg_decoder_tpu.core.types import (
    CoefficientPlanes,
    FrameHeader,
    HuffTableSpec,
    Scan,
)
from jpeg_decoder_tpu.native.runtime import scan_layout

from .models.host import _StructureShim

#: One Huffman table as K2 reads it: thr[16], base[16], symbols[1024].
TABLE_INTS = 16 + 16 + 1024


def resolve_device(device) -> torch.device:
    """torch.device for `device`; a CUDA device without CUDA raises (the
    port never drops to the CPU on its own: pass device="cpu" for that)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' but torch.cuda.is_available() is False; pass"
            " device='cpu' to run the plain PyTorch versions of the kernels"
        )
    return dev


# ---------------------------------------------------------------------------
# Huffman tables (counterpart of jpeg_decoder_tpu/ops/entropy_pallas.py
# _ladder_tables, which cannot be imported without JAX)
# ---------------------------------------------------------------------------


def _ladder_tables(spec: HuffTableSpec):
    """Canonical decode as (thresholds[16], base[16], symbols[1024]).

    For a left-aligned 16-bit window c: len = 1 + sum_j(c >= thr[j]), and
    the symbol's index into `symbols` is (c >> (16 - len)) + base[len-1].
    thr[j] is the exclusive upper bound of all codes of length <= j+1,
    left-aligned; lengths with no codes inherit the previous bound. Invalid
    prefixes resolve to a slot holding the sentinel 0x1FF.
    """
    # Validation only: build_canonical raises on oversubscribed/invalid
    # DHT counts before the ladder would silently encode garbage.
    build_canonical(spec)
    counts = np.asarray(spec.counts, dtype=np.int64)
    symbols = np.asarray(spec.symbols, dtype=np.int64)
    thr = np.zeros(16, dtype=np.int64)
    base = np.zeros(16, dtype=np.int64)
    sym1024 = np.full(1024, 0x1FF, dtype=np.int32)
    code = 0
    ptr = 0
    for ln in range(1, 17):
        n = int(counts[ln - 1])
        base[ln - 1] = ptr - code
        if n:
            sym1024[ptr : ptr + n] = symbols[ptr : ptr + n]
        code += n
        thr[ln - 1] = code << (16 - ln)
        code <<= 1
        ptr += n
    for j in range(1, 16):
        if thr[j] < thr[j - 1]:
            thr[j] = thr[j - 1]
    return thr.astype(np.int32), base.astype(np.int32), sym1024


@functools.lru_cache(maxsize=256)
def _ladder_cached(counts_b: bytes, symbols_b: bytes) -> np.ndarray:
    spec = HuffTableSpec(
        table_class=0, table_id=0,
        counts=np.frombuffer(counts_b, dtype=np.uint8),
        symbols=np.frombuffer(symbols_b, dtype=np.uint8),
    )
    out = np.concatenate(_ladder_tables(spec)).astype(np.int32)
    out.flags.writeable = False
    return out


def ladder_for_spec(spec: HuffTableSpec) -> np.ndarray:
    """One table as K2's flat int32 [TABLE_INTS] row (content-cached)."""
    return _ladder_cached(
        np.asarray(spec.counts, np.uint8).tobytes(),
        np.asarray(spec.symbols, np.uint8).tobytes(),
    )


def scan_tables(frame: FrameHeader, scan: Scan):
    """(total_mcus, units int32 [P, 11], tables int32 [n_specs, TABLE_INTS]).

    `units` is native.runtime.scan_layout's unit layout (plane, scomp,
    dc, ac, h, v, j, k, wrap, plane_bw, plane_bh) with columns 2 and 3
    re-pointed at rows of `tables`: one row per distinct (class, id) the
    scan uses, in first-use order (entropy_pallas._scan_tables)."""
    total_mcus, params, _luts = scan_layout(_StructureShim(frame), scan)
    units = np.array(params, dtype=np.int32)
    rows: dict[tuple[int, int], int] = {}
    specs = []
    for u in range(units.shape[0]):
        sc = scan.header.components[int(units[u, 1])]
        for col, key, tables in (
            (2, (0, sc.dc), scan.dc_tables), (3, (1, sc.ac), scan.ac_tables),
        ):
            if key not in rows:
                rows[key] = len(specs)
                specs.append(tables[key[1]])
            units[u, col] = rows[key]
    tabs = np.stack([ladder_for_spec(s) for s in specs])
    return total_mcus, units, tabs


@dataclasses.dataclass(frozen=True)
class DeviceTables:
    """A scan's decode state on the device."""

    total_mcus: int
    units: torch.Tensor    # int32 [P, 11]
    huffman: torch.Tensor  # int32 [n_specs, TABLE_INTS]


def tables_to_device(frame: FrameHeader, scan: Scan, device) -> DeviceTables:
    """The numpy outputs of the shared host layer as the port's tensors:
    the unit layout and Huffman tables of `scan`."""
    total_mcus, units, tabs = scan_tables(frame, scan)
    return DeviceTables(
        total_mcus=total_mcus,
        units=torch.from_numpy(units).to(device),
        huffman=torch.from_numpy(tabs).to(device),
    )


def quant_table_to_device(values_natural, device) -> torch.Tensor:
    """A natural-order quantization table as int32 [64] (the pixel stage
    takes its tables this way, models/decoder.PixelStage)."""
    arr = np.ascontiguousarray(values_natural, dtype=np.int32)
    return torch.from_numpy(arr).to(device)


# ---------------------------------------------------------------------------
# Coefficient planes
# ---------------------------------------------------------------------------


def zero_planes(frame: FrameHeader, device) -> list[torch.Tensor]:
    """Zeroed int16 [by, bx, 64] planes per component (sequential scans
    that are not interleaved skip the MCU-padding blocks)."""
    return [
        torch.zeros((c.blocks_y, c.blocks_x, 64), dtype=torch.int16,
                    device=device)
        for c in frame.components
    ]


def planes_to_device(planes: CoefficientPlanes, device) -> list[torch.Tensor]:
    """CoefficientPlanes (numpy int16) -> device tensors, one copy each."""
    return [torch.from_numpy(np.ascontiguousarray(p)).to(device)
            for p in planes.planes]
