"""Carry decode state from the host layers onto a torch device, and from
another package's objects into the port's.

A JPEG decoder has no learned weights: its "parameters" are the tables a
stream defines (Huffman and quantization) and its intermediate state is the
coefficient-plane IR (core/types.CoefficientPlanes, int16 [by, bx, 64]
zigzag). The port's host layers (io/, core/, native/, utils/) produce both
as numpy arrays; this module turns them into the tensors the port's kernels
take.

The port's config, enums, error classes and parsed structures are its own
objects: those of the JAX package jpeg_decoder_tpu are equal in content and
distinct in identity. The `*_from` functions below carry such an object
across by its field names and numpy arrays alone (this module imports
nothing of that package); a byte stream crosses by being parsed again with
the port's parser.
"""

from __future__ import annotations

import functools
import threading
import weakref

import numpy as np
import torch

import dataclasses
import enum

from .core.huffman import build_canonical
from .core.types import (
    CoefficientPlanes,
    FrameHeader,
    HuffTableSpec,
    QuantTable,
    Scan,
)
from .native.runtime import scan_layout
from .utils.config import DecodeConfig, EncodeConfig

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
# Crossings from objects of another package (duck-typed)
# ---------------------------------------------------------------------------


def config_from(obj) -> DecodeConfig:
    """The port's DecodeConfig from any object with the same field names;
    an enum member crosses by its `.name`."""
    kw = {}
    for f in dataclasses.fields(DecodeConfig):
        v = getattr(obj, f.name)
        default = f.default
        if isinstance(default, enum.Enum):
            v = type(default)[v.name]
        kw[f.name] = v
    return DecodeConfig(**kw)


def encode_config_from(obj) -> EncodeConfig:
    """The port's EncodeConfig from any object with the same field names."""
    return EncodeConfig(**{f.name: getattr(obj, f.name)
                           for f in dataclasses.fields(EncodeConfig)})


def huff_spec_from(obj) -> HuffTableSpec:
    """The port's HuffTableSpec from any object with table_class, table_id
    and the BITS / HUFFVAL arrays `counts` and `symbols`."""
    return HuffTableSpec(
        table_class=int(obj.table_class), table_id=int(obj.table_id),
        counts=np.array(obj.counts, dtype=np.uint8),
        symbols=np.array(obj.symbols, dtype=np.uint8),
    )


def quant_table_from(obj) -> QuantTable:
    """The port's QuantTable from any object with `precision` and the
    natural-order uint16 [64] `values`."""
    return QuantTable(
        precision=int(obj.precision),
        values=np.array(obj.values, dtype=np.uint16),
    )


def planes_from(frame: FrameHeader, arrays) -> CoefficientPlanes:
    """The port's CoefficientPlanes for `frame` (the port's own, from its
    parser) holding copies of int16 [by, bx, 64] arrays, one per component."""
    planes = CoefficientPlanes(frame)
    for dst, src in zip(planes.planes, arrays, strict=True):
        dst[...] = np.asarray(src, dtype=np.int16).reshape(dst.shape)
    return planes


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


def group_key(frame: FrameHeader, scan: Scan):
    """(key, total_mcus, units, tables) of one scan. Scans with equal keys
    decode in one K2 launch: the key is the JAX batch path's group key
    (entropy_pallas.entropy_decode_batch), (ri, P, the units' (dc, ac,
    scan component) schedule, the Huffman tables' content)."""
    total_mcus, units, tabs = scan_tables(frame, scan)
    ri = scan.restart_interval or total_mcus
    key = (ri, units.shape[0], units[:, [2, 3, 1]].tobytes(), tabs.tobytes())
    return key, total_mcus, units, tabs


def group_tables(members):
    """A group's decode state as K2 reads it, from [(total_mcus, units,
    tables)] of its scans, one per image (group_key): total_mcus int64
    [n_img]; units int32 [n_img, P, 11], whose wrap, bw and bh follow each
    image's geometry; and the shared int32 [n_specs, TABLE_INTS] tables
    (the first member's: all are equal by the key). With plane_addresses,
    that is all the group's device state."""
    return (np.array([m[0] for m in members], dtype=np.int64),
            np.stack([m[1] for m in members]), members[0][2])


def plane_addresses(planes, device) -> torch.Tensor:
    """int64 [n_img, 4] device addresses of each image's component planes
    (0 past the last component): K2's per-image plane table. The copy
    does not wait for the device (the pageable source is staged before it
    returns)."""
    addr = np.zeros((len(planes), 4), dtype=np.int64)
    for i, img in enumerate(planes):
        addr[i, : len(img)] = [p.data_ptr() for p in img]
    return torch.from_numpy(addr).to(device, non_blocking=True)


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


#: The most host memory that pinned read-backs hold at once, counted in
#: the caching host allocator's blocks (a power of two each, so a 4K RGB of
#: 24.9 MB holds 32 MiB): sixteen 4K frames. Torch keeps a pinned block
#: page-locked until the process ends, so this also bounds what the
#: allocator's cache keeps of them. A read-back past it, a gigapixel frame
#: or one more output while a caller holds many, is pageable.
PINNED_BUDGET_BYTES = 512 << 20

_pinned_lock = threading.Lock()
_pinned_held = 0


def _take_pinned(n: int) -> bool:
    """Book n bytes of PINNED_BUDGET_BYTES; False, and nothing booked, where
    they would pass it."""
    global _pinned_held
    with _pinned_lock:
        if _pinned_held + n > PINNED_BUDGET_BYTES:
            return False
        _pinned_held += n
        return True


def _give_pinned(n: int) -> None:
    global _pinned_held
    with _pinned_lock:
        _pinned_held -= n


def to_host(t: torch.Tensor, pin: bool = False) -> tuple[np.ndarray, bool]:
    """A device tensor as a host numpy array, and whether it is pinned.
    With `pin`, from a CUDA device, while PINNED_BUDGET_BYTES allows, the
    copy lands in a block of torch's caching host allocator, pinned: the
    DMA writes it directly, with no bounce through CUDA's own staging
    buffer. The array keeps the block alive and owns it; when the caller
    drops the array the allocator takes the block back, hands it to the
    next read-back of its size, and the budget gets its bytes back.
    Otherwise `.cpu()`, pageable."""
    n = 1 << max(t.nbytes - 1, 0).bit_length()
    if not pin or t.device.type != "cuda" or not _take_pinned(n):
        return t.cpu().numpy(), False
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return _booked(host.numpy(), n), True


def _booked(arr: np.ndarray, n: int) -> np.ndarray:
    """`arr`, its n booked bytes given back when it goes. The array, not
    the tensor: `.numpy()` bases the array on a wrapper of its own, so the
    tensor object goes as `to_host` returns, while every view of the array,
    and a tensor made from it by `torch.from_numpy`, keeps the array."""
    weakref.finalize(arr, _give_pinned, n)
    return arr
