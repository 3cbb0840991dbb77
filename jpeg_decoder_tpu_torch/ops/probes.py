"""The dependent-step probes PK1-PK7 (counterpart of the Pallas kernels in
benchmarks/pallas_gather_probe.py, pallas_gather_probe2.py,
pallas_gather_probe3.py and pallas_gather_probe4.py).

Each function runs `steps` iterations of one serial chain per lane and
returns the final state; two chain lengths give the cost of one dependent
step (benchmarks/gather_probe.py). They price in isolation what the entropy
kernel K2 does per symbol: a data-dependent lookup, a variable shift, a
compare-ladder step, a refill from a staged stream.

For a CUDA tensor a function launches its kernel (csrc/probes.cu); for a
CPU tensor it runs the plain PyTorch version in this file, a Python loop of
tensor operations over the steps. `plain=True` asks for the plain version
on the tensors' own device, which is how a kernel is held against it on a
card. 32-bit unsigned state (the JAX kernels'
uint32) travels as int32 tensors holding the same bits; the plain versions
compute it in int64 and mask.

`VARIANTS` lists the 21 variants of the four scripts under the scripts' own
labels, each with a maker that reproduces the script's inputs from the same
`np.random.default_rng(seed)` calls, and a runner that gives the script's
output shape.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from .. import _build

I32 = torch.int32
I64 = torch.int64
_M32 = 0xFFFFFFFF
#: Shared memory one block may use on the H100 (dynamic, with the opt-in).
MAX_SHARED_BYTES = 227 * 1024
#: The script's constant initial state of the symbol step (PK6).
SYMBOL_STATE = (0x9E3779B9, 32, 0)


def _bits_i32(x64: torch.Tensor) -> torch.Tensor:
    """int64 values taken modulo 2^32 -> the int32 tensor with those bits."""
    x = x64 & _M32
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(I32)


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bits -> their unsigned value in int64."""
    return x.to(I64) & _M32


def _check(name: str, *tensors: torch.Tensor, f32: torch.Tensor | None = None) -> torch.device:
    """The one device of `tensors` (contiguous int32) and `f32` (contiguous
    float32, if given)."""
    dev = tensors[0].device
    typed = [(t, I32) for t in tensors]
    if f32 is not None:
        typed.append((f32, torch.float32))
    for t, dtype in typed:
        if t.dtype != dtype or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous {dtype} on one device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for {dev}")
    return dev


def _in_range(name: str, idx: torch.Tensor, size: int) -> None:
    """A chain's start indices must lie in [0, size): every later index
    does, by the chain's modulus. Checked for a CPU tensor. A CUDA tensor's
    values are not read here, which would put a synchronisation and two
    reductions in front of every launch: the kernel clamps a start into
    range instead, so a bad one reads no memory outside the table."""
    if idx.device.type == "cpu" and idx.numel() \
            and (int(idx.min()) < 0 or int(idx.max()) >= size):
        raise ValueError(f"{name}: start indices must lie in [0, {size})")


def _placement(name: str, placement, nbytes: int) -> bool:
    """True for shared memory. None picks shared memory when the table fits
    a block's (227 KB on the H100), else global memory."""
    if placement is None:
        return nbytes <= MAX_SHARED_BYTES
    if placement not in ("shared", "global"):
        raise ValueError(f"{name}: placement must be 'shared', 'global' or None")
    if placement == "shared" and nbytes > MAX_SHARED_BYTES:
        raise ValueError(f"{name}: a {nbytes}-byte table does not fit shared memory")
    return placement == "shared"


# ---------------------------------------------------------------------------
# PK1 gather_chain
# ---------------------------------------------------------------------------


def _gather_chain_plain(tab, idx, steps, axis, add_idx, mod):
    for i in range(steps):
        if tab.dim() == 1:
            v = torch.take(tab, idx.to(I64))
        else:
            v = torch.take_along_dim(tab, idx.to(I64), dim=axis)
        idx = torch.remainder(v + idx + i if add_idx else v + i, mod)
    return idx


def gather_chain(tab: torch.Tensor, idx0: torch.Tensor, steps: int, axis: int = 0,
                 add_idx: bool = False, mod: int | None = None,
                 placement: str | None = None, plain: bool = False) -> torch.Tensor:
    """`steps` dependent gathers: v = take_along_axis(tab, idx, axis) (take,
    for a 1-D table shared by all lanes), then idx = (v [+ idx] + i) mod
    `mod` (default: the table's extent along `axis`). int32; idx0 has the
    table's shape except along `axis`. Returns the final idx.

    `placement` ("shared", "global" or None for shared memory when the table
    fits) says where the kernel keeps the table; the result does not depend
    on it."""
    dev = _check("gather_chain", tab, idx0)
    if tab.dim() == 1:
        size, strides = tab.shape[0], (0, 0, 1)
    elif tab.dim() == 2 and idx0.dim() == 2 and axis in (0, 1) \
            and idx0.shape[1 - axis] == tab.shape[1 - axis]:
        size = tab.shape[axis]
        # (row_stride, col_stride, idx_stride) of csrc/probes.cu
        strides = (tab.shape[1], 0, 1) if axis == 1 else (0, 1, tab.shape[1])
    else:
        raise ValueError("gather_chain: idx0 must have the table's shape except along axis")
    mod = size if mod is None else mod
    if not 0 < mod <= size:
        raise ValueError(f"gather_chain: mod must lie in (0, {size}]")
    _in_range("gather_chain", idx0, size)
    in_shared = _placement("gather_chain", placement, tab.numel() * 4)
    if dev.type == "cpu" or plain:
        return _gather_chain_plain(tab, idx0, steps, axis, add_idx, mod)
    out = torch.empty_like(idx0)
    lane_cols = idx0.shape[-1] if idx0.dim() == 2 else 1
    _build.launch(
        "jdtc_probe_gather_chain", _build.ptr(tab), _build.ptr(idx0), _build.ptr(out),
        idx0.numel(), lane_cols, *strides, tab.numel(), size, int(add_idx), mod, steps,
        int(in_shared), _build.stream_of(out))
    return out


# ---------------------------------------------------------------------------
# PK2 onehot_lookup_chain
# ---------------------------------------------------------------------------


def _onehot_lookup_chain_plain(tab, idx, steps, bits, mask):
    # indexed, not a one-hot product: exact, and no TF32 can enter
    n = tab.shape[0]
    for i in range(steps):
        v = tab[(idx >> bits).to(I64), (idx & (n - 1)).to(I64)].to(I32)
        idx = (v + idx + i) & mask
    return idx


def onehot_lookup_chain(tab: torch.Tensor, idx0: torch.Tensor, steps: int, mask: int,
                        placement: str | None = None, plain: bool = False) -> torch.Tensor:
    """`steps` lookups v = tab[idx >> b, idx & (n - 1)] in a float32 [n, n]
    table (n = 2^b) of integers below 2^13, then idx = (v + idx + i) & mask.
    The JAX kernel forms the lookup as a one-hot product; the value is the
    same. Returns the final int32 idx."""
    dev = _check("onehot_lookup_chain", idx0, f32=tab)
    if tab.dim() != 2 or tab.shape[0] != tab.shape[1] or tab.shape[0] & (tab.shape[0] - 1):
        raise ValueError("onehot_lookup_chain: the table must be [n, n], n = 2^b")
    n = tab.shape[0]
    if not 0 <= mask < n * n:
        raise ValueError(f"onehot_lookup_chain: mask must lie in [0, {n * n})")
    _in_range("onehot_lookup_chain", idx0, mask + 1)
    bits = n.bit_length() - 1
    in_shared = _placement("onehot_lookup_chain", placement, n * n * 4)
    if dev.type == "cpu" or plain:
        return _onehot_lookup_chain_plain(tab, idx0, steps, bits, mask)
    out = torch.empty_like(idx0)
    _build.launch(
        "jdtc_probe_onehot_lookup_chain", _build.ptr(tab), _build.ptr(idx0),
        _build.ptr(out), idx0.numel(), n, bits, mask, steps, int(in_shared),
        _build.stream_of(out))
    return out


# ---------------------------------------------------------------------------
# PK3 row_scatter_chain
# ---------------------------------------------------------------------------


def _row_scatter_chain_plain(idx, width, steps):
    out = torch.zeros((idx.shape[0], width), dtype=I32, device=idx.device)
    rows = torch.arange(idx.shape[0], device=idx.device)
    for i in range(steps):
        out[rows, idx.to(I64)] += idx + i
        idx = torch.remainder(idx + 7, width)
    return out


def row_scatter_chain(idx0: torch.Tensor, width: int, steps: int,
                      plain: bool = False) -> torch.Tensor:
    """Each step out[r, idx[r]] += idx[r] + i for every row r, then idx =
    (idx + 7) mod width. int32 idx0 [rows]; returns out [rows, width], which
    starts from zero (the JAX kernel adds into its uninitialised output)."""
    dev = _check("row_scatter_chain", idx0)
    if idx0.dim() != 1:
        raise ValueError("row_scatter_chain: idx0 must be [rows]")
    _in_range("row_scatter_chain", idx0, width)
    if dev.type == "cpu" or plain:
        return _row_scatter_chain_plain(idx0, width, steps)
    out = torch.empty((idx0.shape[0], width), dtype=I32, device=dev)  # the kernel clears it
    _build.launch("jdtc_probe_row_scatter_chain", _build.ptr(idx0), _build.ptr(out),
                  idx0.shape[0], width, steps, _build.stream_of(out))
    return out


# ---------------------------------------------------------------------------
# PK4 vshift_chain
# ---------------------------------------------------------------------------


def _vshift_chain_plain(x, sh, steps, n_ops):
    x, sh = _u32(x), _u32(sh)
    for i in range(steps):
        for k in range(n_ops):
            x = (((x >> ((sh + i + k) & 31)) ^ x) + 1) & _M32
    return _bits_i32(x)


def vshift_chain(x0: torch.Tensor, sh: torch.Tensor, steps: int, n_ops: int = 1,
                 plain: bool = False) -> torch.Tensor:
    """x = ((x >> ((sh + i + k) & 31)) ^ x) + 1 for k < n_ops, each step, on
    uint32 bits held in int32 tensors of one shape. `n_ops` is 1 or 10, the
    scripts' two unrolled step bodies. Returns the final x."""
    dev = _check("vshift_chain", x0, sh)
    if x0.shape != sh.shape:
        raise ValueError("vshift_chain: x0 and sh must have one shape")
    if n_ops not in (1, 10):
        raise ValueError("vshift_chain: n_ops must be 1 or 10")
    if dev.type == "cpu" or plain:
        return _vshift_chain_plain(x0, sh, steps, n_ops)
    out = torch.empty_like(x0)
    _build.launch("jdtc_probe_vshift_chain", _build.ptr(x0), _build.ptr(sh),
                  _build.ptr(out), x0.numel(), n_ops, steps, _build.stream_of(out))
    return out


# ---------------------------------------------------------------------------
# PK5 combined_step_chain
# ---------------------------------------------------------------------------


def _combined_step_chain_plain(tab, words, steps):
    n_words, lanes = words.shape
    dev = words.device
    row0 = tab[0].to(I64)
    w = _u32(words)
    cols = torch.arange(lanes, device=dev)
    bitbuf = torch.full((lanes,), 0x9E3779B9, dtype=I64, device=dev)
    bitcnt = torch.full((lanes,), 32, dtype=I64, device=dev)
    wordpos = torch.zeros(lanes, dtype=I64, device=dev)
    acc = torch.zeros(lanes, dtype=I64, device=dev)
    for _ in range(steps):
        e = row0[(bitbuf >> 20) & 0xFFF]
        ln = e & 31
        bitbuf = (bitbuf << ln) & _M32
        bitcnt = bitcnt - ln
        need = bitcnt < 16
        nxt = w[torch.remainder(wordpos, n_words), cols]
        bitbuf = bitbuf | torch.where(need, nxt >> 16, 0)
        bitcnt = bitcnt + torch.where(need, 16, 0)
        wordpos = wordpos + need.to(I64)
        acc = acc ^ e
    return _bits_i32(acc + bitcnt + wordpos + bitbuf).reshape(1, lanes)


def combined_step_chain(tab: torch.Tensor, words: torch.Tensor, steps: int,
                        plain: bool = False) -> torch.Tensor:
    """A decoder-like step per lane: a 12-bit peek of a 32-bit bit buffer, a
    length e & 31 from row 0 of the int32 [rows, 4096] table, the shift, and
    below 16 bits a 16-bit refill from words[wordpos mod n, lane] (uint32
    bits, int32 [n, lanes]); acc ^= e. Every lane starts from the script's
    constant state. Returns int32 [1, lanes]: acc + bitcnt + wordpos + bitbuf,
    wrapping."""
    dev = _check("combined_step_chain", tab, words)
    if tab.dim() != 2 or tab.shape[1] != 4096 or words.dim() != 2:
        raise ValueError("combined_step_chain: tab must be [rows, 4096], words [n, lanes]")
    if dev.type == "cpu" or plain:
        return _combined_step_chain_plain(tab, words, steps)
    n_words, lanes = words.shape
    out = torch.empty((1, lanes), dtype=I32, device=dev)
    _build.launch("jdtc_probe_combined_step_chain", _build.ptr(tab), _build.ptr(words),
                  _build.ptr(out), lanes, tab.shape[1], n_words, steps,
                  _build.stream_of(out))
    return out


# ---------------------------------------------------------------------------
# PK6 symbol_step_chain
# ---------------------------------------------------------------------------

_SYMBOL_SHAPE = (8, 128)


def symbol_state(device, state=SYMBOL_STATE):
    """(bitbuf, bitcnt, acc) int32 [8, 128] tensors filled with `state`'s
    three constants (default: the script's)."""
    return tuple(
        _bits_i32(torch.full(_SYMBOL_SHAPE, v, dtype=I64, device=device)) for v in state)


def _symbol_step_chain_plain(thr, sym, state, steps):
    bitbuf, bitcnt, acc = _u32(state[0]), state[1].to(I64), state[2].to(I64)
    thr = thr.reshape(16).to(I64)
    sym = sym.to(I64)
    for _ in range(steps):
        code16 = bitbuf >> 16
        ln = 1 + (code16[..., None] > thr).sum(-1)
        ln = torch.clamp(ln, max=16)
        off = (code16 >> (16 - ln)) & 0x3FF
        lo = off & 127
        hi = (off >> 7) & 7
        row = torch.take_along_dim(sym, lo, dim=1)
        s = torch.take_along_dim(row, hi, dim=0)
        size = s & 0xF
        ext = (bitbuf >> (32 - ln - size)) & ((1 << size) - 1)
        half = torch.where(size > 0, 1 << torch.clamp(size - 1, min=0), 0)
        val = torch.where(ext < half, ext - 2 * half + 1, ext)
        bitbuf = (bitbuf << (ln + size)) & _M32
        bitcnt = bitcnt - (ln + size)
        need = bitcnt < 16
        bitbuf = bitbuf | torch.where(need, 0x5A5A, 0)
        bitcnt = torch.where(need, bitcnt + 16, bitcnt)
        acc = acc ^ val
    return _bits_i32(acc + bitcnt + bitbuf)


def symbol_step_chain(thr: torch.Tensor, sym: torch.Tensor, steps: int, state=None,
                      plain: bool = False) -> torch.Tensor:
    """K2's symbol step on [8, 128] lane state (bitbuf as uint32 bits,
    bitcnt, acc; int32): a 16-threshold compare ladder (thr int32 [16] or
    [1, 16]), a 1024-entry lookup in sym int32 [8, 128] in two stages (by
    the offset's low 7 bits along a row, then by its high 3 bits down the
    column, which reads another lane's row value), EXTEND, the shifts and a
    constant refill. `state` defaults to the script's constants. Returns
    int32 [8, 128]: acc + bitcnt + bitbuf, wrapping."""
    if state is None:
        state = symbol_state(thr.device)
    dev = _check("symbol_step_chain", thr, sym, *state)
    if thr.numel() != 16 or sym.shape != _SYMBOL_SHAPE \
            or any(s.shape != _SYMBOL_SHAPE for s in state):
        raise ValueError("symbol_step_chain: thr [16], sym and the state [8, 128]")
    if dev.type == "cpu" or plain:
        return _symbol_step_chain_plain(thr, sym, state, steps)
    out = torch.empty(_SYMBOL_SHAPE, dtype=I32, device=dev)
    _build.launch("jdtc_probe_symbol_step_chain", _build.ptr(thr), _build.ptr(sym),
                  *(_build.ptr(s) for s in state), _build.ptr(out), steps,
                  _build.stream_of(out))
    return out


# ---------------------------------------------------------------------------
# PK7 dma_wave_chain
# ---------------------------------------------------------------------------

_WAVE = 128      # copies per wave, one per lane
_SLOTS = 16      # window slots; copy c lands in slot c % 16
_SLOT_ROWS = 8   # rows of 64 int32 per copy (2 KB)


def dma_waves(steps: int) -> int:
    """Waves of 128 copies in a chain of `steps` copies: at least one."""
    return max(1, steps // _WAVE)


def _dma_wave_chain_plain(stream, off, steps):
    n_rows = stream.shape[0]
    dev = stream.device
    window = torch.zeros((_SLOTS * _SLOT_ROWS, stream.shape[1]), dtype=I32, device=dev)
    lanes = torch.arange(_WAVE, device=dev)
    off = off.reshape(_WAVE).clone()
    for _ in range(dma_waves(steps)):
        rows = torch.remainder(off + lanes, n_rows - _SLOT_ROWS).tolist()
        for c, r in enumerate(rows):  # in issue order: a slot keeps its last copy
            s = (c % _SLOTS) * _SLOT_ROWS
            window[s:s + _SLOT_ROWS] = stream[r:r + _SLOT_ROWS]
        off = off + 1
    return (off + window[0, 0]).reshape(1, _WAVE)


def dma_wave_chain(stream: torch.Tensor, off0: torch.Tensor, steps: int,
                   plain: bool = False) -> torch.Tensor:
    """`steps` // 128 waves (at least one) of 128 asynchronous copies of 8
    rows x 64 int32 from stream[(off[c] + c) mod (rows - 8)] into slot c mod
    16 of a [128, 64] window; wait; off += 1. Eight copies of a wave land in
    each slot: the last one issued stays. stream int32 [rows, 64] in device
    memory, off0 int32 [1, 128]. Returns off + window[0, 0], int32 [1, 128]."""
    dev = _check("dma_wave_chain", stream, off0)
    if stream.dim() != 2 or stream.shape[1] != 64 or stream.shape[0] <= 2 * _SLOT_ROWS \
            or off0.numel() != _WAVE:
        raise ValueError("dma_wave_chain: stream [rows > 16, 64], off0 [1, 128]")
    if dev.type == "cpu" and int(off0.min()) < 0:  # on a card the kernel clamps, see _in_range
        raise ValueError("dma_wave_chain: offsets must not be negative")
    if dev.type == "cpu" or plain:
        return _dma_wave_chain_plain(stream, off0, steps)
    out = torch.empty((1, _WAVE), dtype=I32, device=dev)
    _build.launch("jdtc_probe_dma_wave_chain", _build.ptr(stream), _build.ptr(off0),
                  _build.ptr(out), stream.shape[0], dma_waves(steps),
                  _build.stream_of(out))
    return out


# ---------------------------------------------------------------------------
# The scripts' 21 variants: inputs and runners
# ---------------------------------------------------------------------------


def _rng_ints(seed, hi, shape, dtype=np.int32):
    return np.random.default_rng(seed).integers(0, hi, shape, dtype=dtype)


def _shift_inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2**32, (8, 128), dtype=np.uint32)
    sh = rng.integers(0, 32, (8, 128), dtype=np.uint32)
    return {"x": x.view(np.int32), "sh": sh.view(np.int32)}


def _square_inputs(shape, axis):
    rng = np.random.default_rng(shape[axis])
    tab = rng.integers(0, shape[axis], shape, dtype=np.int32)
    return {"tab": tab, "idx0": rng.integers(0, shape[axis], shape, dtype=np.int32)}


def _p5_inputs():
    rng = np.random.default_rng(5)
    row = rng.integers(1, 17, 4096, dtype=np.int32)
    words = rng.integers(0, 2**32, (2048, 128), dtype=np.uint32)
    return {"tab": np.tile(row[None, :], (8, 1)), "words": words.view(np.int32)}


def _h4_inputs():
    rng = np.random.default_rng(44)
    thr = rng.integers(0, 1 << 16, (1, 16), dtype=np.int32)
    return {"thr": thr, "sym": rng.integers(0, 256, (8, 128), dtype=np.int32)}


def _arange_table(rows):
    tab = np.arange(4096, dtype=np.int32)
    return tab if rows is None else np.tile(tab[None, :], (rows, 1))


@dataclasses.dataclass(frozen=True)
class Variant:
    """One `build_*` function of the four scripts."""

    key: str                 # "E1" ... "H5"
    label: str               # the script's own label
    round: int               # 1..4: which script
    kernel: str              # C entry point it launches on a card
    inputs: Callable[[], dict]   # the script's inputs, numpy, from its seeds
    run: Callable            # (tensors dict, steps, **kw) -> the script's output


def _gather(axis, add_idx=False, mod=None, out_shape=None, idx_shape=None):
    def run(t, steps, **kw):
        idx0 = t["idx0"] if idx_shape is None else t["idx0"].reshape(idx_shape)
        out = gather_chain(t["tab"], idx0, steps, axis, add_idx, mod, **kw)
        return out if out_shape is None else out.reshape(out_shape)
    return run


def _shift(n_ops):
    return lambda t, steps, **kw: vshift_chain(t["x"], t["sh"], steps, n_ops, **kw)


_GATHER = "jdtc_probe_gather_chain"
_ONEHOT = "jdtc_probe_onehot_lookup_chain"
_SHIFT = "jdtc_probe_vshift_chain"

VARIANTS: tuple[Variant, ...] = (
    Variant("E1", "E1 take shared 4096", 1, _GATHER,
            lambda: {"tab": _arange_table(None), "idx0": _rng_ints(0, 4096, (8, 128))},
            _gather(0, add_idx=True)),
    Variant("E2", "E2 take_along_axis rows", 1, _GATHER,
            lambda: {"tab": _rng_ints(1, 2**20, (128, 2048)),
                     "idx0": _rng_ints(2, 2048, (1, 128))},
            _gather(1, add_idx=True, out_shape=(1, 128), idx_shape=(128, 1))),
    Variant("E3", "E3 bilinear 64x64", 1, _ONEHOT,
            lambda: {"tab": _rng_ints(3, 1 << 13, (64, 64), np.int64).astype(np.float32),
                     "idx0": _rng_ints(4, 4096, (1, 128))},
            lambda t, steps, **kw: onehot_lookup_chain(t["tab"], t["idx0"], steps,
                                                       0xFFF, **kw)),
    Variant("E4", "E4 bilinear 256x256", 1, _ONEHOT,
            lambda: {"tab": _rng_ints(5, 1 << 13, (256, 256), np.int64).astype(np.float32),
                     "idx0": _rng_ints(6, 65536, (2, 128))},
            lambda t, steps, **kw: onehot_lookup_chain(t["tab"], t["idx0"], steps,
                                                       0xFFFF, **kw)),
    Variant("E5", "E5 row scatter", 1, "jdtc_probe_row_scatter_chain",
            lambda: {"idx0": _rng_ints(7, 512, (1, 128))},
            lambda t, steps, **kw: row_scatter_chain(t["idx0"].reshape(128), 512, steps,
                                                     **kw)),
    Variant("E6", "E6 variable shift", 1, _SHIFT, lambda: _shift_inputs(8), _shift(1)),
    Variant("P1", "P1 lane-gather 4096", 2, _GATHER,
            lambda: {"tab": _arange_table(8), "idx0": _rng_ints(0, 4096, (8, 128))},
            _gather(1)),
    Variant("P2", "P2 sublane-fetch 2048", 2, _GATHER,
            lambda: {"tab": _rng_ints(1, 2**20, (2048, 128)),
                     "idx0": _rng_ints(2, 2048, (1, 128))}, _gather(0)),
    Variant("P3", "P3 sublane-fetch 16384", 2, _GATHER,
            lambda: {"tab": _rng_ints(3, 2**20, (16384, 128)),
                     "idx0": _rng_ints(4, 16384, (1, 128))}, _gather(0)),
    Variant("P4", "P4 var-shift", 2, _SHIFT, lambda: _shift_inputs(8), _shift(1)),
    Variant("P5", "P5 combined step", 2, "jdtc_probe_combined_step_chain", _p5_inputs,
            lambda t, steps, **kw: combined_step_chain(t["tab"], t["words"], steps, **kw)),
    Variant("G1", "G1 crossbar 8x128 ax1", 3, _GATHER,
            lambda: _square_inputs((8, 128), 1), _gather(1)),
    Variant("G2", "G2 sublane 512x128 ax0", 3, _GATHER,
            lambda: _square_inputs((512, 128), 0), _gather(0)),
    Variant("G3", "G3 sublane 4096x128 ax0", 3, _GATHER,
            lambda: _square_inputs((4096, 128), 0), _gather(0)),
    Variant("G4a", "G4a loop body x1", 3, _SHIFT, lambda: _shift_inputs(9), _shift(1)),
    Variant("G4b", "G4b loop body x10", 3, _SHIFT, lambda: _shift_inputs(9), _shift(10)),
    Variant("H1", "H1 sublane 8x128 ax0", 4, _GATHER,
            lambda: _square_inputs((8, 128), 0), _gather(0)),
    Variant("H2", "H2 sublane 32x128 ax0", 4, _GATHER,
            lambda: _square_inputs((32, 128), 0), _gather(0)),
    Variant("H3", "H3 crossbar 128x128 ax1", 4, _GATHER,
            lambda: _square_inputs((128, 128), 1), _gather(1)),
    Variant("H4", "H4 realistic symbol step", 4, "jdtc_probe_symbol_step_chain",
            _h4_inputs,
            lambda t, steps, **kw: symbol_step_chain(t["thr"], t["sym"], steps, **kw)),
    Variant("H5", "H5 per-lane DMA", 4, "jdtc_probe_dma_wave_chain",
            lambda: {"stream": _rng_ints(55, 2**20, (4096, 64)),
                     "idx0": _rng_ints(56, 4096 - 300, (1, 128))},
            lambda t, steps, **kw: dma_wave_chain(t["stream"], t["idx0"], steps, **kw)),
)

BY_KEY = {v.key: v for v in VARIANTS}

#: Where the kernels that take no `placement` keep what a step touches.
_FIXED_PLACEMENT = {
    "jdtc_probe_row_scatter_chain": "output in global memory",
    "jdtc_probe_vshift_chain": "registers",
    "jdtc_probe_combined_step_chain": "table in shared memory, words in global memory",
    "jdtc_probe_symbol_step_chain": "tables in shared memory",
    "jdtc_probe_dma_wave_chain": "stream in global memory, window in shared memory",
}


def placement_of(variant: Variant, tensors: dict) -> str:
    """Where a card run of the variant keeps its table by default. "table
    in shared memory" means that `placement="global"` is the other choice."""
    fixed = _FIXED_PLACEMENT.get(variant.kernel)
    if fixed is not None:
        return fixed
    fits = _placement(variant.kernel, None, tensors["tab"].numel() * 4)
    return "table in shared memory" if fits else "table in global memory"


def tensors_for(variant: Variant, device) -> dict:
    """The variant's inputs as tensors on `device`."""
    return {k: torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for k, a in variant.inputs().items()}
