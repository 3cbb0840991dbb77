"""K03 (csrc/pixel_exact.cu, EXACT) and K13 (csrc/pixel_float.cu, FLOAT32)
at other strip sizes, on one CUDA card.

    python -m jpeg_decoder_tpu_torch.benchmarks.pixel_sweep \\
        [--strip 2 4 8 16 32] [--reps 15] [--precision exact float32]
        [--k13-variants] [--k0] [--colour] [--k1] [--k4] [--k5]
        [--no-sweep]

G, the MCUs of one strip (one block of threads for K03; one step of a
block of threads' walk for K13), is an argument of the kernels, so one
build serves every size. The inputs are the coefficient
planes of a 3840x2160 4:2:0 request of random dense blocks
(inputs.make_jpeg) and of a photograph tiled to that size
(inputs.photo_jpeg), as the native host decoder reads them: one request
with its pixel planes (JpegDecoder's case) and eight stacked without them
(BatchDecoder's). Every variant is first held bitwise against the default
G. Each line is one JSON object: G, the coefficient blocks of a block of
threads (8 threads a block, at most 1024), and the card's time for one call
(`card_ms`), beside the launches each replaced (K0 x 3 + K3, or K1 x 3 +
K3) on the same inputs in the same way, with the card's name and power
limit. Compare within one run only.

Also one line of the instruction mix of K03, K0 (and its earlier design),
K13 and K1 as built (cuobjdump -sass: the counts of the opcodes that take
the time, per kernel, and cuobjdump -res-usage: registers, spills, static
shared memory); and with --k13-variants the same timing for K13's variants
(VARIANTS: two that drop work, to attribute its time, and the design
choices it did not take). Each copy is built by nvcc in a temporary
directory, run in a process of its own and, unless it drops work, held
bitwise against the plain version (K03, K0) or K1 x 3 + K3 (K13).

With --k0, K0 (csrc/idct_exact.cu) beside its earlier design
(jdtc_idct_exact_gather, k0_gather), in turns (earlier, K0, K0, earlier),
the card alone and with L2 flushed before each call, on the 4K request's
three planes and eight such requests stacked, both held bitwise against
the plain version first; then copies of the package whose K0 keeps the new
layout with the chain's earlier spelling (`K0, earlier arithmetic`) and
with the halvings alone (`K0, halvings in float32`), so that the layout's,
the halvings' and the integer store's shares can each be read. With
--colour, K3f, K3 and K3c beside their earlier design (a thread a pixel,
colour_pixel) in the same way on the 4K 4:2:0 planes, eight 4K frames
stacked, and the 4K 4:4:4 four-component frame under each transform.
With --k1, K1 (csrc/idct_float.cu) beside its earlier design
(jdtc_idct_float_column, k1_column) in the same way on the 4K request's
luma plane and on its three planes, held bitwise against each other first,
then K1's VARIANTS. With --k4, K4 (csrc/fdct.cu) beside its earlier design
(jdtc_fdct_column, fdct_column) on a 3840x2160 photograph (photograph_4k)
at 4:2:0 and 4:4:4, q85, held bitwise against each other first, then K4's
VARIANTS (run lengths among them). With --k5, K5 (csrc/idct_scaled.cu, one
launch for all components) on the 4K request's three planes at k = 1, 2
and 4 beside its earlier design (jdtc_idct_scaled_percomp, a launch a
plane, k5_percomp) in turns, the card alone and with L2 flushed, after
holding the two bitwise; beside them the earlier design with its
coefficient loads issued before its shared-memory fold and barrier, and an
empty kernel at the earlier design's three grids and at the new design's
one grid (the launch floor); then each K5 kernel's registers, shared
memory and instruction mix, and from them the blocks of threads resident
on an SM and the waves of each launch (k5_occupancy).
Each of --k0, --k1, --k4 and --k5 ends with the instruction mix.
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

PACKAGE = Path(__file__).resolve().parents[1]
W, H, RI = 3840, 2160, 240
#: The opcodes of the instruction mix: conversions (F2F between float and
#: double, F2I, I2F, I2FP, FRND), float64 and float32 arithmetic, shared
#: memory loads and stores, loads from the constant bank and device memory.
SASS_OPS = ("F2F", "F2I", "I2F", "I2FP", "FRND", "DMUL", "DADD", "FADD", "FMUL", "FFMA", "LDS",
            "STS", "LDC", "LDG")
#: The kernels of the instruction mix, by their symbols' names.
SASS_KERNELS = ("pixel_exact_kernel", "idct_exact_kernel", "idct_exact_gather_kernel",
                "pixel_float_kernel", "idct_float_kernel", "idct_float_column_kernel",
                "fdct_kernel", "fdct_column_kernel", "idct_scaled_kernel",
                "idct_scaled_percomp_kernel")
#: A spin of about 10 ms at the H100's 1.98 GHz: long enough for the host to
#: queue a sample's calls behind it, K0 x 3 + K3 being 32 launches.
PARK_CYCLES = 20_000_000
CALLS_PER_SAMPLE = 8


def card_ms(fn, reps: int) -> float:
    """The card's milliseconds for one fn(): the median over `reps` samples
    of CALLS_PER_SAMPLE calls between two CUDA events, queued behind a spin
    kernel so that they run back to back and the host's time between
    launches does not count (after a warm-up call)."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(PARK_CYCLES)
        a.record()
        for _ in range(CALLS_PER_SAMPLE):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / CALLS_PER_SAMPLE)
    return statistics.median(times)


#: Bytes written between two calls of card_ms_flushed: five times the H100's
#: 50 MB L2, so that nothing of the call before stays in it.
FLUSH_BYTES = 256 << 20


def card_ms_flushed(fn, reps: int) -> float:
    """The card's milliseconds for one fn() that finds the L2 cold: the
    median over `reps` calls, each between two CUDA events and after a
    write of FLUSH_BYTES, all queued behind a spin kernel (so the host's
    time between launches does not count; the flush lies outside the
    events)."""
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn()
    marks = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(reps)]
    torch.cuda._sleep(PARK_CYCLES)
    for a, b in marks:
        flush.zero_()
        a.record()
        fn()
        b.record()
    marks[-1][1].synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in marks)


def in_turns(new, earlier, reps: int) -> dict:
    """`new` beside `earlier` the card alone and with L2 flushed, in turns
    (earlier, new, new, earlier): the lists card_ms, earlier_card_ms,
    flushed_ms and earlier_flushed_ms."""
    out = {"card_ms": [], "earlier_card_ms": [], "flushed_ms": [], "earlier_flushed_ms": []}
    for key, fn in (("earlier_", earlier), ("", new), ("", new), ("earlier_", earlier)):
        out[f"{key}card_ms"].append(card_ms(fn, reps))
        out[f"{key}flushed_ms"].append(card_ms_flushed(fn, reps))
    return out


def k0_k3(planes, qts, frame, quirks, want_planes: bool = True, precision=None):
    """The route K03 replaced: K0 per component, then K3; under
    `precision` FLOAT32 the route K13 replaced, K1 per component, then K3."""
    from .. import IdctPrecision
    from ..ops import color, idct

    bits12 = frame.precision == 12
    precision = precision or IdctPrecision.EXACT
    pixel = [idct.idct_plane(p, q, bits12, precision) for p, q in zip(planes, qts)]
    rgb = color.planes_to_rgb(pixel, frame.height, frame.width,
                              tuple((c.hsf, c.vsf) for c in frame.components), quirks)
    return rgb, (pixel if want_planes else None)


def k0_gather(coeff_plane, qt, bits12: bool = False):
    """K0's earlier design (csrc/idct_exact.cu jdtc_idct_exact_gather: a
    thread a block gathering its coefficients from device memory, the
    chain's earlier spelling) on a card tensor, as idct_plane launches K0:
    for measurement, reached by no wrapper."""
    from .. import _build

    *lead, by, bx, _ = coeff_plane.shape
    rows = int(np.prod(lead, dtype=np.int64)) * by
    out = torch.empty((*lead, by * 8, bx * 8), dtype=torch.uint8, device=coeff_plane.device)
    if rows * bx:
        _build.launch("jdtc_idct_exact_gather", _build.ptr(coeff_plane), _build.ptr(qt),
                      rows * bx, bx, int(bits12), _build.ptr(out), _build.stream_of(out))
    return out


def k1_column(coeff_plane, qt, bits12: bool = False):
    """K1's earlier design (csrc/idct_float.cu jdtc_idct_float_column: a
    thread a pixel position of 8 blocks) on a card tensor, as idct_plane
    launches K1: for measurement, reached by no wrapper."""
    from .. import _build
    from ..ops import idct

    *lead, by, bx, _ = coeff_plane.shape
    rows = int(np.prod(lead, dtype=np.int64)) * by
    out = torch.empty((*lead, by * 8, bx * 8), dtype=torch.uint8, device=coeff_plane.device)
    if rows * bx:
        _build.launch("jdtc_idct_float_column", _build.ptr(coeff_plane), _build.ptr(qt),
                      _build.ptr(idct.idct_matrix_on(coeff_plane.device)), rows * bx, bx,
                      int(bits12), _build.ptr(out), _build.stream_of(out))
    return out


def k1_plain(coeff_plane, qt, bits12: bool = False):
    """K1's plain version on a coefficient plane [..., by, bx, 64]: the pixel
    plane idct_plane gives on a CPU tensor, on the tensor's device."""
    from ..ops import idct

    *lead, by, bx, _ = coeff_plane.shape
    rows = int(np.prod(lead, dtype=np.int64)) * by
    return idct.blocks_to_plane(idct.idct_float(coeff_plane.reshape(-1, 64), qt, bits12),
                                rows, bx).reshape(*lead, by * 8, bx * 8)


def k1_turns(planes, qts, reps: int) -> dict:
    """K1 over the planes (one launch a plane) beside its earlier design, in
    turns (in_turns), after holding the two bitwise against each other;
    with the blocks."""
    from .. import IdctPrecision
    from ..ops import idct

    f32 = IdctPrecision.FLOAT32
    new = lambda: [idct.idct_plane(c, t, False, f32) for c, t in zip(planes, qts)]  # noqa: E731
    earlier = lambda: [k1_column(c, t) for c, t in zip(planes, qts)]  # noqa: E731
    if not all(torch.equal(a, b) for a, b in zip(new(), earlier())):
        raise RuntimeError("K1 differs from its earlier design")
    return dict(in_turns(new, earlier, reps), blocks=sum(c[..., 0].numel() for c in planes))


def fdct_column(img, factors, kq, out=None):
    """K4's earlier design (csrc/fdct.cu jdtc_fdct_column) on a card image,
    with encode_planes's arguments: for measurement, reached by no
    wrapper."""
    import ctypes

    from .. import _build
    from ..ops import fdct

    h, w = img.shape[:2]
    _, _, comps = fdct.plane_layout(h, w, factors)
    sizes = [by * bx * 64 for by, bx, _, _ in comps]
    if out is None:
        out = torch.empty(sum(sizes), dtype=torch.int16, device=img.device)
    views = [v.view(by, bx, 64) for v, (by, bx, _, _) in zip(out.split(sizes), comps)]
    if sum(sizes):
        params = fdct.comp_params(views, comps, factors, kq.shape[0])
        _build.launch("jdtc_fdct_column", _build.ptr(img), h, w, 1 if img.dim() == 2 else 3,
                      len(factors), params.ctypes.data_as(ctypes.c_void_p), _build.ptr(kq),
                      fdct.COLOR_CONSTANTS.ctypes.data_as(ctypes.c_void_p),
                      _build.stream_of(img))
    return views


def k4_turns(img, factors, kq, reps: int) -> dict:
    """K4 on one image beside its earlier design, in turns (in_turns), after
    holding the two bitwise against each other; with the blocks."""
    from ..ops import fdct

    _, _, comps = fdct.plane_layout(img.shape[0], img.shape[1], factors)
    blocks = sum(by * bx for by, bx, _, _ in comps)
    out = torch.empty(blocks * 64, dtype=torch.int16, device=img.device)
    old = torch.empty_like(out)
    new = lambda: fdct.encode_planes(img, factors, kq, out)  # noqa: E731
    earlier = lambda: fdct_column(img, factors, kq, old)  # noqa: E731
    new()
    earlier()
    if not torch.equal(out, old):
        raise RuntimeError("K4 differs from its earlier design")
    return dict(in_turns(new, earlier, reps), blocks=blocks)


def photograph_4k():
    """A 3840x2160 photograph on the card: the EXACT decode of a corpus
    photograph tiled to that size (inputs.photo_jpeg), K4's input in
    chip_smoke.py."""
    from .. import JpegDecoder
    from .inputs import PHOTOS_420, photo_jpeg

    rgb = JpegDecoder(device="cuda").decode_rgb(photo_jpeg(PHOTOS_420[0], W, H, RI))
    return torch.from_numpy(np.ascontiguousarray(rgb)).cuda()


def k4_sweep(reps: int) -> list[dict]:
    """K4 on the 4K photograph at 4:2:0 and 4:4:4, q85, beside its earlier
    design in turns (k4_turns)."""
    from ..models import encoder
    from ..ops import fdct
    from .gather_probe import card_line

    img = photograph_4k()
    kq = fdct.fdct_tables(encoder.quality_qtables(85), img.device)
    return [dict(kernel="K4", case=f"4K photograph {sub}", run=fdct.run_mcus(factors),
                 card=card_line(), **k4_turns(img, factors, kq, reps))
            for sub, factors in ((s, encoder._SAMPLING[s]) for s in ("420", "444"))]


def k5_percomp(planes, qts, k: int, bits12: bool = False, loads_first: bool = False):
    """K5's earlier design (csrc/idct_scaled.cu jdtc_idct_scaled_percomp: a
    launch a plane, each block of threads folding the band into shared
    memory; with `loads_first` its coefficient loads issued before the fold
    and the barrier) on card planes and their int32 tables on the card, as
    idct_planes_scaled's arguments: for measurement, reached by no
    wrapper."""
    from .. import _build
    from ..ops import idct

    outs = []
    for c, q in zip(planes, qts):
        *lead, by, bx, _ = c.shape
        rows = int(np.prod(lead, dtype=np.int64)) * by
        out = torch.empty((*lead, by * k, bx * k), dtype=torch.uint8, device=c.device)
        if rows * bx:
            _build.launch("jdtc_idct_scaled_percomp", _build.ptr(c), _build.ptr(q),
                          _build.ptr(idct.idct_matrix_scaled_on(c.device, k)), rows * bx, bx, k,
                          int(bits12), int(loads_first), _build.ptr(out), _build.stream_of(out))
        outs.append(out)
    return outs


def k5_empty(ctas) -> None:
    """An empty kernel of K5's threads once for each count of blocks of
    threads in `ctas`: the launch floor of a design with those grids."""
    from .. import _build

    stream = _build.stream_of(torch.empty(0, device="cuda"))
    for n in ctas:
        _build.launch("jdtc_idct_scaled_empty", int(n), stream)


def k5_grids(planes) -> tuple[list[int], int]:
    """The blocks of threads of the earlier design's launches (one a plane)
    and of the new design's one launch (each plane from a block of
    threads' boundary: the same count)."""
    from ..ops import idct

    per = [-(-c[..., 0].numel() // idct.K5_THREADS) for c in planes]
    return per, sum(per)


def k5_turns(planes, qts, k: int, reps: int, bits12: bool = False) -> dict:
    """K5 (one launch) beside its earlier design (a launch a plane) over the
    planes, in turns (in_turns), after holding the new design, the earlier
    one and the earlier one with its loads first bitwise against each
    other; beside them, the card alone and with L2 flushed, the earlier
    design with its loads first and the empty kernel at the earlier design's
    grids and at the new design's grid (k5_grids); with the blocks."""
    from ..ops import idct

    host = [q.cpu().numpy() for q in qts]
    new = lambda: idct.idct_planes_scaled(planes, host, k, bits12)  # noqa: E731
    earlier = lambda: k5_percomp(planes, qts, k, bits12)  # noqa: E731
    first = lambda: k5_percomp(planes, qts, k, bits12, loads_first=True)  # noqa: E731
    if not all(torch.equal(a, b) and torch.equal(a, c)
               for a, b, c in zip(new(), earlier(), first())):
        raise RuntimeError(f"K5 differs from its earlier design at k = {k}")
    per, one = k5_grids(planes)
    out = dict(in_turns(new, earlier, reps), blocks=sum(c[..., 0].numel() for c in planes),
               ctas=one, earlier_ctas=per)
    for key, fn in (("loads_first", first), ("empty_earlier_grids", lambda: k5_empty(per)),
                    ("empty_one_grid", lambda: k5_empty([one]))):
        out[f"{key}_ms"] = card_ms(fn, reps)
        out[f"{key}_flushed_ms"] = card_ms_flushed(fn, reps)
    return out


#: The H100's limits an SM for the blocks of threads resident at once: 2048
#: threads, 32 blocks of threads, 65,536 registers (allocated a warp at a
#: time in units of 256), 228 KB of shared memory with 1 KB reserved a
#: block of threads; 132 SMs.
SM_THREADS, SM_CTAS, SM_REGS, SM_SHARED, CTA_RESERVED, SMS = 2048, 32, 65536, 233472, 1024, 132


def k5_occupancy(ctas_by_k: dict, threads: int = 256) -> dict:
    """Each K5 kernel instance (template arguments in the symbol: K, and
    the earlier design's loads-first flag) as built: its registers, shared
    memory and instruction mix (_symbol_mix), the blocks of threads
    resident on an SM by the limits above, and the waves of its launches
    at `ctas_by_k` (k -> {"new": one grid, "earlier": the grids of its
    launches})."""
    from .. import _build

    mix, resources = _symbol_mix(str(_build.build()))
    out = {}
    for symbol, r in resources.items():
        if "idct_scaled" not in symbol or "empty" in symbol:
            continue
        m = re.search(r"ILi(\d)E(?:Lb(\d)E)?", symbol)
        k = int(m.group(1))
        earlier = "percomp" in symbol
        name = (f"earlier k={k}" + (" loads first" if m.group(2) == "1" else "")) if earlier \
            else f"new k={k}"
        warps = -(-threads // 32)
        regs_cta = -(-r.get("reg", 0) * 32 // 256) * 256 * warps
        resident = min(SM_THREADS // threads, SM_CTAS,
                       SM_REGS // regs_cta if regs_cta else SM_CTAS,
                       SM_SHARED // (r.get("shared", 0) + CTA_RESERVED))
        grids = ctas_by_k[k]["earlier" if earlier else "new"]
        out[name] = dict(**r, sass=dict(mix.get(symbol, {})), resident_ctas_per_sm=resident,
                         grids=grids,
                         waves=[round(g / (SMS * resident), 3) for g in grids])
    return out


def k5_sweep(reps: int) -> list[dict]:
    """K5 on the 4K request's three planes at k = 4, 2 and 1 (k5_turns), 8-
    bit, then each instance's occupancy (k5_occupancy)."""
    from .gather_probe import card_line
    from .inputs import F420, make_jpeg

    _frame, planes, qts = decoded([make_jpeg(W, H, F420, RI, 0)], torch.device("cuda"))
    per, one = k5_grids(planes)
    recs = [dict(kernel="K5", case=f"4K request, 3 planes, k = {k}", k=k, card=card_line(),
                 **k5_turns(planes, qts, k, reps)) for k in (4, 2, 1)]
    recs.append(dict(kernel="K5", occupancy=k5_occupancy(
        {k: {"new": [one], "earlier": per} for k in (1, 2, 4)})))
    return recs


def colour_pixel(planes, h, w, factors, quirks, upsample="nn", exact=True, raw_cmyk=False,
                 gray_shear=None, stripes=None):
    """K3's and K3f's earlier design (csrc/color.cu jdtc_color_pixel,
    jdtc_fancy_pixel: a thread a pixel) on card tensors, with
    planes_to_rgb's arguments and geometry: for measurement, reached by no
    wrapper."""
    from .. import Quirks
    from ..ops import color

    lead = planes[0].shape[:-2]
    shear = quirks == Quirks.REFERENCE if gray_shear is None else gray_shear
    fancy = upsample == "fancy" and len(planes) > 1
    mode = color.GRAY if len(planes) == 1 else color.colour_mode(len(planes), exact, raw_cmyk)
    return color._launch("jdtc_fancy_pixel" if fancy else "jdtc_color_pixel", planes, lead,
                         h, w, factors, quirks, mode, shear, stripes)


def k1_k3(planes, qts, frame, quirks, want_planes: bool = True):
    """The route K13 replaced: K1 per component, then K3."""
    from .. import IdctPrecision

    return k0_k3(planes, qts, frame, quirks, want_planes, IdctPrecision.FLOAT32)


def dequantized(planes, qts):
    """The [N, 64] float32 dequantized zigzag blocks of every component,
    stacked: the left operand of the FLOAT32 product (ops/idct.idct_float)."""
    from ..core.types import ZIGZAG

    rows = []
    for p, q in zip(planes, qts):
        zz = torch.as_tensor(ZIGZAG, dtype=torch.long, device=p.device)
        rows.append(p.reshape(-1, 64).to(torch.float32) * q[zz].to(torch.float32))
    return torch.cat(rows)


def product_ms(planes, qts, reps: int) -> float:
    """The card's time of the FLOAT32 product alone as one library call:
    torch.matmul of the dequantized [N, 64] blocks by K, TF32 off (cuBLAS):
    the yardstick for the product K1 and K13 form in their own bodies."""
    from ..ops import idct

    x = dequantized(planes, qts)
    k = idct.idct_matrix_on(x.device)
    out = torch.empty_like(x)
    with idct._true_float32_matmul():
        return card_ms(lambda: torch.matmul(x, k, out=out), reps)


def decoded(datas, device):
    """(frame, coefficient planes, tables) of the first stream, as the
    native host decoder reads it, its planes stacked with those of the rest
    when there are several (same geometry and tables), on `device`."""
    from .. import DecodeConfig, convert
    from ..models import host

    frames, stacks = [], []
    for data in datas:
        frame, planes, qts = host.host_decode(data, DecodeConfig())
        frames.append(frame)
        stacks.append(planes.planes)
    frame = frames[0]
    qt = [convert.quant_table_to_device(qts[c.qtid], device) for c in frame.components]
    if len(datas) == 1:
        return frame, [torch.from_numpy(p).to(device) for p in stacks[0]], qt
    return frame, [torch.from_numpy(np.stack([s[c] for s in stacks])).to(device)
                   for c in range(frame.ncs)], qt


def sweep(cases: dict, strips, reps: int, precision=None) -> list[dict]:
    """For each case name -> (frame, planes, tables, want_planes), K03 (or
    K13 under `precision` FLOAT32) at each G in `strips` (bitwise against
    the default G first), and the launches it replaced (`old_ms`: K0 x 3 +
    K3, or K1 x 3 + K3); one record per case and G."""
    from .. import IdctPrecision, Quirks
    from ..ops import pixel
    from .gather_probe import card_line

    precision = precision or IdctPrecision.EXACT
    fused = pixel.pixel_exact if precision == IdctPrecision.EXACT else pixel.pixel_float
    card = card_line()
    out = []
    for name, (frame, planes, qts, want) in cases.items():
        q = Quirks.REFERENCE
        factors = tuple((c.hsf, c.vsf) for c in frame.components)
        per_mcu = sum(fh * fv for fh, fv in factors)
        default = pixel.default_strip(factors, precision)
        base = fused(planes, qts, frame, q, want)
        old_ms = card_ms(lambda: k0_k3(planes, qts, frame, q, want, precision), reps)
        for g in strips:
            got = fused(planes, qts, frame, q, want, strip=g)
            same = torch.equal(got[0], base[0]) and (
                not want or all(torch.equal(a, b) for a, b in zip(got[1], base[1])))
            if not same:
                raise RuntimeError(f"{name}: G = {g} differs from G = {default}")
            ms = card_ms(lambda: fused(planes, qts, frame, q, want, strip=g), reps)
            out.append(dict(case=name, precision=precision.value, strip=g,
                            default=g == default, blocks=g * per_mcu, ms=ms,
                            old_ms=old_ms, card=card))
    return out


def _kernel_of(symbol: str):
    return next((k for k in SASS_KERNELS if k in symbol), None)


def _symbol_mix(lib: str) -> tuple[dict, dict]:
    """({symbol: {opcode: count}}, {symbol: resources}) of every kernel in
    the library at `lib` (cuobjdump -sass and -res-usage; the opcodes of
    SASS_OPS, the resources registers, spill bytes and static shared
    memory); ({}, {}) where the toolkit has no cuobjdump."""
    from .. import _build

    tool = Path(_build._nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return {}, {}
    out = subprocess.run([str(tool), "-sass", lib], capture_output=True,
                         text=True, check=True, timeout=300).stdout
    mix: dict = {}
    name = None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            continue
        op = re.match(r"\s+/\*[0-9a-f]+\*/\s+(?:@!?U?P\d+\s+)?([A-Z0-9]+)", line)
        if name and op and op.group(1) in SASS_OPS:
            mix.setdefault(name, collections.Counter())[op.group(1)] += 1
    res = subprocess.run([str(tool), "-res-usage", lib], capture_output=True,
                         text=True, timeout=300).stdout
    resources = {}
    name = None
    for line in res.splitlines():
        m = re.search(r"Function (\S+):", line)
        if m:
            name = m.group(1)
            continue
        if name and "REG:" in line:
            resources[name] = {k.lower(): int(v) for k, v in
                               re.findall(r"(REG|STACK|SHARED|LOCAL):(\d+)", line)}
    return mix, resources


def sass_mix() -> dict:
    """kernel -> {opcode: count} in the built library's SASS, for the
    kernels of SASS_KERNELS ({} where the toolkit has no cuobjdump): the
    instructions of their code as written, not counts a block (K0's code
    and its earlier design's run once a block, K03's row and column passes once a row and once a
    column, K13's product once a pixel row of four blocks), a template's
    instances summed; and under "resources" each one's registers, spill
    bytes and static shared memory (cuobjdump -res-usage; the last
    instance's)."""
    from .. import _build

    by_symbol, by_symbol_res = _symbol_mix(str(_build.build()))
    mix: dict = {}
    resources = {}
    for symbol, counts in by_symbol.items():
        name = _kernel_of(symbol)
        if name:
            mix.setdefault(name, collections.Counter()).update(counts)
    for symbol, r in by_symbol_res.items():
        name = _kernel_of(symbol)
        if name:
            resources[name] = r
    out = {k: dict(v) for k, v in mix.items()}
    out["resources"] = resources
    return out


#: K13's product as it was before K1, K13 and K4 shared idct_float.cuh's
#: `product`: K as four float4 first, then a block's x and dot4 a pixel.
K13_OWN_LOOP = r"""#pragma unroll
      for (int j = 0; j < kBlocksPerThread; ++j) {
#pragma unroll
        for (int px = 0; px < 4; ++px) acc[j][px] = 0.0f;
      }
#pragma unroll 2
      for (int z = 0; z < 64; z += 4) {
        float4 k[4];  // K[z + d][4q .. 4q + 3]
#pragma unroll
        for (int d = 0; d < 4; ++d) k[d] = *reinterpret_cast<const float4*>(kq + (z + d) * 64);
#pragma unroll
        for (int j = 0; j < kBlocksPerThread; ++j) {
          const float4 x =
              *reinterpret_cast<const float4*>(xt + (g + j * groups) * kXStride + z);
          acc[j][0] = jdtc_float::dot4(acc[j][0], x, k[0].x, k[1].x, k[2].x, k[3].x);
          acc[j][1] = jdtc_float::dot4(acc[j][1], x, k[0].y, k[1].y, k[2].y, k[3].y);
          acc[j][2] = jdtc_float::dot4(acc[j][2], x, k[0].z, k[1].z, k[2].z, k[3].z);
          acc[j][3] = jdtc_float::dot4(acc[j][3], x, k[0].w, k[1].w, k[2].w, k[3].w);
        }
      }
"""

#: Variants built from a copy of the package: name -> (the kernel, its
#: source edits as (file in csrc/, regular expression, replacement, the
#: count of matches expected), whether the copy must stay bitwise). The
#: K0 ones keep its layout with the chain's earlier spelling (float64
#: halvings and store) and with the halvings alone; the K13 ones test
#: its design: two attribute its time (without the product; without the
#: colour step and the stores of RGB and the planes), the others are the
#: choices it did not take (blocks a thread, a floor of threads for the
#: strip's other steps, K read from device memory through L1 instead of
#: shared memory) and its product loop before the shared tile; the K1 and
#: K4 ones their register tiles, thread counts and K4's run length, held
#: bitwise against the earlier design, and (dropping work) their time
#: without the product or, for K4, without forming the samples. A bitwise
#: K13 variant is timed in turns beside the tree's K13 (_worker).
VARIANTS = {
    "K0, earlier arithmetic": ("K0", [("idct_exact.cu", r"kArithmetic = 2;",
                                       "kArithmetic = 0;", 1)], True),
    "K0, halvings in float32": ("K0", [("idct_exact.cu", r"kArithmetic = 2;",
                                        "kArithmetic = 1;", 1)], True),
    "K0, 64 blocks a CTA": ("K0", [("idct_exact.cu", r"kThreads = 128;", "kThreads = 64;", 1)],
                            True),
    "K0, 256 blocks a CTA": ("K0", [("idct_exact.cu", r"kThreads = 128;", "kThreads = 256;",
                                     1)], True),
    "K13 without the product": ("K13", [("idct_float.cuh", r"z < 64; z \+= 4", "z < 0; z += 4",
                                         1)], False),
    "K13 without the colour step and the stores": (
        "K13", [("pixel_float.cu",
                 r"    jdtc_strip::(store_planes|colour_tiles|store_rgb)\(p, s, smem, tid, nt\);\n",
                 "", 3)], False),
    "K13, two blocks a thread": ("K13", [("pixel_float.cu", r"kBlocksPerThread = 4;",
                                          "kBlocksPerThread = 2;", 1)], True),
    "K13, eight blocks a thread": ("K13", [("pixel_float.cu", r"kBlocksPerThread = 4;",
                                            "kBlocksPerThread = 8;", 1)], True),
    "K13, 256 threads at least": ("K13", [("pixel_float.cu", r"kMinThreads = 64;",
                                           "kMinThreads = 256;", 1)], True),
    "K13, its own product loop": ("K13", [
        ("pixel_float.cu", r"      jdtc_float::product<kBlocksPerThread, 4>\(kq, xt \+ g \* kXStride,"
                           r" groups \* kXStride, acc\);\n", K13_OWN_LOOP, 1)], True),
    "K13, K through L1": ("K13", [
        ("pixel_float.cu", r"kq = ks \+ 4 \* q;", "kq = p.kmat + 4 * q;", 1),
        ("pixel_float.cu", r"  for \(int k = tid; k < 64 \* 16; k \+= nt\) jdtc_strip::cp_async16"
                           r"\(ks \+ 4 \* k, p.kmat \+ 4 \* k\);\n", "", 1),
        ("pixel_float.cu", r"p.sm_k \+ 64 \* 64 \* 4,", "p.sm_k,", 1)], True),
    "K1, 256 threads of four blocks": ("K1", [
        ("idct_float.cu", r"kThreads = 128;", "kThreads = 256;", 1),
        ("idct_float.cu", r"kBlocksPerThread = 8;", "kBlocksPerThread = 4;", 1)], True),
    "K1, 256 threads of two blocks": ("K1", [
        ("idct_float.cu", r"kThreads = 128;", "kThreads = 256;", 1),
        ("idct_float.cu", r"kBlocksPerThread = 8;", "kBlocksPerThread = 2;", 1)], True),
    "K1, 8 blocks x 8 pixels": ("K1", [("idct_float.cu", r"kCols = 4;", "kCols = 8;", 1)], True),
    "K1 without the product": ("K1", [("idct_float.cu", r"    jdtc_float::product<kBlocksPerThread,"
                                       r" kCols>\(.*?\n.*?acc\);",
                                       "    for (auto& a : acc) for (auto& v : a) v = q;", 1)],
                               False),
    "K4 without the product": ("K4", [
        ("fdct.cu", r"    jdtc_float::product<kBlocksPerThread, kCols>"
                    r"\(kq, x, groups \* kXStride, acc\);",
         "    for (auto& a : acc) for (auto& v : a) v = x[0];", 1)], False),
    "K4 without the samples": ("K4", [
        ("fdct.cu", r"    form_samples<S>\(p, r, rgb, tile, tid, nt\);", "", 1)], False),
    "K4, registers for one block of threads an SM": (
        "K4", [("fdct.cu", r"kMinBlocksPerSm = 2;", "kMinBlocksPerSm = 1;", 1)], True),
    "K4, 256 threads": ("K4", [("fdct.cu", r"kMaxThreads = 512;", "kMaxThreads = 256;", 1)],
                        True),
    "K4, 4 blocks x 8 coefficients": ("K4", [("fdct.cu", r"kCols = 4;", "kCols = 8;", 1)], True),
    "K4, 8 blocks x 4 coefficients, 256 threads": ("K4", [
        ("fdct.cu", r"kBlocksPerThread = 4;", "kBlocksPerThread = 8;", 1),
        ("fdct.cu", r"kMaxThreads = 512;", "kMaxThreads = 256;", 1)], True),
    **{f"K4, runs of {n} blocks": ("K4", [("fdct.cu", r"kRunBlocks = 96;",
                                           f"kRunBlocks = {n};", 1)], True)
       for n in (48, 72, 120, 144, 192)},
}


def variant_inputs(path: Path, dense, photo=None) -> None:
    """The variants' inputs into `path`: the dense 4K request with planes
    and eight such requests without, as the native host decoder reads
    them; K4's, the 4K photograph (photograph_4k), where given; and the
    path of the tree's own kernel library, which a K13 variant is timed
    beside."""
    from .. import _build

    cases = {"dense 4K request, planes": (*decoded(dense[:1], "cpu"), True),
             "8 x dense 4K, RGB only": (*decoded(dense, "cpu"), False)}
    torch.save({"cases": cases, "photograph": None if photo is None else photo.cpu(),
                "library": str(_build.build())}, path)


def on_library(lib, fn):
    """fn with every launch it makes going to kernel library `lib`
    (_build.load) instead of the process's own."""
    from .. import _build

    def call():
        own = _build.library()
        _build._lib = lib
        try:
            return fn()
        finally:
            _build._lib = own

    return call


def build_variant(name: str, inputs: Path, reps: int) -> list[dict]:
    """VARIANTS[name] built in a temporary copy of the package and timed
    there by a process of its own (_worker) on the inputs in file `inputs`
    (variant_inputs)."""
    _kernel, edits, _bitwise = VARIANTS[name]
    with tempfile.TemporaryDirectory() as tmp:
        pkg = Path(tmp) / PACKAGE.name
        shutil.copytree(PACKAGE, pkg, ignore=shutil.ignore_patterns("__pycache__", "build"))
        for file, pattern, replacement, count in edits:
            path = pkg / "csrc" / file
            text, n = re.subn(pattern, replacement, path.read_text(), flags=re.M)
            if n != count:
                raise RuntimeError(f"{name}: {file}: {n} edits, expected {count}")
            path.write_text(text)
        r = subprocess.run([sys.executable, "-m", f"{PACKAGE.name}.benchmarks.pixel_sweep",
                            "--worker", name, str(inputs), "--reps", str(reps)],
                           cwd=tmp, capture_output=True, text=True, timeout=900)
        if r.returncode != 0:
            raise RuntimeError(f"the variant {name!r} failed: {r.stderr[-3000:]}")
        return [json.loads(line) for line in r.stdout.strip().splitlines()]


def _worker(name: str, inputs: str, reps: int) -> None:
    """In a variant's copy: its kernel held bitwise against K03's plain
    version, K1 x 3 + K3 or (K1, K4) its earlier design, unless the variant
    drops work, then timed; a bitwise K13 variant also held bitwise against
    the tree's K13 and timed in turns beside it (in_turns: `tree_` the
    tree's)."""
    from .. import IdctPrecision, Quirks, _build
    from ..ops import idct, pixel
    from .gather_probe import card_line

    kernel, _edits, bitwise = VARIANTS[name]
    fn, want_fn = ((pixel.pixel_exact, pixel._pixel_exact_plain) if kernel == "K03"
                   else (pixel.pixel_float, k1_k3))
    q = Quirks.REFERENCE
    data = torch.load(inputs, weights_only=False)
    if kernel == "K4":
        from ..models import encoder
        from ..ops import fdct

        photo = data["photograph"].cuda()
        kq = fdct.fdct_tables(encoder.quality_qtables(85), photo.device)
        for sub in ("420", "444"):
            factors = encoder._SAMPLING[sub]
            rec = (k4_turns(photo, factors, kq, reps) if bitwise else in_turns(
                lambda f=factors: fdct.encode_planes(photo, f, kq),
                lambda f=factors: fdct_column(photo, f, kq), reps))
            print(json.dumps(dict(case=f"4K photograph {sub}", variant=name, kernel=kernel,
                                  bitwise_checked=bitwise, card=card_line(), **rec)),
                  flush=True)
        return
    for case, (frame, planes, qts, want) in data["cases"].items():
        planes = [t.cuda() for t in planes]
        qts = [t.cuda() for t in qts]
        if kernel == "K1":
            if case != "dense 4K request, planes":
                continue
            for label, cs, ts in (("luma plane", planes[:1], qts[:1]), ("3 planes", planes, qts)):
                # held bitwise against the earlier design, unless the variant drops work
                rec = k1_turns(cs, ts, reps) if bitwise else in_turns(
                    lambda c=cs, t=ts: [idct.idct_plane(a, b, False, IdctPrecision.FLOAT32)
                                        for a, b in zip(c, t)],
                    lambda c=cs, t=ts: [k1_column(a, b) for a, b in zip(c, t)], reps)
                print(json.dumps(dict(case=f"{case}, {label}", variant=name, kernel=kernel,
                                      bitwise_checked=bitwise, card=card_line(), **rec)),
                      flush=True)
            continue
        if kernel == "K0":
            k0 = lambda: [idct.idct_plane(c, t) for c, t in zip(planes, qts)]  # noqa: E731
            if any(not torch.equal(a, k0_plain(c, t)) for a, c, t in zip(k0(), planes, qts)):
                raise RuntimeError(f"{case}: the variant {name!r} changed the bytes")
            by_plane = [card_ms(lambda c=c, t=t: idct.idct_plane(c, t), reps)
                        for c, t in zip(planes, qts)]
            print(json.dumps(dict(case=case, variant=name, kernel=kernel, bitwise_checked=True,
                                  ms=card_ms(k0, reps), flushed_ms=card_ms_flushed(k0, reps),
                                  ms_by_plane=by_plane, card=card_line())), flush=True)
            continue
        if bitwise:
            got = fn(planes, qts, frame, q, want)
            ref = want_fn(planes, qts, frame, q, want)
            if not torch.equal(got[0], ref[0]) or (
                    want and not all(torch.equal(a, b) for a, b in zip(got[1], ref[1]))):
                raise RuntimeError(f"{case}: the variant {name!r} changed the bytes")
        mine = lambda: fn(planes, qts, frame, q, want)  # noqa: E731
        if kernel == "K13" and bitwise:
            tree = on_library(_build.load(data["library"]), mine)
            got, ref = mine(), tree()
            if not torch.equal(got[0], ref[0]) or (
                    want and not all(torch.equal(a, b) for a, b in zip(got[1], ref[1]))):
                raise RuntimeError(f"{case}: the variant {name!r} differs from the tree's K13")
            turns = in_turns(mine, tree, reps)
            rec = {k.replace("earlier_", "tree_"): v for k, v in turns.items()}
        else:
            rec = dict(ms=card_ms(mine, reps))
        print(json.dumps(dict(case=case, variant=name, kernel=kernel, bitwise_checked=bitwise,
                              card=card_line(), **rec)), flush=True)


def k0_plain(coeff_plane, qt, bits12: bool = False):
    """K0's plain version on a coefficient plane [..., by, bx, 64]: the
    pixel plane idct_plane gives on a CPU tensor, on the tensor's device."""
    from ..ops import idct

    *lead, by, bx, _ = coeff_plane.shape
    rows = int(np.prod(lead, dtype=np.int64)) * by
    return idct.blocks_to_plane(idct.idct_exact(coeff_plane.reshape(-1, 64), qt, bits12),
                                rows, bx).reshape(*lead, by * 8, bx * 8)


def k0_turns(planes, qts, reps: int) -> dict:
    """K0 over the planes (one launch a plane, as a request) beside its
    earlier design, in turns (in_turns), after holding both bitwise against
    the plain version; with the blocks."""
    from ..ops import idct

    new = lambda: [idct.idct_plane(c, t) for c, t in zip(planes, qts)]  # noqa: E731
    earlier = lambda: [k0_gather(c, t) for c, t in zip(planes, qts)]  # noqa: E731
    for a, b, c, t in zip(new(), earlier(), planes, qts):
        want = k0_plain(c, t)
        if not (torch.equal(a, want) and torch.equal(b, want)):
            raise RuntimeError("K0 or its earlier design differs from the plain version")
    by_plane = [card_ms(lambda c=c, t=t: idct.idct_plane(c, t), reps) for c, t in zip(planes, qts)]
    return dict(in_turns(new, earlier, reps), card_ms_by_plane=by_plane,
                blocks=sum(c[..., 0].numel() for c in planes))


def colour_turns(planes, h, w, factors, reps: int, upsample="nn", exact=True,
                 raw_cmyk=False) -> dict:
    """K3/K3f over the planes (REFERENCE) beside its earlier design, in
    turns, after holding both bitwise against the plain version; with the
    output pixels."""
    from .. import Quirks
    from ..ops import color

    args = (planes, h, w, factors, Quirks.REFERENCE, upsample, exact, raw_cmyk)
    new = lambda: color.planes_to_rgb(*args)  # noqa: E731
    earlier = lambda: colour_pixel(*args)  # noqa: E731
    want = color._planes_to_rgb_plain(*args)
    if not (torch.equal(new(), want) and torch.equal(earlier(), want)):
        raise RuntimeError("K3/K3f or its earlier design differs from the plain version")
    return dict(in_turns(new, earlier, reps), pixels=want[..., 0].numel())


def colour_cases(dense, cmyk) -> dict:
    """The colour kernels' 4K cases: name -> (planes, h, w, factors,
    upsample, exact, raw_cmyk), from the pixel planes of the dense 4K
    request (one, and eight stacked) and of the 4K 4:4:4 four-component
    frame."""
    from ..core import oracle

    def pix(data):
        from .. import DecodeConfig
        from ..models import host

        frame, planes, qts = host.host_decode(data, DecodeConfig())
        return [torch.from_numpy(p).cuda() for p in oracle.pixels_from_coeffs(frame, planes, qts)]

    one = pix(dense[0])
    eight = [torch.stack(ps) for ps in zip(*[pix(d) for d in dense])]
    four = pix(cmyk)
    f420 = ((2, 2), (1, 1), (1, 1))
    f4 = ((1, 1),) * 4
    return {
        "K3f, 4K 4:2:0": (one, H, W, f420, "fancy", True, False),
        "K3f, 8 x 4K 4:2:0": (eight, H, W, f420, "fancy", True, False),
        "K3, 4K 4:2:0": (one, H, W, f420, "nn", True, False),
        "K3c YCCK EXACT, 4K 4:4:4": (four, H, W, f4, "nn", True, False),
        "K3c YCCK FLOAT32, 4K 4:4:4": (four, H, W, f4, "nn", False, False),
        "K3c CMYK, 4K 4:4:4": (four, H, W, f4, "nn", True, True),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--strip", type=int, nargs="+", default=[2, 4, 8, 16, 32])
    ap.add_argument("--reps", type=int, default=15)
    ap.add_argument("--precision", nargs="+", choices=["exact", "float32"],
                    default=["exact", "float32"])
    ap.add_argument("--k13-variants", action="store_true",
                    help="also time K13's variants (copies of the package)")
    ap.add_argument("--k0", action="store_true",
                    help="also K0 beside its earlier design, and its arithmetic's variants")
    ap.add_argument("--colour", action="store_true",
                    help="also K3f, K3 and K3c beside their earlier design")
    ap.add_argument("--k1", action="store_true",
                    help="also K1 beside its earlier design, and K1's and K13's variants")
    ap.add_argument("--k4", action="store_true",
                    help="also K4 beside its earlier design, and K4's variants")
    ap.add_argument("--k5", action="store_true",
                    help="also K5 beside its earlier design and the launch floor")
    ap.add_argument("--no-sweep", action="store_true",
                    help="only the variants and --k0/--colour/--k1/--k4/--k5")
    ap.add_argument("--worker", nargs=2, help=argparse.SUPPRESS)
    ns = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("pixel_sweep needs a CUDA card")
    if ns.worker:
        _worker(*ns.worker, ns.reps)
        return
    from .inputs import F420, PHOTOS_420, make_jpeg, photo_jpeg

    dense = [make_jpeg(W, H, F420, RI, seed) for seed in range(8)]
    names = ([n for n, v in VARIANTS.items() if v[0] == "K13"] if ns.k13_variants else []) + (
        [n for n, v in VARIANTS.items() if v[0] == "K0"] if ns.k0 else []) + (
        [n for n, v in VARIANTS.items() if v[0] == "K1"] if ns.k1 else []) + (
        [n for n, v in VARIANTS.items() if v[0] == "K4"] if ns.k4 else [])
    from .gather_probe import card_line

    if ns.k0:
        for case, datas in (("4K request, 3 planes", dense[:1]), ("8 x 4K, 3 stacked planes",
                                                                  dense)):
            _frame, planes, qts = decoded(datas, torch.device("cuda"))
            print(json.dumps(dict(kernel="K0", case=case, card=card_line(),
                                  **k0_turns(planes, qts, ns.reps))), flush=True)
    if ns.colour:
        from .inputs import CMYK_FILE

        cmyk = photo_jpeg(CMYK_FILE, W, H, W // 8)
        for case, (planes, h, w, factors, up, exact, raw) in colour_cases(dense, cmyk).items():
            print(json.dumps(dict(case=case, card=card_line(), **colour_turns(
                planes, h, w, factors, ns.reps, up, exact, raw))), flush=True)
    if ns.k1:
        for case, datas in (("4K request, luma plane", dense[:1]),
                            ("4K request, 3 planes", dense[:1])):
            _frame, planes, qts = decoded(datas, torch.device("cuda"))
            if "luma" in case:
                planes, qts = planes[:1], qts[:1]
            print(json.dumps(dict(kernel="K1", case=case, card=card_line(),
                                  **k1_turns(planes, qts, ns.reps))), flush=True)
    if ns.k4:
        for rec in k4_sweep(ns.reps):
            print(json.dumps(rec), flush=True)
    if ns.k5:
        for rec in k5_sweep(ns.reps):
            print(json.dumps(rec), flush=True)
    if ns.k0 or ns.k1 or ns.k4 or ns.k5:
        print(json.dumps({"sass": sass_mix()}), flush=True)
    if names:
        with tempfile.TemporaryDirectory() as tmp:
            inputs = Path(tmp) / "inputs.pt"
            variant_inputs(inputs, dense, photograph_4k() if ns.k4 else None)
            for name in names:
                for rec in build_variant(name, inputs, ns.reps):
                    print(json.dumps(rec), flush=True)
    if ns.no_sweep:
        return
    dev = torch.device("cuda")
    photo = photo_jpeg(PHOTOS_420[0], W, H, RI)
    cases = {
        "dense 4K request, planes": (*decoded(dense[:1], dev), True),
        "photograph tiled to 4K, planes": (*decoded([photo], dev), True),
        "8 x dense 4K, RGB only": (*decoded(dense, dev), False),
    }
    from .. import IdctPrecision

    for precision in ns.precision:
        for rec in sweep(cases, ns.strip, ns.reps, IdctPrecision(precision)):
            print(json.dumps(rec), flush=True)
    print(json.dumps({"sass": sass_mix()}), flush=True)


if __name__ == "__main__":
    main()
