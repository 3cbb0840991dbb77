"""K2u (csrc/unstuff.cu) on one CUDA card: the single-pass kernel beside
the earlier three-kernel design and what bounds them, and at other tile
sizes.

    python -m jpeg_decoder_tpu_torch.benchmarks.k2u_sweep \\
        [--reps 15] [--threads 128 256 512] [--vecs 1 2] [--variants]
        [--variants-only]

Inputs (benchmarks/inputs.py): one 3840x2160 4:2:0 request of random dense
blocks, the two photographs tiled to that size, a 640x352 stream and eight
dense 4K requests in one call. For each, one JSON line, each kernel first
held bitwise against the plain version:
  - `card_ms` of the single pass (`jdtc_unstuff`: the memset of its
    scratch, the pass and the one-block sub_base kernel) and `card_ms_3pass` of the three kernels
    (`jdtc_unstuff_3pass`), timed in turns, three-pass, single, single,
    three-pass: the card's time alone (`pixel_sweep.card_ms`, calls
    queued behind a spin kernel);
  - `copy_card_ms`: a device-to-device copy of the same raw bytes, the floor
    of any pass that reads and writes each byte once, the card alone;
  - `compaction_ms`: the compaction as one PyTorch call, `raw[keep]` with
    the mask made beforehand (a yardstick the port never calls; it
    synchronises to learn its output's size, so CUDA events around one
    call);
  - `wrapper_ms`: `unstuff_segments` between CUDA events, one call, and
    `wrapper_readback_ms`: the three-kernel wrapper, the kernels and the read-back
    of `seg_off` it ended with, the same way;
  - the bound: the raw bytes and bounds read once, the stream and its
    offsets written once, over 3.35 TB/s.
Then the stage lines' order replayed (the dense request, then the two
photographs): each wrapper's first call between CUDA events, its host time
and the device segments the caching allocator added; and the registers,
spills and shared memory of the kernels of csrc/unstuff.cu (nvcc -Xptxas
-v, a few seconds). With --threads/--vecs, copies of the package with
kThreads and kVecs rewritten (a tile is kThreads x 16 x kVecs bytes), and
with --variants the copies of VARIANTS, which drop one step to attribute
the time (not checked: their output is wrong); each copy is built by nvcc
in a temporary directory and run in a process of its own on the same
streams, the tile sizes held bitwise against the plain version first.
Each line carries the card's name and power limit; compare within one run
only.
"""

from __future__ import annotations

import argparse
import json
import pickle
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

PACKAGE = Path(__file__).resolve().parents[1]
W, H, RI = 3840, 2160, 240
SEEDS = (20261016, 1, 2, 3, 4, 5, 6, 7)
HBM_BYTES_PER_S = 3.35e12


def events_ms(fn, reps: int) -> list[float]:
    """Each of `reps` calls of fn between two CUDA events."""
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return out


def device_args(datas, dev):
    """raw, lo, hi of a group of streams on `dev`, as launch_args uploads
    them."""
    from ..io.parser import parse
    from ..ops import entropy_cuda

    structures = [parse(d) for d in datas]
    packs = [entropy_cuda.prepare_scan(s, s.scans[0]) for s in structures]
    raw, lo, hi, *_ = entropy_cuda.to_device(entropy_cuda.host_args(packs), dev)
    return raw, lo, hi


def case_streams() -> dict:
    """name -> the JPEG streams of one K2u call; the first three in the
    stage lines' order."""
    from .inputs import F420, PHOTOS_420, make_jpeg, photo_jpeg

    dense = [make_jpeg(W, H, F420, RI, seed) for seed in SEEDS]
    out = {"dense 4K request": dense[:1]}
    for p in PHOTOS_420:
        out[f"photograph {p.stem} tiled to 4K"] = [photo_jpeg(p, W, H, RI)]
    out["640x352 stream"] = [make_jpeg(640, 352, F420, 40, 12)]
    out["8 x dense 4K, one call"] = dense
    return out


def cases(streams: dict, dev) -> dict:
    """case_streams' groups as (raw, lo, hi) on `dev`."""
    return {name: device_args(datas, dev) for name, datas in streams.items()}


def check(raw, lo, hi) -> tuple:
    """The single pass and the three kernels bitwise against the plain
    version: returns (plain result, the bytes defined)."""
    from ..ops import entropy_cuda

    want = entropy_cuda._unstuff_plain(raw, lo, hi)
    end = int(want.seg_off[-1]) + 8
    got = entropy_cuda.unstuff_segments(raw, lo, hi)
    old, old_off = entropy_cuda._unstuff_3pass(raw, lo, hi)
    if not (torch.equal(got.stream[:end], want.stream[:end])
            and torch.equal(got.seg_off, want.seg_off)
            and torch.equal(got.sub_base, want.sub_base)
            and torch.equal(old[:end], want.stream[:end]) and torch.equal(old_off, want.seg_off)):
        raise RuntimeError("K2u differs from its plain version")
    return want, end


def bound(raw, lo, want, end) -> dict:
    """Bytes that any K2u must move: raw bytes and bounds in, the stream,
    its tail and offsets out."""
    nbytes = raw.numel() + 16 * lo.numel() + end + 8 * want.seg_off.numel()
    return dict(bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes", bound_bytes=nbytes)


def measure(name, raw, lo, hi, reps: int, card: str) -> dict:
    from ..ops import entropy_cuda
    from .pixel_sweep import card_ms

    want, end = check(raw, lo, hi)
    single = lambda: entropy_cuda.unstuff_segments(raw, lo, hi)
    three = lambda: entropy_cuda._unstuff_3pass(raw, lo, hi)
    old = [card_ms(three, reps)]
    new = [card_ms(single, reps), card_ms(single, reps)]
    old.append(card_ms(three, reps))
    out = torch.empty_like(raw)
    keep = entropy_cuda._keep_mask(raw, lo, hi)
    return dict(
        case=name, raw_bytes=raw.numel(), segments=lo.numel(), kept=end - 8,
        card_ms=statistics.median(new), card_ms_runs=new,
        card_ms_3pass=statistics.median(old), card_ms_3pass_runs=old,
        copy_card_ms=card_ms(lambda: out.copy_(raw), reps),
        compaction_ms=statistics.median(events_ms(lambda: raw[keep], reps)),
        wrapper_ms=statistics.median(events_ms(single, reps)),
        wrapper_readback_ms=statistics.median(
            events_ms(lambda: three()[1].cpu(), reps)),
        **bound(raw, lo, want, end), card=card)


def replay(named: dict, reps: int, card: str) -> list[dict]:
    """The stage lines' K2u call in their order, single pass and the three-kernel
    wrapper with its read-back: one call between events (as
    chip_smoke.stage_times takes it), then `reps` more; the host clock of
    the first; the device segments the caching allocator added."""
    from ..ops import entropy_cuda

    out = []
    for name, (raw, lo, hi) in named.items():
        for kind, fn in (("single pass", lambda: entropy_cuda.unstuff_segments(raw, lo, hi)),
                         ("3pass with read-back",
                          lambda: entropy_cuda._unstuff_3pass(raw, lo, hi)[1].cpu())):
            before = torch.cuda.memory_stats().get("segment.all.allocated", 0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            first = events_ms(fn, 1)[0]
            first_host = (time.perf_counter() - t0) * 1e3
            segments = torch.cuda.memory_stats().get("segment.all.allocated", 0) - before
            out.append(dict(replay=name, kernel=kind, first_ms=first, first_host_ms=first_host,
                            new_device_segments=segments, later_ms=events_ms(fn, reps),
                            card=card))
    return out


def ptxas_report(source: str = "unstuff.cu") -> dict:
    """kernel -> {registers, spill bytes, shared memory} of csrc/`source` as
    nvcc -Xptxas -v reports them ({} without nvcc)."""
    from .. import _build

    try:
        nvcc = _build._nvcc()
    except RuntimeError:
        return {}
    with tempfile.TemporaryDirectory() as tmp:
        r = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
                            str(_build.SRC_DIR / source), "-o", str(Path(tmp) / "u.o")],
                           capture_output=True, text=True, timeout=300)
    report, name = {}, None
    for line in (r.stdout + r.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            sym = m.group(1)
            name = next((k for k in ("unstuff_kernel", "sub_base_kernel", "count_kernel",
                                     "block_scan_kernel", "scatter_kernel", "fdct_kernel",
                                     "fdct_column_kernel")
                         if k in sym), sym)
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            report.setdefault(name, {})["spill_store_bytes"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            report.setdefault(name, {})["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            report[name]["shared_bytes"] = int(s.group(1)) if s else 0
    return report


#: Copies of csrc/unstuff.cu that drop a step, to attribute the single
#: pass's time (their output is wrong, so nothing checks it): name -> the
#: source edits as (regular expression, replacement, matches expected).
VARIANTS = {
    # every tile's offset is its own first byte: no tile waits for another
    "without the look-back": [
        (r"unsigned long long offset = 0;", "unsigned long long offset = t0;", 1),
        (r"if \(tile > 0\) \{\n      for \(int64_t end", "if (false) {\n      for (int64_t end", 1)],
    "without the stores": [
        (r"for \(int q = 16 \* tid; q < end;", "for (int q = 16 * tid; q < 0;", 1)],
    "without the layout kernel": [
        (r"  sub_base_kernel<<<1, kScanThreads, 0, st>>>\(g\.seg_off, n_segs, sub_bytes,\n"
         r"\s+static_cast<int64_t\*>\(sub_base\)\);\n", "", 1)],
}


def worker(inputs: str, reps: int, bitwise: bool) -> None:
    """In a variant's copy: its single pass held bitwise against the plain
    version (unless it drops work), then timed on every case of the
    streams saved in `inputs`."""
    from .. import _build
    from ..ops import entropy_cuda
    from .gather_probe import card_line
    from .pixel_sweep import card_ms

    dev = torch.device("cuda")
    card = card_line()
    tile = _build.library().jdtc_unstuff_tile_bytes()
    streams = pickle.loads(Path(inputs).read_bytes())
    for name, (raw, lo, hi) in cases(streams, dev).items():
        if bitwise:
            check(raw, lo, hi)
        ms = card_ms(lambda: entropy_cuda.unstuff_segments(raw, lo, hi), reps)
        print(json.dumps(dict(case=name, tile_bytes=tile, card_ms=ms, bitwise_checked=bitwise,
                              card=card)), flush=True)


def build_variant(label: str, edits, inputs: Path, reps: int, bitwise: bool) -> list[dict]:
    """A copy of the package with `edits` made to csrc/unstuff.cu, built by
    nvcc in a temporary directory and timed there by a process of its own
    (worker)."""
    with tempfile.TemporaryDirectory() as tmp:
        pkg = Path(tmp) / PACKAGE.name
        shutil.copytree(PACKAGE, pkg, ignore=shutil.ignore_patterns("__pycache__", "build"))
        cu = pkg / "csrc" / "unstuff.cu"
        for pattern, replacement, count in edits:
            text, n = re.subn(pattern, replacement, cu.read_text())
            if n != count:
                raise RuntimeError(f"{label}: {pattern!r} matched {n} times, expected {count}")
            cu.write_text(text)
        r = subprocess.run(
            [sys.executable, "-m", f"{PACKAGE.name}.benchmarks.k2u_sweep", "--reps", str(reps),
             "--worker", str(inputs), *([] if bitwise else ["--unchecked"])],
            cwd=tmp, capture_output=True, text=True, timeout=900)
        if r.returncode != 0:
            raise RuntimeError(f"{label}: {r.stderr[-3000:]}")
        return [json.loads(line) for line in r.stdout.strip().splitlines()]


def sweep(threads, vecs, variants: bool, reps: int) -> None:
    """The tile sizes (kThreads x kVecs) and, with `variants`, VARIANTS, each
    a copy of the package timed on the same streams."""
    runs = [(f"threads {t}, vecs {v}", dict(threads=t, vecs=v), [
        (r"constexpr int kThreads = \d+;(\s+// threads of a block)",
         rf"constexpr int kThreads = {t};\1", 1),
        (r"constexpr int kVecs = \d+;", f"constexpr int kVecs = {v};", 1)], True)
        for t in threads for v in vecs]
    if variants:
        runs += [(name, dict(variant=name), edits, False) for name, edits in VARIANTS.items()]
    with tempfile.TemporaryDirectory() as tmp:
        inputs = Path(tmp) / "streams.pickle"
        inputs.write_bytes(pickle.dumps(case_streams()))
        for label, tags, edits, bitwise in runs:
            for rec in build_variant(label, edits, inputs, reps, bitwise):
                print(json.dumps(dict(**tags, **rec)), flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=15)
    ap.add_argument("--threads", type=int, nargs="+", default=[])
    ap.add_argument("--vecs", type=int, nargs="+", default=[1])
    ap.add_argument("--variants", action="store_true",
                    help="also time VARIANTS (copies that drop a step)")
    ap.add_argument("--variants-only", action="store_true")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--unchecked", action="store_true", help=argparse.SUPPRESS)
    ns = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k2u_sweep needs a CUDA card")
    if ns.worker:
        worker(ns.worker, ns.reps, not ns.unchecked)
        return
    if ns.threads or ns.variants:
        sweep(ns.threads, ns.vecs, ns.variants, ns.reps)
    if ns.variants_only:
        return
    from .gather_probe import card_line

    card = card_line()
    named = cases(case_streams(), torch.device("cuda"))
    check(*named["640x352 stream"])  # builds and loads the kernels
    for rec in replay(dict(list(named.items())[:3]), 5, card):
        print(json.dumps(rec), flush=True)
    for name, (raw, lo, hi) in named.items():
        print(json.dumps(measure(name, raw, lo, hi, ns.reps, card)), flush=True)
    print(json.dumps({"ptxas": ptxas_report(), "card": card}), flush=True)


if __name__ == "__main__":
    main()
