"""K03 (csrc/pixel_exact.cu) at other strip sizes, on one CUDA card.

    python -m jpeg_decoder_tpu_torch.benchmarks.pixel_sweep \\
        [--strip 2 4 8 16 32] [--reps 15] [--halve-in-float]

G, the MCUs of one strip (one block of threads), is an argument of the
kernel, so one build serves every size. The inputs are the coefficient
planes of a 3840x2160 4:2:0 request of random dense blocks
(inputs.make_jpeg) and of a photograph tiled to that size
(inputs.photo_jpeg), as the native host decoder reads them: one request
with its pixel planes (JpegDecoder's case) and eight stacked without them
(BatchDecoder's). Every variant is first held bitwise against the default
G. Each line is one JSON object: G, the coefficient blocks of a block of
threads (8 threads a block, at most 1024), and the card's time for one call
(`card_ms`), beside K0 x 3 + K3 on the same inputs in the same way, with
the card's name and power limit. Compare within one run only.

Also one line of the instruction mix of K03 and K0 as built (cuobjdump
-sass: the counts of the opcodes that take the time, per kernel), and with
--halve-in-float the same timing for a copy of the package whose EXACT
IDCT (csrc/idct_exact.cuh) computes each `st(mul(0.5, x))` as the float32
product `__fmul_rn(0.5f, x)`: bitwise the same result (halving is exact
in both types, so the float64 product rounded to float32 is the float32
product), two 64-bit conversions fewer each; that copy is built by nvcc in a
temporary directory, run in a process of its own and held bitwise against
the plain version.
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
#: memory loads and stores.
SASS_OPS = ("F2F", "F2I", "I2F", "I2FP", "FRND", "DMUL", "DADD", "FADD", "FMUL", "LDS", "STS")
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


def k0_k3(planes, qts, frame, quirks, want_planes: bool = True):
    """The route K03 replaced: K0 per component, then K3."""
    from ..ops import color, idct

    bits12 = frame.precision == 12
    pixel = [idct.idct_plane(p, q, bits12) for p, q in zip(planes, qts)]
    rgb = color.planes_to_rgb(pixel, frame.height, frame.width,
                              tuple((c.hsf, c.vsf) for c in frame.components), quirks)
    return rgb, (pixel if want_planes else None)


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


def sweep(cases: dict, strips, reps: int) -> list[dict]:
    """For each case name -> (frame, planes, tables, want_planes), K03 at
    each G in `strips` (bitwise against the default G first), and K0 x 3 +
    K3; one record per case and G."""
    from .. import Quirks
    from ..ops import pixel
    from .gather_probe import card_line

    card = card_line()
    out = []
    for name, (frame, planes, qts, want) in cases.items():
        q = Quirks.REFERENCE
        factors = tuple((c.hsf, c.vsf) for c in frame.components)
        per_mcu = sum(fh * fv for fh, fv in factors)
        base = pixel.pixel_exact(planes, qts, frame, q, want)
        old_ms = card_ms(lambda: k0_k3(planes, qts, frame, q, want), reps)
        for g in strips:
            got = pixel.pixel_exact(planes, qts, frame, q, want, strip=g)
            same = torch.equal(got[0], base[0]) and (
                not want or all(torch.equal(a, b) for a, b in zip(got[1], base[1])))
            if not same:
                raise RuntimeError(f"{name}: G = {g} differs from G = {pixel.default_strip(factors)}")
            ms = card_ms(lambda: pixel.pixel_exact(planes, qts, frame, q, want, strip=g), reps)
            out.append(dict(case=name, strip=g, default=g == pixel.default_strip(factors),
                            blocks=g * per_mcu, ms=ms, k0_k3_ms=old_ms, card=card))
    return out


def sass_mix() -> dict:
    """kernel -> {opcode: count} in the built library's SASS, for K03's and
    K0's kernels ({} where the toolkit has no cuobjdump): the instructions
    of their code as written, not counts a block (K0's code runs once a
    block, K03's row and column passes once a row and once a column)."""
    from .. import _build

    tool = Path(_build._nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return {}
    out = subprocess.run([str(tool), "-sass", str(_build.build())], capture_output=True,
                         text=True, check=True, timeout=300).stdout
    mix: dict = {}
    name = None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = next((k for k in ("pixel_exact_kernel", "idct_exact_kernel")
                         if k in m.group(1)), None)
            continue
        op = re.match(r"\s+/\*[0-9a-f]+\*/\s+(?:@!?U?P\d+\s+)?([A-Z0-9]+)", line)
        if name and op and op.group(1) in SASS_OPS:
            mix.setdefault(name, collections.Counter())[op.group(1)] += 1
    return {k: dict(v) for k, v in mix.items()}


def halved_variant(reps: int) -> list[dict]:
    """K03 built from a copy of the package whose idct_exact.cuh halves in
    float32 (module docstring), timed in a process of its own on the dense
    4K request with planes and on eight without."""
    with tempfile.TemporaryDirectory() as tmp:
        pkg = Path(tmp) / PACKAGE.name
        shutil.copytree(PACKAGE, pkg, ignore=shutil.ignore_patterns("__pycache__", "build"))
        header = pkg / "csrc" / "idct_exact.cuh"
        text, n = re.subn(r"st\(mul\(0\.5, (.*)\)\);$", r"__fmul_rn(0.5f, \1);",
                          header.read_text(), flags=re.M)
        if n != 12:
            raise RuntimeError(f"idct_exact.cuh: {n} halvings rewritten, expected 12")
        header.write_text(text)
        r = subprocess.run([sys.executable, "-m", f"{PACKAGE.name}.benchmarks.pixel_sweep",
                            "--worker", "--reps", str(reps)],
                           cwd=tmp, capture_output=True, text=True, timeout=900)
        if r.returncode != 0:
            raise RuntimeError(f"the halved variant failed: {r.stderr[-3000:]}")
        return [json.loads(line) for line in r.stdout.strip().splitlines()]


def _worker(reps: int) -> None:
    """In a variant's copy: K03 held bitwise against the plain version, then
    timed, on the dense 4K request (planes) and eight (RGB only)."""
    from .. import Quirks
    from ..ops import pixel
    from .gather_probe import card_line
    from .inputs import F420, make_jpeg

    dev = torch.device("cuda")
    dense = [make_jpeg(W, H, F420, RI, seed) for seed in range(8)]
    for name, datas, want in (("dense 4K request, planes", dense[:1], True),
                              ("8 x dense 4K, RGB only", dense, False)):
        frame, planes, qts = decoded(datas, dev)
        q = Quirks.REFERENCE
        got = pixel.pixel_exact(planes, qts, frame, q, want)
        plain = pixel._pixel_exact_plain(planes, qts, frame, q, want)
        if not torch.equal(got[0], plain[0]) or (
                want and not all(torch.equal(a, b) for a, b in zip(got[1], plain[1]))):
            raise RuntimeError(f"{name}: the variant differs from the plain version")
        ms = card_ms(lambda: pixel.pixel_exact(planes, qts, frame, q, want), reps)
        print(json.dumps(dict(case=name, variant="halve in float32", ms=ms,
                              card=card_line())), flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--strip", type=int, nargs="+", default=[2, 4, 8, 16, 32])
    ap.add_argument("--reps", type=int, default=15)
    ap.add_argument("--halve-in-float", action="store_true")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ns = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("pixel_sweep needs a CUDA card")
    if ns.worker:
        _worker(ns.reps)
        return
    from .inputs import F420, PHOTOS_420, make_jpeg, photo_jpeg

    dev = torch.device("cuda")
    dense = [make_jpeg(W, H, F420, RI, seed) for seed in range(8)]
    photo = photo_jpeg(PHOTOS_420[0], W, H, RI)
    cases = {
        "dense 4K request, planes": (*decoded(dense[:1], dev), True),
        "photograph tiled to 4K, planes": (*decoded([photo], dev), True),
        "8 x dense 4K, RGB only": (*decoded(dense, dev), False),
    }
    for rec in sweep(cases, ns.strip, ns.reps):
        print(json.dumps(rec), flush=True)
    print(json.dumps({"sass": sass_mix()}), flush=True)
    if ns.halve_in_float:
        for rec in halved_variant(ns.reps):
            print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
