"""K2 (csrc/entropy_decode.cu) at other subsequence and block sizes, on one
CUDA card.

    python -m jpeg_decoder_tpu_torch.benchmarks.k2_sweep \\
        [--sub 64 128 256] [--threads 256 512] [--reps 5]

(the inputs are benchmarks/inputs.py's.) The
subsequence size and the threads of a block are constants of the source,
not arguments of the kernel, so every variant is a copy of the package in a
temporary directory with the two constants rewritten (kSubBytes and
kThreads in the source, SUB_BYTES in ops/entropy_cuda.py), built by nvcc
and run in a process of its own. Each variant decodes one 3840x2160 4:2:0
request of random dense blocks (restart interval 240 MCUs, 135 segments),
eight of them in one call, and two such requests of real blocks (the
coefficients of two photographs of the test corpus tiled to that size,
inputs.photo_jpeg), checks the planes against the native host decoder's, and prints one
JSON line per shape: median milliseconds of `reps` calls (CUDA events, the
planes zeroed outside them), the launches of pass 2, the steps inside them
and the time of each pass, with the card's name and power limit. The
variant that the source fixes is among them; compare within one run only.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

PACKAGE = Path(__file__).resolve().parents[1]
W, H, RI = 3840, 2160, 240
SEEDS = (20261016, 1, 2, 3, 4, 5, 6, 7)


def _rewrite(path: Path, pattern: str, value: int) -> None:
    text, n = re.subn(pattern, lambda m: f"{m.group(1)}{value}{m.group(2)}", path.read_text())
    if n != 1:
        raise RuntimeError(f"{path.name}: {pattern!r} matched {n} times")
    path.write_text(text)


def worker(files: list[str], reps: int) -> None:
    """Time the package this process imported (a variant's copy) on the
    streams in `files`: the first alone, all but the last two in one call,
    the last two (photographs) each alone."""
    import torch

    from jpeg_decoder_tpu_torch import DecodeConfig, convert
    from jpeg_decoder_tpu_torch.benchmarks.gather_probe import card_line
    from jpeg_decoder_tpu_torch.io.parser import parse
    from jpeg_decoder_tpu_torch.models import host
    from jpeg_decoder_tpu_torch.ops import entropy_cuda

    dev = torch.device("cuda")
    datas = [Path(f).read_bytes() for f in files]
    for group, blocks in ((datas[:1], "dense"), (datas[:-2], "dense"),
                          (datas[-2:-1], Path(files[-2]).stem),
                          (datas[-1:], Path(files[-1]).stem)):
        _, native, _ = host.host_decode(group[0], DecodeConfig())
        structures = [parse(d) for d in group]
        args, on_host = entropy_cuda.launch_args(
            [entropy_cuda.prepare_scan(s, s.scans[0]) for s in structures], dev)
        planes = [convert.zero_planes(s.frame, dev) for s in structures]
        times, passes, rounds, steps = [], [], [], []
        for _ in range(reps + 1):  # the first call warms up
            for img in planes:
                for p in img:
                    p.zero_()
            rec = {}
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            status = entropy_cuda.decode_segments(*args, planes, records=rec, host=on_host)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
            passes.append(rec["pass_ms"])
            rounds.append(rec["rounds"])
            steps.append(rec["steps"])
        entropy_cuda.check_status(status, args[1])
        if not all(torch.equal(p.cpu(), torch.from_numpy(n))
                   for p, n in zip(planes[0], native.planes)):
            raise RuntimeError("planes differ from the native host decoder's")
        print(json.dumps(dict(
            sub_bytes=entropy_cuda.SUB_BYTES, images=len(group), blocks=blocks,
            subsequences=int(rec["sub_base"][-1]),
            ms=statistics.median(times[1:]), pass2_launches=rounds[1:],
            pass2_steps=steps[1:],
            pass_ms=[statistics.median(p[i] for p in passes[1:]) for i in range(5)],
            card=card_line())), flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sub", type=int, nargs="+", default=[64, 128, 256])
    ap.add_argument("--threads", type=int, nargs="+", default=[256, 512])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--worker", nargs="+", help=argparse.SUPPRESS)
    ns = ap.parse_args(argv)
    if ns.worker:
        worker(ns.worker, ns.reps)
        return
    from .inputs import F420, PHOTOS_420, make_jpeg, photo_jpeg

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        files = []
        for seed in SEEDS:
            files.append(str(tmp / f"{seed}.jpg"))
            Path(files[-1]).write_bytes(make_jpeg(W, H, F420, RI, seed))
        for photo in PHOTOS_420:
            files.append(str(tmp / f"photograph_{photo.name}"))
            Path(files[-1]).write_bytes(photo_jpeg(photo, W, H, RI))
        for sub in ns.sub:
            for threads in ns.threads:
                root = tmp / f"sub{sub}_threads{threads}"
                pkg = root / PACKAGE.name
                shutil.copytree(PACKAGE, pkg, ignore=shutil.ignore_patterns("__pycache__"))
                cu = pkg / "csrc" / "entropy_decode.cu"
                _rewrite(cu, r"(constexpr int kSubBytes = )\d+(;)", sub)
                _rewrite(cu, r"(constexpr int kThreads = )\d+(;)", threads)
                _rewrite(pkg / "ops" / "entropy_cuda.py", r"(\nSUB_BYTES = )\d+(\n)", sub)
                r = subprocess.run(
                    [sys.executable, "-m", f"{PACKAGE.name}.benchmarks.k2_sweep",
                     "--reps", str(ns.reps), "--worker", *files],
                    cwd=root, capture_output=True, text=True, timeout=900)
                if r.returncode != 0:
                    raise RuntimeError(f"sub {sub}, threads {threads}: {r.stderr[-2000:]}")
                for line in r.stdout.strip().splitlines():
                    print(json.dumps(dict(threads=threads, **json.loads(line))), flush=True)


if __name__ == "__main__":
    main()
