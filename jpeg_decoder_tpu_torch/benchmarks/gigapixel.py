"""Time and memory of one EXACT decode of a gigapixel frame, in a process
of its own, so that the host's peak resident set is the decode's.

    python -m jpeg_decoder_tpu_torch.benchmarks.gigapixel FILE \\
        [--engine streamed|striped] [--n-stripes N]

FILE is read through np.memmap (the input pages in as the host entropy
stage reads it). Before the timed decode, a small frame of the same
sampling is decoded once by the same path (streamed in two chunks, so that
a ChunkStage is built and run; striped in the same number of stripes), so
that the time leaves out the card's context and the kernels' loading.
Prints one JSON line: the wall time of the decode (host clock, from the
bytes to the host RGB), megapixels a second, the card's peak allocated
memory (torch.cuda.max_memory_allocated) during the decode, the process's
resident set after the imports (`python -m` imports the package, and so
torch, before main runs) and after the warm-up (the resident set before
the decode), its peak during the decode (VmRSS of /proc/self/status
sampled every 2 ms on a thread; VmHWM too, where the kernel reports it)
and its ru_maxrss, and the card's name and power limit. ru_maxrss is carried across fork and exec on Linux, so a
child's is at least its parent's at the fork; the samples are this
process's own. `measure` runs it as a child process; chip_smoke.py calls
that.
"""

from __future__ import annotations

import argparse
import json
import resource
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np


def card() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else "unknown card"


def proc_status_kb(field: str) -> int | None:
    """A kB field of /proc/self/status (VmRSS, VmHWM), or None if absent."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith(field + ":"):
                return int(line.split()[1])
    return None


class PeakRss:
    """Within the block, the largest VmRSS sampled every `interval` seconds
    on a thread of its own (`peak_kb`)."""

    def __init__(self, interval: float = 0.002):
        self.interval = interval
        self.peak_kb = proc_status_kb("VmRSS")
        if self.peak_kb is None:
            raise RuntimeError("no VmRSS in /proc/self/status")
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _sample(self) -> None:
        self.peak_kb = max(self.peak_kb, proc_status_kb("VmRSS"))

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            self._sample()

    def __enter__(self) -> "PeakRss":
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join()
        self._sample()


def decode(data, engine: str, n_stripes: int | None, n_chunks: int | None = None):
    from ..parallel import stripes

    if engine == "streamed":
        return stripes.decode_streamed(data, n_chunks=n_chunks)
    return stripes.decode_striped(data, n_stripes=n_stripes)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("file")
    ap.add_argument("--engine", choices=["streamed", "striped"], default="streamed")
    ap.add_argument("--n-stripes", type=int, default=None)
    ns = ap.parse_args(argv)

    import torch

    from .inputs import PHOTOS_420, photo_jpeg

    imports_kb = proc_status_kb("VmRSS")
    # the card's context and the kernels, loaded on a small frame
    decode(photo_jpeg(PHOTOS_420[0], 2048, 2048, 128), ns.engine, ns.n_stripes, n_chunks=2)
    data = np.memmap(ns.file, dtype=np.uint8, mode="r")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before_kb = proc_status_kb("VmRSS")
    with PeakRss() as rss:
        t0 = time.perf_counter()
        rgb = decode(data, ns.engine, ns.n_stripes)
        seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    px = rgb.shape[0] * rgb.shape[1]
    hwm = proc_status_kb("VmHWM")
    print(json.dumps(dict(
        engine=ns.engine, n_stripes=ns.n_stripes,
        width=rgb.shape[1], height=rgb.shape[0], decode_s=seconds, mp_per_s=px / seconds / 1e6,
        max_memory_allocated_mb=peak / 2**20, rss_after_imports_mb=imports_kb / 1024,
        rss_before_mb=before_kb / 1024,
        peak_rss_mb=rss.peak_kb / 1024,
        vm_hwm_mb=None if hwm is None else hwm / 1024,
        ru_maxrss_mb=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024,
        card=card())), flush=True)


def measure(path: Path, engine: str, n_stripes: int | None = None,
            timeout: float = 600) -> dict:
    """Run main in a child process from the repository root; its JSON."""
    cmd = [sys.executable, "-m", "jpeg_decoder_tpu_torch.benchmarks.gigapixel", str(path),
           "--engine", engine]
    if n_stripes:
        cmd += ["--n-stripes", str(n_stripes)]
    root = Path(__file__).resolve().parents[2]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout, cwd=root)
    if r.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd[3:])}: exit {r.returncode}\n{r.stderr[-3000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


if __name__ == "__main__":
    main()
