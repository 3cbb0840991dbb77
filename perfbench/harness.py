"""One run of one cell of `BENCHMARK.json`: set up, warm up, measure for
`--seconds`, check the outputs against the plain reference, print the
result line.

    python3 -m perfbench --workload NAME --seed N --seconds S --trace 0|1

Everything a cell names is found by name: its configuration
(`configs/<config>.json`: the program's `DecodeConfig` and the entry the
window drives), its traffic (`traffic/<traffic>.json`: the generator's
parameters and the loop, `loops/<loop>.py`), its end-to-end metrics
(`end_to_end/<metric>.py`) and its per-layer metrics (`metrics/<metric>.py`).
Each reader is a module with `read(run)` that returns a number, or None
where its run has nothing for it to read.

`--trace 0` reports the cell's end-to-end metrics (where one of them is read
from the device's trace, the window runs under a `torch.profiler` that
records the card's activity alone); `--trace 1` runs the same window under
`torch.profiler` with the program's `collect_metrics` on and reports the
cell's per-layer metrics, the device's busy time and a breakdown. Without a card the run fails and prints no result, except under
`--rehearse`, which runs the cell's small `rehearse` sizes on the CPU (the
program's plain PyTorch paths) and whose line carries no device metric.
`--control` runs the configuration's `control` settings (the program's own
lower-precision path) in place of its own: the check must come out false.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib
import importlib.util
import json
import os
import resource
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: Modules that may not be loaded in a run: JAX and the JAX package the
#: program was ported from (top-level names compared whole).
FORBIDDEN = ("jax", "jaxlib", "flax", "jpeg_decoder_tpu")
#: Build and kernel caches, at fixed places inside the checkout.
CACHES = {"TORCH_EXTENSIONS_DIR": ROOT / ".perfbench_cache" / "torch_extensions",
          "TRITON_CACHE_DIR": ROOT / ".perfbench_cache" / "triton"}


class NoResult(Exception):
    """The run cannot give a result line (no card, a forbidden module)."""


@dataclasses.dataclass
class LoopResult:
    """What a loop's window did. Requests: one latency a request (inf for
    one that raised). Batches: the images the entry yielded and the seconds
    from the window's start to the last of them."""

    attempted: int = 0
    failed: int = 0
    latencies_s: list = dataclasses.field(default_factory=list)
    images: int = 0
    elapsed_s: float = 0.0
    window_s: float = 0.0
    #: the pool index of each image the entry yielded, in order (batches)
    indices: list = dataclasses.field(default_factory=list)
    #: (pool index, host RGB) of the outputs drawn for the check
    samples: list = dataclasses.field(default_factory=list)
    #: launches of each entropy (K2) and pixel-stage call: images each
    #: covers; None where a call launches once a group of one size and
    #: table set in it, which the readers then weigh image by image
    images_per_call: int | None = 1


class Reservoir:
    """Outputs drawn for the check, from the seed: each of the run's outputs
    is kept with the same chance (algorithm R), `k` of them at the end."""

    def __init__(self, k: int, seed: int):
        from . import gen

        self.k = k
        self.rng = gen.rng_for(seed, 1)
        self.seen = 0
        self.items: list = []

    def offer(self, n: int) -> list:
        """For the next n outputs: [(which of them, its slot)] to keep, in
        order (a later one replaces an earlier one in the same slot)."""
        import numpy as np

        t = np.arange(self.seen, self.seen + n)
        j = self.rng.integers(0, t + 1)
        self.seen += n
        slot = np.where(t < self.k, t, j)
        return [(int(i), int(s)) for i, s in zip(np.flatnonzero(slot < self.k),
                                                 slot[slot < self.k])]

    def put(self, slot: int, item) -> None:
        if slot < len(self.items):
            self.items[slot] = item
        else:
            self.items.append(item)


@dataclasses.dataclass
class Run:
    """Everything a metric reader may read."""

    workload: dict
    config: dict
    traffic: dict
    pool: object
    result: LoopResult
    setup_s: float
    #: the program's GLOBAL_METRICS over the window: name -> (calls, s, items)
    stages: dict
    #: the program's kernel launches over the window (`_build.LAUNCHES`)
    launches: dict
    #: trace.Trace of the window (--trace 1 on a card), else None
    trace: object = None


def load_bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def named(items: list, name: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise SystemExit(f"no entry named {name!r} in BENCHMARK.json")


def reader(kind: str, name: str):
    """The reader module `perfbench/<kind>/<name>.py`."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, section: str, workload: str) -> list:
    return [m for m in bench[section] if workload in m.get("workloads", [workload])]


def decode_config(settings: dict, collect: bool):
    from jpeg_decoder_tpu_torch import DecodeConfig
    from jpeg_decoder_tpu_torch.utils import config as cfgmod

    kw = {}
    for k, v in settings.items():
        enum = {"entropy_backend": cfgmod.EntropyBackend, "idct_precision": cfgmod.IdctPrecision,
                "quirks": cfgmod.Quirks}.get(k)
        kw[k] = enum[v] if enum else v
    return DecodeConfig(collect_metrics=collect, **kw)


def _stage_delta(before: dict, after: dict) -> dict:
    out = {}
    for k, st in after.items():
        b = before.get(k, (0, 0.0, 0.0))
        calls = st.calls - b[0]
        if calls:
            out[k] = (calls, st.total_s - b[1], st.total_items - b[2])
    return out


def _snapshot(stages: dict) -> dict:
    return {k: (v.calls, v.total_s, v.total_items) for k, v in stages.items()}


class Window:
    """The measured window as the loops see it: `open()` right before the
    first timed call, `close()` right after the last. `profiled` "full"
    (--trace 1) runs torch.profiler over exactly that span, the host's
    operators and the card's activity; "device" records the card's
    activity alone, for an end-to-end metric read from the device's trace.

    At `open()` what set-up left alive is collected once and frozen, so that
    the program's full collections in the window walk the program's own
    objects and not the harness's pool and imports; `close()` thaws it."""

    def __init__(self, profiled: str | None, device):
        self.profiled = profiled
        self.traced = profiled == "full"
        self.device = device
        self.prof = self.range = None
        self.t_open = self.t_close = 0.0

    def open(self):
        import torch
        from jpeg_decoder_tpu_torch import _build
        from jpeg_decoder_tpu_torch.utils.metrics import GLOBAL_METRICS

        gc.collect()
        gc.freeze()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.stages0 = _snapshot(GLOBAL_METRICS.stages)
        self.launches0 = dict(_build.LAUNCHES)
        if self.profiled:
            from torch.profiler import ProfilerActivity, profile, record_function

            self.prof = profile(activities=[ProfilerActivity.CUDA] if self.profiled == "device"
                                else [ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.start()
            self.range = record_function("perfbench.window")
            self.range.__enter__()
        self.rusage = [resource.getrusage(resource.RUSAGE_SELF)]
        self.t_open = time.perf_counter()

    def close(self):
        import torch
        from jpeg_decoder_tpu_torch import _build
        from jpeg_decoder_tpu_torch.utils.metrics import GLOBAL_METRICS

        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.t_close = time.perf_counter()
        self.rusage.append(resource.getrusage(resource.RUSAGE_SELF))
        gc.unfreeze()
        if self.profiled:
            self.range.__exit__(None, None, None)
            t = time.perf_counter()
            self.prof.stop()
            print(f"trace: the profiler stopped in {time.perf_counter() - t:.3f} s",
                  file=sys.stderr)
        self.stages = _stage_delta(self.stages0, GLOBAL_METRICS.stages)
        self.launches = {k: v - self.launches0.get(k, 0) for k, v in _build.LAUNCHES.items()
                         if v != self.launches0.get(k, 0)}

    def span(self, name: str):
        """A record_function range around one of the harness's calls, when
        traced (it labels the idle gaps)."""
        if not self.traced:
            import contextlib

            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function("perfbench." + name)


def check(samples: list, pool, config: dict, device) -> dict:
    """Each drawn output against the reference's RGB of its input, at that
    image's own size and with its own tables: the RGB bytes that differ,
    the largest difference, how many were compared."""
    import torch

    from . import gen, reference

    expected: dict = {}
    off = worst = 0
    for idx, rgb in samples:
        if idx not in expected:
            im = pool.images[idx]
            coeffs = [torch.from_numpy(c).to(device) for c in im.coeffs]
            expected[idx] = reference.decode_rgb(
                im.width, im.height, gen.COMPS_420, coeffs,
                [im.qts[0], im.qts[1], im.qts[1]], config["decode_config"].get("upsample", "nn"))
        exp = expected[idx]
        got = torch.from_numpy(rgb).to(device)
        if got.shape != exp.shape:
            off += exp.numel()
            worst = max(worst, 255)
            continue
        diff = (got.to(torch.int16) - exp.to(torch.int16)).abs()
        off += int((diff != 0).sum())
        worst = max(worst, int(diff.max()))
    return {"compared": len(samples), "rgb_bytes_off": off, "rgb_max_diff": worst}


def _power_limit() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           timeout=30)
        return r.stdout.strip().splitlines()[0] if r.returncode == 0 and r.stdout else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def forbidden_loaded() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run(workload: str, seed: int, seconds: float, traced: bool, t0: float,
        rehearse: bool = False, control: bool = False, traffic: dict | None = None,
        bench: dict | None = None) -> dict:
    """One run of `workload`: the result line as a dict (its "checks"
    last). `t0` is the process's start on the perf_counter clock."""
    for k, v in CACHES.items():
        os.environ[k] = str(v)
    bench = bench or load_bench()
    cell = named(bench["workloads"], workload)
    cfg_entry = named(bench["configs"], cell["config"])
    config = json.loads((ROOT / cfg_entry["file"]).read_text())
    traffic = traffic or json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())

    import torch

    if rehearse:
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            raise NoResult(f"{workload} needs {cell['chips']} CUDA device(s); "
                           f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        device = torch.device("cuda", 0)

    from . import gen

    pool = gen.make_pool(traffic, seed, rehearse=rehearse)
    settings = dict(config["decode_config"])
    if control:
        settings.update(config["control"])
    cfg = decode_config(settings, collect=traced)
    loop = importlib.import_module(f"perfbench.loops.{traffic['loop']}")
    section, kind = ("per_layer", "metrics") if traced else ("end_to_end", "end_to_end")
    wanted = cell_metrics(bench, section, workload)
    profiled = None if rehearse else "full" if traced else (
        "device" if any(m["source"] == "device_trace" for m in wanted) else None)
    window = Window(profiled, device)
    result = loop.run(cfg, config, traffic, pool, seconds, seed, device, window, rehearse)
    ru0, ru1 = window.rusage
    print(f"host in the window: {ru1.ru_utime - ru0.ru_utime:.3f} s user,"
          f" {ru1.ru_stime - ru0.ru_stime:.3f} s system, {ru1.ru_minflt - ru0.ru_minflt} minor"
          f" faults", file=sys.stderr)
    setup_s = window.t_open - t0

    peak = 0
    if device.type == "cuda":
        torch.cuda.synchronize()
        peak = int(torch.cuda.max_memory_allocated(device))
    trace = None
    if window.prof is not None:
        from . import trace as tracemod

        t = time.perf_counter()
        trace = tracemod.from_profile(window.prof, device_only=profiled == "device")
        window.prof = None
        print(f"trace: {len(trace.device)} device and {len(trace.host)} host events read in"
              f" {time.perf_counter() - t:.3f} s", file=sys.stderr)
    if device.type == "cuda":
        torch.cuda.empty_cache()

    checks = check(result.samples, pool, config, device)
    result.samples = []
    r = Run(cell, config, traffic, pool, result, setup_s, window.stages, window.launches, trace)

    metrics = {}
    for m in wanted:
        # a rehearsal has no device: no device metric is read from it
        v = None if rehearse and m["source"] == "device_trace" else reader(kind, m["name"]).read(r)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    if rehearse:
        dev = {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    else:
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
               "count": cell["chips"], "memory_peak_bytes": peak,
               "power": _power_limit()}
    line = {"correct": False, "attempted": result.attempted, "failed": result.failed,
            "metrics": metrics, "device": dev}
    if trace is not None and traced:
        dev["busy_s"] = trace.busy_s
        dev["window_s"] = trace.window_s
        line["breakdown"] = {"device_ops": trace.top_ops(), "idle_gaps": trace.idle_gaps()}
    line["checks"] = {
        "compared": {"value": checks["compared"], "at_least": 1},
        "failed": {"value": result.failed, "limit": 0},
        "rgb_bytes_off": {"value": checks["rgb_bytes_off"], "limit": 0},
        "rgb_max_diff": {"value": checks["rgb_max_diff"], "limit": 0},
    }
    line["correct"] = all(c["value"] <= c["limit"] if "limit" in c else c["value"] >= c["at_least"]
                          for c in line["checks"].values())
    return line


def _summary(line: dict, result_note: str) -> list:
    out = [result_note]
    for name, c in line["checks"].items():
        bound = f"limit {c['limit']}" if "limit" in c else f"at least {c['at_least']}"
        out.append(f"check {name} {c['value']} {bound}")
    return out


def main(argv=None, t0: float | None = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    p = argparse.ArgumentParser(prog="python3 -m perfbench", description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rehearse", action="store_true",
                   help="the cell's small sizes on the CPU; no device metric")
    p.add_argument("--control", action="store_true",
                   help="the configuration's control settings: the check must fail")
    a = p.parse_args(argv)
    try:
        line = run(a.workload, a.seed, a.seconds, bool(a.trace), t0,
                   rehearse=a.rehearse, control=a.control)
        loaded = forbidden_loaded()
        if loaded:
            raise NoResult("modules of JAX or the JAX package were loaded: " + ", ".join(loaded))
    except NoResult as e:
        print(f"perfbench: no result: {e}", file=sys.stderr)
        return 2
    note = (f"{a.workload} seed {a.seed}: {line['attempted']} attempted, {line['failed']} failed"
            f"{' (control)' if a.control else ''}; correct {line['correct']}")
    if "window_s" in line["device"]:
        print(f"trace: busy {line['device']['busy_s']:.6f} s of {line['device']['window_s']:.6f} s",
              file=sys.stderr)
    for s in _summary(line, note):
        print(s, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
