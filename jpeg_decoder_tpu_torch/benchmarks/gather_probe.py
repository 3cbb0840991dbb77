"""Per-step cost of the dependent-step probes PK1-PK7 on one CUDA card.

    python -m jpeg_decoder_tpu_torch.benchmarks.gather_probe [--round 1|2|3|4|all]

The counterpart of the `__main__` blocks of benchmarks/pallas_gather_probe.py
and its rounds 2, 3 and 4, with their method: every variant runs at two
chain lengths (256 and 4096 steps in rounds 1 to 3, 4096 and 32768 in round
4) and the cost of one dependent step is the slope between the two times,
which cancels the launch and the set-up. Each time is the median of 7
samples (5 in round 4) after a warm-up, taken with CUDA events; a sample is
eight launches between one pair of events, over eight. The host needs
longer to issue a launch than the card needs for a short chain of shifts,
so a sample first parks the card behind a spin kernel of about a
millisecond, and issues the first event and the eight launches meanwhile:
when the spin ends they run back to back, and the events time the card
alone. The wrappers read no value of a device tensor, so nothing
synchronises in between.

One line per variant, under the script's own label, with ns/step, the two
times, where the table lay, and the card's name and power limit. A variant
whose table fits shared memory is also run with the table in global memory
(read through __ldg) and that slope is printed on the same line: the same
function in two placements.

It runs on the card. `--device cpu` runs the plain PyTorch versions on the
CPU instead (pick short chains with `--steps`), times them with the host
clock and says so on each line; without a card and without that option it
raises. A variant that fails raises: nothing is caught.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import time

import torch

from .. import convert
from ..ops import probes

#: (short, long) chain lengths and repetitions of each round's script.
ROUND_STEPS = {1: (256, 4096), 2: (256, 4096), 3: (256, 4096), 4: (4096, 32768)}
ROUND_REPS = {1: 7, 2: 7, 3: 7, 4: 5}
#: Launches between one pair of CUDA events (one sample).
LAUNCHES_PER_SAMPLE = 8
#: Clock cycles the card spins before a sample's first event, while the host
#: queues the sample's launches behind it (about a millisecond).
PARK_CYCLES = 2_000_000


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, device: torch.device) -> float:
    """Median milliseconds of one fn() over `reps` samples after a warm-up:
    on a card a sample is LAUNCHES_PER_SAMPLE calls between two CUDA events,
    queued behind a spin kernel so that they run back to back; on the CPU
    one call on the host clock."""
    fn()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(PARK_CYCLES)
            a.record()
            for _ in range(LAUNCHES_PER_SAMPLE):
                fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / LAUNCHES_PER_SAMPLE)
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def slope(variant: probes.Variant, tensors: dict, steps, reps: int,
          device: torch.device, **kw) -> dict:
    """ns per dependent step of one variant, from its times at two chain
    lengths."""
    s1, s2 = steps
    t1 = time_ms(lambda: variant.run(tensors, s1, **kw), reps, device)
    t2 = time_ms(lambda: variant.run(tensors, s2, **kw), reps, device)
    return {"ns_per_step": (t2 - t1) / (s2 - s1) * 1e6, "steps": (s1, s2), "ms": (t1, t2)}


def measure(variant: probes.Variant, device: torch.device, steps=None, reps=None) -> dict:
    """One variant's record: its slope in the default placement and, where
    the table fits shared memory, in global memory too."""
    steps = steps or ROUND_STEPS[variant.round]
    reps = reps or ROUND_REPS[variant.round]
    tensors = probes.tensors_for(variant, device)
    rec = {"key": variant.key, "label": variant.label, "kernel": variant.kernel,
           **slope(variant, tensors, steps, reps, device)}
    if device.type != "cuda":
        rec["placement"] = "plain version"
        return rec
    rec["placement"] = probes.placement_of(variant, tensors)
    if rec["placement"] == "table in shared memory":
        rec["global"] = slope(variant, tensors, steps, reps, device, placement="global")
    return rec


def format_line(rec: dict, where: str) -> str:
    (s1, s2), (t1, t2) = rec["steps"], rec["ms"]
    line = (f"[{rec['label']}] {rec['ns_per_step']:.2f} ns/step"
            f" (t{s1}={t1:.4f} ms t{s2}={t2:.4f} ms), {rec['placement']}")
    if "global" in rec:
        g = rec["global"]
        line += (f"; table in global memory {g['ns_per_step']:.2f} ns/step"
                 f" (t{s1}={g['ms'][0]:.4f} ms t{s2}={g['ms'][1]:.4f} ms)")
    return f"{line} [{where}]"


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--round", default="all", choices=["1", "2", "3", "4", "all"])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu for the plain versions")
    ap.add_argument("--steps", type=int, nargs=2, metavar=("SHORT", "LONG"),
                    help="chain lengths instead of each round's own")
    ap.add_argument("--reps", type=int, help="runs per time instead of each round's own")
    args = ap.parse_args(argv)
    if args.steps and not 0 < args.steps[0] < args.steps[1]:
        ap.error("--steps SHORT LONG needs 0 < SHORT < LONG")
    device = convert.resolve_device(args.device)
    where = (card_line() if device.type == "cuda"
             else "cpu, plain PyTorch version, host clock: not a device time")
    rounds = (1, 2, 3, 4) if args.round == "all" else (int(args.round),)
    records = []
    for variant in probes.VARIANTS:
        if variant.round in rounds:
            rec = measure(variant, device, args.steps, args.reps)
            print(format_line(rec, where), flush=True)
            records.append(rec)
    return records


if __name__ == "__main__":
    main()
