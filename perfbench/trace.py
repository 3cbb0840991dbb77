"""What a `torch.profiler` trace of a run's window says: the device's busy
time, each kernel group's time and launches, the copies, the operations
that took most time and the idle gaps, labelled by what the host was doing.

It reads the profiler's own events (`profiler.kineto_results.events()`:
kernels, memcpy and memset on the card, the host's operators and
`record_function` ranges), all on one clock. Kernels are known by the
function names of the program's CUDA sources (`csrc/*.cu`), demangled as
CUPTI reports them, or mangled, where an Itanium name carries each
identifier after its length.
"""

from __future__ import annotations

import dataclasses
import re
from collections import defaultdict

#: The program's kernels by layer: its entropy stage (K2u `unstuff.cu`, K2
#: `entropy_decode.cu`) and its pixel stage (K03/K13 `pixel_*.cu`, K0/K1/K5
#: `idct_*.cu`, K3/K3f `color.cu`).
KERNELS = {
    "entropy": ("unstuff_kernel", "sub_base_kernel", "count_kernel", "block_scan_kernel",
                "scatter_kernel", "build_lut_kernel", "pass1_kernel", "pass2_kernel",
                "scan_segment_kernel", "scan_kernel", "write_kernel", "dc_segment_kernel",
                "dc_kernel"),
    "pixel": ("pixel_exact_kernel", "pixel_float_kernel", "idct_exact_kernel",
              "idct_float_kernel", "idct_scaled_kernel", "colour_run_kernel",
              "colour_pixel_kernel"),
}
_KERNEL_OF = {k: layer for layer, ks in KERNELS.items() for k in ks}
_DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
#: The ranges the harness puts around its own calls.
HARNESS_PREFIX = "perfbench."


def kernel_id(name: str) -> str | None:
    """The program's kernel a device event's name is, or None."""
    for ident in re.findall(r"[A-Za-z_][A-Za-z0-9_]*", name):
        if ident in _KERNEL_OF:
            return ident
    for ident in _KERNEL_OF:
        if f"{len(ident)}{ident}" in name:
            return ident
    return None


def device_kind(name: str) -> str:
    if name.startswith("Memcpy"):
        return "htod" if "HtoD" in name else "dtoh" if "DtoH" in name else "memcpy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


@dataclasses.dataclass
class Event:
    name: str
    start: int  # ns
    end: int
    thread: int = 0


@dataclasses.dataclass
class Trace:
    window: Event
    device: list  # Event, sorted by start
    host: list  # Event: operators and record_function ranges

    @property
    def window_s(self) -> float:
        return (self.window.end - self.window.start) / 1e9

    def _merged(self, events=None) -> list:
        out: list = []
        for e in self.device if events is None else events:
            s, t = max(e.start, self.window.start), min(e.end, self.window.end)
            if t <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], t)
            else:
                out.append([s, t])
        return out

    @property
    def busy_s(self) -> float:
        """Seconds of the window in which a kernel, copy or memset ran."""
        return sum(t - s for s, t in self._merged()) / 1e9

    @property
    def kernel_busy_s(self) -> float:
        """Seconds of the window in which a kernel ran (copies and memsets
        left out)."""
        return sum(t - s for s, t in self._merged(
            [e for e in self.device if device_kind(e.name) == "kernel"])) / 1e9

    def kernels(self, layer: str) -> list:
        return [e for e in self.device if _KERNEL_OF.get(kernel_id(e.name) or "") == layer]

    def seconds(self, events) -> float:
        return sum(e.end - e.start for e in events) / 1e9

    def launches(self, ident: str) -> int:
        return sum(1 for e in self.device if kernel_id(e.name) == ident)

    def copies(self, *kinds: str) -> list:
        return [e for e in self.device if device_kind(e.name) in kinds]

    def top_ops(self, n: int = 10) -> list:
        """The device operations that took most time: [[name, seconds]]."""
        by = defaultdict(int)
        for e in self.device:
            by[_short(e.name)] += e.end - e.start
        return [[k, v / 1e9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """The device's idle time in the window by what the host was doing
        at each gap's middle (the harness's range around the call, then
        the innermost operator or range open on any thread):
        [[label, seconds]], most first."""
        merged = self._merged()
        edges = [self.window.start] + [x for iv in merged for x in iv] + [self.window.end]
        gaps = [(s, t) for s, t in zip(edges[0::2], edges[1::2]) if t > s]
        host = sorted(self.host, key=lambda e: e.start)
        by = defaultdict(int)
        active: list = []
        i = 0
        # one sweep: gaps and host events both by time; the events open at
        # a gap's middle are few (a stack a thread)
        for s, t in gaps:
            mid = (s + t) // 2
            while i < len(host) and host[i].start <= mid:
                active.append(host[i])
                i += 1
            active = [e for e in active if e.end > mid]
            outer = [e for e in active if e.name.startswith(HARNESS_PREFIX)
                     and e.name != HARNESS_PREFIX + "window"]
            inner = [e for e in active if not e.name.startswith(HARNESS_PREFIX)]
            label = (min(outer, key=lambda e: e.end - e.start).name if outer else "-") + " > " + (
                _short(min(inner, key=lambda e: e.end - e.start).name) if inner else "python")
            by[label] += t - s
        return [[k, v / 1e9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def _short(name: str, n: int = 96) -> str:
    return name if len(name) <= n else name[:n - 3] + "..."


def _ns(e, which: str) -> int:
    fn = getattr(e, f"{which}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(e, f"{which}_us")() * 1000)


def from_profile(prof, device_only: bool = False) -> Trace:
    """The Trace of a finished torch.profiler.profile whose window the
    harness wrapped in record_function("perfbench.window"). A profile of
    the card's activity alone (`device_only`) may hold no host range: its
    window is then the span of its device events, and its busy time the
    same."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    device, host, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        kind = e.activity_type() if hasattr(e, "activity_type") else None
        ev = Event(e.name(), _ns(e, "start"), _ns(e, "end"), int(e.start_thread_id()))
        if e.device_type() == cuda:
            if kind in _DEVICE_ACTIVITIES or (kind is None and not e.is_user_annotation()):
                device.append(ev)
        elif kind in ("cpu_op", "user_annotation", None):
            if ev.name == HARNESS_PREFIX + "window":
                window = ev
            host.append(ev)
    device.sort(key=lambda e: e.start)
    if window is None and device_only and device:
        window = Event(HARNESS_PREFIX + "window", device[0].start,
                       max(e.end for e in device))
    if window is None:
        raise RuntimeError("the trace holds no perfbench.window range")
    return Trace(window, device, host)
