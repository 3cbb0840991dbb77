"""Per-stage timing and throughput metrics, and the spans that name them in
a trace.

The reference's only performance instrumentation is a commented-out timing
loop (`reference/src/jpeg_decoder.c:51,105`) and ad-hoc `perf record`
runs (perf.data in its .gitignore). Here metrics are first-class: a
lightweight registry of named timers and counters that the pipeline always
populates (`GLOBAL_METRICS`), whatever `DecodeConfig.collect_metrics` says.
`span(name, enabled)` times a region in the registry and, only when
`enabled` (call sites pass `cfg.collect_metrics`), also opens the
`torch.profiler` range "jpegtpu.<name>", on the clock of the card's events
in the same trace. The profiler records a range opened on a worker thread
(a loader's prefetch thread) only under
`_ExperimentalConfig(profile_all_threads=True)`; the timer records it
always.
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field


@dataclass
class StageStat:
    calls: int = 0
    total_s: float = 0.0
    total_items: float = 0.0

    @property
    def mean_s(self) -> float:
        return self.total_s / self.calls if self.calls else 0.0

    @property
    def items_per_s(self) -> float:
        return self.total_items / self.total_s if self.total_s else 0.0


@dataclass
class Metrics:
    """Thread-safe registry of per-stage stats."""

    stages: dict[str, StageStat] = field(default_factory=dict)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def record(self, stage: str, seconds: float, items: float = 0.0) -> None:
        with self._lock:
            st = self.stages.setdefault(stage, StageStat())
            st.calls += 1
            st.total_s += seconds
            st.total_items += items

    @contextlib.contextmanager
    def timer(self, stage: str, items: float = 0.0):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(stage, time.perf_counter() - t0, items)

    def summary(self) -> dict[str, dict[str, float]]:
        with self._lock:
            return {
                k: {
                    "calls": v.calls,
                    "total_s": round(v.total_s, 6),
                    "mean_s": round(v.mean_s, 6),
                    "items_per_s": round(v.items_per_s, 3),
                }
                for k, v in self.stages.items()
            }


# Global default registry; pipelines may use their own instance.
GLOBAL_METRICS = Metrics()


def span(name: str, enabled: bool, items: float = 0.0):
    """Time a region under `name` in GLOBAL_METRICS; when `enabled`, also
    open the torch.profiler range "jpegtpu.<name>" around it. Disabled, it
    is GLOBAL_METRICS.timer and nothing more: no range object is built."""
    if not enabled:
        return GLOBAL_METRICS.timer(name, items)
    return _ranged(name, items)


@contextlib.contextmanager
def _ranged(name: str, items: float):
    import torch.profiler  # deferred: keep utils importable without torch

    with torch.profiler.record_function("jpegtpu." + name), GLOBAL_METRICS.timer(name, items):
        yield


def count(name: str, n: float) -> None:
    """A counter in GLOBAL_METRICS's table: one more call under `name`, n
    more items, no seconds."""
    GLOBAL_METRICS.record(name, 0.0, n)
