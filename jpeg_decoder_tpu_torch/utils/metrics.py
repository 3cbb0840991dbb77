"""Per-stage timing and throughput metrics.

The reference's only performance instrumentation is a commented-out timing
loop (`reference/src/jpeg_decoder.c:51,105`) and ad-hoc `perf record`
runs (perf.data in its .gitignore). Here metrics are first-class: a
lightweight registry of named counters/timers that the pipeline populates
when `DecodeConfig.collect_metrics` is on, plus `torch.profiler` trace hooks.
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


@contextlib.contextmanager
def device_trace(name: str, enabled: bool = False):
    """Wrap a region in a torch.profiler record_function range when
    enabled (it shows as a named span in a torch.profiler trace)."""
    if not enabled:
        yield
        return
    import torch.profiler  # deferred: keep utils importable without torch

    with torch.profiler.record_function(name):
        yield
