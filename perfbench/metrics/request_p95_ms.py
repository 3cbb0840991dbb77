"""request_p95_ms: the 95th percentile of the latency of every request of
the traced window, ms (closed loop, one request in flight; host clock
around JpegDecoder.decode_rgb(bytes) to the host RGB, under the profiler).
A per-layer reading, not an end-to-end metric: its run-to-run spread is
wider than any bound the benchmark may set (PERF.md section 2)."""

from perfbench import readers

LAYER = "entry"
UNIT = "ms"
MOVES = "request_p50_ms"


def read(run):
    return readers.latency_ms(run, 95)
