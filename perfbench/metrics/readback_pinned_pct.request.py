"""readback_pinned_pct.request: the program's `readback_pinned_pct` counter
(GLOBAL_METRICS, models/decoder._pixel_stage's `copy_out`): 100 for a
request whose RGB `convert.to_host` put in pinned host memory, which the
DMA writes directly, 0 for one into pageable memory, which CUDA bounces
through a staging buffer (`decode`, or the pinned budget full); the mean
over the window's requests."""

from perfbench import attribution

LAYER = "copies (convert.py, models/decoder.py, parallel/batch.py)"
UNIT = "%"
MOVES = "request_p50_ms"


def read(run):
    return attribution.items_per_call(run, "readback_pinned_pct")
