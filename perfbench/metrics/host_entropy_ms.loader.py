"""host_entropy_ms.loader: the program's
`entropy_batch_fallback` timer (GLOBAL_METRICS: the wall time of the native
host entropy decode of the members PALLAS does not take, across the host's
threads, in parallel/batch.py), ms per image it decoded."""

from perfbench import readers

LAYER = "host entropy (models/host.py, native/runtime.py)"
UNIT = "ms"
MOVES = "kernel_us_per_image"


def read(run):
    return readers.stage_ms(run, "entropy_batch_fallback", "item")
