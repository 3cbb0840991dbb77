"""host_wait_ms.loader: the program's `batch_wait` span (GLOBAL_METRICS,
host clock around the consumer's wait for the prefetch thread's host stage
of the next batch in BatchDecoder.decode_stream), ms per image yielded."""

from perfbench import readers

LAYER = "entry"
UNIT = "ms"
MOVES = "kernel_us_per_image"


def read(run):
    return readers.stage_ms(run, "batch_wait", "item")
