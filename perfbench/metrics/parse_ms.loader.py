"""parse_ms.loader: the program's `batch_parse` span (GLOBAL_METRICS, host
clock around the parses of a batch's streams on the loader's prefetch
thread, parallel/batch.BatchDecoder._host_many), ms per image parsed."""

from perfbench import readers

LAYER = "host parse (io/parser.py)"
UNIT = "ms"
MOVES = "kernel_us_per_image"


def read(run):
    return readers.stage_ms(run, "batch_parse", "item")
