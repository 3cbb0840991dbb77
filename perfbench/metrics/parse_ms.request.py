"""parse_ms.request: the program's `parse` timer (GLOBAL_METRICS,
host clock around io/parser.parse in models/decoder.decode), ms per request
in the window."""

from perfbench import readers

LAYER = "host parse (io/parser.py)"
UNIT = "ms"
MOVES = "request_p50_ms"


def read(run):
    return readers.stage_ms(run, "parse", "call")
