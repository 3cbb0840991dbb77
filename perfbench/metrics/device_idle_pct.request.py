"""device_idle_pct.request: the share of the traced
window in which no kernel, copy or memset ran on the card, %."""

from perfbench import readers

LAYER = "device"
UNIT = "%"
MOVES = "request_p50_ms"


def read(run):
    return readers.idle_pct(run)
