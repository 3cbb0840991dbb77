"""device_idle_pct.loader: the share of the traced
window in which no kernel, copy or memset ran on the card, %."""

from perfbench import readers

LAYER = "device"
UNIT = "%"
MOVES = "kernel_us_per_image"


def read(run):
    return readers.idle_pct(run)
