"""entropy_roofline_pct.loader: the share of their
roofline that K2u and K2 reach on a batch (one call a batch): the bound of
the window's calls on this cell's own inputs, over the device time of
their kernels in the traced window, %."""

from perfbench import readers

LAYER = "device entropy (ops/entropy_device.py, ops/entropy_cuda.py: K2u, K2)"
UNIT = "%"
MOVES = "kernel_us_per_image"


def read(run):
    return readers.roofline_pct(run, "entropy")
