"""entropy_roofline_pct.request: the share of
their roofline that K2u and K2 reach on a request: the bound of the
window's K2 calls on this cell's own inputs (roofline.entropy_bound_s), over
the device time of their kernels in the traced window, %."""

from perfbench import readers

LAYER = "device entropy (ops/entropy_device.py, ops/entropy_cuda.py: K2u, K2)"
UNIT = "%"
MOVES = "request_p50_ms"


def read(run):
    return readers.roofline_pct(run, "entropy")
