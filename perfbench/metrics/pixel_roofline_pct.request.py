"""pixel_roofline_pct.request: the share of its
roofline that the pixel stage (K03 on a 4:2:0 nearest-neighbour request,
sample planes stored) reaches: the bound of the window's calls on this
cell's own inputs (roofline.pixel_bound_s), over the device time of its
kernels in the traced window, %."""

from perfbench import readers

LAYER = "pixel stage (models/decoder.PixelStage, ops/pixel.py, ops/idct.py, ops/color.py)"
UNIT = "%"
MOVES = "request_p50_ms"


def read(run):
    return readers.roofline_pct(run, "pixel")
