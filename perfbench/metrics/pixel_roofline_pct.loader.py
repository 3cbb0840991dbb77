"""pixel_roofline_pct.loader: the share of its roofline
that the pixel stage (K0 three times and K3f on a fancy batch) reaches: the
bound of the window's calls, over the device time of its kernels in the
traced window, %."""

from perfbench import readers

LAYER = "pixel stage (models/decoder.PixelStage, ops/pixel.py, ops/idct.py, ops/color.py)"
UNIT = "%"
MOVES = "kernel_us_per_image"


def read(run):
    return readers.roofline_pct(run, "pixel")
