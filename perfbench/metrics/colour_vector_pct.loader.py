"""colour_vector_pct.loader: the program's `colour_vector_pct` counter
(GLOBAL_METRICS, ops/color._launch): the percent of a K3 or K3f launch's
runs of 16 pixels whose every component took the vector loads, averaged over
the window's launches (one K3f launch a fancy batch). The rest take the
per-pixel rule, which costs K3f several times a vector run's time."""

from perfbench import attribution

LAYER = "pixel stage (models/decoder.PixelStage, ops/pixel.py, ops/idct.py, ops/color.py)"
UNIT = "%"
MOVES = "kernel_us_per_image"


def read(run):
    return attribution.items_per_call(run, "colour_vector_pct")
