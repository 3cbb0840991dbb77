"""decode_mps.loader: source pixels of every image whose host RGB
BatchDecoder.decode_stream yielded in the traced window, over its seconds
(to the last batch yielded), in megapixels a second; the RGB is allocated
afresh each batch, as the entry returns it, so first touch of its pages is
inside. A per-layer reading, not an end-to-end metric: the rate is bound
by the host's single-thread speed, which drifts from run to run by more
than any bound the benchmark may set (PERF.md section 2). Under the
profiler it reads lower than an untraced window would."""

from perfbench import readers

LAYER = "entry"
UNIT = "MP/s"
MOVES = "kernel_us_per_image"


def read(run):
    return readers.mps(run)
