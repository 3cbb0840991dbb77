"""copy_ms.loader: device time of the host-to-device
and device-to-host copies in the traced window (raw bytes or host-decoded
coefficients up, the batch's RGB down), ms per image yielded."""

from perfbench import readers

LAYER = "copies (convert.py, models/decoder.py, parallel/batch.py)"
UNIT = "ms"
MOVES = "kernel_us_per_image"


def read(run):
    return readers.copy_ms(run, "image")
