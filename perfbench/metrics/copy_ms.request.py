"""copy_ms.request: device time of the
host-to-device and device-to-host copies in the traced window (the raw
bytes up, the RGB and sample planes down), ms per request."""

from perfbench import readers

LAYER = "copies (convert.py, models/decoder.py, parallel/batch.py)"
UNIT = "ms"
MOVES = "request_p50_ms"


def read(run):
    return readers.copy_ms(run, "request")
