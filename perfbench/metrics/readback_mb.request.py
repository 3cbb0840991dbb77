"""readback_mb.request: the program's `readback_mb` counter (GLOBAL_METRICS,
models/decoder._pixel_stage's `copy_out`): the MB a request reads back from
the card, per request in the window. `decode_rgb` reads back its RGB alone
(3840x2160x3 bytes, 24.88 MB); a stage that also returns its sample planes
reads them back too."""

from perfbench import attribution

LAYER = "copies (convert.py, models/decoder.py, parallel/batch.py)"
UNIT = "MB"
MOVES = "request_p50_ms"


def read(run):
    return attribution.items_per_call(run, "readback_mb")
