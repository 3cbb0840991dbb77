"""card_span_pct.request: the program's `card_span_pct` counter
(GLOBAL_METRICS, models/decoder._decode): 100 for a DEVICE request decoded
from its header parse alone, whose segments K2u found on the card and whose
result stood, 0 for one that took the full parse (io/parser.parse and the
host's span scan); the mean over the window's requests. Absent where the
program has no such counter."""

from perfbench import attribution

LAYER = "host parse (io/parser.py)"
UNIT = "%"
MOVES = "request_p50_ms"


def read(run):
    return attribution.items_per_call(run, "card_span_pct")
