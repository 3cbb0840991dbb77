"""idle_unattributed_pct.request: the share of the traced window's
device-idle time that no program span covers ("jpegtpu.*" profiler ranges
on any thread the trace recorded: a request's parse, entropy set-up,
uploads, launches, status check, stage lookup, pixel stage and read-back),
%. Intervals overlap exactly; nested ranges count once."""

from perfbench import attribution

LAYER = "device"
UNIT = "%"
MOVES = "request_p50_ms"


def read(run):
    return attribution.unattributed_idle_pct(run)
