"""idle_unattributed_pct.loader: the share of the traced window's
device-idle time that no program span covers ("jpegtpu.*" profiler ranges
on any thread the trace recorded: on the consumer's thread the wait for the
prefetch thread's host stage, the stage lookup, the pixel stage and the
RGB's read-back), %. Intervals overlap exactly; nested ranges count
once."""

from perfbench import attribution

LAYER = "device"
UNIT = "%"
MOVES = "kernel_us_per_image"


def read(run):
    return attribution.unattributed_idle_pct(run)
