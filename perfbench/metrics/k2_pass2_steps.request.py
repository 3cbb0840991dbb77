"""k2_pass2_steps.request: the program's `k2_pass2_steps` counter
(GLOBAL_METRICS, ops/entropy_cuda.decode_segments): the steps of K2's pass 2
(summed over its launches, the most of any block in each), per K2 call in
the window (one call a scan of a request). Pass 2's time follows its steps."""

from perfbench import attribution

LAYER = "device entropy (ops/entropy_device.py, ops/entropy_cuda.py: K2u, K2)"
UNIT = "steps"
MOVES = "request_p50_ms"


def read(run):
    return attribution.items_per_call(run, "k2_pass2_steps")
