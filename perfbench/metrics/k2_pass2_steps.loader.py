"""k2_pass2_steps.loader: the program's `k2_pass2_steps` counter
(GLOBAL_METRICS, ops/entropy_cuda.decode_segments): the steps of K2's pass 2
(summed over its launches, the most of any block in each), per K2 call in
the window (one call a batch group). Pass 2's time follows its steps."""

from perfbench import attribution

LAYER = "device entropy (ops/entropy_device.py, ops/entropy_cuda.py: K2u, K2)"
UNIT = "steps"
MOVES = "kernel_us_per_image"


def read(run):
    return attribution.items_per_call(run, "k2_pass2_steps")
