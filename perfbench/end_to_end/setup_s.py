"""setup_s: from the process's start to the first timed call: the torch
import, the kernel libraries loaded (built on a checkout's first run), the
inputs made from the seed, and the warm-up of the cell's own shapes."""


def read(run):
    return run.setup_s
