"""kernel_us_per_image: the time in the window in which a kernel ran on
the card (overlaps counted once; copies and memsets, which the copy
engines run, left out), in us per image yielded: the compute time a
loader's decode takes from a training step that shares the card. Read
from a profile of the card's activity alone over the untraced window."""

from perfbench import readers


def read(run):
    return readers.kernel_us(run, "image")
