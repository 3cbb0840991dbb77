"""request_p50_ms: the median latency of every request completed in
the window, ms (closed loop, one request in flight; host clock around
JpegDecoder.decode_rgb(bytes) to the host RGB)."""

from perfbench import readers


def read(run):
    return readers.latency_ms(run, 50)
