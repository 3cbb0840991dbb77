"""What the metric readers (`end_to_end/*.py`, `metrics/*.py`) share: the
arithmetic of a run's numbers, each function returning None where the run
has nothing to read."""

from __future__ import annotations

import statistics

from . import roofline


def latency_ms(run, q: float):
    """The q-th percentile (0-100) of every request's latency in the window,
    ms, by `statistics.quantiles` (inclusive); a request that raised counts
    at the whole window."""
    lat = run.result.latencies_s
    if not lat:
        return None
    if len(lat) == 1:
        return lat[0] * 1e3
    return statistics.quantiles(lat, n=100, method="inclusive")[int(q) - 1] * 1e3


def _trace(run):
    return run.trace if run.trace is not None and run.trace.window_s > 0 else None


def _per_image(run, which: str) -> float:
    """The mean over the pool of one image's roofline bound, seconds."""
    pool = run.pool
    blocks = pool.blocks
    if which == "entropy":
        b = [roofline.entropy_bound_s(im.scan_bytes, blocks, im.symbols) for im in pool.images]
    else:
        b = [roofline.pixel_bound_s(blocks, pool.width * pool.height,
                                    planes_out=run.config["entry"] == "JpegDecoder.decode_rgb",
                                    fancy=run.config["decode_config"].get("upsample") == "fancy")
             for im in pool.images]
    return sum(b) / len(b)


#: A kernel each call of a layer launches once: K2's pass 1; the pixel
#: stage's colour step (K03, K13, K3, K3f).
_ANCHORS = {"entropy": ("pass1_kernel",),
            "pixel": ("pixel_exact_kernel", "pixel_float_kernel", "colour_run_kernel",
                      "colour_pixel_kernel")}


def roofline_pct(run, layer: str):
    """The layer's kernels' share of their roofline, %: the calls in the
    traced window times the images a call covers times one image's bound,
    over the device time of the layer's kernels in the window."""
    tr = _trace(run)
    if tr is None:
        return None
    spent = tr.seconds(tr.kernels(layer))
    calls = sum(tr.launches(k) for k in _ANCHORS[layer])
    if not spent or not calls:
        return None
    return 100.0 * calls * run.result.images_per_call * _per_image(run, layer) / spent


def copy_ms(run, per: str):
    """Device time of host-to-device and device-to-host copies in the
    traced window, ms per request or per image yielded."""
    tr = _trace(run)
    n = run.result.attempted if per == "request" else run.result.images
    if tr is None or not n:
        return None
    return tr.seconds(tr.copies("htod", "dtoh")) * 1e3 / n


def kernel_us(run, per: str):
    """The time in the window in which a kernel ran on the card (overlaps
    counted once; copies and memsets left out), us per request or per
    image yielded."""
    tr = _trace(run)
    n = run.result.attempted if per == "request" else run.result.images
    if tr is None or not n:
        return None
    return tr.kernel_busy_s * 1e6 / n


def mps(run):
    """Source megapixels a second: every image the entry yielded in the
    window, over the seconds to the last of them."""
    r = run.result
    if not r.images or r.elapsed_s <= 0:
        return None
    return r.images * run.pool.width * run.pool.height / r.elapsed_s / 1e6


def idle_pct(run):
    """The share of the traced window in which nothing ran on the card, %."""
    tr = _trace(run)
    if tr is None:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def stage_ms(run, stage: str, per: str):
    """A program timer's (GLOBAL_METRICS) seconds over the window, ms per
    call (`per` "call") or per item it counted (`per` "item")."""
    st = run.stages.get(stage)
    if st is None:
        return None
    calls, seconds, items = st
    n = calls if per == "call" else items
    return seconds * 1e3 / n if n else None
