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


def _bound_s(run, im, which: str) -> float:
    """One image's roofline bound in a layer, seconds."""
    if which == "entropy":
        return roofline.entropy_bound_s(im.scan_bytes, im.blocks, im.symbols)
    return roofline.pixel_bound_s(im.blocks, im.pixels,
                                  planes_out=run.config["entry"] == "JpegDecoder.decode_rgb",
                                  fancy=run.config["decode_config"].get("upsample") == "fancy")


def _per_image(run, which: str) -> float:
    """The mean over the pool of one image's roofline bound, seconds."""
    b = [_bound_s(run, im, which) for im in run.pool.images]
    return sum(b) / len(b)


#: A kernel each call of a layer launches once: K2's pass 1; the pixel
#: stage's colour step (K03, K13, K3, K3f).
_ANCHORS = {"entropy": ("pass1_kernel",),
            "pixel": ("pixel_exact_kernel", "pixel_float_kernel", "colour_run_kernel",
                      "colour_pixel_kernel")}


def roofline_pct(run, layer: str):
    """The layer's kernels' share of their roofline, %: the bound of the
    work of the traced window over the device time of the layer's kernels
    in it. Where a loop's call covers a fixed number of images
    (`images_per_call`), the work is the calls the trace holds times that
    number times the mean image's bound; where a call's launches follow the
    groups of one size and table set in it (None), it is the summed bound
    of the images the window yielded. The entropy layer reads nothing
    there once the host's entropy decoder took images K2 never saw."""
    tr = _trace(run)
    if tr is None:
        return None
    spent = tr.seconds(tr.kernels(layer))
    calls = sum(tr.launches(k) for k in _ANCHORS[layer])
    if not spent or not calls:
        return None
    per_call = run.result.images_per_call
    if per_call is not None:
        return 100.0 * calls * per_call * _per_image(run, layer) / spent
    if layer == "entropy" and run.stages.get("entropy_batch_fallback", (0, 0.0, 0))[2]:
        return None
    images = run.pool.images
    return 100.0 * sum(_bound_s(run, images[i], layer) for i in run.result.indices) / spent


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
    images = run.pool.images
    return sum(images[i].pixels for i in r.indices) / r.elapsed_s / 1e6


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
