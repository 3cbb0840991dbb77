"""Requests in a closed loop, one in flight: each the host clock around
`JpegDecoder.decode_rgb(bytes)`, which returns the host RGB. The pool's
streams are sent in turn; warm-up sends each of them (every stage key and
shape the window will use) and then more, up to `warmup`. Traffic keys:
warmup, sample (outputs drawn for the check)."""

from __future__ import annotations

import sys
import time
import traceback

from ..harness import LoopResult, Reservoir


def run(cfg, config, traffic, pool, seconds, seed, device, window, rehearse):
    from jpeg_decoder_tpu_torch import JpegDecoder

    if config["entry"] != "JpegDecoder.decode_rgb":
        raise ValueError(f"closed_requests drives JpegDecoder.decode_rgb, not {config['entry']}")
    t = {**traffic, **(traffic.get("rehearse", {}) if rehearse else {})}
    dec = JpegDecoder(cfg, device=device)
    datas = [im.data for im in pool.images]
    for i in range(max(t["warmup"], len(datas))):
        dec.decode_rgb(datas[i % len(datas)])
    res = LoopResult()
    keep = Reservoir(t["sample"], seed)
    ends = []
    window.open()
    deadline = window.t_open + seconds
    while True:
        idx = res.attempted % len(datas)
        with window.span("request"):
            t1 = time.perf_counter()
            try:
                rgb = dec.decode_rgb(datas[idx])
                lat = time.perf_counter() - t1
            except Exception:  # a request that raises is a failed request
                if not res.failed:
                    traceback.print_exc(file=sys.stderr)
                res.failed += 1
                rgb, lat = None, seconds
        res.latencies_s.append(lat)
        ends.append(time.perf_counter() - window.t_open)
        res.attempted += 1
        for _, slot in keep.offer(1):
            keep.put(slot, (idx, rgb))
        if time.perf_counter() >= deadline:
            break
    window.close()
    res.window_s = window.t_close - window.t_open
    q = sorted(res.latencies_s)
    at = ", ".join(f"p{p} {q[min(len(q) - 1, len(q) * p // 100)] * 1e3:.3f}"
                   for p in (10, 50, 90, 95, 99, 100))
    print(f"requests: {res.attempted} in {res.window_s:.3f} s; the latency percentiles are"
          f" over these {res.attempted} samples (ms: {at})", file=sys.stderr)
    quarters = [sorted(x for x, e in zip(res.latencies_s, ends) if k * seconds / 4 <= e < (k + 1) * seconds / 4)
                for k in range(4)]
    print("quarters of the window, p50 ms: " + " ".join(
        f"{q[len(q) // 2] * 1e3:.3f}" if q else "-" for q in quarters), file=sys.stderr)
    res.samples = [s for s in keep.items if s[1] is not None]
    return res
