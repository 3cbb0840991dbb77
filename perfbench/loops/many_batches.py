"""Batches handed to `BatchDecoder.decode_many(datas)` back to back, closed
loop: each call returns every image's host RGB before the next is made.
The entry groups a call's images by size and quant tables and decodes the
groups one after another with no prefetch; the loop measures it as users
call it and adds no pipelining of its own. The pool's images are taken
`batch` a call, in turn, wrapping round. Warm-up makes `warmup_batches`
calls, and at least as many as the pool takes to be seen whole, so that
every size and table set the window meets has been decoded once. The
window counts every image the calls yielded, with its pool index, up to
the first call that returns at or after its end, and its seconds end
there. Traffic keys: batch, warmup_batches, sample (images drawn for the
check)."""

from __future__ import annotations

import sys
import time
import traceback

from ..harness import LoopResult, Reservoir


def run(cfg, config, traffic, pool, seconds, seed, device, window, rehearse):
    from jpeg_decoder_tpu_torch import BatchDecoder

    if config["entry"] != "BatchDecoder.decode_many":
        raise ValueError(f"many_batches drives BatchDecoder.decode_many, not {config['entry']}")
    t = {**traffic, **(traffic.get("rehearse", {}) if rehearse else {})}
    b = t["batch"]
    bd = BatchDecoder(cfg, device=device)
    datas = [im.data for im in pool.images]
    n = len(datas)

    def take(start):
        return [(start + j) % n for j in range(b)]

    fed = 0  # images handed to the entry before the call in hand
    for _ in range(max(t["warmup_batches"], -(-n // b))):
        bd.decode_many([datas[i] for i in take(fed)])
        fed += b
    res = LoopResult(images_per_call=None)
    keep = Reservoir(t["sample"], seed)
    marks = []
    window.open()
    deadline = window.t_open + seconds
    while True:
        idx = take(fed)
        with window.span("batch"):
            try:
                outs = bd.decode_many([datas[i] for i in idx])
            except Exception:  # a call that raises fails each of its images
                if not res.failed:
                    traceback.print_exc(file=sys.stderr)
                res.failed += b
                outs = None
        now = time.perf_counter()
        res.attempted += b
        pixels = 0
        if outs is not None:
            res.images += len(outs)
            res.indices += idx
            pixels = sum(pool.images[i].pixels for i in idx)
            for j, slot in keep.offer(len(outs)):
                keep.put(slot, (idx[j], outs[j].copy()))
        marks.append((now - window.t_open, pixels))
        fed += b
        if now >= deadline:
            break
    res.elapsed_s = now - window.t_open
    window.close()
    res.window_s = window.t_close - window.t_open
    res.samples = list(keep.items)
    q = seconds / 4
    rates = [sum(px for m, px in marks if k * q <= m < (k + 1) * q) / q / 1e6 for k in range(4)]
    print(f"batches: {len(marks)}; quarters of the window, MP/s: "
          + " ".join(f"{r:.1f}" for r in rates), file=sys.stderr)
    return res
