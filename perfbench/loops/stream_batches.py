"""Batches fed to `BatchDecoder.decode_stream(..., batch_size)` back to
back, from one stream that runs through warm-up and the window, so that
its pipeline (the host stage of batch k+1 beside the device stage of batch
k) is full when the window opens. The pool's images are fed in turn,
wrapping round. The window counts every image whose host RGB the stream
yielded, up to the first batch yielded at or after its end, and its
seconds end there, and it records each image's pool index. Traffic keys:
batch, warmup_batches, sample (images drawn for the check)."""

from __future__ import annotations

import sys
import time
import traceback

from ..harness import LoopResult, Reservoir


def _feed(datas, start):
    i = start
    while True:
        yield datas[i % len(datas)]
        i += 1


def run(cfg, config, traffic, pool, seconds, seed, device, window, rehearse):
    from jpeg_decoder_tpu_torch import BatchDecoder

    if config["entry"] != "BatchDecoder.decode_stream":
        raise ValueError(f"stream_batches drives BatchDecoder.decode_stream, not {config['entry']}")
    t = {**traffic, **(traffic.get("rehearse", {}) if rehearse else {})}
    b = t["batch"]
    bd = BatchDecoder(cfg, device=device)
    datas = [im.data for im in pool.images]
    stream = bd.decode_stream(_feed(datas, 0), batch_size=b)
    fed = 0  # images the stream has been given up to the batch in hand
    for _ in range(t["warmup_batches"]):
        next(stream)
        fed += b
    res = LoopResult(images_per_call=b)
    keep = Reservoir(t["sample"], seed)
    marks = []
    window.open()
    deadline = window.t_open + seconds
    while True:
        with window.span("batch"):
            try:
                out = next(stream)
            except Exception:  # a batch that raises fails each of its images
                if not res.failed:
                    traceback.print_exc(file=sys.stderr)
                res.failed += b
                out = None
                stream = bd.decode_stream(_feed(datas, fed + b), batch_size=b)
        now = time.perf_counter()
        res.attempted += b
        idx = []
        if out is not None:
            idx = [(fed + j) % len(datas) for j in range(out.shape[0])]
            res.images += len(idx)
            res.indices += idx
            for j, slot in keep.offer(len(idx)):
                keep.put(slot, (idx[j], out[j].copy()))
        marks.append((now - window.t_open, sum(pool.images[i].pixels for i in idx)))
        fed += b
        if now >= deadline:
            break
    res.elapsed_s = now - window.t_open
    window.close()
    stream.close()
    res.window_s = window.t_close - window.t_open
    res.samples = list(keep.items)
    q = seconds / 4
    rates = [sum(px for m, px in marks if k * q <= m < (k + 1) * q) / q / 1e6 for k in range(4)]
    print(f"batches: {len(marks)}; quarters of the window, MP/s: "
          + " ".join(f"{r:.1f}" for r in rates), file=sys.stderr)
    return res
