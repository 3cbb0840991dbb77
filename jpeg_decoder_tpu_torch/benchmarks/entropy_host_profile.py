"""Where the host's time goes in the entropy stage of a PALLAS request, on
one CUDA card.

    python -m jpeg_decoder_tpu_torch.benchmarks.entropy_host_profile [--reps 30]

(the inputs are benchmarks/inputs.py's.) For one 3840x2160 4:2:0 request of
random dense blocks and one of a photograph's blocks tiled to that size it times,
on the host clock with the card idle before and after each call, every step
between the bytes of the file and the checked status: parse, prepare_scan,
host_args, to_device, unstuff_segments (K2u: it enqueues the single pass
and the layout kernel and reads nothing back), decode_segments (K2, beside
the sum of its passes from CUDA events) and check_status (the status and
the unstuffed offsets in one read-back); and, apart, what K2's wrapper does
before its first kernel (the records' capacity from the raw lengths in
numpy, the two uploads and the allocations) and what the four read-backs
cost a caller that does not hand it the host's copies of its arguments
(decode_segments_without_host). One JSON line per input: median microseconds of `reps` calls,
with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np

W, H, RI = 3840, 2160, 240


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=30)
    ns = ap.parse_args(argv)

    import torch

    from .. import convert
    from ..io.parser import parse
    from ..ops import entropy_cuda
    from .gather_probe import card_line
    from .inputs import F420, PHOTOS_420, make_jpeg, photo_jpeg

    dev = torch.device("cuda")

    def us(fn) -> float:
        times = []
        for _ in range(ns.reps + 1):  # the first call warms up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e6)
        return round(statistics.median(times[1:]), 1)

    for blocks, data in (("dense", make_jpeg(W, H, F420, RI, 20261016)),
                         (PHOTOS_420[0].stem, photo_jpeg(PHOTOS_420[0], W, H, RI))):
        s = parse(data)
        pack = entropy_cuda.prepare_scan(s, s.scans[0])
        host = entropy_cuda.host_args([pack])
        raw, lo, hi, *rest = entropy_cuda.to_device(host, dev)
        stream, seg_off, sub_base = entropy_cuda.unstuff_segments(raw, lo, hi)
        seg_img, _seg_idx, _ri, total_mcus, units, tables = rest
        bound = entropy_cuda.raw_bound(host[1], host[2])
        on_host = entropy_cuda.HostArrays(bound, host[3], host[6], host[7], sub_base)
        planes = [convert.zero_planes(s.frame, dev)]
        rec: dict = {}
        for records in (None, rec):  # the first call loads the kernels
            status = entropy_cuda.decode_segments(stream, seg_off, *rest, planes,
                                                  records=records, host=on_host)
        entropy_cuda.check_status(status, seg_off)
        n_subs = int(entropy_cuda.sub_layout(bound)[-1])   # the records' capacity
        n_du = pack.total_mcus * pack.units.shape[0]
        du_base = np.array([0, n_du], dtype=np.int64)

        def allocations():
            return [torch.empty(n, dtype=dtype, device=dev) for n, dtype in (
                (2 * len(lo), torch.int64), (n_subs, torch.int64), (n_subs, torch.int64),
                (n_subs, torch.int32), (n_du, torch.int16),
                (tables.shape[0] << 10, torch.int16), (1, torch.int32))]

        line = dict(
            blocks=blocks, bytes=len(data), subsequences=int(rec["sub_base"][-1]),
            record_capacity=n_subs,
            parse=us(lambda: parse(data)),
            prepare_scan=us(lambda: entropy_cuda.prepare_scan(s, s.scans[0])),
            host_args=us(lambda: entropy_cuda.host_args([pack])),
            to_device=us(lambda: entropy_cuda.to_device(host, dev)),
            unstuff_segments=us(lambda: entropy_cuda.unstuff_segments(raw, lo, hi)),
            decode_segments=us(lambda: entropy_cuda.decode_segments(
                stream, seg_off, *rest, planes, host=on_host)),
            decode_segments_without_host=us(lambda: entropy_cuda.decode_segments(
                stream, seg_off, *rest, planes)),
            passes_sum=round(1e3 * sum(rec["pass_ms"]), 1),
            check_status=us(lambda: entropy_cuda.check_status(status, seg_off)),
            before_k2s_first_kernel=dict(
                read_back_units=us(lambda: units.cpu().numpy()),
                read_back_seg_img=us(lambda: seg_img.cpu().numpy()),
                read_back_seg_off=us(lambda: seg_off.cpu().numpy()),
                read_back_total_mcus=us(lambda: total_mcus.cpu().numpy()),
                sub_layout=us(lambda: entropy_cuda.sub_layout(bound)),
                upload_du_base=us(lambda: torch.from_numpy(du_base).to(dev, non_blocking=True)),
                upload_plane_addresses=us(lambda: convert.plane_addresses(planes, dev)),
                allocations=us(allocations)),
            unit="us", card=card_line())
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
