"""The batched entropy decode rate on the device: K2u + K2 over a batch of
same-config 4K images in one call (the port of
benchmarks/pallas_batched.py).

    python -m jpeg_decoder_tpu_torch.benchmarks.k2_batched [--images 8]
        [--width 3840] [--height 2160] [--repeat 3] [--device cuda|cpu]
        [--out FILE]

The workload is pallas_batched.py's: uniform noise (seed 20260818),
quality 85, 4:2:0, a restart marker per MCU row (interval W/16), encoded
by the port's encoder. The streams are parsed once; each timed call is
ops/entropy_cuda.entropy_decode_batch on zeroed stacked planes (the
zeroing included, as BatchDecoder's PALLAS path does it): the upload of
the raw bytes, K2u and K2 for the whole batch, one group. The time is the
median wall time of --repeat calls after a warm one, each synchronised.
`subsequences` is K2's thread count for the batch (self-synchronising
subsequences of the unstuffed segments), in place of the TPU kernel's
lanes a invocation. Before it prints, the planes of the last call are
held bitwise against the native host decoder's; on a difference it exits
1. Prints one JSON line; --out FILE writes it to FILE as well.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

SEED = 20260818


def make_inputs(n: int, w: int, h: int, device) -> list[bytes]:
    """pallas_batched.py's images, encoded on `device`."""
    from ..models.encoder import JpegEncoder
    from ..utils.config import EncodeConfig

    rng = np.random.default_rng(SEED)
    enc = JpegEncoder(EncodeConfig(quality=85, subsampling="420", restart_interval=w // 16),
                      device)
    return [enc.encode(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)) for _ in range(n)]


def decode_batch(structures, device) -> list[list]:
    """One entropy_decode_batch call into zeroed stacked planes: per image,
    its planes (device tensors)."""
    import torch

    from ..ops import entropy_cuda
    from ..utils.config import DecodeConfig

    frame = structures[0].frame
    stacks = [torch.zeros((len(structures), c.blocks_y, c.blocks_x, 64), dtype=torch.int16,
                          device=device) for c in frame.components]
    planes = [[s[i] for s in stacks] for i in range(len(structures))]
    return [p for p, _qts in entropy_cuda.entropy_decode_batch(structures, DecodeConfig(),
                                                               planes)]


def subsequences(structures, device) -> int:
    """K2's subsequences for the batch: one per SUB_BYTES of each unstuffed
    segment (entropy_cuda.sub_layout), summed over the batch's groups."""
    from ..ops import entropy_cuda

    groups: dict = {}
    for s in structures:
        pack = entropy_cuda.prepare_scan(s, s.scans[0])
        groups.setdefault(pack.key, []).append(pack)
    n = 0
    for packs in groups.values():
        args, _host = entropy_cuda.launch_args(packs, device)
        n += int(entropy_cuda.sub_layout(args[1].cpu().numpy())[-1])
    return n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--images", type=int, default=8)
    ap.add_argument("--width", type=int, default=3840)
    ap.add_argument("--height", type=int, default=2160)
    ap.add_argument("--repeat", type=int, default=3)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out", type=Path, default=None, help="also write the line to FILE")
    args = ap.parse_args(argv)

    import torch

    from .. import convert
    from ..io.parser import parse
    from ..models import host
    from ..utils.config import DecodeConfig

    try:
        dev = convert.resolve_device(args.device)
    except RuntimeError as e:
        print(f"k2_batched: {e}", file=sys.stderr)
        return 2

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    datas = make_inputs(args.images, args.width, args.height, dev)
    structures = [parse(d) for d in datas]
    n_segs = sum(s.scans[0].span.num_segments for s in structures)
    px = args.images * args.width * args.height

    decode_batch(structures, dev)  # warm
    sync()
    ts = []
    for _ in range(args.repeat):
        t0 = time.perf_counter()
        planes = decode_batch(structures, dev)
        sync()
        ts.append(time.perf_counter() - t0)
    t = float(np.median(ts))

    for i, (d, got) in enumerate(zip(datas, planes)):
        _frame, want, _qts = host.host_decode(d, DecodeConfig())
        for ci, p in enumerate(got):
            if not np.array_equal(p.cpu().numpy(), want.plane(ci)):
                print(f"k2_batched: image {i} component {ci} differs from the native host"
                      " decoder's planes", file=sys.stderr)
                return 1

    result = {
        "artifact": "k2_batched_entropy",
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "images": args.images,
        "segments": n_segs,
        "subsequences": subsequences(structures, dev),
        "batch_wall_s": round(t, 6),
        "mp_per_s": round(px / t / 1e6, 1),
    }
    if dev.type == "cuda":
        result["device_kind"] = torch.cuda.get_device_name(dev)
    line = json.dumps(result)
    print(line, flush=True)
    if args.out is not None:
        args.out.write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
