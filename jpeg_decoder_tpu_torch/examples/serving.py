"""Serving example: sustained batch decode on a CUDA card, or over the ranks
of a mesh (the port of examples/serving.py).

    python -m jpeg_decoder_tpu_torch.examples.serving [--device cuda|cpu]

One process, one card: make_mesh() is then 1 x 1 and BatchDecoder decodes
on the card. Across cards, one rank a card under NCCL, torch's own launch:

    torchrun --nproc-per-node 4 -m jpeg_decoder_tpu_torch.examples.serving

Each rank joins the process group (parallel/multihost.initialize reads
torchrun's RANK, WORLD_SIZE and LOCAL_RANK; NCCL, the rank's card),
make_mesh() puts every rank on the data axis, every rank passes the same
streams and each decodes its slice of every batch; the RGB is gathered,
so every rank prints the whole stream's numbers. Across hosts, torchrun's
--nnodes and --rdzv-endpoint do the same over every host's cards.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def main(device="cuda", n_streams: int = 64, side: int = 512):
    """`n_streams` same-geometry side x side requests (q85 4:2:0, restart
    interval 4, seed 0), decoded by decode_stream in batches of 16, which
    overlaps batch k+1's host entropy (threads) with batch k's device
    stage. Returns the requests and the frames [n, side, side, 3]."""
    from ..models.encoder import JpegEncoder
    from ..parallel import batch, mesh
    from ..utils.config import DecodeConfig, EncodeConfig
    from ..utils.metrics import GLOBAL_METRICS

    rng = np.random.default_rng(0)
    print("encoding a synthetic request stream...")
    enc = JpegEncoder(EncodeConfig(quality=85, subsampling="420", restart_interval=4), device)
    datas = [enc.encode(rng.integers(0, 256, (side, side, 3), dtype=np.uint8))
             for _ in range(n_streams)]

    m = mesh.make_mesh()  # every rank on the data axis
    bd = batch.BatchDecoder(DecodeConfig(), device, m)

    t0 = time.perf_counter()
    frames = []
    for rgb_batch in bd.decode_stream(datas, batch_size=16):
        frames.append(rgb_batch)
    dt = time.perf_counter() - t0
    n = sum(f.shape[0] for f in frames)
    px = n * side * side
    print(f"{n} frames in {dt * 1e3:.0f} ms = {n / dt:.1f} frames/s, {px / dt / 1e6:.1f} MP/s"
          f" on {m.size()} rank(s) ({bd.device})")
    print("per-stage metrics:", GLOBAL_METRICS.summary())
    return datas, np.concatenate(frames)


def progressive_serving(device="cuda", n_streams: int = 8, side: int = 512):
    """Progressive streams: one image is a set of bit-serial scan chains and
    cannot fill the host's cores alone, so the serving axis is across
    images: host_decode_batch runs several images' host stages at once.
    The streams are the port's encoder's (progressive, q85 4:2:0, seed 1).
    Returns the requests and each image's coefficient planes."""
    from ..models.encoder import JpegEncoder
    from ..models.host import PlanePool, host_decode_batch
    from ..utils.config import DecodeConfig, EncodeConfig

    rng = np.random.default_rng(1)
    enc = JpegEncoder(EncodeConfig(quality=85, subsampling="420", progressive=True), device)
    datas = [enc.encode(rng.integers(0, 256, (side, side, 3), dtype=np.uint8))
             for _ in range(n_streams)]

    # num_threads=1: the per-image scan DAG buys nothing once images, not
    # scans, fill the cores
    cfg = DecodeConfig(num_threads=1)
    pool = PlanePool()
    planes_out = []
    t0 = time.perf_counter()
    for _frame, planes, _qts in host_decode_batch(datas, cfg, pool):
        planes_out.append([p.copy() for p in planes.planes])
        pool.release(planes)  # hand the planes to the device stage in real use
    dt = time.perf_counter() - t0
    n = len(planes_out)
    print(f"progressive serving: {n} images, {dt / n * 1e3:.1f} ms/img host stage aggregate")
    return datas, planes_out


def cli(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    from .. import convert
    from ..parallel import multihost

    if "WORLD_SIZE" in os.environ:  # under torchrun
        multihost.initialize(backend="gloo" if args.device == "cpu" else None)
    try:
        device = convert.resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"serving: {e}") from None
    main(device)
    progressive_serving(device)


if __name__ == "__main__":
    cli()
