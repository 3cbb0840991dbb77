"""Batch decode throughput against the size of the mesh's data axis (the
port of benchmarks/scaling.py).

    python -m jpeg_decoder_tpu_torch.benchmarks.scaling [--sizes 1,2,4,8]
        [--batch 32] [--hw 256] [--repeat 3] [--device cuda|cpu]
        [--backend nccl|gloo] [--out FILE]

The workload is scaling.py's: --batch uniform-noise images of --hw x --hw
(seed 7), quality 85, 4:2:0, restart interval 2, encoded by the port's
encoder, decoded with DecodeConfig() (NATIVE entropy on the host, K03 on
the device). For each size n, n processes join one torch.distributed
group (a file store in a temporary directory), one rank a process, each
on its own card under NCCL (the default on the card) or, under gloo, all
on the first card or on the host (--device cpu). Each runs
BatchDecoder(cfg, device, make_mesh(n_data=n)).decode_batch once to warm
it, then --repeat times after a barrier, timed by the host clock to the
host result (every rank returns the whole batch), with every launch count
set to 0 just before the timed calls. Sizes above the card count are
skipped with a line on stderr, as scaling.py skips sizes above its device
count: on a one-card machine that leaves n = 1. `--backend gloo --device
cpu` runs any number of ranks on the host (the tests run it so).

Each rank holds its batch bitwise against decode() of the same bytes
without a mesh on the host (the kernels' plain versions); the script exits
1 if one differs. Prints one JSON line a size: mesh_devices, frames_per_s,
mp_per_s and scaling_efficiency against the first size run (rank 0's
median), with the SHA-256 of the decoded batch and each rank's launches and
their work (_build.LAUNCHES, LAUNCH_UNITS).
--out FILE writes the records as scaling.py does. Gloo ranks that share
one device (or the host) cannot scale with n: there the numbers measure
the gather through the host, and the file says so.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

SEED = 7
DEADLINE_S = 600.0


def make_inputs(batch: int, hw: int, device) -> list[bytes]:
    """scaling.py's images, encoded on `device`."""
    from ..models.encoder import JpegEncoder
    from ..utils.config import EncodeConfig

    rng = np.random.default_rng(SEED)
    enc = JpegEncoder(EncodeConfig(quality=85, subsampling="420", restart_interval=2), device)
    return [enc.encode(rng.integers(0, 256, (hw, hw, 3), dtype=np.uint8))
            for _ in range(batch)]


def rank_main(ns) -> None:
    """One rank of a size: writes DIR/rank{R}.json."""
    import torch
    import torch.distributed as dist

    from .. import DecodeConfig, _build
    from ..models.decoder import decode
    from ..parallel import mesh as mesh_mod
    from ..parallel import multihost
    from ..parallel.batch import BatchDecoder

    multihost.initialize(f"file://{ns.dir / 'store'}", num_processes=ns.world,
                         process_id=ns.rank, backend=ns.backend)
    if ns.device == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    else:
        dev = torch.device("cpu")
    datas = make_inputs(ns.batch, ns.hw, dev)
    bd = BatchDecoder(DecodeConfig(), dev, mesh_mod.make_mesh(n_data=ns.world))
    out = bd.decode_batch(datas)  # warm
    _build.LAUNCHES.clear()
    _build.LAUNCH_UNITS.clear()
    ts = []
    for _ in range(ns.repeat):
        dist.barrier()
        t0 = time.perf_counter()
        out = bd.decode_batch(datas)
        ts.append(time.perf_counter() - t0)
    # the same bytes decoded without a mesh, on the host (the plain
    # versions of the kernels)
    cpu = DecodeConfig().replace(use_device=False)
    want = np.stack([decode(d, cpu, device="cpu").rgb for d in datas])
    rec = {"rank": ns.rank, "world": ns.world, "backend": ns.backend,
           "card": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
           "wall_s": ts, "launches": dict(_build.LAUNCHES), "units": dict(_build.LAUNCH_UNITS),
           "shape": list(out.shape),
           "sha256": hashlib.sha256(np.ascontiguousarray(out).tobytes()).hexdigest(),
           "bitwise": bool(out.shape == want.shape and np.array_equal(out, want))}
    dist.barrier()
    dist.destroy_process_group()
    (ns.dir / f"rank{ns.rank}.json").write_text(json.dumps(rec))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", default="1,2,4,8")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--hw", type=int, default=256, help="image side length")
    ap.add_argument("--repeat", type=int, default=3)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="default: nccl on the card, gloo on the host")
    ap.add_argument("--out", default=None, help="also write the per-size records as JSON")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--dir", type=Path, default=None, help=argparse.SUPPRESS)
    ns = ap.parse_args(argv)
    ns.backend = ns.backend or ("nccl" if ns.device == "cuda" else "gloo")
    if ns.rank is not None:
        rank_main(ns)
        return 0

    import torch

    from .. import _build, convert
    from ..native import runtime as native_runtime
    from . import mesh_ranks

    try:
        dev = convert.resolve_device(ns.device)
    except RuntimeError as e:
        print(f"scaling: {e}", file=sys.stderr)
        return 2
    if ns.backend == "nccl" and dev.type != "cuda":
        print("scaling: NCCL needs --device cuda", file=sys.stderr)
        return 2
    # built once here, so that the ranks never build side by side
    if not native_runtime.available():
        print("scaling: the native runtime is unavailable", file=sys.stderr)
        return 2
    if dev.type == "cuda":
        _build.library()
    px = ns.batch * ns.hw * ns.hw
    base_rate = base_n = None
    records = []
    for n in [int(s) for s in ns.sizes.split(",")]:
        if dev.type == "cuda" and n > torch.cuda.device_count():
            print(f"# skipping mesh size {n}: only {torch.cuda.device_count()} cards",
                  file=sys.stderr)
            continue
        with tempfile.TemporaryDirectory(prefix="jdt_scaling_") as tmp:
            try:
                ranks = mesh_ranks.run_ranks(
                    "jpeg_decoder_tpu_torch.benchmarks.scaling",
                    ["--dir", tmp, "--batch", str(ns.batch), "--hw", str(ns.hw),
                     "--repeat", str(ns.repeat), "--device", ns.device,
                     "--backend", ns.backend], n, Path(tmp), DEADLINE_S)
            except RuntimeError as e:
                print(f"scaling: {e}", file=sys.stderr)
                return 1
        if not all(r["bitwise"] for r in ranks):
            print(f"scaling: size {n} decoded a batch that differs from the decode without"
                  f" a mesh on the host", file=sys.stderr)
            return 1
        t = float(np.median(ranks[0]["wall_s"]))
        rate = px / t
        if base_rate is None:
            base_rate, base_n = rate, n
        rec = {
            "mesh_devices": n,
            "frames_per_s": round(ns.batch / t, 2),
            "mp_per_s": round(rate / 1e6, 2),
            "scaling_efficiency": round((rate / n) / (base_rate / base_n), 3),
            "sha256": ranks[0]["sha256"],
            "launches": [r["launches"] for r in ranks],
            "units": [r["units"] for r in ranks],
        }
        records.append(rec)
        print(json.dumps(rec), flush=True)
    if ns.out:
        shared = ns.backend == "gloo"
        with open(ns.out, "w") as f:
            json.dump({
                "headline": ("the ranks share one device: read the sizes above 1 as the"
                             " cost of the gather through the host, not as scaling"
                             if shared else "shared_core_raw (a card a rank, NCCL)"),
                "shared_core_raw": {
                    "warning": ("gloo ranks share one device (or the host's cores), so"
                                " frames/s cannot scale with n; scaling_efficiency of about"
                                " 1/n is expected and measures the gather, not scaling"
                                ) if shared else None,
                    "platform": "gpu" if dev.type == "cuda" else "cpu",
                    "backend": ns.backend,
                    "device_kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                                    else "cpu"),
                    "sizes": records,
                },
            }, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
