"""The mesh paths on one rank of a process group: the rank's side of
chip_smoke.py's phase "main paths, mesh", which starts the ranks.

    python -m jpeg_decoder_tpu_torch.benchmarks.mesh_ranks DIR --rank R \\
        --world N --backend nccl|gloo [--cases batches stripes dryrun gigapixel] \\
        [--device cuda|cpu]

DIR holds the inputs (batch0.jpg ... batch7.jpg: chip_smoke.py writes its
eight 3840x2160 4:2:0 requests with a marker per MCU row; gigapixel.jpg)
and the process group's file store. Every rank runs on the first CUDA card
(`--device cpu`: on the host, the kernels' plain versions); under gloo
several ranks share it. Cases, each a mesh path run once to warm it, then once with
every launch count set to 0 just before it and read just after:
  batches   -- BatchDecoder(cfg, mesh).decode_batch of the eight requests
               over a data axis of N ranks, PALLAS and NATIVE, EXACT and
               FLOAT32;
  stripes   -- decode_striped(mesh) of batch0.jpg over a stripe axis of N
               ranks: fancy EXACT (NATIVE: each rank decodes its stripe's
               restart segments), fancy FLOAT32 (PALLAS: the whole image
               on the card, sliced) and nearest-neighbour EXACT;
  dryrun    -- entry.dryrun_multichip(N);
  gigapixel -- decode_striped(mesh) of gigapixel.jpg over a stripe axis of
               N ranks, nearest-neighbour EXACT.
Each result is held bitwise against the same call without a mesh on the
same card (decode_striped with N stripes; for the dry run the whole-frame
K6f decode of the tiny image and K4 on it; for the gigapixel frame on rank
0 alone) and its SHA-256 recorded, so that the ranks can be compared.
Writes DIR/rank{R}.json: per case the launches and their work, the wall
time (host clock, bytes to the host result), and the host-clock seconds
of the halo exchanges and the gathers (utils.metrics `mesh_halo_exchange`,
`mesh_gather`).

run_ranks starts the ranks of such a script (this one, benchmarks/scaling.py)
and collects their records.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

CASES = ("batches", "stripes", "dryrun", "gigapixel")
REPO = Path(__file__).resolve().parents[2]


def run_ranks(module: str, args, world: int, tmp: Path, timeout: float = 600.0) -> list:
    """`world` processes of `python -m module *args --rank R --world N`, from
    the repository's root, whose ranks write tmp/rank{R}.json (tmp also holds
    the group's file store and each rank's log); the records in rank order.
    The first rank to fail, or the deadline, ends the others and raises
    RuntimeError with that rank's log."""
    for f in [tmp / "store", *tmp.glob("rank*.json")]:
        f.unlink(missing_ok=True)
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    logs = [tmp / f"rank{r}.log" for r in range(world)]
    procs = []
    for r in range(world):
        with open(logs[r], "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", module, *args, "--rank", str(r), "--world", str(world)],
                cwd=str(REPO), env=env, stdout=f, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    killed = set()
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for r, p in enumerate(procs):
            if p.poll() is None:
                p.kill()
                killed.add(r)
            p.wait()
    # the rank that failed on its own, before those ended for it
    failed = sorted((r in killed, r) for r, p in enumerate(procs) if p.returncode != 0)
    if failed:
        r = failed[0][1]
        raise RuntimeError(f"rank {r} of {world} exited {procs[r].returncode}:"
                           f" {logs[r].read_text()[-3000:]}")
    return [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(world)]


def _digest(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _run(name: str, mesh_fn, plain_fn, out: dict) -> None:
    """mesh_fn warm, then counted and timed; its result against plain_fn's
    (None: not compared on this rank)."""
    from .. import _build
    from ..utils.metrics import GLOBAL_METRICS as metrics

    mesh_fn()
    _build.LAUNCHES.clear()
    _build.LAUNCH_UNITS.clear()
    metrics.stages.clear()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = mesh_fn()
    wall = time.perf_counter() - t0
    launches, units = dict(_build.LAUNCHES), dict(_build.LAUNCH_UNITS)
    stages = metrics.summary()
    got = got if isinstance(got, tuple) else (got,)
    want = plain_fn() if plain_fn is not None else None
    if want is not None:
        want = want if isinstance(want, tuple) else (want,)
    out[name] = dict(
        launches=launches, units=units, wall_s=wall,
        halo_s=stages.get("mesh_halo_exchange", {}).get("total_s", 0.0),
        halo_calls=stages.get("mesh_halo_exchange", {}).get("calls", 0),
        gather_s=stages.get("mesh_gather", {}).get("total_s", 0.0),
        gather_calls=stages.get("mesh_gather", {}).get("calls", 0),
        shape=[list(a.shape) for a in got], sha256=_digest(*got),
        bitwise=None if want is None else all(
            a.shape == b.shape and np.array_equal(a, b) for a, b in zip(got, want)))


def _dryrun_reference(n: int, dev):
    """dryrun_multichip(n) without a mesh: the tiny image's whole-frame
    striped fancy decode (K6f) for every member of the batch, then K4."""
    from ..entry import _tiny_coeffs
    from ..models.encoder import quality_qtables
    from ..ops import fdct as fdct_ops
    from ..parallel import stripes

    n_stripe = 2 if n % 2 == 0 and n >= 2 else 1
    frame, planes, qts, cfg = _tiny_coeffs(h=16 * n_stripe, w=32)
    stage = stripes.build_striped_stage(stripes._stage_for(frame, qts, cfg.replace(
        upsample="fancy")), n_stripe, dev)
    rgb = stage(*[torch.from_numpy(p).to(dev) for p in planes.planes])
    kq = fdct_ops.fdct_tables([quality_qtables(85)[0]], dev)
    co = fdct_ops.encode_planes(rgb[..., 0].contiguous(), ((1, 1),), kq)[0].reshape(-1, 64)
    batch = 2 * (n // n_stripe)
    return (np.stack([rgb.cpu().numpy()] * batch),
            np.stack([co.to(torch.int32).cpu().numpy()] * batch))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dir", type=Path)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--backend", choices=("nccl", "gloo"), required=True)
    ap.add_argument("--cases", nargs="+", choices=CASES, default=list(CASES))
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ns = ap.parse_args(argv)

    import torch.distributed as dist

    from .. import DecodeConfig, EntropyBackend, IdctPrecision
    from ..entry import dryrun_multichip
    from ..parallel import mesh as mesh_mod
    from ..parallel import multihost
    from ..parallel import stripes
    from ..parallel.batch import BatchDecoder

    multihost.initialize(f"file://{ns.dir / 'store'}", num_processes=ns.world,
                         process_id=ns.rank, backend=ns.backend)
    dev = torch.device(ns.device, 0)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    n = ns.world
    out: dict = {"rank": ns.rank, "world": n, "backend": ns.backend,
                 "process_info": multihost.process_info(),
                 "card": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"}
    exact, f32 = IdctPrecision.EXACT, IdctPrecision.FLOAT32
    pallas, native = EntropyBackend.PALLAS, EntropyBackend.NATIVE
    if "batches" in ns.cases:
        datas = [(ns.dir / f"batch{i}.jpg").read_bytes() for i in range(8)]
        mesh = mesh_mod.make_mesh(n_data=n)
        for b in (pallas, native):
            for p in (exact, f32):
                cfg = DecodeConfig(entropy_backend=b, idct_precision=p)
                _run(f"BatchDecoder mesh {b.value} {p.value} decode_batch",
                     lambda cfg=cfg: BatchDecoder(cfg, dev, mesh).decode_batch(datas),
                     lambda cfg=cfg: BatchDecoder(cfg, dev).decode_batch(datas), out)
    if "stripes" in ns.cases:
        data = (ns.dir / "batch0.jpg").read_bytes()
        mesh = mesh_mod.make_mesh(n_data=1, n_stripe=n)
        for name, cfg in (("fancy exact", DecodeConfig(upsample="fancy")),
                          ("fancy pallas float32", DecodeConfig(
                              upsample="fancy", entropy_backend=pallas, idct_precision=f32)),
                          ("nn exact", DecodeConfig())):
            _run(f"decode_striped mesh {name}",
                 lambda cfg=cfg: stripes.decode_striped(data, cfg, device=dev, mesh=mesh),
                 lambda cfg=cfg: stripes.decode_striped(data, cfg, n_stripes=n, device=dev),
                 out)
    if "dryrun" in ns.cases:
        _run(f"dryrun_multichip({n})", lambda: dryrun_multichip(n, dev),
             lambda: _dryrun_reference(n, dev), out)
    if "gigapixel" in ns.cases:
        data = (ns.dir / "gigapixel.jpg").read_bytes()
        mesh = mesh_mod.make_mesh(n_data=1, n_stripe=n)
        cfg = DecodeConfig()
        _run("decode_striped mesh gigapixel exact",
             lambda: stripes.decode_striped(data, cfg, device=dev, mesh=mesh),
             (lambda: stripes.decode_striped(data, cfg, n_stripes=n, device=dev))
             if ns.rank == 0 else None, out)
    dist.barrier()
    dist.destroy_process_group()
    (ns.dir / f"rank{ns.rank}.json").write_text(json.dumps(out))


if __name__ == "__main__":
    main()
