"""Multi-process initialization on torch.distributed (counterpart of
jpeg_decoder_tpu/parallel/multihost.py).

The JAX package joins every process into one JAX system, in which
`jax.devices()` lists every device of every host. The port follows
torch's own idiom instead: one process (rank) a device, as `torchrun
--nproc-per-node` launches them, all in one default process group. The
mesh of parallel/mesh.py spans the group's ranks; its collectives run on
the group's backend, NCCL between cards, gloo on the host.

Launch under torchrun (one rank a card; the rendezvous comes from the
environment):

    torchrun --nproc-per-node 4 serve.py
        from jpeg_decoder_tpu_torch.parallel import mesh, multihost
        multihost.initialize()                 # NCCL, LOCAL_RANK's card
        m = mesh.make_mesh()                   # ("data", "stripe") over the ranks
        rgb = BatchDecoder(cfg, "cuda", m).decode_batch(datas)

or by hand, one call a process (the tests run this on the CPU, gloo):

    multihost.initialize("file:///tmp/store", num_processes=2, process_id=i)
    multihost.initialize("localhost:29500", num_processes=2, process_id=i)
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from ..utils.logging import get_logger

log = get_logger("multihost")

_initialized = False


def _init_method(coordinator_address: str | None) -> str:
    """A `host:port` is a TCP store, a `file://` path a file store, and no
    address torchrun's environment (MASTER_ADDR, MASTER_PORT)."""
    if coordinator_address is None:
        return "env://"
    if "://" in coordinator_address:
        return coordinator_address
    return f"tcp://{coordinator_address}"


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids=None,
    backend: str | None = None,
) -> None:
    """Join this process into the default process group as rank
    `process_id` of `num_processes` (both from torchrun's RANK and
    WORLD_SIZE when not given). `backend` defaults to "nccl" where CUDA is
    present, else "gloo". Under NCCL this rank's card is the first of
    `local_device_ids`, else LOCAL_RANK's. A second call logs a warning
    and returns."""
    global _initialized
    if _initialized or dist.is_initialized():
        log.warning("multihost.initialize called twice; ignoring")
        return
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    rank = int(os.environ["RANK"]) if process_id is None and "RANK" in os.environ else process_id
    world = (int(os.environ["WORLD_SIZE"])
             if num_processes is None and "WORLD_SIZE" in os.environ else num_processes)
    if backend == "nccl":
        if local_device_ids is not None:
            card = list(local_device_ids)[0]
        else:
            card = int(os.environ.get("LOCAL_RANK", rank or 0)) % torch.cuda.device_count()
        torch.cuda.set_device(card)
    dist.init_process_group(backend, init_method=_init_method(coordinator_address),
                            world_size=-1 if world is None else world,
                            rank=-1 if rank is None else rank)
    _initialized = True
    info = process_info()
    log.info("process %d/%d up (%s): %d local / %d global devices", info["process_index"],
             info["process_count"], backend, info["local_devices"], info["global_devices"])


def is_distributed() -> bool:
    """Whether this process belongs to a process group of more than one
    rank."""
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def process_info() -> dict:
    """The JAX version's four keys, counted in the process group: one
    device a rank, so every process has one local device and the group
    as many devices as ranks (one of each without a group)."""
    grouped = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if grouped else 1
    return {
        "process_index": dist.get_rank() if grouped else 0,
        "process_count": world,
        "local_devices": 1,
        "global_devices": world,
    }
