"""The ("data", "stripe") mesh over torch.distributed ranks, and its
collectives (counterpart of jpeg_decoder_tpu/parallel/mesh.py).

The JAX mesh holds k devices of one or many processes; the port's holds k
RANKS, one device each (parallel/multihost.py). Its two named axes keep
their JAX names and meaning:

  * "data"   -- batch data parallelism: each rank of the axis runs the
               host stage and the pixel stage of its slice of a batch
               (parallel/batch.py);
  * "stripe" -- spatial parallelism: rank k of the axis decodes stripe k
               of MCU rows of one image (parallel/stripes.py); under fancy
               upsampling it exchanges one chroma row with each neighbour.

`make_mesh` returns a torch.distributed.device_mesh.DeviceMesh. The kernels
run on plain local tensors of the rank's device, never on DTensors; a
`Sharding` (batch_sharding, stripe_sharding, replicated) names a leading
axis split over one mesh axis and gives this rank's slice of it, the
gather of the slices (all_gather_into_tensor) and the halo exchange
(batch_isend_irecv between stripe neighbours).

Collectives run on the group's backend device: CUDA tensors go to NCCL as
they are; under gloo, which has no CUDA send, receive or all-gather, the
halo rows and the gathered outputs are copied to the host explicitly and
the halo rows back to the rank's device. The kernels still run on the
rank's device (several gloo ranks may share one card).
"""

from __future__ import annotations

import dataclasses
import warnings

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..utils.metrics import GLOBAL_METRICS as metrics

DATA_AXIS = "data"
STRIPE_AXIS = "stripe"


def _grouped() -> bool:
    return dist.is_available() and dist.is_initialized()


def _nccl() -> bool:
    return _grouped() and dist.get_backend() == "nccl"


def make_mesh(n_data: int | None = None, n_stripe: int = 1, devices=None) -> DeviceMesh:
    """A ("data", "stripe") mesh of n_data x n_stripe ranks: the first of
    `devices`, a list of ranks of the process group (default: every rank),
    row by row. n_data defaults to len(devices) // n_stripe. Every rank of
    the group calls it with the same arguments (the mesh's subgroups are
    made collectively). Without a process group: this process alone, a
    1 x 1 mesh over its device."""
    world = dist.get_world_size() if _grouped() else 1
    devices = list(range(world)) if devices is None else [int(r) for r in devices]
    if any(not 0 <= r < world for r in devices):
        raise ValueError(f"ranks {devices} are not all in a process group of {world}")
    if n_data is None:
        n_data = len(devices) // n_stripe
    need = n_data * n_stripe
    if need > len(devices):
        raise ValueError(f"mesh {n_data}x{n_stripe} needs {need} devices, have {len(devices)}")
    grid = torch.tensor(devices[:need], dtype=torch.int64).reshape(n_data, n_stripe)
    names = (DATA_AXIS, STRIPE_AXIS)
    if not _grouped():
        kind = "cuda" if torch.cuda.is_available() else "cpu"
        return DeviceMesh(kind, grid, mesh_dim_names=names, _init_backend=False, _rank=0)
    return DeviceMesh("cuda" if _nccl() else "cpu", grid, mesh_dim_names=names)


@dataclasses.dataclass(frozen=True, eq=False)
class Sharding:
    """A leading axis split in equal slices over mesh axis `axis` and
    replicated over the other (`axis` None: replicated over both)."""

    mesh: DeviceMesh
    axis: str | None

    @property
    def size(self) -> int:
        """The slices: the axis's ranks."""
        if self.axis is None:
            return 1
        return self.mesh.size(self.mesh.mesh_dim_names.index(self.axis))

    @property
    def index(self) -> int:
        """This rank's slice: its coordinate on the axis."""
        coord = self.mesh.get_coordinate()
        if coord is None:
            raise ValueError("this rank is not in the mesh")
        if self.axis is None:
            return 0
        return coord[self.mesh.mesh_dim_names.index(self.axis)]

    def local(self, x):
        """This rank's slice of x's leading axis, a multiple of `size`."""
        n = len(x)
        if n % self.size:
            raise ValueError(f"a leading axis of {n} does not split in {self.size}")
        step = n // self.size
        return x[self.index * step:(self.index + 1) * step]

    def _group(self):
        return self.mesh.get_group(self.axis)

    def _on_backend(self, t: torch.Tensor) -> torch.Tensor:
        """t where the group's backend takes it: on this rank's card under
        NCCL, copied to the host under gloo."""
        where = torch.device("cuda", torch.cuda.current_device()) if _nccl() else "cpu"
        return t.detach().to(where).contiguous()

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The slices of every rank of the axis, in axis order, concatenated
        on the leading axis (all_gather_into_tensor): on the card under
        NCCL, on the host under gloo; `local` itself on a one-rank axis."""
        if self.size == 1:
            return local
        src = self._on_backend(local)
        out = src.new_empty((self.size * src.shape[0], *src.shape[1:]))
        with metrics.timer("mesh_gather", items=out.numel() * out.element_size()), \
                warnings.catch_warnings():
            # newer torch names it all_gather_single; the card's may not
            warnings.simplefilter("ignore", FutureWarning)
            dist.all_gather_into_tensor(out, src, group=self._group())
        return out

    def halo_exchange(self, first: torch.Tensor, last: torch.Tensor):
        """(top, bottom) halo rows of this rank's stripe: the previous
        rank's `last` rows and the next rank's `first` (batch_isend_irecv),
        this rank's own `first` and `last` at the axis's two ends (the JAX
        ppermute with the edge replicated, stripes.py:56-67). The halos
        lie on first's device."""
        n, k = self.size, self.index
        if n == 1:
            return first, last
        group = self._group()
        ranks = dist.get_process_group_ranks(group)
        send_first, send_last = self._on_backend(first), self._on_backend(last)
        top = send_last.new_empty(send_last.shape) if k > 0 else None
        bottom = send_first.new_empty(send_first.shape) if k < n - 1 else None
        ops = []
        if k > 0:
            ops += [dist.P2POp(dist.isend, send_first, ranks[k - 1], group),
                    dist.P2POp(dist.irecv, top, ranks[k - 1], group)]
        if k < n - 1:
            ops += [dist.P2POp(dist.isend, send_last, ranks[k + 1], group),
                    dist.P2POp(dist.irecv, bottom, ranks[k + 1], group)]
        with metrics.timer("mesh_halo_exchange", items=2 * first.numel()):
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        top = first if top is None else top.to(first.device)
        bottom = last if bottom is None else bottom.to(last.device)
        return top, bottom


def batch_sharding(mesh: DeviceMesh) -> Sharding:
    """Leading-axis batch sharding over the data axis."""
    return Sharding(mesh, DATA_AXIS)


def stripe_sharding(mesh: DeviceMesh) -> Sharding:
    """Leading-axis (block-row) sharding over the stripe axis."""
    return Sharding(mesh, STRIPE_AXIS)


def replicated(mesh: DeviceMesh) -> Sharding:
    return Sharding(mesh, None)
