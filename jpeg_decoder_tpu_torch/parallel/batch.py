"""Same-geometry batch serving on a torch device, or on the ranks of a
mesh (counterpart of jpeg_decoder_tpu/parallel/batch.py).

The serving shape: many JPEGs per step.
  NATIVE (and the other host backends): host threads run the native
    entropy decode concurrently (the ctypes call releases the GIL) into
    pooled planes, which stack into [B, by, bx, 64] and go to the device in
    one copy per component.
  PALLAS: the streams are parsed on the host, and the restart segments of
    every batchable member decode on the device in one K2 launch per group
    (ops/entropy_cuda.entropy_decode_batch), straight into the stacked
    batch tensor of each component. A member K2 does not take
    (progressive, restart-free over 256 MCUs, oversized segments) takes the
    native host decode, and its planes are copied into its slice.
  DEVICE: one image at a time, as the JAX class takes it: parse, then the
    DEVICE route (ops/entropy_device.py: K2u and K2 per scan) into the
    image's own zeroed planes on the device, stacked for the pixel stage.
Then one PixelStage call over the stacked planes, RGB alone: one K03
(EXACT) or K13 (FLOAT32) launch for a 3-component nearest-neighbour batch
(ops/pixel.py), else one K0 (EXACT), K1 (FLOAT32) or K5 (scale < 8) launch
per component and one K3 or K3f launch (models/decoder.PixelStage);
and one device-to-host copy of [B, h, w, 3]. As the JAX class, it takes
every config and never reads `use_device`: the pixel stage runs on the
device.

With a mesh (parallel/mesh.make_mesh), decode_batch, decode_stream and
decode_many are SPMD: every rank passes the same list. The batch is padded
to a multiple of the "data" axis's ranks with copies of its last stream
(the JAX batch's padding, batch.py:178-184), and each rank of the axis runs
the host stage and the pixel stage of its slice alone (the ranks of one
data slice along "stripe" compute the same slice, as JAX's P("data") is
replicated over "stripe"). The slices' RGB is gathered over the axis
(all_gather_into_tensor) and cropped: every rank returns the whole batch,
where the JAX class returns one global array. A slice that fails (a
JpegError) or differs in geometry fails every rank alike, after a small
exchange of each slice's status, rather than leaving the others waiting in
the gather.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import hashlib
import itertools
import os

import numpy as np
import torch

from ..io.parser import parse
from ..utils.config import DecodeConfig, EntropyBackend
from ..utils.errors import JpegError, JpegFormatError
from ..utils.metrics import GLOBAL_METRICS as metrics
from ..utils.metrics import span

from .. import convert
from ..models import decoder as decoder_mod
from ..models import host
from ..ops import entropy_cuda
from . import mesh as mesh_mod


@dataclasses.dataclass(frozen=True, eq=False)
class StackedPlanes:
    """One member's coefficient planes: slot `index` of its batch's stacked
    device tensors (one int16 [n, by, bx, 64] per component)."""

    stacks: tuple
    index: int

    @property
    def planes(self) -> list[torch.Tensor]:
        return [s[self.index] for s in self.stacks]


class BatchDecoder:
    """Same-geometry batch decoder on `device`: one pixel stage per
    (geometry, tables, config), batches streamed through it; with `mesh`,
    each rank of its "data" axis takes a slice of every batch."""

    def __init__(self, cfg: DecodeConfig | None = None, device="cuda", mesh=None):
        self.cfg = cfg or DecodeConfig()
        self.device = convert.resolve_device(device)
        self.mesh = mesh
        self._data = None if mesh is None else mesh_mod.batch_sharding(mesh)
        self._pool = host.PlanePool()

    @property
    def _n_data(self) -> int:
        return 1 if self._data is None else self._data.size

    def _workers(self) -> int:
        return self.cfg.num_threads or os.cpu_count() or 1

    def _host_many(self, datas):
        """Host stage for a batch of raw streams: (frame, planes, qts)
        triples. NATIVE: the fused host path per image, images across host
        threads, planes from the pool. PALLAS: parse, then the device
        entropy decode of the whole batch (planes are StackedPlanes).
        DEVICE: host_decode per image in this thread (so that its launches
        stay on this thread's stream), planes a list of device tensors."""
        workers = self._workers()
        if self.cfg.entropy_backend == EntropyBackend.PALLAS:
            with span("batch_parse", self.cfg.collect_metrics, items=len(datas)):
                structures = [parse(d, self.cfg) for d in datas]
            results = self._entropy_many_pallas(structures, workers)
            return [(s.frame, p, q) for s, (p, q) in zip(structures, results)]
        if self.cfg.entropy_backend == EntropyBackend.DEVICE:
            with metrics.timer("entropy_device_batch", items=len(datas)):
                return [host.host_decode(d, self.cfg, device=self.device) for d in datas]

        def one(d):
            return host.host_decode(d, self.cfg, self._pool)

        with metrics.timer("entropy_batch", items=len(datas)):
            if workers == 1 or len(datas) == 1:
                return [one(d) for d in datas]
            with cf.ThreadPoolExecutor(max_workers=workers) as pool:
                return list(pool.map(one, datas))

    def _entropy_many_pallas(self, structures, workers):
        """Device-resident entropy for the whole batch: zeroed stacked
        planes per frame geometry, one K2 launch per group for the
        batchable members, and the native host decode, copied into its
        slice, for each member K2 does not take -- per member, not by
        failing the batch."""
        on = self.cfg.collect_metrics
        slots: list = [None] * len(structures)
        by_frame: dict = {}
        for i, s in enumerate(structures):
            by_frame.setdefault(s.frame, []).append(i)
        for frame, idxs in by_frame.items():
            stacks = tuple(
                torch.zeros((len(idxs), c.blocks_y, c.blocks_x, 64),
                            dtype=torch.int16, device=self.device)
                for c in frame.components
            )
            for j, i in enumerate(idxs):
                slots[i] = StackedPlanes(stacks, j)

        results: list = [None] * len(structures)
        batch_idx = [i for i, s in enumerate(structures) if entropy_cuda.batchable(s)]
        if batch_idx:
            with span("entropy_pallas_batch", on, items=len(batch_idx)):
                outs = entropy_cuda.entropy_decode_batch(
                    [structures[i] for i in batch_idx], self.cfg,
                    [slots[i].planes for i in batch_idx],
                )
            for i, (_planes, qts) in zip(batch_idx, outs):
                results[i] = (slots[i], qts)
        rest = [i for i in range(len(structures)) if results[i] is None]
        if rest:
            host_cfg = dataclasses.replace(
                self.cfg, entropy_backend=EntropyBackend.NATIVE)

            def one(i):
                s = structures[i]
                return i, host._entropy_decode(s, host_cfg, self._pool.acquire(s))

            with span("entropy_batch_fallback", on, items=len(rest)):
                if workers == 1 or len(rest) == 1:
                    done = [one(i) for i in rest]
                else:
                    with cf.ThreadPoolExecutor(max_workers=workers) as pool:
                        done = list(pool.map(one, rest))
            with span("fallback_copy", on, items=len(rest)):
                for i, (planes, qts) in done:
                    for dst, src in zip(slots[i].planes, planes.planes):
                        dst.copy_(torch.from_numpy(src))
                    self._pool.release(planes)
                    results[i] = (slots[i], qts)
        return results

    def _host_share(self, datas):
        """The host stage of this rank's share of a batch: all of it
        without a mesh; with one, its slice of the batch padded to a
        multiple of the data axis with copies of the last stream. Under a
        mesh a JpegError is returned, to be raised on every rank alike."""
        if self._data is None:
            return self._host_many(datas)
        padded = list(datas) + [datas[-1]] * ((-len(datas)) % self._n_data)
        try:
            return self._host_many(self._data.local(padded))
        except JpegError as e:
            return e

    def _host_share_on(self, stream, datas):
        """_host_share with its device work on `stream` (the consumer's):
        K2 launches from the prefetch thread stay ordered with the pixel
        stage of the batch before."""
        with torch.cuda.stream(stream):
            return self._host_share(datas)

    def decode_batch(self, datas: list[bytes]) -> np.ndarray:
        """Decode a batch of SAME-GEOMETRY JPEGs -> [B, H, W, 3] uint8."""
        if not datas:
            return np.zeros((0, 0, 0, 3), dtype=np.uint8)
        return self._device_batch(self._host_share(datas), len(datas))

    def decode_stream(self, datas, batch_size: int | None = None):
        """Pipelined streaming decode: yields [B, H, W, 3] arrays per batch.

        While the device runs batch k, a worker thread runs the host stage
        of batch k+1 (parse and entropy, and under PALLAS its K2 launches,
        on the consumer's CUDA stream). Same-geometry inputs assumed (use
        decode_many for mixed). The default batch is two images a rank of
        the data axis."""
        batch_size = batch_size or 2 * self._n_data
        it = iter(datas)
        stream = (torch.cuda.current_stream(self.device)
                  if self.device.type == "cuda" else None)
        with cf.ThreadPoolExecutor(max_workers=1) as prefetcher:
            pending = None
            while True:
                chunk = list(itertools.islice(it, batch_size))
                nxt = (prefetcher.submit(self._host_share_on, stream, chunk), len(chunk)) \
                    if chunk else None
                if pending is not None:
                    with span("batch_wait", self.cfg.collect_metrics, items=pending[1]):
                        results = pending[0].result()
                    yield self._device_batch(results, pending[1])
                pending = nxt
                if pending is None:
                    return

    def _device_batch(self, results, b: int) -> np.ndarray:
        """The device stage of this rank's host results, (frame, planes,
        qts) triples, then (with a mesh) the gather of every rank's slice:
        numpy [b, H, W, 3], the batch's b images."""
        if self._data is None:
            rgb = self._device_rgb(results)[0]
            with span("copy_out", self.cfg.collect_metrics):
                return rgb.cpu().numpy()
        err = results if isinstance(results, JpegError) else None
        rgb = key = None
        if err is None:
            try:
                rgb, key = self._device_rgb(results)
            except JpegError as e:
                err = e
        # every rank learns whether every slice decoded, and to one
        # geometry, before the gather
        digest = 0 if key is None else int.from_bytes(
            hashlib.sha256(repr(key).encode()).digest()[:7], "little")
        shape = [0] * 4 if rgb is None else list(rgb.shape)
        status = self._data.gather(torch.tensor([[err is None, digest, *shape]],
                                                dtype=torch.int64, device=self.device))
        if not bool(status[:, 0].all()):
            raise err or JpegError("another rank of the mesh failed its slice of the batch")
        if bool((status[:, 1:] != status[:1, 1:]).any()):
            raise JpegFormatError("decode_stream needs identical geometry/tables across inputs")
        return self._data.gather(rgb)[:b].cpu().numpy()

    def _device_rgb(self, results):
        """The pixel stage over pre-run host results: (the RGB [n, H, W, 3]
        on the device, the stage key)."""
        on = self.cfg.collect_metrics
        with span("stage_lookup", on):
            keys = set()
            for frame, _planes, qts in results:
                for c in frame.components:
                    if c.qtid not in qts:
                        raise JpegFormatError(
                            f"component {c.id} references undefined quant table {c.qtid}")
                keys.add(decoder_mod._stage_key(
                    frame, decoder_mod.qt_by_comp_bytes(frame, qts), self.cfg))
            if len(keys) != 1:
                raise JpegFormatError(
                    "decode_stream needs identical geometry/tables across inputs")
            frame, first, qts = results[0]
            stage = decoder_mod.device_stage_for(frame, qts, self.cfg, self.device)
        with span("device_batch", on, items=len(results)):
            if isinstance(first, StackedPlanes):
                # K2 (and the fallback copies) wrote every member in place:
                # one key means one frame, so one stack, in member order
                coeffs = list(first.stacks)
            elif isinstance(first, list):
                # the DEVICE route's planes, already on the device
                coeffs = [torch.stack([p[ci] for _f, p, _q in results])
                          for ci in range(frame.ncs)]
            else:
                coeffs = [
                    torch.from_numpy(np.stack([p.plane(ci) for _f, p, _q in results]))
                    .to(self.device)
                    for ci in range(frame.ncs)
                ]
                # np.stack copied the coefficients: the pooled planes can
                # serve the next batch.
                for _frame, planes, _qts in results:
                    self._pool.release(planes)
            rgb, _ = stage(*coeffs, want_planes=False)
            return rgb, keys.pop()

    def decode_many(self, datas: list[bytes]) -> list[np.ndarray]:
        """Decode a mixed batch: groups by geometry and per-scan header,
        restart interval and quant-table content, one batch per group;
        returns per-input RGB arrays in input order."""
        structures = [parse(d, self.cfg) for d in datas]
        order: dict = {}
        for i, s in enumerate(structures):
            key = (
                s.frame,
                tuple(
                    (
                        sc.header,
                        sc.restart_interval,
                        tuple((tid, qt.values.tobytes())
                              for tid, qt in sorted(sc.quant_tables.items())),
                    )
                    for sc in s.scans
                ),
            )
            order.setdefault(key, []).append(i)
        out: list = [None] * len(datas)
        for idxs in order.values():
            rgbs = self._device_batch(self._host_share([datas[i] for i in idxs]), len(idxs))
            for j, i in enumerate(idxs):
                out[i] = rgbs[j]
        return out


def decode_batch(datas: list[bytes], cfg: DecodeConfig | None = None,
                 device="cuda", mesh=None) -> np.ndarray:
    return BatchDecoder(cfg, device, mesh).decode_batch(datas)
