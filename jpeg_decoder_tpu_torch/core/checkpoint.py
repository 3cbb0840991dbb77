"""Checkpoint / resume of the coefficient-plane IR (counterpart of
jpeg_decoder_tpu/core/checkpoint.py).

The reference has no checkpointing; its one resumable structure is the
progressive coefficient Buffer that persists across scans
(reference/src/decode.c:20-25, 67-93). This module makes that IR
explicitly durable: a scan-granular decoder that can snapshot its
coefficient planes plus progress metadata after any scan and resume in a
new process, sized for huge progressive files and long multi-scan batch
jobs.

Format: a single .npz holding every component plane, the scans-done cursor,
frame geometry, and the quant tables seen so far. Integrity is guarded by a
content digest so a truncated/foreign file fails loudly instead of decoding
garbage (the reference's failure mode is a silent exit(1), decode.c:861).
The format and digest are the JAX package's, so a file written by either
package restores in the other.

`ScanDecoder.finish` runs the port's pixel stage (models/decoder.PixelStage:
the card's kernels for a CUDA device, their plain versions for "cpu") on the
accumulated planes. With `use_device=False` it runs the NumPy oracle's EXACT
IDCT and nearest-neighbour colour conversion at full size whatever the
config's upsampling and scale, as the JAX package's finish does
(ROADMAP.md §3).
"""

from __future__ import annotations

import hashlib
import json
import zipfile
import zlib
from pathlib import Path

import numpy as np

from ..io.markers import Encoding
from ..utils.config import DecodeConfig
from ..utils.errors import JpegError, JpegFormatError
from .types import CoefficientPlanes, Component, DecodedImage, FrameHeader, JpegStructure

_FORMAT_VERSION = 1


def _frame_meta(frame: FrameHeader) -> dict:
    return {
        "process": frame.process.value,
        "precision": frame.precision,
        "width": frame.width,
        "height": frame.height,
        "components": [
            [c.id, c.hsf, c.vsf, c.qtid, c.x, c.y] for c in frame.components
        ],
    }


def _frame_from_meta(meta: dict) -> FrameHeader:
    comps = tuple(
        Component(id=c[0], hsf=c[1], vsf=c[2], qtid=c[3], x=c[4], y=c[5])
        for c in meta["components"]
    )
    return FrameHeader(
        process=Encoding(meta["process"]),
        precision=meta["precision"],
        width=meta["width"],
        height=meta["height"],
        components=comps,
    )


def save_checkpoint(
    path: str | Path,
    frame: FrameHeader,
    planes: CoefficientPlanes,
    scans_done: int,
    qts: dict[int, np.ndarray],
) -> None:
    meta = {
        "version": _FORMAT_VERSION,
        "frame": _frame_meta(frame),
        "scans_done": scans_done,
        "qt_ids": sorted(qts),
    }
    arrays = {
        f"plane_{i}": planes.plane(i) for i in range(frame.ncs)
    }
    for tid in qts:
        arrays[f"qt_{tid}"] = np.asarray(qts[tid], dtype=np.uint16)
    digest = hashlib.sha256()
    digest.update(json.dumps(meta, sort_keys=True).encode())  # metadata too
    for k in sorted(arrays):
        digest.update(k.encode())
        digest.update(np.ascontiguousarray(arrays[k]).tobytes())
    meta["digest"] = digest.hexdigest()
    np.savez_compressed(
        path, __meta__=np.frombuffer(json.dumps(meta).encode(), np.uint8),
        **arrays,
    )


def load_checkpoint(path: str | Path):
    """Returns (frame, planes, scans_done, qts). Raises JpegFormatError on
    corruption (a damaged archive too, which the JAX package lets NumPy's
    or zipfile's own errors report) or version mismatch."""
    try:
        return _load_checkpoint(path)
    except (OSError, EOFError, KeyError, ValueError, zipfile.BadZipFile, zlib.error) as e:
        raise JpegFormatError(f"unreadable checkpoint {path}: {e}") from e


def _load_checkpoint(path: str | Path):
    with np.load(path) as z:
        try:
            meta = json.loads(bytes(z["__meta__"]).decode())
        except Exception as e:
            raise JpegFormatError(f"unreadable checkpoint metadata: {e}")
        if meta.get("version") != _FORMAT_VERSION:
            raise JpegFormatError(
                f"checkpoint version {meta.get('version')} unsupported"
            )
        frame = _frame_from_meta(meta["frame"])
        planes = CoefficientPlanes(frame)
        arrays = {}
        for i in range(frame.ncs):
            arrays[f"plane_{i}"] = z[f"plane_{i}"]
        qts = {}
        for tid in meta["qt_ids"]:
            arrays[f"qt_{tid}"] = qts.setdefault(
                tid, z[f"qt_{tid}"]
            )
        digest = hashlib.sha256()
        meta_core = {k: v for k, v in meta.items() if k != "digest"}
        digest.update(json.dumps(meta_core, sort_keys=True).encode())
        for k in sorted(arrays):
            digest.update(k.encode())
            digest.update(np.ascontiguousarray(arrays[k]).tobytes())
        if digest.hexdigest() != meta["digest"]:
            raise JpegFormatError("checkpoint digest mismatch (corrupt file)")
        for i in range(frame.ncs):
            p = planes.plane(i)
            if arrays[f"plane_{i}"].shape != p.shape:
                raise JpegFormatError("checkpoint plane shape mismatch")
            p[...] = arrays[f"plane_{i}"]
    return frame, planes, meta["scans_done"], qts


class ScanDecoder:
    """Scan-granular decoder with checkpoint/resume.

    step() decodes one scan into the persistent coefficient planes (on the
    host); checkpoint()/restore() snapshot and revive the IR between scans;
    finish() runs the pixel stage on `device` on whatever has been
    accumulated (a partially-decoded progressive image renders at reduced
    quality: exactly the progressive use case). `device` defaults to the
    card; "cpu" runs the kernels' plain versions.
    """

    def __init__(self, structure: JpegStructure, cfg: DecodeConfig | None = None,
                 device="cuda"):
        from .. import convert

        self.structure = structure
        self.cfg = cfg or DecodeConfig()
        self.device = convert.resolve_device(device)
        self.planes = CoefficientPlanes(structure.frame)
        self.qts: dict[int, np.ndarray] = {}
        self.scans_done = 0

    @property
    def total_scans(self) -> int:
        return len(self.structure.scans)

    @property
    def finished(self) -> bool:
        return self.scans_done >= self.total_scans

    def step(self) -> int:
        """Decode the next scan; returns its index."""
        if self.finished:
            raise JpegError("all scans already decoded")
        from . import entropy_np, oracle

        scan = self.structure.scans[self.scans_done]
        for tid, qt in scan.quant_tables.items():
            self.qts[tid] = qt.values
        is_prog = self.structure.frame.process == Encoding.PROGRESSIVE_DCT
        # The shared scan loop with the LUT reader: this path is
        # correctness-critical, not hot.
        decode_scan = (oracle.decode_progressive_scan if is_prog
                       else oracle.decode_sequential_scan)
        decode_scan(self.structure, scan, self.planes,
                    reader_cls=entropy_np.bsio.FastBitReader,
                    make_table=entropy_np._lut_table)
        idx = self.scans_done
        self.scans_done += 1
        return idx

    def checkpoint(self, path: str | Path) -> None:
        save_checkpoint(
            path, self.structure.frame, self.planes, self.scans_done, self.qts
        )

    @classmethod
    def restore(
        cls,
        path: str | Path,
        structure: JpegStructure,
        cfg: DecodeConfig | None = None,
        device="cuda",
    ) -> "ScanDecoder":
        frame, planes, scans_done, qts = load_checkpoint(path)
        if frame != structure.frame:
            raise JpegFormatError(
                "checkpoint geometry does not match the provided stream"
            )
        self = cls(structure, cfg, device)
        self.planes = planes
        self.scans_done = scans_done
        self.qts = qts
        return self

    def finish(self) -> DecodedImage:
        """The pixel stage on the accumulated coefficients: RGB and pixel
        planes on the host."""
        frame = self.structure.frame
        if not self.cfg.use_device:
            from . import oracle

            pixel_planes = oracle.pixels_from_coeffs(frame, self.planes, self.qts)
            rgb = oracle.color_convert(frame, pixel_planes, self.cfg.quirks)
            return DecodedImage(frame=frame, planes=pixel_planes, rgb=rgb)
        from .. import convert
        from ..models import decoder as decoder_mod

        stage = decoder_mod.device_stage_for(frame, self.qts, self.cfg, self.device)
        rgb_dev, planes_dev = stage(*convert.planes_to_device(self.planes, self.device),
                                    want_planes=True)
        rgb = rgb_dev.cpu().numpy()
        host_planes = [p.cpu().numpy() for p in planes_dev]
        return DecodedImage(frame=frame, planes=host_planes, rgb=rgb)
