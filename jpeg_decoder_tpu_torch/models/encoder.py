"""The encode pipeline on a torch device (counterpart of
jpeg_decoder_tpu/models/encoder.py):

  device:  colour -> edge pad -> box subsample -> level shift -> FDCT +
           quantize, every component in one step (ops/fdct.encode_planes;
           kernel K4 on the card, the plain version on the CPU)
  host:    MCU-interleaved run/size Huffman pack, optional restart markers,
           optional two-pass optimized tables (the port's native C++,
           native/runtime.encode_scan_planes / count_scan_planes, or
           core/entropy_encode)
  host:    marker emission (io/writer.py)

The coefficient planes come back to the host in one copy per image, into a
pinned buffer on the card's path. `encode_stream` queues image k+1's upload,
K4 launch and copy back before it packs image k, so the card computes while
the host packs.
"""

from __future__ import annotations

import collections
import dataclasses
import functools

import numpy as np
import torch
from torch import nn

from ..core import entropy_encode, huffman
from ..core.types import standard_chrominance_qtable, standard_luminance_qtable
from ..io import writer
from ..native import runtime as native_runtime
from ..ops import fdct as fdct_ops
from ..utils.config import EncodeConfig
from ..utils.errors import JpegConfigError
from ..utils.metrics import GLOBAL_METRICS as metrics

from .. import convert

_SAMPLING = {
    "444": ((1, 1), (1, 1), (1, 1)),
    "422": ((2, 1), (1, 1), (1, 1)),
    "420": ((2, 2), (1, 1), (1, 1)),
    # Exotic-but-legal factors (T.81 A.1.1 allows any h,v in 1..4); Pillow
    # cannot write them, so the in-repo writer is the corpus source.
    "411": ((4, 1), (1, 1), (1, 1)),
    "440": ((1, 2), (1, 1), (1, 1)),
    # Mixed chroma factors: Cb at (2,1), Cr at (1,2) under a (2,2) luma.
    "mixed": ((2, 2), (2, 1), (1, 2)),
}

#: Uses of the Python packer after the native call raised ("pack", "count"),
#: so that a run on the card can show it took none.
FALLBACKS: collections.Counter = collections.Counter()


def quality_qtables(quality: int) -> tuple[np.ndarray, np.ndarray]:
    """IJG quality scaling of the Annex K tables (natural order)."""
    if quality < 50:
        scale = 5000 // quality
    else:
        scale = 200 - 2 * quality
    out = []
    for base in (standard_luminance_qtable(), standard_chrominance_qtable()):
        t = (base.astype(np.int64) * scale + 50) // 100
        out.append(np.clip(t, 1, 255).astype(np.uint16))
    return out[0], out[1]


class EncodeStage(nn.Module):
    """uint8 image -> per-component int16 [by, bx, 64] zigzag quantized
    coefficient planes, for one (h, w, sampling, tables, gray) key: the
    counterpart of _build_device_stage. Holds the folded FDCT tables
    (ops/fdct.fdct_tables) on its device; forward returns the planes as
    views of one flat int16 tensor, (flat, planes)."""

    def __init__(self, h: int, w: int, subsampling: str, qt_bytes: tuple[bytes, ...],
                 gray: bool, device):
        super().__init__()
        self.factors = ((1, 1),) if gray else _SAMPLING[subsampling]
        self.mcus_x, self.mcus_y, comps = fdct_ops.plane_layout(h, w, self.factors)
        self.shapes = [(by, bx, 64) for by, bx, _, _ in comps]
        self.size = sum(by * bx * 64 for by, bx, _ in self.shapes)
        qts = [np.frombuffer(q, dtype=np.uint16) for q in qt_bytes[: 1 if gray else 2]]
        self.register_buffer("kq", fdct_ops.fdct_tables(qts, device))

    def forward(self, img: torch.Tensor):
        flat = torch.empty(self.size, dtype=torch.int16, device=img.device)
        return flat, fdct_ops.encode_planes(img, self.factors, self.kq, flat)

    def split(self, flat: np.ndarray) -> list[np.ndarray]:
        """The per-component planes of a host copy of `flat` (views)."""
        out, at = [], 0
        for shape in self.shapes:
            n = int(np.prod(shape))
            out.append(flat[at : at + n].reshape(shape))
            at += n
        return out


@functools.lru_cache(maxsize=64)
def _build_encode_stage(h: int, w: int, subsampling: str, qt_bytes: tuple[bytes, ...],
                        gray: bool, device: torch.device) -> EncodeStage:
    return EncodeStage(h, w, subsampling, qt_bytes, gray, device)


def _unit_layout(factors, n_tables: int) -> tuple[np.ndarray, list[int]]:
    """Per-unit-in-MCU descriptor rows for the plane-direct native packer:
    [units_per_mcu, 8] int32 (comp, fh, fv, j, k, sci, dc_table, ac_table),
    in spec A.2.3 unit order. Returns (unit_params, unit_sci)."""
    rows, unit_sci = [], []
    for ci, (fh, fv) in enumerate(factors):
        t = 0 if ci == 0 else n_tables - 1
        for j in range(fv):
            for k in range(fh):
                rows.append((ci, fh, fv, j, k, ci, t, t))
                unit_sci.append(ci)
    return np.asarray(rows, dtype=np.int32), unit_sci


def _mcu_order(coeffs: list[np.ndarray], factors, mcus_x: int, mcus_y: int):
    """Flatten per-component [by, bx, 64] planes into MCU-interleaved unit
    order (spec A.2.3); returns (blocks [n_units_total, 64], per-unit
    scan-component indices within one MCU, units_per_mcu)."""
    per_comp = []
    unit_sci = []
    for ci, (fh, fv) in enumerate(factors):
        r = (
            coeffs[ci].reshape(mcus_y, fv, mcus_x, fh, 64)
            .transpose(0, 2, 1, 3, 4)
            .reshape(mcus_y * mcus_x, fv * fh, 64)
        )
        per_comp.append(r)
        unit_sci += [ci] * (fv * fh)
    interleaved = np.concatenate(per_comp, axis=1)  # (mcu, units, 64)
    units_per_mcu = interleaved.shape[1]
    return interleaved.reshape(-1, 64), unit_sci, units_per_mcu


@dataclasses.dataclass
class _Pending:
    """One image between its dispatch and its pack: the stage, the host
    buffer its planes land in, and the event that marks their arrival
    (None on the CPU)."""

    h: int
    w: int
    gray: bool
    stage: EncodeStage
    host: torch.Tensor
    ready: torch.cuda.Event | None


class JpegEncoder:
    """Reusable encoder handle: holds config and device, and shares the
    cached device stage across calls (same-shape images reuse one)."""

    def __init__(self, cfg: EncodeConfig | None = None, device="cuda"):
        self.cfg = cfg or EncodeConfig()
        self.device = convert.resolve_device(device)

    @staticmethod
    def _fallback_order(coeffs, factors, mcus_x, mcus_y, n_tables):
        """Materialized MCU-interleaved layout for the Python packer."""
        blocks, unit_sci, units_per_mcu = _mcu_order(coeffs, factors, mcus_x, mcus_y)
        table_of_unit = [
            (0, 0) if sci == 0 else (n_tables - 1, n_tables - 1) for sci in unit_sci
        ]
        mcu_blocks = [
            (unit_sci[i % units_per_mcu], blocks[i]) for i in range(blocks.shape[0])
        ]
        return mcu_blocks, table_of_unit, units_per_mcu

    @classmethod
    def _pack(cls, coeffs, factors, mcus_x, mcus_y, dc_tables, ac_tables, n_tables, cfg):
        """Entropy pack: plane-direct native C++, with the byte-identical
        Python packer as a fallback that FALLBACKS counts."""
        if native_runtime.available():
            unit_params, _ = _unit_layout(factors, n_tables)
            try:
                return native_runtime.encode_scan_planes(
                    coeffs, mcus_x, mcus_x * mcus_y, unit_params,
                    dc_tables, ac_tables, cfg.restart_interval,
                )
            except (RuntimeError, ValueError):
                pass  # fall through to the Python packer
        FALLBACKS["pack"] += 1
        mcu_blocks, table_of_unit, units_per_mcu = cls._fallback_order(
            coeffs, factors, mcus_x, mcus_y, n_tables
        )
        return entropy_encode.encode_blocks(
            mcu_blocks, dc_tables, ac_tables, table_of_unit,
            units_per_mcu, cfg.restart_interval,
        )

    @classmethod
    def _count(cls, coeffs, factors, mcus_x, mcus_y, n_tables, cfg):
        """Symbol-frequency pass for two-pass optimized tables: native
        plane-direct count, with the Python walk as a counted fallback."""
        if native_runtime.available():
            unit_params, _ = _unit_layout(factors, n_tables)
            try:
                return native_runtime.count_scan_planes(
                    coeffs, mcus_x, mcus_x * mcus_y, unit_params,
                    n_tables, n_tables, cfg.restart_interval,
                )
            except (RuntimeError, ValueError):
                pass
        FALLBACKS["count"] += 1
        mcu_blocks, table_of_unit, units_per_mcu = cls._fallback_order(
            coeffs, factors, mcus_x, mcus_y, n_tables
        )
        return entropy_encode.count_symbols(
            mcu_blocks, n_tables, n_tables, table_of_unit,
            units_per_mcu, cfg.restart_interval,
        )

    def _huffman_specs(self, cfg, coeffs, factors, mcus_x, mcus_y, gray):
        n_tables = 1 if gray else 2
        if cfg.huffman == "optimized":
            freq_dc, freq_ac = self._count(coeffs, factors, mcus_x, mcus_y, n_tables, cfg)
            dc_specs = [
                dataclasses.replace(huffman.optimal_code_lengths(freq_dc[t]),
                                    table_class=0, table_id=t)
                for t in range(n_tables)
            ]
            ac_specs = [
                dataclasses.replace(huffman.optimal_code_lengths(freq_ac[t]),
                                    table_class=1, table_id=t)
                for t in range(n_tables)
            ]
        else:
            dc_specs = [huffman.annex_k_dc_luminance()]
            ac_specs = [huffman.annex_k_ac_luminance()]
            if not gray:
                dc_specs.append(huffman.annex_k_dc_chrominance())
                ac_specs.append(huffman.annex_k_ac_chrominance())
        return dc_specs, ac_specs

    @staticmethod
    def _geometry(img, cfg):
        """Validate the input array; returns (h, w, gray)."""
        gray = cfg.subsampling == "gray" or img.ndim == 2
        if img.ndim == 2:
            h, w = img.shape
        elif img.ndim == 3 and img.shape[2] == 3:
            h, w = img.shape[:2]
        else:
            raise JpegConfigError(f"expected [H,W] gray or [H,W,3] RGB, got {img.shape}")
        if img.dtype != np.uint8:
            raise JpegConfigError("input must be uint8")
        return h, w, gray

    def _assemble_baseline(self, cfg, h, w, gray, coeffs, factors, mcus_x, mcus_y,
                           qts) -> bytes:
        """Tables + entropy pack + marker assembly (spec B.2) for a
        baseline (SOF0) frame from fetched coefficient planes."""
        qt_l, qt_c = qts
        n_tables = 1 if gray else 2
        dc_specs, ac_specs = self._huffman_specs(cfg, coeffs, factors, mcus_x, mcus_y, gray)
        dc_tables = [huffman.build_encode_table(s) for s in dc_specs]
        ac_tables = [huffman.build_encode_table(s) for s in ac_specs]
        entropy = self._pack(coeffs, factors, mcus_x, mcus_y, dc_tables, ac_tables,
                             n_tables, cfg)

        parts = [writer.soi(), writer.app0_jfif(), writer.dqt(0, qt_l)]
        if not gray:
            parts.append(writer.dqt(1, qt_c))
        if gray:
            sof_comps = [(1, 1, 1, 0)]
            sos_comps = [(1, 0, 0)]
        else:
            sof_comps = [(ci + 1, fh, fv, 0 if ci == 0 else 1)
                         for ci, (fh, fv) in enumerate(factors)]
            sos_comps = [(1, 0, 0)] + [(ci + 1, n_tables - 1, n_tables - 1) for ci in (1, 2)]
        parts.append(writer.sof(w, h, sof_comps))
        for s in dc_specs + ac_specs:
            parts.append(writer.dht(s))
        if cfg.restart_interval:
            parts.append(writer.dri(cfg.restart_interval))
        parts.append(writer.sos(sos_comps))
        parts.append(entropy)
        parts.append(writer.eoi())
        return b"".join(parts)

    def _assemble_progressive(self, cfg, h, w, gray, coeffs, factors, qts) -> bytes:
        """Progressive (SOF2) assembly: one interleaved DC scan, then a
        full-band (ss=1..63) AC scan per component (spec G.2), with
        two-pass optimized tables (EOBn symbols are absent from Annex K)."""
        ee = entropy_encode
        qt_l, qt_c = qts
        hmax = max(f[0] for f in factors)
        vmax = max(f[1] for f in factors)
        mcus_x = -(-w // (8 * hmax))
        mcus_y = -(-h // (8 * vmax))
        ncs = 1 if gray else 3
        n_tables = 1 if gray else 2

        # MCU-ordered DC stream + per-unit metadata for the interleaved DC scan.
        blocks, unit_sci, _ = _mcu_order(coeffs, factors, mcus_x, mcus_y)
        dcs = blocks[:, 0]
        dc_table_of_unit = [0 if sci == 0 else n_tables - 1 for sci in unit_sci]

        # Per-component non-interleaved AC block sequences (raster over the
        # component's own ceil(x/8) x ceil(y/8) grid, not the MCU-padded grid).
        ac_seqs = []
        for ci, (fh, fv) in enumerate(factors):
            cx = -(-w * fh // hmax)
            cy = -(-h * fv // vmax)
            pad_x, pad_y = -(-cx // 8), -(-cy // 8)
            ac_seqs.append(coeffs[ci][:pad_y, :pad_x].reshape(-1, 64))

        freq_dc = [np.zeros(256, dtype=np.int64) for _ in range(n_tables)]
        freq_ac = [np.zeros(256, dtype=np.int64) for _ in range(n_tables)]
        ee.encode_dc_scan(dcs, unit_sci, dc_table_of_unit, None, freq=freq_dc)
        for ci in range(ncs):
            t = 0 if ci == 0 else n_tables - 1
            ee.encode_ac_scan(ac_seqs[ci], 1, 63, None, freq=freq_ac[t])

        def spec_of(freq, table_class, table_id):
            s = huffman.optimal_code_lengths(freq)
            return dataclasses.replace(s, table_class=table_class, table_id=table_id)

        dc_specs = [spec_of(freq_dc[t], 0, t) for t in range(n_tables)]
        ac_specs = [spec_of(freq_ac[t], 1, t) for t in range(n_tables)]
        dc_tables = [huffman.build_encode_table(s) for s in dc_specs]
        ac_tables = [huffman.build_encode_table(s) for s in ac_specs]

        dc_entropy = ee.encode_dc_scan(dcs, unit_sci, dc_table_of_unit, dc_tables)
        ac_entropy = [
            ee.encode_ac_scan(ac_seqs[ci], 1, 63, ac_tables[0 if ci == 0 else n_tables - 1])
            for ci in range(ncs)
        ]

        parts = [writer.soi(), writer.app0_jfif(), writer.dqt(0, qt_l)]
        if not gray:
            parts.append(writer.dqt(1, qt_c))
        if gray:
            sof_comps = [(1, 1, 1, 0)]
            dc_sos = [(1, 0, 0)]
        else:
            sof_comps = [(ci + 1, fh, fv, 0 if ci == 0 else 1)
                         for ci, (fh, fv) in enumerate(factors)]
            dc_sos = [(1, 0, 0), (2, n_tables - 1, 0), (3, n_tables - 1, 0)]
        parts.append(writer.sof(w, h, sof_comps, marker=0xC2))
        for s in dc_specs + ac_specs:
            parts.append(writer.dht(s))
        parts.append(writer.sos(dc_sos, ss=0, se=0))
        parts.append(dc_entropy)
        for ci in range(ncs):
            t = 0 if ci == 0 else n_tables - 1
            parts.append(writer.sos([(ci + 1, 0, t)], ss=1, se=63))
            parts.append(ac_entropy[ci])
        parts.append(writer.eoi())
        return b"".join(parts)

    def _qts(self):
        qt_l, qt_c = quality_qtables(self.cfg.quality)
        return (qt_l, qt_c), (qt_l.tobytes(), qt_c.tobytes())

    def _dispatch(self, img, qt_bytes) -> _Pending:
        """Validate `img`, queue its upload, its device stage and the copy
        of its planes back, and return without waiting for the card."""
        img = np.asarray(img)
        h, w, gray = self._geometry(img, self.cfg)
        stage = _build_encode_stage(h, w, self.cfg.subsampling, qt_bytes, gray, self.device)
        src = torch.from_numpy(np.ascontiguousarray(img))
        with metrics.timer("encode_dispatch"):
            if self.device.type == "cpu":
                flat, _ = stage(src)
                return _Pending(h, w, gray, stage, flat, None)
            flat, _ = stage(src.to(self.device, non_blocking=True))
            host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
            host.copy_(flat, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record()
        return _Pending(h, w, gray, stage, host, ready)

    def _finish(self, p: _Pending, qts) -> bytes:
        """Wait for one image's planes alone, then pack and assemble it."""
        if p.ready is not None:
            with metrics.timer("encode_wait"):
                p.ready.synchronize()
        coeffs = p.stage.split(p.host.numpy())
        with metrics.timer("encode_assemble"):
            if self.cfg.progressive:
                return self._assemble_progressive(self.cfg, p.h, p.w, p.gray, coeffs,
                                                  p.stage.factors, qts)
            return self._assemble_baseline(self.cfg, p.h, p.w, p.gray, coeffs,
                                           p.stage.factors, p.stage.mcus_x, p.stage.mcus_y,
                                           qts)

    def encode(self, img: np.ndarray) -> bytes:
        qts, qt_bytes = self._qts()
        return self._finish(self._dispatch(img, qt_bytes), qts)

    def encode_stream(self, imgs):
        """Pipelined streaming encode: yields JPEG bytes per input image.

        Image k+1's upload, K4 launch and copy back are queued before the
        host packs image k, and the host waits on image k's event alone,
        so the card computes ahead while the host packs. Output bytes equal
        per-image encode() calls."""
        qts, qt_bytes = self._qts()
        pending = None
        for img in imgs:
            nxt = self._dispatch(img, qt_bytes)
            if pending is not None:
                yield self._finish(pending, qts)
            pending = nxt
        if pending is not None:
            yield self._finish(pending, qts)


def encode(img: np.ndarray, cfg: EncodeConfig | None = None, device="cuda") -> bytes:
    """Encode an RGB/grayscale uint8 array to JPEG bytes on `device`."""
    return JpegEncoder(cfg, device).encode(img)
