"""Streamed and striped decode of one large image on a torch device
(counterpart of jpeg_decoder_tpu/parallel/stripes.py).

The JAX package cuts one image's coefficient planes in stripes of MCU rows:
decode_striped runs every stripe's pixel stage under shard_map over the
mesh's stripe axis, decode_streamed one chunk at a time through one compiled
program, so that memory stays bounded. The port's decode_striped takes
either `n_stripes`, all stripes resident on one device, or a mesh
(parallel/mesh.py), one stripe a rank of its stripe axis:

  decode_striped, one device: block rows padded to a multiple of n_stripes
    with copies of the last block row go to the device, a stripe at a time,
    and StripeStage runs all stripes in one launch per kernel.
    Nearest-neighbour: K6n, which is K03
    (EXACT) or K13 (FLOAT32) for a 3-component frame whose PADDED geometry
    is tile-local, else K0 or K1 per component and K3 (K3c on four planes),
    each launched with the stripe rule. Fancy: K6f, K0 or K1 per component
    over the padded planes, then K3f under the striped rule: the
    triangular passes only where ops/color.fancy_ok holds, a stripe's halo
    row being its neighbour's edge row in the same padded plane.
  decode_striped over a mesh: rank k of the stripe axis decodes stripe k
    alone (StripeStage.stripe). Its entropy: the stripe's restart segments
    where the plan allows, else the whole image, sliced (on the device for
    PALLAS). Nearest-neighbour: K6n with the stripe's origin, no halo.
    Fancy: K0 or K1 on the stripe, then the edge rows of each component
    whose vertical pass needs them traded with the neighbouring ranks
    (Sharding.halo_exchange, batch_isend_irecv), then K6h, K3f with those
    halo rows. The stripes' RGB is gathered over the axis; every rank
    returns the whole image.
  decode_streamed: ChunkStage runs one chunk of MCU rows at a time (K6n),
    one chunk's int16 buffers reused on the host and uploaded once a chunk,
    and only the chunk's real rows copied back.

The stripe rule (ops/color.nn_rows, the kernels' colour::nn_row) runs the
reference's index rule on the padded frame's row and clamps the source into
the output row's stripe. The port reproduces the JAX program where it
differs from whole-image decode (ROADMAP.md §3): (1) under fancy
upsampling the vertical pass's neighbour below the plane's last real row is
the first row of the padding's copy of the last block row; (2) gray frames
take CORRECT addressing whatever the quirks (no width-stride shear); (3)
four components always take the YCCK transform, raw Adobe CMYK included;
(4) a component that fancy_ok refuses takes the nearest-neighbour rule at
its own ratios, where whole-image decode runs the passes it can first.

Host entropy runs stripe by stripe where the restart interval covers whole
MCU rows that do not straddle a stripe (NATIVE only, the gate of the JAX
package); otherwise the whole image is decoded first and split (the PALLAS
planes, born on the device, are sliced there).

CPU tensors run each stage's plain route, the JAX program stripe by stripe
(_stripe_nn_plain, _halo_exchange_rows, _fancy_upsample_v2x_striped over a
list of stripe planes); `plain=True` runs it on the card too, as the card
checks' yardstick.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch
from torch import nn

from ..core.numerics import _nn_index_f32
from ..core.types import FrameHeader
from ..io.parser import parse
from ..utils.config import DecodeConfig, EntropyBackend, IdctPrecision

from .. import convert
from ..models import decoder as decoder_mod
from ..models import host
from ..ops import color as color_ops
from ..ops import idct as idct_ops
from ..ops import pixel as pixel_ops
from . import mesh as mesh_mod

#: Output pixels a chunk aims at when decode_streamed picks n_chunks (the
#: JAX package's rule, stripes.py:427).
CHUNK_PIXELS = 32 << 20


def _halo_exchange_rows(xs: list[torch.Tensor]) -> list[torch.Tensor]:
    """Each stripe plane [rows, w] extended by a top and a bottom halo row:
    its neighbours' edge rows, the outer edges replicated (the JAX
    ppermute, stripes.py:56, over a list of resident stripes)."""
    n = len(xs)
    return [torch.cat([xs[i - 1][-1:] if i else x[:1], x,
                       xs[i + 1][:1] if i < n - 1 else x[-1:]]) for i, x in enumerate(xs)]


def _v2x_extended(ext: torch.Tensor) -> torch.Tensor:
    """The vertical 2x triangular pass of a float32 stripe plane between
    its halo rows (ext: [top; rows; bottom]): floats in, floats out,
    floored once later."""
    up, mid, down = ext[:-2], ext[1:-1], ext[2:]
    even = (3.0 * mid + up + 1.0) * 0.25
    odd = (3.0 * mid + down + 2.0) * 0.25
    return torch.stack([even, odd], dim=1).reshape(-1, mid.shape[1])


def _fancy_upsample_v2x_striped(xs: list[torch.Tensor]) -> list[torch.Tensor]:
    """The vertical pass of each float32 stripe plane with its halo rows
    (stripes.py:70)."""
    return [_v2x_extended(ext) for ext in _halo_exchange_rows(xs)]


def _stripe_rows(plane, k: int, lby: int):
    """Block rows k * lby .. (k + 1) * lby of `plane` [by, bx, 64] padded
    with copies of its last block row (_pad_plane_rows's stripe k)."""
    return _pad_plane_rows(plane, max(len(plane), (k + 1) * lby))[k * lby:(k + 1) * lby]


def _padded_mcus_y(mcus_y: int, n_stripes: int) -> int:
    return -(-mcus_y // n_stripes) * n_stripes


def _pad_plane_rows(plane, by_pad: int):
    """Pad [by, bx, 64] to [by_pad, bx, 64] with copies of the last block
    row (NumPy arrays, or tensors on their device)."""
    by = plane.shape[0]
    if by == by_pad:
        return plane
    if isinstance(plane, torch.Tensor):
        return torch.cat([plane, plane[-1:].expand(by_pad - by, *plane.shape[1:])])
    return np.concatenate([plane, np.repeat(plane[-1:], by_pad - by, axis=0)], axis=0)


def _striped_entropy_plan(structure, cfg: DecodeConfig, n_stripes: int):
    """Stripe-aligned entropy guards and the per-stripe decode, shared by
    entropy_decode_striped and decode_streamed: (decode_stripe, lby, qts),
    decode_stripe(k, planes) filling the caller's ZEROED [lby[ci], bx, 64]
    int16 arrays with stripe k's block rows (the native runtime writes only
    nonzero coefficients); or None where the stream does not allow striped
    entropy: another backend than NATIVE, no native runtime, progressive or
    several scans, or restart segments that are not whole MCU rows or
    straddle a stripe."""
    from ..native import runtime as nr

    frame = structure.frame
    if (cfg.entropy_backend != EntropyBackend.NATIVE
            or not nr.available()
            or len(structure.scans) != 1
            or frame.process.name == "PROGRESSIVE_DCT"):
        return None
    scan = structure.scans[0]
    ri = scan.restart_interval
    if scan.header.nics != frame.ncs or ri == 0 or ri % frame.mcus_x != 0:
        return None
    total_mcus, params, luts = nr.scan_layout(structure, scan)
    n_segs = nr._check_segments(scan, total_mcus)
    mcu_rows_per_seg = ri // frame.mcus_x
    rows_per_stripe = _padded_mcus_y(frame.mcus_y, n_stripes) // n_stripes
    if rows_per_stripe % mcu_rows_per_seg:
        return None
    segs_per_stripe = rows_per_stripe // mcu_rows_per_seg
    bounds = list(scan.span.segment_bounds())
    threads = cfg.num_threads or os.cpu_count() or 1
    lby = [rows_per_stripe * c.vsf for c in frame.components]
    # the unit layout's plane heights made stripe-local; every other column
    # is the same for every stripe
    local_params = params.copy()
    for u in range(local_params.shape[0]):
        local_params[u, 10] = lby[int(local_params[u, 0])]

    def decode_stripe(k, planes):
        s0 = k * segs_per_stripe
        s1 = min(s0 + segs_per_stripe, n_segs)
        if s0 >= s1:
            return  # a stripe wholly in padding rows stays zero
        local_mcus = min((s1 - s0) * ri, total_mcus - s0 * ri)
        nr.decode_scan_native_raw(structure, scan, planes, cfg.replace(num_threads=threads),
                                  bounds[s0:s1], local_mcus, local_params, luts)

    qts = {tid: qt.values for s in structure.scans for tid, qt in s.quant_tables.items()}
    return decode_stripe, lby, qts


def _zeroed(frame: FrameHeader, lby) -> list[np.ndarray]:
    return [np.zeros((n, c.blocks_x, 64), dtype=np.int16) for n, c in zip(lby, frame.components)]


def entropy_decode_stripe(structure, cfg: DecodeConfig, n_stripes: int, k: int, device):
    """Stripe k alone of n: its int16 block rows [lby[ci], bx, 64] on
    `device`, padding rows replicated as entropy_decode_striped replicates
    them, and the tables (a rank of a mesh's stripe axis). Where
    _striped_entropy_plan allows, the native runtime decodes the stripe's
    restart segments alone (and, for a stripe wholly in padding rows, the
    stripe that holds the image's last block row); otherwise the whole
    image is decoded (PALLAS: on the device) and its stripe k taken."""
    frame = structure.frame
    plan = _striped_entropy_plan(structure, cfg, n_stripes)
    if plan is None:
        planes, qts = host._entropy_decode(structure, cfg, device=device)
        if not isinstance(planes, list):
            planes = [planes.plane(ci) for ci in range(frame.ncs)]
        lby = [_padded_mcus_y(frame.mcus_y, n_stripes) // n_stripes * c.vsf
               for c in frame.components]
        rows = [_stripe_rows(p, k, n) for p, n in zip(planes, lby)]
    else:
        decode_stripe, lby, qts = plan
        decoded = {k: _zeroed(frame, lby)}
        decode_stripe(k, decoded[k])
        rows = decoded[k]
        for ci, c in enumerate(frame.components):
            real = c.blocks_y - k * lby[ci]  # this stripe's rows inside the image
            if real >= lby[ci]:
                continue
            last = c.blocks_y - 1  # the image's last block row, in stripe `holder`
            holder = last // lby[ci]
            if holder not in decoded:
                decoded[holder] = _zeroed(frame, lby)
                decode_stripe(holder, decoded[holder])
            rows[ci][max(real, 0):] = decoded[holder][ci][last - holder * lby[ci]]
    return [r.contiguous() if isinstance(r, torch.Tensor)
            else torch.from_numpy(np.ascontiguousarray(r)).to(device) for r in rows], qts


def entropy_decode_striped(structure, cfg: DecodeConfig, n_stripes: int):
    """Stripe-parallel host entropy: (stripe_planes, qts) with
    stripe_planes[k][ci] stripe k's [lby, bx, 64] int16 block rows, padding
    rows replicated so that stacking the stripes gives _pad_plane_rows of
    the whole plane; or None where _striped_entropy_plan refuses."""
    plan = _striped_entropy_plan(structure, cfg, n_stripes)
    if plan is None:
        return None
    decode_stripe, lby, qts = plan
    frame = structure.frame
    stripe_planes = []
    for k in range(n_stripes):
        planes = _zeroed(frame, lby)
        decode_stripe(k, planes)
        stripe_planes.append(planes)
    # stripes over padding MCU rows got no data: each of those block rows
    # takes the last decoded one
    for ci, c in enumerate(frame.components):
        last = stripe_planes[0][ci][0]
        flat_row = 0
        for k in range(n_stripes):
            p = stripe_planes[k][ci]
            for r in range(p.shape[0]):
                if flat_row < c.blocks_y:
                    last = p[r]
                else:
                    p[r] = last
                flat_row += 1
    return stripe_planes, qts


class _StripedStage(nn.Module):
    """What ChunkStage and StripeStage share: the padded geometry of a key
    cut in `n` stripes (padded height pad_h, hs output rows and lby[ci] block
    rows a stripe), the route and the plain routes."""

    def __init__(self, key, n: int, device):
        super().__init__()
        frame, qt_by_comp, precision, quirks, upsample, scale = key
        if scale != 8:
            raise ValueError("striped decode is full-scale only (scale == 8)")
        if frame.ncs not in (1, 3, 4):
            raise ValueError(f"no color transform for {frame.ncs} components")
        self.frame, self.n = frame, n
        self.precision, self.quirks, self.upsample = precision, quirks, upsample
        self.exact = precision == IdctPrecision.EXACT
        self.bits12 = frame.precision == 12
        self.factors = tuple((c.hsf, c.vsf) for c in frame.components)
        mcus_y_pad = _padded_mcus_y(frame.mcus_y, n)
        self.pad_h = mcus_y_pad * 8 * frame.max_vsf
        self.hs = self.pad_h // n
        self.lby = [mcus_y_pad // n * c.vsf for c in frame.components]
        #: the padded frame and a stripe's, as the kernels' geometry
        self.padded = frame.with_height(self.pad_h, reference_quirks=False)
        self.stripe_frame = frame.with_height(self.hs, reference_quirks=False)
        # the route: K03 or K13 where the PADDED frame's geometry is
        # tile-local (the index rule runs on its rows)
        self.fused = frame.ncs == 3 and upsample == "nn" and pixel_ops.fits(self.padded)
        for ci, q in enumerate(qt_by_comp):
            self.register_buffer(
                f"qt{ci}", convert.quant_table_to_device(np.frombuffer(q, np.uint16), device))

    def _qts(self):
        return [getattr(self, f"qt{ci}") for ci in range(self.frame.ncs)]

    def _nn(self, planes, frame: FrameHeader, stripes: color_ops.Stripes):
        """K6n over `planes` of `frame` (a stripe's or the padded one)."""
        qts = self._qts()
        if self.fused:
            fused = pixel_ops.pixel_exact if self.exact else pixel_ops.pixel_float
            return fused(planes, qts, frame, self.quirks, want_planes=False, stripes=stripes)[0]
        pixel = [idct_ops.idct_plane(p, q, self.bits12, self.precision)
                 for p, q in zip(planes, qts)]
        return self._colour(pixel, frame.height, "nn", stripes)

    def _colour(self, pixel, h: int, upsample: str, stripes: color_ops.Stripes, halos=None):
        # striped gray is CORRECT addressing, four components always YCCK
        return color_ops.planes_to_rgb(pixel, h, self.frame.width, self.factors, self.quirks,
                                       upsample, exact=self.exact, raw_cmyk=False,
                                       gray_shear=False, stripes=stripes, halos=halos)

    def _pixel_plain(self, planes):
        """Each component's pixel plane [lby * 8, bx * 8] of one stripe."""
        out = []
        for p, q, c in zip(planes, self._qts(), self.frame.components):
            pix = idct_ops._PLAIN[self.precision](p.reshape(-1, 64), q, self.bits12)
            out.append(idct_ops.blocks_to_plane(pix, p.shape[0], c.blocks_x))
        return out

    def _convert(self, chans):
        if self.frame.ncs == 1:
            return color_ops.gray_to_rgb(chans[0])
        if self.frame.ncs == 3:
            return color_ops.ycbcr_to_rgb(*chans, self.quirks)
        return color_ops.ycck_to_rgb(*chans, self.exact, self.quirks)

    def _stripe_nn(self, k: int, ci: int, plane: torch.Tensor) -> torch.Tensor:
        """Component ci of stripe k by the JAX rule (stripes.py:157-165):
        the global row table sliced at k * hs, made stripe-local, clamped;
        the global column table."""
        c = self.frame.components[ci]
        vmax, hmax = self.frame.max_vsf, self.frame.max_hsf
        local_rows = plane.shape[0]
        table = _nn_index_f32(self.pad_h, np.float32(c.vsf) / np.float32(vmax))
        rows = np.clip(table[k * self.hs:(k + 1) * self.hs] - k * local_rows, 0, local_rows - 1)
        cols = _nn_index_f32(self.frame.width, np.float32(c.hsf) / np.float32(hmax))
        rows_t = torch.from_numpy(rows).to(plane.device)
        cols_t = torch.from_numpy(cols).to(plane.device)
        return plane[rows_t[:, None], cols_t[None, :]]

    def _stripe_nn_plain(self, k: int, planes) -> torch.Tensor:
        """Stripe k's RGB [hs, W, 3] under nearest-neighbour upsampling from
        its own block rows (make_chunk_stage's chunk_fn)."""
        pixel = self._pixel_plain(planes)
        return self._convert([self._stripe_nn(k, ci, p) for ci, p in enumerate(pixel)])

    def _stripes(self, planes):
        """The padded planes cut in the n stripes' block rows."""
        return [[p[k * lby:(k + 1) * lby] for p, lby in zip(planes, self.lby)]
                for k in range(self.n)]


class ChunkStage(_StripedStage):
    """The device stage of one chunk of MCU rows of a large image, the
    counterpart of make_chunk_stage (stripes.py:322): forward(k, *planes)
    takes chunk k's int16 planes [lby[ci], bx, 64] and gives its RGB [hs,
    W, 3] (rows past the image are padding). Nearest-neighbour only. One
    launch a chunk of K03 or K13, or K0/K1 per component and K3, each with
    the chunk's origin and the stripe height (K6n); `plain` (and CPU
    tensors) runs _stripe_nn_plain."""

    def __init__(self, key, n_chunks: int, device):
        if key[4] == "fancy":
            raise ValueError("make_chunk_stage is NN-only (fancy needs halos)")
        super().__init__(key, n_chunks, device)

    def forward(self, k: int, *planes: torch.Tensor, plain: bool = False) -> torch.Tensor:
        if plain or planes[0].device.type == "cpu":
            return self._stripe_nn_plain(k, planes)
        return self._launches(k, planes)

    def _launches(self, k: int, planes) -> torch.Tensor:
        """The kernels' route (on CPU tensors, each wrapper's plain
        version)."""
        return self._nn(planes, self.stripe_frame, color_ops.Stripes(k * self.hs, self.hs))


class StripeStage(_StripedStage):
    """The device stage of a whole image cut in n stripes, the counterpart
    of make_shard_fn (stripes.py:86) and build_striped_stage (:177):
    forward(*planes) takes the padded int16 planes [n * lby[ci], bx, 64]
    and gives the padded frame's RGB [pad_h, W, 3] (crop to the height
    outside). All stripes in one launch per kernel: K6n (nearest-neighbour)
    or K6f (fancy: K0/K1 per component, then K3f under the striped rule).
    `plain` (and CPU tensors): the JAX program stripe by stripe."""

    def forward(self, *planes: torch.Tensor, plain: bool = False) -> torch.Tensor:
        if plain or planes[0].device.type == "cpu":
            if self.upsample == "fancy":
                return self._fancy_plain(planes)
            return torch.cat([self._stripe_nn_plain(k, s)
                              for k, s in enumerate(self._stripes(planes))])
        return self._launches(planes)

    def _launches(self, planes) -> torch.Tensor:
        """The kernels' route (on CPU tensors, each wrapper's plain
        version)."""
        stripes = color_ops.Stripes(0, self.hs)
        if self.upsample != "fancy":
            return self._nn(planes, self.padded, stripes)
        pixel = [idct_ops.idct_plane(p, q, self.bits12, self.precision)
                 for p, q in zip(planes, self._qts())]
        return self._colour(pixel, self.pad_h, "fancy", stripes)

    def _fancy_plain(self, planes) -> torch.Tensor:
        """make_shard_fn's fancy branch for every stripe, each with its
        neighbours' edge rows as its halo rows."""
        pixel = [self._pixel_plain(s) for s in self._stripes(planes)]
        ext = [_halo_exchange_rows([pixel[k][ci] for k in range(self.n)])
               for ci in range(self.frame.ncs)]
        return torch.cat([self._fancy_stripe_plain(
            k, pixel[k], [(e[k][:1], e[k][-1:]) for e in ext]) for k in range(self.n)])

    def _fancy_stripe_plain(self, k: int, pixel, halos) -> torch.Tensor:
        """make_shard_fn's fancy branch (stripes.py:139-156) for stripe k's
        uint8 pixel planes, halos[ci] its (top, bottom) halo rows: the
        passes where fancy_ok (the vertical one over the plane between
        them), one floor and clamp, the crop; the rule elsewhere. The plain
        version of K6h."""
        mh, mv = self.frame.max_hsf, self.frame.max_vsf
        chans = []
        for ci, (fh, fv) in enumerate(self.factors):
            if not color_ops.fancy_ok(fh, fv, mh, mv):
                chans.append(self._stripe_nn(k, ci, pixel[ci]))
                continue
            rows = [pixel[ci]]
            if 2 * fv == mv:
                rows = [halos[ci][0].reshape(1, -1), pixel[ci], halos[ci][1].reshape(1, -1)]
            up = [r.to(torch.float32) for r in rows]
            if 2 * fh == mh:
                up = [color_ops.fancy_h2x(u) for u in up]
            up = _v2x_extended(torch.cat(up)) if 2 * fv == mv else up[0]
            chans.append(torch.clamp(torch.floor(up), 0.0, 255.0).to(
                torch.uint8)[:self.hs, :self.frame.width])
        return self._convert(chans)

    def stripe(self, k: int, planes, exchange=None, plain: bool = False) -> torch.Tensor:
        """Stripe k alone, a rank's share of make_shard_fn: its int16 planes
        [lby[ci], bx, 64] -> its RGB [hs, W, 3]. Nearest-neighbour: K6n
        with the stripe's origin. Fancy: K0/K1 on the stripe, the edge rows
        of each component whose vertical pass reads a halo row traded by
        `exchange(first, last) -> (top, bottom)` (one row each, the
        components' rows side by side; default: none, this stripe's own
        edge rows, as at the ends of the stripe axis), then K6h. `plain`
        (and CPU tensors): the JAX program's stripe."""
        if plain or planes[0].device.type == "cpu":
            if self.upsample != "fancy":
                return self._stripe_nn_plain(k, planes)
            pixel = self._pixel_plain(planes)
            return self._fancy_stripe_plain(k, pixel, self._halos(pixel, exchange))
        return self._stripe_launches(k, planes, exchange)

    def _stripe_launches(self, k: int, planes, exchange=None) -> torch.Tensor:
        """stripe's kernel route (on CPU tensors, each wrapper's plain
        version)."""
        stripes = color_ops.Stripes(k * self.hs, self.hs)
        if self.upsample != "fancy":
            return self._nn(planes, self.stripe_frame, stripes)
        pixel = [idct_ops.idct_plane(p, q, self.bits12, self.precision)
                 for p, q in zip(planes, self._qts())]
        return self._colour(pixel, self.hs, "fancy", stripes, self._halos(pixel, exchange))

    def edge_rows(self, pixel):
        """(the components whose vertical pass reads a halo row, their
        first rows side by side, their last rows side by side) of a
        stripe's pixel planes: what a stripe sends its neighbours."""
        mh, mv = self.frame.max_hsf, self.frame.max_vsf
        takes = [ci for ci, (fh, fv) in enumerate(self.factors)
                 if color_ops.takes_halo(fh, fv, mh, mv)]
        if not takes:
            return takes, None, None
        return (takes, torch.cat([pixel[ci][0] for ci in takes]),
                torch.cat([pixel[ci][-1] for ci in takes]))

    def _halos(self, pixel, exchange):
        """Each component's (top, bottom) halo rows [1, stride] for the
        stripe of pixel planes `pixel`, None where its passes read none
        (None for all: no halo, and the stripe's colour launch is K6f's):
        its edge rows traded by `exchange`."""
        takes, first, last = self.edge_rows(pixel)
        if not takes:
            return None
        halos = [None] * self.frame.ncs
        top, bottom = exchange(first, last) if exchange is not None else (first, last)
        widths = [pixel[ci].shape[1] for ci in takes]
        for ci, t, b in zip(takes, top.split(widths), bottom.split(widths)):
            halos[ci] = (t.reshape(1, -1), b.reshape(1, -1))
        return halos


@functools.lru_cache(maxsize=64)
def make_chunk_stage(key, n_chunks: int, device: torch.device) -> ChunkStage:
    """The ChunkStage of a stage key, built once a (key, n_chunks, device)."""
    return ChunkStage(key, n_chunks, device)


@functools.lru_cache(maxsize=64)
def build_striped_stage(key, n_stripes: int, device: torch.device) -> StripeStage:
    """The StripeStage of a stage key, built once a (key, n_stripes,
    device)."""
    return StripeStage(key, n_stripes, device)


def _stage_for(frame: FrameHeader, qts, cfg: DecodeConfig):
    return decoder_mod._stage_key(frame, decoder_mod.qt_by_comp_bytes(frame, qts), cfg)


def _chunk_buffers(frame: FrameHeader, lby, device):
    """One chunk's int16 planes back to back, on the host and on `device`
    (reused for every chunk, one upload a chunk): (host flat, host views
    [lby[ci], bx, 64], device flat, device views)."""
    sizes = [n * c.blocks_x * 64 for n, c in zip(lby, frame.components)]
    flat = np.zeros(sum(sizes), dtype=np.int16)
    flat_dev = torch.empty(flat.shape, dtype=torch.int16, device=device)
    offs = np.cumsum([0, *sizes])
    shapes = [(n, c.blocks_x, 64) for n, c in zip(lby, frame.components)]
    return (flat, [flat[a:b].reshape(s) for a, b, s in zip(offs, offs[1:], shapes)],
            flat_dev, [flat_dev[a:b].view(s) for a, b, s in zip(offs, offs[1:], shapes)])


def decode_streamed(data, cfg: DecodeConfig | None = None, n_chunks: int | None = None,
                    sink=None, device="cuda"):
    """Decode one large image chunk by chunk, so that only one chunk's
    coefficients and intermediates live on the device (and, where the
    restart intervals align with the chunks, on the host): [H, W, 3] uint8
    on the host. n_chunks defaults to one a CHUNK_PIXELS of output.

    sink(k, rgb, r0, take): a per-chunk consumer in place of the host
    output; rgb is chunk k's [hs, W, 3] uint8 tensor on `device`, its rows
    0..take real (rows r0..r0 + take of the image). With a sink nothing is
    copied back and the result is None.

    Fancy upsampling (which needs halos) and a single chunk go to
    decode_striped, where a sink raises ValueError."""
    cfg = cfg or DecodeConfig()
    device = convert.resolve_device(device)
    structure = parse(data, cfg)
    frame = structure.frame
    if n_chunks is None:
        n_chunks = max(1, -(-frame.height * frame.width // CHUNK_PIXELS))
    if cfg.upsample == "fancy" or n_chunks == 1:
        if sink is not None:
            raise ValueError("sink requires the chunked path (NN upsampling, >1 chunk)")
        return decode_striped(data, cfg, device=device)
    mcu_rows = _padded_mcus_y(frame.mcus_y, n_chunks) // n_chunks
    lby = [mcu_rows * c.vsf for c in frame.components]

    plan = _striped_entropy_plan(structure, cfg, n_chunks)
    whole = None
    if plan is not None:
        decode_stripe, _lby, qts = plan
    else:
        whole, qts = host._entropy_decode(structure, cfg, device=device)
        if not isinstance(whole, list):
            whole = [whole.plane(ci) for ci in range(frame.ncs)]
    on_device = whole is not None and isinstance(whole[0], torch.Tensor)
    if not on_device:
        flat, bufs, flat_dev, chunk_dev = _chunk_buffers(frame, lby, device)

    stage = make_chunk_stage(_stage_for(frame, qts, cfg), n_chunks, device)
    hs = stage.hs
    out = None if sink is not None else np.zeros((frame.height, frame.width, 3), np.uint8)
    for k in range(n_chunks):
        if on_device:
            chunk_in = []
            for p, n in zip(whole, lby):
                src = p[k * n:(k + 1) * n]
                if src.shape[0] < n:
                    # padding block rows: zeros (no real row samples them)
                    src = torch.cat([src, src.new_zeros((n - src.shape[0], *src.shape[1:]))])
                chunk_in.append(src)
        else:
            flat.fill(0)  # the native runtime writes only nonzero coefficients
            if plan is not None:
                decode_stripe(k, bufs)
            else:
                for b, p, n in zip(bufs, whole, lby):
                    src = p[k * n:(k + 1) * n]
                    b[:src.shape[0]] = src
            flat_dev.copy_(torch.from_numpy(flat))
            chunk_in = chunk_dev
        rgb = stage(k, *chunk_in)
        r0 = k * hs
        take = min(hs, frame.height - r0)
        if take > 0:  # a chunk wholly in padding rows goes nowhere
            if sink is not None:
                sink(k, rgb, r0, take)
            else:
                torch.from_numpy(out[r0:r0 + take]).copy_(rgb[:take])
        del rgb  # one chunk's RGB live at a time, not this one's beside the next's
    return out


def decode_striped(data, cfg: DecodeConfig | None = None, n_stripes: int | None = None,
                   device="cuda", mesh=None) -> np.ndarray:
    """Decode one large image with its device stage cut in stripes of MCU
    rows: [H, W, 3] uint8 on the host. Any height (padded stripes). Host
    entropy runs stripe by stripe where the restart intervals align with
    the stripes, else whole-image and padded with copies of the last block
    row.

    Without a mesh: `n_stripes` stripes (default: the CUDA devices, one
    stripe on the CPU), all resident on `device`, one launch per kernel.
    With a mesh (parallel/mesh.make_mesh; every rank calls with the same
    bytes): as many stripes as its stripe axis has ranks, rank k decoding
    stripe k on `device`, the stripes' RGB gathered over the axis; every
    rank returns the whole image."""
    cfg = cfg or DecodeConfig()
    device = convert.resolve_device(device)
    structure = parse(data, cfg)
    if mesh is not None:
        sharding = mesh_mod.stripe_sharding(mesh)
        if n_stripes not in (None, sharding.size):
            raise ValueError(f"n_stripes {n_stripes} against a stripe axis of {sharding.size}")
        return _decode_stripe_of(structure, cfg, sharding, device)
    if n_stripes is None:
        n_stripes = max(1, torch.cuda.device_count()) if device.type == "cuda" else 1
    stage, planes = _striped_planes(structure, cfg, n_stripes, device)
    return stage(*planes)[: structure.frame.height].cpu().numpy()


def _decode_stripe_of(structure, cfg: DecodeConfig, sharding, device) -> np.ndarray:
    """decode_striped on this rank of a mesh: its stripe's entropy and
    pixel stage, the halo rows traded with its neighbours on the stripe
    axis, the gather of every stripe's RGB, cropped."""
    frame = structure.frame
    n, k = sharding.size, sharding.index
    planes, qts = entropy_decode_stripe(structure, cfg, n, k, device)
    stage = build_striped_stage(_stage_for(frame, qts, cfg), n, device)
    rgb = stage.stripe(k, planes, sharding.halo_exchange if n > 1 else None)
    return sharding.gather(rgb)[: frame.height].cpu().numpy()


def _striped_planes(structure, cfg: DecodeConfig, n_stripes: int, device):
    """decode_striped's StripeStage and its padded coefficient planes on
    `device`."""
    frame = structure.frame
    mcus_y_pad = _padded_mcus_y(frame.mcus_y, n_stripes)

    striped = entropy_decode_striped(structure, cfg, n_stripes)
    if striped is not None:
        stripe_planes, qts = striped
        # the padded planes on the device, filled a stripe at a time
        inputs = []
        for ci, c in enumerate(frame.components):
            lby = stripe_planes[0][ci].shape[0]
            plane = torch.empty((n_stripes * lby, c.blocks_x, 64), dtype=torch.int16,
                                device=device)
            for k in range(n_stripes):
                plane[k * lby:(k + 1) * lby].copy_(torch.from_numpy(stripe_planes[k][ci]))
            inputs.append(plane)
    else:
        planes, qts = host._entropy_decode(structure, cfg, device=device)
        if not isinstance(planes, list):
            planes = [planes.plane(ci) for ci in range(frame.ncs)]
        inputs = [_pad_plane_rows(p, mcus_y_pad * c.vsf)
                  for p, c in zip(planes, frame.components)]
    stage = build_striped_stage(_stage_for(frame, qts, cfg), n_stripes, device)
    return stage, [p.contiguous() if isinstance(p, torch.Tensor)
                   else torch.from_numpy(np.ascontiguousarray(p)).to(device) for p in inputs]
