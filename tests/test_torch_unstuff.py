"""K2u on the CPU (jpeg_decoder_tpu_torch/ops/entropy_cuda.py): the model
of the single-pass kernel's tile schedule (`_unstuff_tiled_plain`: the
segments that touch a tile, the keep mask, the look-back prefix in tile
order, the compaction, the offsets) bitwise against the plain version
(`_unstuff_plain`), the host's per-segment unstuffing (`pack_scan`) and the
JAX backend's own (`entropy_pallas._pack_group`), at tiles small enough to
cut segments anywhere; K2's layout from the device (`_sub_base_plain`)
against `sub_layout`; the records sized by the raw lengths, which launch_args
knows before K2u runs, never below the exact layout, and the schedule's model
unchanged by the slack; and check_status, given the unstuffed offsets on the
device, raising what it raised with the host's. K2u without bounds
(find_segments): its plain version (`_find_plain`) against the host's span
scan (io/bitstream.scan_entropy_span) followed by `_unstuff_plain` with the
bounds it gives, and the model of its tile schedule (`_find_tiled_plain`)
against the plain version, on bytes cut across tile edges and ended every
way a scan ends. Inputs come from numpy seeds and the test corpus.
Tolerance: none, everything is integer."""

import numpy as np
import pytest
import torch

from jpeg_decoder_tpu.ops import entropy_pallas
from jpeg_decoder_tpu_torch import JpegError, convert
from jpeg_decoder_tpu_torch.io import bitstream
from jpeg_decoder_tpu_torch.io.parser import parse
from jpeg_decoder_tpu_torch.ops import entropy_cuda

from chip_smoke import damaged_streams

from . import corpus
from .test_torch_entropy import DAMAGED, _damaged
from .test_torch_entropy_subseq import assert_unstuffed
from .torch_crossing import (
    block_boundary_case,
    bound_at,
    dc_only_stream,
    empty_segments,
    find_cases,
    pairs_across_edges,
    scan_bytes,
    scan_to_end,
    unstuffed_by_the_host,
)

TILES = [16, 64, 4096]


def _assert_tiled(raw, lo, hi, tile):
    """The tiled model, the plain version and the host's unstuffing agree,
    stream and offsets, bitwise."""
    raw, lo, hi = (np.ascontiguousarray(a) for a in (raw, lo, hi))
    stream, seg_off = unstuffed_by_the_host(raw, lo, hi)
    args = [torch.from_numpy(a) for a in (raw, lo, hi)]
    got = entropy_cuda._unstuff_tiled_plain(*args, tile)
    assert_unstuffed(got, args[0], stream, seg_off)
    plain = entropy_cuda._unstuff_plain(*args)
    for a, b in zip(got, plain):
        assert torch.equal(a, b)


def _k2u_streams():
    """Every stream the K2u tests use: the corpus's DRI streams and their
    restart-free twins, DC-only streams with a stuffed pair in almost every
    data unit, and a batch whose first image ends on a restart marker."""
    out = {}
    for name, dri, plain in corpus.dri_corpus():
        out[name] = scan_bytes([dri])
        out[name + "_no_ri"] = scan_bytes([plain])
    diffs = [32767, 32767, -1, 255, 32767, 1, 32767, 32767, 32767, 127, 2047, 32767]
    for ri in (0, 1, 3):
        out[f"stuffed_ri{ri}"] = scan_bytes([dc_only_stream(diffs, nb_x=4, restart_interval=ri)])
    good = dc_only_stream([5, -3, 32767, 9], nb_x=2, restart_interval=2)
    span = parse(good).scans[0].span
    cut = good[: span.restart_offsets[-1] + 2] + good[span.end:]
    out["empty_last_then_next"] = scan_bytes([cut, good])
    raw, lo, hi, _, _ = block_boundary_case()
    out["block_boundary_case"] = (raw, lo, hi)
    return out


STREAMS = sorted(_k2u_streams())


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("name", STREAMS)
def test_tiled_model_matches_plain_and_the_host(name, tile):
    _assert_tiled(*_k2u_streams()[name], tile)


@pytest.mark.parametrize("name", [n for n, _d, _p in corpus.dri_corpus()])
def test_tiled_model_matches_the_jax_backends_unstuffing(name):
    """Segment by segment against entropy_pallas._pack_group, the host code
    K2u replaces (its lanes hold the unstuffed segments as big-endian
    words)."""
    raw, lo, hi = _k2u_streams()[name]
    words, nbytes, _ = entropy_pallas._pack_group(
        [(raw, int(a), int(b)) for a, b in zip(lo, hi)], len(lo))
    lanes = np.stack([(words >> s) & 0xFF for s in (24, 16, 8, 0)], -1)
    lanes = lanes.astype(np.uint8).reshape(len(lo), -1)
    got = entropy_cuda._unstuff_tiled_plain(*map(torch.from_numpy, (raw, lo, hi)), 64)
    stream, seg_off = got.stream.numpy(), got.seg_off.numpy()
    np.testing.assert_array_equal(np.diff(seg_off), nbytes)
    for i in range(len(lo)):
        np.testing.assert_array_equal(stream[seg_off[i] : seg_off[i + 1]], lanes[i, : nbytes[i]])


@pytest.mark.parametrize("tile", TILES)
def test_tiled_model_pairs_across_every_tile_edge(tile):
    _assert_tiled(*pairs_across_edges(tile), tile)


@pytest.mark.parametrize("tile", [16, 64])
def test_tiled_model_a_bound_at_each_position_of_a_tile(tile):
    for p in range(tile):
        _assert_tiled(*bound_at(tile, p), tile)


@pytest.mark.parametrize("tile", TILES)
def test_tiled_model_empty_segments(tile):
    for case in empty_segments(tile):
        _assert_tiled(*case, tile)


@pytest.mark.parametrize("tile", TILES)
def test_tiled_model_batch_of_unequal_images(tile):
    """Images of unequal sizes, samplings and restart intervals laid back
    to back, as a batch group is laid out."""
    from jpeg_decoder_tpu_torch.benchmarks.inputs import make_jpeg

    datas = [make_jpeg(40, 24, ((2, 2), (1, 1), (1, 1)), 1, 5),
             make_jpeg(100, 37, ((1, 1),), 0, 6),
             make_jpeg(72, 40, ((2, 1), (1, 1), (1, 1)), 3, 7),
             dc_only_stream([32767, -32767, 1, 255], nb_x=2, restart_interval=1)]
    _assert_tiled(*scan_bytes(datas), tile)


def test_sub_base_plain_equals_sub_layout():
    rng = np.random.default_rng(3)
    for n in (0, 1, 7, 300):
        lens = rng.integers(0, 700, n)
        lens[: n // 3] = rng.choice([0, 1, 127, 128, 129, 256], n // 3)
        seg_off = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
        for sub in (4, 128):
            np.testing.assert_array_equal(
                entropy_cuda._sub_base_plain(torch.from_numpy(seg_off), sub).numpy(),
                entropy_cuda.sub_layout(seg_off, sub))


def _groups():
    return {**{name: [dri] for name, dri, _p in corpus.dri_corpus()},
            "stuffed_ri1": [dc_only_stream(
                [32767, 32767, -1, 255, 32767, 1, 32767, 32767], nb_x=4, restart_interval=1)],
            "batch": [corpus.dri_corpus()[0][1]] * 3}


@pytest.mark.parametrize("name", sorted(_groups()))
def test_raw_bound_layout_covers_the_exact_one(name):
    """launch_args sizes K2's records by the raw lengths: per segment never
    fewer subsequences than the unstuffed lengths give, so neither in all
    nor in the largest segment (K2's grid)."""
    structures = [parse(d) for d in _groups()[name]]
    args, host = entropy_cuda.launch_args(
        [entropy_cuda.prepare_scan(s, s.scans[0]) for s in structures], "cpu")
    exact = entropy_cuda.sub_layout(args[1].numpy())
    bound = entropy_cuda.sub_layout(host.seg_bound)
    np.testing.assert_array_equal(host.sub_base.numpy(), exact)
    assert (np.diff(bound) >= np.diff(exact)).all()
    assert bound[-1] >= exact[-1] and np.diff(bound).max() >= np.diff(exact).max()
    assert (np.diff(host.seg_bound) >= np.diff(args[1].numpy())).all()


@pytest.mark.parametrize("name", sorted(_groups()))
def test_model_with_the_raw_bound_capacity_matches_the_exact_layout(name):
    """The schedule's model with its records sized as K2's wrapper sizes
    them from the raw lengths: the same status, planes and records, and
    the slack past the layout untouched."""
    structures = [parse(d) for d in _groups()[name]]
    args, host = entropy_cuda.launch_args(
        [entropy_cuda.prepare_scan(s, s.scans[0]) for s in structures], "cpu")
    capacity = int(entropy_cuda.sub_layout(host.seg_bound)[-1])
    zeros = lambda: [convert.zero_planes(s.frame, "cpu") for s in structures]
    want_planes, got_planes = zeros(), zeros()
    st_e, exact = entropy_cuda._decode_segments_subseq_plain(*args, want_planes)
    st_s, slack = entropy_cuda._decode_segments_subseq_plain(*args, got_planes,
                                                             capacity=capacity)
    assert torch.equal(st_e, st_s)
    for g, w in zip(got_planes, want_planes):
        for a, b in zip(g, w):
            assert torch.equal(a, b)
    n = int(exact["sub_base"][-1])
    for key in ("rec", "used", "first_du"):
        assert len(slack[key]) == capacity
        np.testing.assert_array_equal(slack[key][:n], exact[key])
        assert not slack[key][n:].any()
    with pytest.raises(ValueError):
        entropy_cuda._decode_segments_subseq_plain(*args, zeros(), capacity=n - 1)


def _status_outcome(status, seg_off):
    try:
        entropy_cuda.check_status(status, seg_off)
    except JpegError as e:
        return type(e)
    return None


def _damaged_cases():
    from jpeg_decoder_tpu_torch.benchmarks.inputs import make_jpeg

    small = make_jpeg(64, 48, ((2, 2), (1, 1), (1, 1)), 2, 1)
    cases = {f"chip_smoke {k}": v for k, v in damaged_streams(small).items()}
    cases.update({f"model {k}": (_damaged(k), v) for k, v in DAMAGED.items()})
    return cases


@pytest.mark.parametrize("name", sorted(_damaged_cases()))
def test_check_status_with_the_device_offsets_raises_as_before(name):
    """The status checked against the unstuffed offsets as launch_args
    leaves them (a tensor, read back with the status) and against the
    host's exact ones (pack_scan): the same error class, the one expected;
    and decode_scan raises it too."""
    data, want = _damaged_cases()[name]
    s = parse(data)
    pack = entropy_cuda.prepare_scan(s, s.scans[0])
    _ri, _stream, seg_off = entropy_cuda.pack_scan(s, s.scans[0], pack.total_mcus,
                                                   pack.units.shape[0])
    args, host = entropy_cuda.launch_args([pack], "cpu")
    status = entropy_cuda.decode_segments(*args, [convert.zero_planes(s.frame, "cpu")],
                                          host=host)
    assert isinstance(args[1], torch.Tensor)
    assert _status_outcome(status, args[1]) is _status_outcome(status, seg_off) is want
    try:
        entropy_cuda.decode_scan(s, s.scans[0], convert.zero_planes(s.frame, "cpu"))
        got = None
    except JpegError as e:
        got = type(e)
    assert got is want


# ---------------------------------------------------------------------------
# K2u without bounds: the segments found on the device
# ---------------------------------------------------------------------------


def _find_streams():
    """name -> (raw, n_segs): find_cases at every tile size of TILES, and
    the corpus's and the DC-only streams from their first entropy byte to
    the end of the file."""
    out = {f"{name}@{tile}": case for tile in TILES for name, case in find_cases(tile).items()}
    for name, dri, plain in corpus.dri_corpus():
        out[name] = scan_to_end(dri)
        out[name + "_no_ri"] = scan_to_end(plain)
    diffs = [32767, 32767, -1, 255, 32767, 1, 32767, 32767, 32767, 127, 2047, 32767]
    for ri in (0, 1, 3):
        out[f"stuffed_ri{ri}"] = scan_to_end(dc_only_stream(diffs, nb_x=4, restart_interval=ri))
    return out


FIND_STREAMS = sorted(_find_streams())


def _defined(ends, n_segs):
    """The entries of find_segments' `ends` that K2u defines: the offsets of
    the segments found up to the header's count, the end of the kept
    bytes, the count found and the end of the scan."""
    k = min(int(ends[n_segs + 1]), n_segs)
    return np.asarray(ends)[[*range(k), n_segs, n_segs + 1, n_segs + 2]]


def _assert_found(got, ends, raw, n_segs):
    """find_segments' result against the host's span scan followed by
    today's _unstuff_plain with the bounds it gives: the stream, the
    offsets, K2's layout, the count found and the end."""
    end, rst, _stuff = bitstream.scan_entropy_span(raw, 0)
    lo = np.concatenate([[0], rst + 2]).astype(np.int64)
    hi = np.concatenate([rst, [end]]).astype(np.int64)
    want = entropy_cuda._unstuff_plain(*map(torch.from_numpy, (raw.copy(), lo, hi)))
    found, final = lo.shape[0], int(want.seg_off[-1])
    k = min(found, n_segs)
    ends = ends.numpy()
    np.testing.assert_array_equal(_defined(ends, n_segs), [*want.seg_off[:k].tolist(), final,
                                                           found, end])
    assert torch.equal(got.stream[: final + 8], want.stream[: final + 8])
    assert got.stream.numel() == raw.shape[0] + 8
    if found == n_segs:
        assert torch.equal(got.seg_off, want.seg_off)
        assert torch.equal(got.sub_base, want.sub_base)


@pytest.mark.parametrize("name", FIND_STREAMS)
def test_find_plain_matches_the_span_scan_and_unstuffing(name):
    raw, n_segs = _find_streams()[name]
    _assert_found(*entropy_cuda._find_plain(torch.from_numpy(raw.copy()), n_segs), raw, n_segs)


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("name", FIND_STREAMS)
def test_find_tiled_model_matches_plain(name, tile):
    """The tile schedule without bounds against the plain version: every
    entry K2u defines, the stream up to its tail, K2's layout where the
    count is the header's."""
    raw, n_segs = _find_streams()[name]
    t = torch.from_numpy(raw.copy())
    got, ends = entropy_cuda._find_tiled_plain(t, n_segs, tile)
    want, want_ends = entropy_cuda._find_plain(t, n_segs)
    np.testing.assert_array_equal(_defined(ends, n_segs), _defined(want_ends, n_segs))
    final = int(want_ends[n_segs]) + 8
    assert torch.equal(got.stream[:final], want.stream[:final])
    if int(want_ends[n_segs + 1]) == n_segs:
        assert torch.equal(got.sub_base, want.sub_base)
    _assert_found(got, ends, raw, n_segs)
