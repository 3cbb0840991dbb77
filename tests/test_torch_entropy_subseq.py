"""K2's schedule and K2u on the CPU (jpeg_decoder_tpu_torch/ops/
entropy_cuda.py): the model of the kernel's passes over subsequences
(`_decode_segments_subseq_plain`: pass 1 from guessed states, the rounds of
pass 2, the prefix sum, the write pass, the DC sums) against the plain
lockstep version and against the oracle planes -- the JAX package's own
reference for its Pallas kernel -- bitwise, at subsequence sizes that force
data units across several subsequences and many rounds; and the plain K2u
(`_unstuff_plain`) against the host's per-segment unstuffing (`pack_scan`).
Inputs come from numpy seeds. Tolerance: none, everything is integer."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from jpeg_decoder_tpu.core import oracle
from jpeg_decoder_tpu.core.types import CoefficientPlanes
from jpeg_decoder_tpu.io.parser import parse as jparse
from jpeg_decoder_tpu.utils.config import EncodeConfig
from jpeg_decoder_tpu_torch import JpegEntropyError, JpegError, JpegTruncatedError, convert
from jpeg_decoder_tpu_torch.io.parser import parse
from jpeg_decoder_tpu_torch.ops import entropy_cuda

from jpeg_decoder_tpu_torch.benchmarks.inputs import DRI_FILES, PHOTOS_420, make_jpeg, photo_jpeg

from . import corpus
from .torch_crossing import block_boundary_case, dc_only_stream
from .test_12bit import _make_12bit_gray
from .test_torch_entropy import DAMAGED, _damaged, _rgb_stream

SIZES = [4, 8, 16, 128]


def _args(datas):
    structures = [parse(d) for d in datas]
    args, _host = entropy_cuda.launch_args(
        [entropy_cuda.prepare_scan(s, s.scans[0]) for s in structures], "cpu")
    return structures, args, args[1]


def _zeros(structures):
    return [convert.zero_planes(s.frame, "cpu") for s in structures]


def _model_vs_plain(datas, sub_bytes):
    """The model and the plain version on one group: status and planes
    bitwise equal. Returns (structures, model planes, records)."""
    structures, args, _ = _args(datas)
    want, got = _zeros(structures), _zeros(structures)
    st_p = entropy_cuda._decode_segments_plain(*args, want)
    st_m, rec = entropy_cuda._decode_segments_subseq_plain(*args, got, sub_bytes=sub_bytes)
    assert torch.equal(st_m, st_p)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert torch.equal(a, b)
    return structures, got, rec


def _assert_oracle(data, planes):
    s = jparse(data)
    want = CoefficientPlanes(s.frame)
    for scan in s.scans:
        oracle.decode_sequential_scan(s, scan, want)
    for ci in range(s.frame.ncs):
        np.testing.assert_array_equal(planes[ci].numpy(), want.plane(ci))


#: gray, gray with edge blocks, 4:4:4, 4:2:2, 4:2:0, 4:2:0 with edge MCUs
BASELINE = [corpus.baseline_corpus()[i] for i in (0, 1, 3, 4, 5, 6)]


@pytest.mark.parametrize("sub_bytes", SIZES)
@pytest.mark.parametrize("name,data", BASELINE, ids=lambda v: v if isinstance(v, str) else "")
def test_model_matches_plain_and_oracle_baseline(name, data, sub_bytes):
    _, got, rec = _model_vs_plain([data], sub_bytes)
    _assert_oracle(data, got[0])
    if sub_bytes == 4:
        # a restart-free scan of many subsequences, data units across several
        assert len(rec["rec"]) > 50 and rec["rounds"] > 1


@pytest.mark.parametrize("sub_bytes", SIZES)
@pytest.mark.parametrize("name,dri,plain", corpus.dri_corpus(),
                         ids=lambda v: v if isinstance(v, str) else "")
def test_model_matches_plain_and_oracle_restart_segments(name, dri, plain, sub_bytes):
    structures, got, rec = _model_vs_plain([dri], sub_bytes)
    _assert_oracle(dri, got[0])
    n_segs = structures[0].scans[0].span.num_segments
    assert n_segs > 1 and len(rec["sub_base"]) == n_segs + 1


@pytest.mark.parametrize("sub_bytes", [8, 128])
@pytest.mark.parametrize("name,data,arr", corpus.exotic_sampling_corpus()[:3],
                         ids=lambda v: v if isinstance(v, str) else "")
def test_model_matches_plain_and_oracle_exotic_sampling(name, data, arr, sub_bytes):
    _, got, _ = _model_vs_plain([data], sub_bytes)
    _assert_oracle(data, got[0])


@pytest.mark.parametrize("sub_bytes", SIZES)
def test_model_matches_plain_12bit(sub_bytes):
    data = _make_12bit_gray(nb_y=4, nb_x=3, restart_interval=3)[0]
    _, got, _ = _model_vs_plain([data], sub_bytes)
    _assert_oracle(data, got[0])


@pytest.mark.parametrize("sub_bytes", [16, 128])
def test_model_segments_shorter_than_a_subsequence(sub_bytes):
    """13 x 25 one-MCU restart segments of a smooth image: most segments
    are a single subsequence, which is also their last."""
    from jpeg_decoder_tpu.models import encoder

    arr = np.clip(corpus._gradient(100, 200).astype(np.int32), 0, 255).astype(np.uint8)
    data = encoder.encode(arr, EncodeConfig(quality=50, subsampling="444", restart_interval=1))
    structures, got, rec = _model_vs_plain([data], sub_bytes)
    _assert_oracle(data, got[0])
    nsub = np.diff(rec["sub_base"])
    assert len(nsub) > 256 and (nsub == 1).mean() > 0.5


@pytest.mark.parametrize("sub_bytes", [8, 128])
def test_model_batch_of_unequal_geometry_in_one_group(sub_bytes):
    datas = [_rgb_stream(s, 48, 64, 2, 4) for s in range(2)]
    datas.append(_rgb_stream(3, 32, 96, 2, 4))
    structures, got, _ = _model_vs_plain(datas, sub_bytes)
    assert len({s.frame for s in structures}) == 2
    for d, planes in zip(datas, got):
        _assert_oracle(d, planes)


def test_model_records_are_a_chain():
    """What the card check compares: every subsequence's start state is its
    predecessor's end state, a segment's first starts at (0, 0, 0), the
    counts sum to the first data units, and the last thread of a segment
    ends at its data-unit total."""
    data = corpus.dri_corpus()[0][1]
    structures, _, rec = _model_vs_plain([data], 16)
    r, used, first, base = rec["rec"], rec["used"], rec["first_du"], rec["sub_base"]
    total_du = 2 * 4 * 6  # two MCU rows of a 64-wide 4:2:0 image
    for lo, hi in zip(base[:-1], base[1:]):
        assert used[lo] == 0 and first[lo] == 0
        for i in range(lo + 1, hi):
            assert used[i] == r[i - 1] & ~entropy_cuda._COUNT_MASK
            assert first[i] == first[i - 1] + ((r[i - 1] >> 16) & 0xFFFF)
        assert first[hi - 1] + ((r[hi - 1] >> 16) & 0xFFFF) >= total_du
    assert rec["changed"][-1] == 0 and len(rec["changed"]) == rec["rounds"]


@settings(max_examples=12, deadline=None)
@given(seed=st.integers(0, 2**31), quality=st.sampled_from([15, 60, 95]),
       sub=st.sampled_from(["444", "420", "422"]), ri=st.integers(0, 5),
       sub_bytes=st.sampled_from([4, 16, 128]))
def test_model_matches_plain_random_images(seed, quality, sub, ri, sub_bytes):
    """Sparse to dense data units (quality), with and without restart
    intervals, sizes that leave edge MCUs."""
    from jpeg_decoder_tpu.models import encoder

    rng = np.random.default_rng(seed)
    h, w = (int(x) for x in rng.integers(9, 50, 2))
    arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    data = encoder.encode(arr, EncodeConfig(quality=quality, subsampling=sub,
                                            restart_interval=ri))
    _, got, _ = _model_vs_plain([data], sub_bytes)
    _assert_oracle(data, got[0])


@pytest.mark.parametrize("sub_bytes", [16, 128])
def test_model_photograph_blocks_fall_into_step_sooner(sub_bytes):
    """The card check's two kinds of block (benchmarks/inputs.py): random
    dense ones, an end-of-block code in one of eight, and a photograph's, one
    in nine of ten, where a chain from a wrong start meets the true one
    within a few blocks."""
    rounds = {}
    for photo in (False, True):
        data = (photo_jpeg(PHOTOS_420[0], 160, 96, 10, shift=5) if photo
                else make_jpeg(160, 96, ((2, 2), (1, 1), (1, 1)), 10, 21))
        _, got, rec = _model_vs_plain([data], sub_bytes)
        _assert_oracle(data, got[0])
        rounds[photo] = rec["rounds"]
    assert rounds[True] < rounds[False]


@pytest.mark.parametrize("path", PHOTOS_420, ids=lambda p: p.stem)
def test_model_on_tiled_photographs(path):
    """Real blocks, with the photograph's own quantisation tables, at a size
    that leaves edge MCUs."""
    data = photo_jpeg(path, 200, 120, 6, shift=2)
    _, got, _ = _model_vs_plain([data], 128)
    _assert_oracle(data, got[0])


def test_model_on_a_foreign_encoders_restart_file():
    """A 4:2:2 file as libjpeg wrote it (its own Huffman tables' use, a
    restart marker every 7 MCUs): model, plain version and oracle agree."""
    data = DRI_FILES[1].read_bytes()
    _, got, rec = _model_vs_plain([data], 128)
    _assert_oracle(data, got[0])
    assert len(rec["sub_base"]) == 33 + 1 and len(rec["rec"]) > 33


# ---------------------------------------------------------------------------
# Damaged streams: same flags, same error class, a bad code before truncation
# ---------------------------------------------------------------------------


def _outcome(status, seg_off):
    try:
        entropy_cuda.check_status(status, seg_off)
    except JpegError as e:
        return type(e)
    return None


@pytest.mark.parametrize("sub_bytes", [8, 128])
@pytest.mark.parametrize("damage", sorted(DAMAGED))
def test_model_damaged_streams_match_plain(damage, sub_bytes):
    structures, args, seg_off = _args([_damaged(damage)])
    want, got = _zeros(structures), _zeros(structures)
    st_p = entropy_cuda._decode_segments_plain(*args, want)
    st_m, _ = entropy_cuda._decode_segments_subseq_plain(*args, got, sub_bytes=sub_bytes)
    assert torch.equal(st_m[:, 0], st_p[:, 0])           # the bad flags, always
    assert _outcome(st_m, seg_off) is _outcome(st_p, seg_off) is DAMAGED[damage]
    if not st_p[:, 0].any():
        assert torch.equal(st_m, st_p)
        for a, b in zip(got[0], want[0]):
            assert torch.equal(a, b)
    if damage == "ff_cut":  # a bad code in one segment, another ran out
        assert st_p[:, 0].any() and _outcome(st_m, seg_off) is JpegEntropyError
    if damage == "truncate":
        assert _outcome(st_m, seg_off) is JpegTruncatedError


# ---------------------------------------------------------------------------
# Hand-packed streams: DC at the extremes, stuffed bytes where they hurt
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sub_bytes", [4, 128])
def test_model_dc_sum_wraps_like_the_int32_predictor(sub_bytes):
    """Differences of +-32767 in a row: the predictor leaves int16 and the
    plain version stores the low 16 bits of its int32 sum; a sum modulo
    2^16 gives the same."""
    diffs = [32767, 32767, 32767, -5, -32767, -32767, -32767, -32767, 1, 0, 32767, 12]
    data = dc_only_stream(diffs, nb_x=4)
    _, got, _ = _model_vs_plain([data], sub_bytes)
    dc = got[0][0].reshape(-1, 64)[:, 0].numpy().astype(np.int64)
    want = ((np.cumsum(diffs) + 2**15) % 2**16) - 2**15
    np.testing.assert_array_equal(dc, want)
    assert (np.abs(np.cumsum(diffs)) > 2**15).any()


def test_model_eob_and_zrl_at_a_boundary():
    """Sparse blocks (quality 10): many EOBs and ZRLs; at 4 bytes a
    subsequence a boundary falls on some of them."""
    data = corpus.baseline_corpus()[8][1]  # rgb420_q10
    _, got, rec = _model_vs_plain([data], 4)
    _assert_oracle(data, got[0])
    assert ((rec["rec"] >> 6) & 63 == 0).any()   # a subsequence ended on a data unit's end


# ---------------------------------------------------------------------------
# K2u's plain version against the host's unstuffing
# ---------------------------------------------------------------------------


def assert_unstuffed(got, raw, stream, seg_off):
    """unstuff_segments' contract: the n_raw + 8 byte buffer begins with
    the host's stream (segments and 8 zero bytes; the plain version's are
    zeros past it), seg_off is the host's, sub_base K2's layout of it."""
    assert got.stream.numel() == raw.numel() + 8
    np.testing.assert_array_equal(got.stream.numpy()[: len(stream)], stream)
    assert not got.stream.numpy()[len(stream):].any()
    np.testing.assert_array_equal(got.seg_off.numpy(), seg_off)
    np.testing.assert_array_equal(got.sub_base.numpy(), entropy_cuda.sub_layout(seg_off))


def _assert_unstuff_matches_pack_scan(data):
    s = parse(data)
    scan = s.scans[0]
    pack = entropy_cuda.prepare_scan(s, scan)
    _ri, stream, seg_off = entropy_cuda.pack_scan(s, scan, pack.total_mcus, pack.units.shape[0])
    raw, lo, hi, *_ = entropy_cuda.to_device(entropy_cuda.host_args([pack]), "cpu")
    assert_unstuffed(entropy_cuda.unstuff_segments(raw, lo, hi), raw, stream, seg_off)
    return raw, stream


@pytest.mark.parametrize("name,dri,plain", corpus.dri_corpus(),
                         ids=lambda v: v if isinstance(v, str) else "")
def test_unstuff_plain_matches_pack_scan(name, dri, plain):
    for data in (dri, plain):
        _assert_unstuff_matches_pack_scan(data)


@pytest.mark.parametrize("restart_interval", [0, 1, 3])
def test_unstuff_plain_many_stuffed_pairs(restart_interval):
    """DC differences of 15 one-bits: a stuffed pair in almost every data
    unit, in one segment, in three and in twelve (pairs at segment starts,
    ends, back to back and across block boundaries: block_boundary_case)."""
    diffs = [32767, 32767, -1, 255, 32767, 1, 32767, 32767, 32767, 127, 2047, 32767]
    data = dc_only_stream(diffs, nb_x=4, restart_interval=restart_interval)
    raw, stream = _assert_unstuff_matches_pack_scan(data)
    n_markers = 0 if not restart_interval else -(-len(diffs) // restart_interval) - 1
    pairs = raw.numpy().tobytes().count(b"\xff\x00")
    assert pairs >= 6 and len(stream) - 8 == len(raw) - pairs - 2 * n_markers
    _model_vs_plain([data], 4)


def test_unstuff_plain_batch_and_an_empty_last_segment():
    """Two images in one group: the second image's bounds follow the first
    image's bytes; an image whose last segment is empty (the scan ends on a
    restart marker) starts its successor's first segment at the same byte."""
    good = dc_only_stream([5, -3, 32767, 9], nb_x=2, restart_interval=2)
    s = parse(good)
    span = s.scans[0].span
    # the same stream with its last segment cut away: ... RSTn | EOI
    cut = good[: span.restart_offsets[-1] + 2] + good[span.end:]
    packs = []
    for data in (cut, good):
        s = parse(data)
        key, total, units, tabs = convert.group_key(s.frame, s.scans[0])
        sp = s.scans[0].span
        packs.append(entropy_cuda.ScanPack(
            key, 2, total, units, tabs, s.data[sp.start : sp.end],
            sp.segment_bounds_flat().reshape(-1, 2) - sp.start))
    raw, lo, hi, *_ = entropy_cuda.to_device(entropy_cuda.host_args(packs), "cpu")
    assert lo[1] == hi[1] == lo[2]            # empty segment, shared start
    got = entropy_cuda.unstuff_segments(raw, lo, hi)
    want = [entropy_cuda.bsio.unstuff(raw.numpy(), int(a), int(b))[0]
            for a, b in zip(lo, hi)]
    assert_unstuffed(got, raw, np.concatenate(want + [np.zeros(8, np.uint8)]),
                     np.concatenate([[0], np.cumsum([len(x) for x in want])]))


def test_raw_bytes_go_to_the_device_from_where_they_lie():
    """host_args hands on views of each file's bytes (no concatenation on
    the host); to_device lays them back to back, where `lo` and `hi` expect
    them."""
    datas = [dc_only_stream([5, -3, 32767, 9], nb_x=2, restart_interval=2),
             dc_only_stream([1, 2, -32767, 4], nb_x=2, restart_interval=2)]
    structures = [parse(d) for d in datas]
    packs = [entropy_cuda.prepare_scan(s, s.scans[0]) for s in structures]
    raws, lo, hi, *_ = host = entropy_cuda.host_args(packs)
    for r, s in zip(raws, structures):
        assert np.shares_memory(r, s.data)
    raw = entropy_cuda.to_device(host, "cpu")[0]
    np.testing.assert_array_equal(raw.numpy(), np.concatenate(raws))
    assert int(hi[-1]) <= raw.numel() and int(lo[len(lo) // 2]) >= len(raws[0])
    one = entropy_cuda.to_device(entropy_cuda.host_args(packs[:1]), "cpu")[0]
    np.testing.assert_array_equal(one.numpy(), raws[0])


def test_unstuff_plain_pair_across_a_4096_byte_block():
    """K2u's kernel works in blocks of 4096 bytes and chunks of 16: stuffed
    pairs are placed across both kinds of boundary (the plain version has
    no blocks; the card test runs the same bytes through the kernel)."""
    raw, lo, hi, want_stream, want_off = block_boundary_case()
    raw = torch.from_numpy(raw)
    got = entropy_cuda.unstuff_segments(raw, torch.from_numpy(lo), torch.from_numpy(hi))
    assert_unstuffed(got, raw, want_stream, want_off)


#: 4-component streams with restart markers: 4:4:4 (4 data units an MCU)
#: and 10 units an MCU, the most JPEG allows; K2's record holds the unit in
#: 4 bits (entropy_cuda._COUNT_MASK), so both fit.
FOUR = [("cmyk_444", make_jpeg(40, 24, ((1, 1),) * 4, 2, 41, 0)),
        ("ycck_10_units", make_jpeg(48, 32, ((2, 2), (1, 1), (1, 1), (2, 2)), 1, 42, 2))]


@pytest.mark.parametrize("sub_bytes", SIZES)
@pytest.mark.parametrize("name,data", FOUR, ids=lambda v: v if isinstance(v, str) else "")
def test_model_matches_plain_and_oracle_four_components(name, data, sub_bytes):
    structures, planes, _ = _model_vs_plain([data], sub_bytes)
    assert structures[0].frame.ncs == 4
    _assert_oracle(data, planes[0])
