"""The port's CUDA kernels (K0, K03, K1, K13, K2, K2u, K3, K3f, K3c, K4, K5, K6n, K6f, K6h
and the probes PK1-PK7) against their plain PyTorch versions, and the decode, batch, encode,
streamed, striped and one-rank mesh paths on the card against the same paths on the CPU or
the card's whole-image decode. Bitwise, except FLOAT32 (K1, K13) and the scaled IDCT
(K5): within 1 of the plain version on at most 1e-3 of the pixels (the two sum the
products in other orders; K5 bitwise at k = 1, one term), and so within 3 in RGB (a
chroma step of 1 moves R or B by up to 1.772); K13 is bitwise equal to K1 x 3 + K3,
which sum in the same order.

This file imports neither JAX, nor the JAX package jpeg_decoder_tpu, nor
Pillow, so that it runs on a machine with a card and without them:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

(--noconftest because tests/conftest.py imports JAX.) Without a card every
test here skips. Inputs are random coefficients made from a numpy seed and
packed by the native runtime (benchmarks.inputs.make_jpeg), and two files
of the test corpus that a foreign encoder wrote with restart markers.
"""

import numpy as np
import pytest
import torch

import jpeg_decoder_tpu_torch as jtt
from jpeg_decoder_tpu_torch import (
    DecodeConfig,
    EntropyBackend,
    IdctPrecision,
    JpegError,
    Quirks,
    _build,
    convert,
)
from jpeg_decoder_tpu_torch.benchmarks.inputs import DRI_FILES, make_jpeg, photo_jpeg
from jpeg_decoder_tpu_torch.models import host as thost
from jpeg_decoder_tpu_torch.ops import color as tcolor
from jpeg_decoder_tpu_torch.ops import entropy_cuda
from jpeg_decoder_tpu_torch.io.parser import parse
from jpeg_decoder_tpu_torch.ops import idct as tidct
from jpeg_decoder_tpu_torch.ops import pixel as tpixel
from jpeg_decoder_tpu_torch.ops import probes
from jpeg_decoder_tpu_torch.core import types as ttypes
from jpeg_decoder_tpu_torch.io.markers import Encoding
from jpeg_decoder_tpu_torch.models import decoder as tdecoder
from jpeg_decoder_tpu_torch.models import encoder as tenc
from jpeg_decoder_tpu_torch.ops import fdct as tfdct
from jpeg_decoder_tpu_torch.parallel import stripes as tstripes
from jpeg_decoder_tpu_torch.utils import jax_free
from jpeg_decoder_tpu_torch.utils.metrics import GLOBAL_METRICS, StageStat

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

pytestmark = pytest.mark.cuda

F420 = ((2, 2), (1, 1), (1, 1))
F444 = ((1, 1), (1, 1), (1, 1))
GRAY = ((1, 1),)
QUIRKS = [Quirks.REFERENCE, Quirks.CORRECT]
PALLAS = DecodeConfig(entropy_backend=EntropyBackend.PALLAS)
BACKENDS = [EntropyBackend.PALLAS, EntropyBackend.NATIVE]
PRECISIONS = list(IdctPrecision)

#: (w, h, sampling, restart interval, seed): a DRI 4:2:0 stream, one
#: segment per MCU, a restart-free gray stream whose width is not a
#: multiple of 8, ...
STREAMS = {
    "420_ri4": (64, 48, F420, 4, 1),
    "444_ri1": (40, 24, F444, 1, 2),
    "gray_no_ri": (100, 37, GRAY, 0, 3),
    "420_ri5_edges": (150, 90, F420, 5, 4),
    "422_ri3": (72, 40, ((2, 1), (1, 1), (1, 1)), 3, 5),
}


DAMAGES = ["truncate", "corrupt8", "corrupt40", "ff", "ff_cut", "cut"]


@pytest.fixture
def cuda_device():
    """Decided when the test runs, never while the module is imported."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: compares a kernel with its plain version")
    return torch.device("cuda")


def _stream(name):
    return make_jpeg(*STREAMS[name])


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_k2_matches_plain(cuda_device, name):
    s = parse(_stream(name))
    args, host = entropy_cuda.launch_args(
        [entropy_cuda.prepare_scan(s, s.scans[0])], cuda_device)
    got = convert.zero_planes(s.frame, cuda_device)
    want = convert.zero_planes(s.frame, cuda_device)
    st_k = entropy_cuda.decode_segments(*args, [got], host=host)
    st_p = entropy_cuda._decode_segments_plain(*args, [want])
    torch.cuda.synchronize()
    assert torch.equal(st_k.cpu(), st_p.cpu())
    entropy_cuda.check_status(st_k, args[1])
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b.cpu())


def _photo_streams():
    """The corpus's two files with restart markers as a foreign encoder wrote
    them (4:2:0 with a marker per MCU row, 4:2:2 with one every 7 MCUs), and
    the first one's coefficients tiled to 800x600 with a marker per row."""
    return {"china_420_file": DRI_FILES[0].read_bytes(),
            "flower_422_file": DRI_FILES[1].read_bytes(),
            "china_420_tiled": photo_jpeg(DRI_FILES[0], 800, 600, 50, shift=3)}


@pytest.mark.parametrize("name", ["china_420_file", "flower_422_file", "china_420_tiled"])
def test_k2_on_photographs_matches_plain_and_native(cuda_device, name):
    """Real blocks (an end-of-block code in nine of ten): status and planes
    against the plain version, planes against the native host decoder."""
    data = _photo_streams()[name]
    s = parse(data)
    args, host = entropy_cuda.launch_args(
        [entropy_cuda.prepare_scan(s, s.scans[0])], cuda_device)
    got = convert.zero_planes(s.frame, cuda_device)
    want = convert.zero_planes(s.frame, cuda_device)
    st_k = entropy_cuda.decode_segments(*args, [got], host=host)
    st_p = entropy_cuda._decode_segments_plain(*args, [want])
    assert torch.equal(st_k.cpu(), st_p.cpu())
    entropy_cuda.check_status(st_k, args[1])
    _, native, _ = thost.host_decode(data, DecodeConfig())
    for a, b, c in zip(got, want, native.planes):
        assert torch.equal(a.cpu(), b.cpu()) and torch.equal(a.cpu(), torch.from_numpy(c))


def test_k2_batch_matches_plain_and_single_launches(cuda_device):
    """Forty images (more than one 32-thread block of segments) of two
    geometries in one launch: against the plain version on the same
    inputs, and against forty single-image launches."""
    datas = [make_jpeg(32, 32, F420, 1, 100 + i) for i in range(20)]
    datas += [make_jpeg(48, 16, F420, 1, 200 + i) for i in range(20)]
    structures = [parse(d) for d in datas]
    packs = [entropy_cuda.prepare_scan(s, s.scans[0]) for s in structures]
    args, host = entropy_cuda.launch_args(packs, cuda_device)
    got = [convert.zero_planes(s.frame, cuda_device) for s in structures]
    want = [convert.zero_planes(s.frame, cuda_device) for s in structures]
    _build.LAUNCHES.clear()
    st_k = entropy_cuda.decode_segments(*args, got, host=host)
    assert _build.LAUNCHES["jdtc_entropy_decode"] == 1
    st_p = entropy_cuda._decode_segments_plain(*args, want)
    torch.cuda.synchronize()
    assert torch.equal(st_k.cpu(), st_p.cpu())
    entropy_cuda.check_status(st_k, args[1])
    for s, g, w in zip(structures, got, want):
        single = convert.zero_planes(s.frame, cuda_device)
        entropy_cuda.decode_scan(s, s.scans[0], single)
        for a, b, c in zip(g, w, single):
            assert torch.equal(a.cpu(), b.cpu()) and torch.equal(a.cpu(), c.cpu())


def _batch_outcome(structures, device):
    try:
        results = entropy_cuda.entropy_decode_batch(
            structures, PALLAS, [convert.zero_planes(s.frame, device) for s in structures])
    except JpegError as e:
        return type(e)
    return [[p.cpu() for p in planes] for planes, _ in results]


@pytest.mark.parametrize("damage", DAMAGES)
def test_k2_batch_with_damaged_member_matches_plain(cuda_device, damage):
    """A damaged member among good ones raises the same error class on the
    card as on the CPU, or the batch decodes to the same planes."""
    structures = [parse(_stream("420_ri4")), parse(_damaged(damage)),
                  parse(_stream("gray_no_ri"))]
    got = _batch_outcome(structures, cuda_device)
    want = _batch_outcome(structures, "cpu")
    if isinstance(want, list):
        assert isinstance(got, list)
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                assert torch.equal(a, b)
    else:
        assert got is want
    if damage == "truncate":
        assert want is jtt.JpegTruncatedError


def _decode_planes_or_error(s, device):
    try:
        planes, _ = entropy_cuda.entropy_decode(
            s, PALLAS, convert.zero_planes(s.frame, device))
    except JpegError as e:
        return type(e)
    return [p.cpu() for p in planes]


def _damaged(damage):
    """A restart-free stream cut short (the EOI kept, so parse() succeeds);
    16 garbage bytes at an offset into a DRI stream's entropy data; "ff":
    eight stuffed 0xFF00 pairs there, 64 one-bits that no code matches;
    "ff_cut": that, and the last restart segment cut in half, so one
    segment has a bad code and another runs out; "cut": only the cut."""
    if damage == "truncate":
        data = _stream("gray_no_ri")
        span = parse(data).scans[0].span
        return data[: span.start + (span.end - span.start) // 2] + data[span.end:]
    data = bytearray(_stream("420_ri4"))
    span = parse(bytes(data)).scans[0].span
    if damage.startswith("corrupt"):
        off = span.start + int(damage[len("corrupt"):])
        data[off : off + 16] = b"\xA5" * 16
    if damage.startswith("ff"):
        data[span.start + 8 : span.start + 24] = b"\xff\x00" * 8
    if damage.endswith("cut"):
        lo, hi = list(span.segment_bounds())[-1]
        data = data[: lo + (hi - lo) // 2] + data[span.end:]
    return bytes(data)


@pytest.mark.parametrize("damage", DAMAGES)
def test_k2_errors_match_plain(cuda_device, damage):
    """A damaged stream raises the same error class on the card as on the
    CPU, or decodes to the same planes."""
    s = parse(_damaged(damage))
    got = _decode_planes_or_error(s, cuda_device)
    want = _decode_planes_or_error(s, "cpu")
    if isinstance(want, list):
        assert isinstance(got, list)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    else:
        assert got is want
    if damage in ("truncate", "cut"):
        assert want is jtt.JpegTruncatedError
    if damage.startswith("ff"):
        assert want is jtt.JpegEntropyError


def _group(datas, device):
    structures = [parse(d) for d in datas]
    packs = [entropy_cuda.prepare_scan(s, s.scans[0]) for s in structures]
    return structures, packs, entropy_cuda.launch_args(packs, device)


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_k2_records_match_the_model(cuda_device, name):
    """The kernel's per-subsequence records (end states and counts, the
    states decoded from, first data units) against the schedule's model on
    the CPU: the fixed point is one, however the blocks raced to it."""
    structures, packs, (args, host) = _group([_stream(name)], cuda_device)
    got = [convert.zero_planes(structures[0].frame, cuda_device)]
    rec = {}
    status = entropy_cuda.decode_segments(*args, got, records=rec, host=host)
    cpu_args, _ = entropy_cuda.launch_args(packs, "cpu")
    want = [convert.zero_planes(structures[0].frame, "cpu")]
    st_m, model = entropy_cuda._decode_segments_subseq_plain(*cpu_args, want)
    assert torch.equal(status.cpu(), st_m)
    for key in ("rec", "used", "first_du"):
        np.testing.assert_array_equal(rec[key].cpu().numpy().astype(np.int64), model[key])
    np.testing.assert_array_equal(rec["sub_base"], model["sub_base"])
    assert 1 <= rec["rounds"] <= model["rounds"] + 1
    assert len(rec["pass_ms"]) == 5 and all(t >= 0 for t in rec["pass_ms"])
    for a, b in zip(got[0], want[0]):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("seed", range(6))
def test_k2_matches_plain_random_shapes(cuda_device, seed):
    """Sizes that leave edge MCUs, several samplings and restart intervals,
    two images of other geometry in one launch; the wrapper without the
    host's copies of its arguments (it reads them back from the card)."""
    rng = np.random.default_rng(seed)
    factors = [F420, F444, GRAY, ((2, 1), (1, 1), (1, 1))][seed % 4]
    ri = int(rng.integers(1, 7))
    datas = [make_jpeg(int(rng.integers(9, 120)), int(rng.integers(9, 90)), factors, ri,
                       1000 + 10 * seed + i) for i in range(2)]
    structures, _, (args, host) = _group(datas, cuda_device)
    got = [convert.zero_planes(s.frame, cuda_device) for s in structures]
    want = [convert.zero_planes(s.frame, cuda_device) for s in structures]
    st_k = entropy_cuda.decode_segments(*args, got)
    st_p = entropy_cuda._decode_segments_plain(*args, want)
    assert torch.equal(st_k.cpu(), st_p.cpu())
    entropy_cuda.check_status(st_k, args[1])
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert torch.equal(a.cpu(), b.cpu())


def test_k2_dc_sum_wraps_like_the_int32_predictor(cuda_device):
    diffs = [32767, 32767, 32767, -5, -32767, -32767, -32767, -32767, 1, 0, 32767, 12]
    structures, _, (args, _host) = _group([dc_only_stream(diffs, nb_x=4)], cuda_device)
    got = [convert.zero_planes(structures[0].frame, cuda_device)]
    want = [convert.zero_planes(structures[0].frame, cuda_device)]
    st_k = entropy_cuda.decode_segments(*args, got)
    st_p = entropy_cuda._decode_segments_plain(*args, want)
    assert torch.equal(st_k.cpu(), st_p.cpu())
    assert torch.equal(got[0][0].cpu(), want[0][0].cpu())
    dc = got[0][0].reshape(-1, 64)[:, 0].cpu().numpy().astype(np.int64)
    np.testing.assert_array_equal(dc, ((np.cumsum(diffs) + 2**15) % 2**16) - 2**15)


# ---------------------------------------------------------------------------
# K2 on the DEVICE route: whole segments, no lane guard
# ---------------------------------------------------------------------------

DEVICE = DecodeConfig(entropy_backend=EntropyBackend.DEVICE)

#: Streams the PALLAS route refuses: restart-free gray of 17 x 16 MCUs (dense
#: blocks), and a gray gradient in two segments of 4100 MCUs (ri * P > 4096;
#: each segment two chunks of the dc pass).
DEVICE_STREAMS = {
    "restart_free_272": (136, 128, GRAY, 0, 6),
    "two_long_segments": (800, 656, GRAY, 4100, 7),
}


def _device_stream(name):
    w, h, factors, ri, seed = DEVICE_STREAMS[name]
    return make_jpeg(w, h, factors, ri, seed, gradient=name == "two_long_segments")


def _device_args(data, device):
    s = parse(data)
    pack = entropy_cuda.prepare_scan(s, s.scans[0], entropy_cuda.check_scan_device)
    return s, pack, entropy_cuda.launch_args([pack], device)


@pytest.mark.parametrize("name", sorted(DEVICE_STREAMS))
def test_k2_device_route_matches_plain(cuda_device, name):
    """K2 on whole segments against the plain lockstep loop on the card, and
    its records against the schedule's model on the CPU."""
    s, pack, (args, host) = _device_args(_device_stream(name), cuda_device)
    with pytest.raises(JpegError):
        entropy_cuda.prepare_scan(s, s.scans[0])  # the PALLAS guards
    got = convert.zero_planes(s.frame, cuda_device)
    want = convert.zero_planes(s.frame, cuda_device)
    rec = {}
    _build.LAUNCHES.clear()
    st_k = entropy_cuda.decode_segments(*args, [got], records=rec, host=host, count_as="K2d")
    assert dict(_build.LAUNCHES) == {"K2d": 1}
    st_p = entropy_cuda._decode_segments_plain(*args, [want])
    assert torch.equal(st_k.cpu(), st_p.cpu())
    entropy_cuda.check_status(st_k, args[1])
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b.cpu())
    cpu_args, _ = entropy_cuda.launch_args([pack], "cpu")
    model_planes = convert.zero_planes(s.frame, "cpu")
    st_m, model = entropy_cuda._decode_segments_subseq_plain(*cpu_args, [model_planes])
    assert torch.equal(st_k.cpu(), st_m)
    for key in ("rec", "used", "first_du"):
        np.testing.assert_array_equal(rec[key].cpu().numpy().astype(np.int64), model[key])
    assert 1 <= rec["rounds"] <= model["rounds"] + 1


@pytest.mark.parametrize("name", sorted(DEVICE_STREAMS))
def test_k2_pass2_steps_counter_is_the_records_steps(cuda_device, name):
    """The k2_pass2_steps counter (GLOBAL_METRICS) counts one call a K2
    launch and adds the steps of pass 2 that K2's records give for it."""
    s, _pack, (args, host) = _device_args(_device_stream(name), cuda_device)
    planes = convert.zero_planes(s.frame, cuda_device)
    before = GLOBAL_METRICS.stages.get("k2_pass2_steps", StageStat())
    calls, items, secs = before.calls, before.total_items, before.total_s
    rec = {}
    entropy_cuda.decode_segments(*args, [planes], records=rec, host=host, count_as="K2d")
    st = GLOBAL_METRICS.stages["k2_pass2_steps"]
    assert (st.calls, st.total_items, st.total_s) == (calls + 1, items + rec["steps"], secs)


def test_k2_chunked_passes_over_a_long_segment_wrap_like_the_int32_predictor(cuda_device):
    """One restart-free segment of 150,000 DC-only blocks (about 375 KB: two
    chunks of the scan pass, 37 of the dc pass) whose differences wrap the
    predictor: every DC the closed form, (cumsum + 2^15) mod 2^16 - 2^15."""
    rng = np.random.default_rng(11)
    diffs = rng.integers(-32767, 32768, 150_000).tolist()
    s, _pack, (args, host) = _device_args(dc_only_stream(diffs, nb_x=500), cuda_device)
    got = convert.zero_planes(s.frame, cuda_device)
    rec = {}
    status = entropy_cuda.decode_segments(*args, [got], records=rec, host=host)
    entropy_cuda.check_status(status, args[1])
    n_subs = int(rec["sub_base"][-1])
    assert n_subs > entropy_cuda.SCAN_CHUNK
    first = rec["first_du"].cpu().numpy().astype(np.int64)
    counts = (rec["rec"].cpu().numpy().astype(np.int64) >> 16) & 0xFFFF
    np.testing.assert_array_equal(first, np.concatenate([[0], np.cumsum(counts)[:-1]]))
    dc = got[0].reshape(-1, 64)[:, 0].cpu().numpy().astype(np.int64)
    np.testing.assert_array_equal(dc, ((np.cumsum(diffs) + 2**15) % 2**16) - 2**15)


def _first_du_of_counts(rec) -> np.ndarray:
    """Each subsequence's first data unit as the scan pass must give it: the
    exclusive prefix sum of the records' data-unit counts within each
    segment (sub_base)."""
    counts = (rec["rec"].cpu().numpy().astype(np.int64) >> 16) & 0xFFFF
    sub_base = np.asarray(rec["sub_base"], dtype=np.int64)
    return np.concatenate([np.concatenate([[0], np.cumsum(counts[a:b])[:-1]])
                           for a, b in zip(sub_base[:-1], sub_base[1:])])


@pytest.mark.parametrize("name", ["420_ri4", "420_ri5_edges", "444_ri1", "dc_only_restart_free"])
def test_k2_chunked_scan_and_dc_passes_match_plain_and_the_model(cuda_device, name):
    """The scan and dc passes as the wrapper picks them (the dc pass in
    chunks; the scan pass in chunks where a segment holds more than one
    chunk of records): on DRI streams the status and planes bitwise the
    plain version's (decode_segments on CPU tensors); on one restart-free
    segment of 120,000 DC-only blocks (2,285 subsequences: two chunks of
    records) every DC the closed form of the cumulative differences. On
    both, the first data units the cumulative record counts."""
    if name == "dc_only_restart_free":
        diffs = np.random.default_rng(12).integers(-32767, 32768, 120_000).tolist()
        structures = [parse(dc_only_stream(diffs, nb_x=400))]
        packs = [entropy_cuda.prepare_scan(structures[0], structures[0].scans[0],
                                           entropy_cuda.check_scan_device)]
        args, host = entropy_cuda.launch_args(packs, cuda_device)
    else:
        structures, packs, (args, host) = _group([_stream(name)], cuda_device)
    planes = convert.zero_planes(structures[0].frame, cuda_device)
    rec = {}
    status = entropy_cuda.decode_segments(*args, [planes], records=rec, host=host)
    entropy_cuda.check_status(status, args[1])
    np.testing.assert_array_equal(rec["first_du"].cpu().numpy().astype(np.int64),
                                  _first_du_of_counts(rec))
    if name == "dc_only_restart_free":
        assert int(rec["sub_base"][-1]) > entropy_cuda.SCAN_CHUNK
        dc = planes[0].reshape(-1, 64)[:, 0].cpu().numpy().astype(np.int64)
        np.testing.assert_array_equal(dc, ((np.cumsum(diffs) + 2**15) % 2**16) - 2**15)
        return
    cpu_args, cpu_host = entropy_cuda.launch_args(packs, "cpu")
    want = convert.zero_planes(structures[0].frame, "cpu")
    st_p = entropy_cuda.decode_segments(*cpu_args, [want], host=cpu_host)
    assert torch.equal(status.cpu(), st_p)
    for a, b in zip(planes, want):
        assert torch.equal(a.cpu(), b)


def test_device_backend_at_4k_matches_native(cuda_device):
    """A restart-free 3840x2160 4:2:0 stream (one segment of about 63,000
    subsequences) through JpegDecoder(DEVICE): planes and RGB bitwise the
    NATIVE decode on the card; one K2u and one K2d launch."""
    data = make_jpeg(3840, 2160, F420, 0, 20261016)
    _build.LAUNCHES.clear()
    got = jtt.JpegDecoder(DEVICE, device=cuda_device).decode(data)
    launches = dict(_build.LAUNCHES)
    want = jtt.JpegDecoder(DecodeConfig(), device=cuda_device).decode(data)
    np.testing.assert_array_equal(got.rgb, want.rgb)
    for a, b in zip(got.planes, want.planes):
        np.testing.assert_array_equal(a, b)
    assert launches["K2d"] == 1 and launches["jdtc_unstuff"] == 1
    assert "jdtc_entropy_decode" not in launches


@pytest.mark.parametrize("case", ["restart_free_272", "several_scans", "12bit"])
def test_device_decode_on_cuda_matches_cpu(cuda_device, case):
    from jpeg_decoder_tpu_torch.benchmarks.inputs import multiscan_jpeg

    data = {"restart_free_272": lambda: _device_stream("restart_free_272"),
            "several_scans": lambda: multiscan_jpeg(150, 90, F420, 3, gradient=True),
            "12bit": lambda: make_jpeg(100, 37, GRAY, 0, 9, precision=12)}[case]()
    got = jtt.decode(data, DEVICE, device=cuda_device)
    want = jtt.decode(data, DEVICE, device="cpu")
    np.testing.assert_array_equal(got.rgb, want.rgb)
    for a, b in zip(got.planes, want.planes):
        np.testing.assert_array_equal(a, b)
    native = jtt.decode(data, DecodeConfig(), device="cpu")
    np.testing.assert_array_equal(got.rgb, native.rgb)


def test_device_batch_decoder_on_cuda_matches_cpu(cuda_device):
    """BatchDecoder(DEVICE): its members one image at a time, on the card
    as on the CPU."""
    datas = [make_jpeg(136, 128, GRAY, 0, 20 + i) for i in range(3)]
    many = [datas[0], _stream("420_ri4"), datas[1]]
    card = jtt.BatchDecoder(DEVICE, device=cuda_device)
    cpu = jtt.BatchDecoder(DEVICE, device="cpu")
    np.testing.assert_array_equal(card.decode_batch(datas), cpu.decode_batch(datas))
    for a, b in zip(card.decode_many(many), cpu.decode_many(many)):
        np.testing.assert_array_equal(a, b)



def test_decode_rgb_reads_back_into_pinned_memory(cuda_device):
    """JpegDecoder(DEVICE).decode_rgb returns its RGB in pinned host memory,
    bitwise decode's, and counts readback_pinned_pct 100 and readback_mb
    the RGB's bytes a request; decode's RGB stays pageable and counts 0.
    An output the caller holds while three more frames of its size are
    decoded (their outputs dropped, so the caching host allocator hands
    their blocks round) stays as it was."""
    datas = [make_jpeg(1280, 720, F420, 0, 40 + i) for i in range(4)]
    dec = jtt.JpegDecoder(DEVICE, device=cuda_device)
    names = ("readback_mb", "readback_pinned_pct")
    before = {k: GLOBAL_METRICS.stages.get(k, StageStat()) for k in names}
    before = {k: (st.calls, st.total_items) for k, st in before.items()}
    held = dec.decode_rgb(datas[0])
    kept = held.copy()
    assert torch.from_numpy(held).is_pinned()
    for data in datas[1:]:
        out = dec.decode_rgb(data)
        assert torch.from_numpy(out).is_pinned() and not np.array_equal(out, kept)
        del out
    np.testing.assert_array_equal(held, kept)
    img = dec.decode(datas[0])
    assert not torch.from_numpy(img.rgb).is_pinned()
    np.testing.assert_array_equal(held, img.rgb)
    got = {k: (GLOBAL_METRICS.stages[k].calls - before[k][0],
               GLOBAL_METRICS.stages[k].total_items - before[k][1]) for k in names}
    assert got["readback_pinned_pct"] == (5, pytest.approx(400.0))
    mb = (5 * held.nbytes + sum(p.nbytes for p in img.planes)) / 1e6
    assert got["readback_mb"] == (5, pytest.approx(mb))


def test_decode_rgb_pins_within_its_budget(cuda_device, monkeypatch):
    """With room for two 720p outputs' blocks (4 MiB each), two held
    outputs are pinned and a third is pageable (readback_pinned_pct 0),
    as a gigapixel frame past the budget is; dropping one gives its block
    back to the next request, and dropping all gives the budget back
    whole. Every output is bitwise decode's."""
    import gc

    from jpeg_decoder_tpu_torch import convert

    datas = [make_jpeg(1280, 720, F420, 0, 50 + i) for i in range(4)]
    dec = jtt.JpegDecoder(DEVICE, device=cuda_device)
    want = [dec.decode(d).rgb for d in datas]
    gc.collect()  # outputs earlier tests left in cycles give their bytes back now
    start = convert._pinned_held
    monkeypatch.setattr(convert, "PINNED_BUDGET_BYTES", start + (8 << 20))
    pct = GLOBAL_METRICS.stages.get("readback_pinned_pct", StageStat())
    c0, n0 = pct.calls, pct.total_items
    outs = [dec.decode_rgb(d) for d in datas[:3]]
    assert [torch.from_numpy(o).is_pinned() for o in outs] == [True, True, False]
    assert convert._pinned_held == start + (8 << 20)
    pct = GLOBAL_METRICS.stages["readback_pinned_pct"]
    assert (pct.calls - c0, pct.total_items - n0) == (3, pytest.approx(200.0))
    del outs[0]
    outs.append(dec.decode_rgb(datas[3]))
    assert torch.from_numpy(outs[-1]).is_pinned()
    for o, w in zip(outs, want[1:]):
        np.testing.assert_array_equal(o, w)
    del outs, o
    assert convert._pinned_held == start


# ---------------------------------------------------------------------------
# K2u: unstuffing on the card
# ---------------------------------------------------------------------------


def _assert_k2u(raw, lo, hi, stream, seg_off, device):
    """One K2u call (one launch) against the plain version on the card and
    against the host's stream and offsets, bitwise: the first
    seg_off[-1] + 8 bytes of the n_raw + 8 byte buffer, the offsets, and
    K2's layout (sub_layout of the offsets)."""
    raw, lo, hi = (torch.as_tensor(np.ascontiguousarray(a)) for a in (raw, lo, hi))
    before = _build.LAUNCHES["jdtc_unstuff"]
    got = entropy_cuda.unstuff_segments(raw.to(device), lo.to(device), hi.to(device))
    assert _build.LAUNCHES["jdtc_unstuff"] == before + 1
    plain = entropy_cuda._unstuff_plain(raw.to(device), lo.to(device), hi.to(device))
    torch.cuda.synchronize()
    end = len(stream)
    assert got.stream.numel() == raw.numel() + 8
    assert torch.equal(got.stream[:end], plain.stream[:end])
    assert torch.equal(got.seg_off, plain.seg_off) and torch.equal(got.sub_base, plain.sub_base)
    np.testing.assert_array_equal(got.stream[:end].cpu().numpy(), stream)
    np.testing.assert_array_equal(got.seg_off.cpu().numpy(), seg_off)
    np.testing.assert_array_equal(got.sub_base.cpu().numpy(), entropy_cuda.sub_layout(seg_off))


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_k2u_matches_plain_and_the_host(cuda_device, name):
    s = parse(_stream(name))
    pack = entropy_cuda.prepare_scan(s, s.scans[0])
    _ri, stream, seg_off = entropy_cuda.pack_scan(
        s, s.scans[0], pack.total_mcus, pack.units.shape[0])
    raw, lo, hi, *_ = entropy_cuda.to_device(entropy_cuda.host_args([pack]), "cpu")
    _assert_k2u(raw, lo, hi, stream, seg_off, cuda_device)


def test_k2u_pairs_across_chunks_and_blocks(cuda_device):
    raw, lo, hi, stream, seg_off = block_boundary_case()
    _assert_k2u(torch.from_numpy(raw), torch.from_numpy(lo), torch.from_numpy(hi),
                stream, seg_off, cuda_device)


@pytest.mark.parametrize("restart_interval", [0, 1, 3])
def test_k2u_many_stuffed_pairs_then_k2(cuda_device, restart_interval):
    diffs = [32767, 32767, -1, 255, 32767, 1, 32767, 32767, 32767, 127, 2047, 32767]
    data = dc_only_stream(diffs, nb_x=4, restart_interval=restart_interval)
    s = parse(data)
    got = _decode_planes_or_error(s, cuda_device)
    want = _decode_planes_or_error(s, "cpu")
    assert isinstance(want, list)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_k2u_batch_with_an_empty_last_segment(cuda_device):
    """Two images in one call; the first ends on a restart marker, so its
    empty last segment and the second image's first start at one byte."""
    good = dc_only_stream([5, -3, 32767, 9], nb_x=2, restart_interval=2)
    span = parse(good).scans[0].span
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
    want = entropy_cuda.unstuff_segments(raw, lo, hi)
    end = int(want.seg_off[-1]) + 8
    _assert_k2u(raw, lo, hi, want.stream[:end].numpy(), want.seg_off.numpy(), cuda_device)


def _k2u_cut_cases():
    """Raw bytes cut where K2u's kernel cuts them: stuffed pairs across
    every edge of its 16-byte loads (a thread's 32 bytes), of a warp's 1024
    bytes and of its 4096-byte tiles; bounds at every position of a
    thread's bytes and near the edges of a warp and of a tile; empty
    segments, an empty last one, none, and a segment across several
    tiles."""
    cases = {f"pairs_every_{step}": pairs_across_edges(step) for step in (16, 1024, 4096)}
    for p in [*range(0, 72), *range(1000, 1048), *range(4048, 4096)]:
        cases[f"bound_at_{p}"] = bound_at(4096, p)
    for tile in (16, 4096):
        for i, case in enumerate(empty_segments(tile)):
            cases[f"empty_{tile}_{i}"] = case
    return cases


@pytest.mark.parametrize("name", ["pairs_every_16", "pairs_every_1024", "pairs_every_4096",
                                  "bound_at", "empty"])
def test_k2u_where_the_kernel_cuts(cuda_device, name):
    assert _build.library().jdtc_unstuff_tile_bytes() == 4096
    for key, (raw, lo, hi) in _k2u_cut_cases().items():
        if key.startswith(name):
            _assert_k2u(raw, lo, hi, *unstuffed_by_the_host(raw, lo, hi), cuda_device)


def test_k2u_eight_4k_images_in_one_call(cuda_device):
    """A batch group of eight dense 3840x2160 requests (1080 segments,
    65 MB of raw bytes: 15,800 tiles) in one call."""
    datas = [make_jpeg(3840, 2160, F420, 240, seed) for seed in range(8)]
    raw, lo, hi = scan_bytes(datas)
    _assert_k2u(raw, lo, hi, *unstuffed_by_the_host(raw, lo, hi), cuda_device)


def test_k2u_and_k2_read_nothing_back_before_k2(cuda_device):
    """No synchronisation from the raw bytes' upload to K2's first kernel:
    launch_args and K2's wrapper up to its launch run with PyTorch's sync
    debug mode set to raise (K2's own flag reads in pass 2, a C call, are
    not PyTorch's)."""
    structures, packs, _ = _group([make_jpeg(640, 352, F420, 40, 12)], cuda_device)
    got = [convert.zero_planes(structures[0].frame, cuda_device)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        args, host = entropy_cuda.launch_args(packs, cuda_device)
        status = entropy_cuda.decode_segments(*args, got, host=host)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    entropy_cuda.check_status(status, args[1])
    want = [convert.zero_planes(structures[0].frame, cuda_device)]
    st_p = entropy_cuda._decode_segments_plain(*args, want)
    assert torch.equal(status.cpu(), st_p.cpu())
    for a, b in zip(got[0], want[0]):
        assert torch.equal(a.cpu(), b.cpu())


# ---------------------------------------------------------------------------
# K2u without bounds, and a DEVICE request from its header alone
# ---------------------------------------------------------------------------


def _find_card_cases():
    """name -> (raw, n_segs): find_cases at the kernel's tile and at 16
    bytes (every edge inside one tile), the small streams, the corpus's
    files with markers and a photograph tiled, and two dense 4K requests
    (restart-free, and a marker per MCU row), from their first entropy
    byte to the end of the file."""
    cases = {f"{k}@{t}": v for t in (4096, 16) for k, v in find_cases(t).items()}
    cases.update({name: scan_to_end(_stream(name)) for name in STREAMS})
    cases.update({name: scan_to_end(d) for name, d in _photo_streams().items()})
    cases["4k_restart_free"] = scan_to_end(make_jpeg(3840, 2160, F420, 0, 20261016))
    cases["4k_dri"] = scan_to_end(make_jpeg(3840, 2160, F420, 240, 7))
    return cases


def test_k2u_without_bounds_matches_plain(cuda_device):
    """find_segments on the card (one jdtc_unstuff launch) against its plain
    version, bitwise: every entry of `ends` that the kernel defines, the
    stream up to its tail, and K2's layout where the count found is the
    header's."""
    assert _build.library().jdtc_unstuff_tile_bytes() == 4096
    for name, (raw, n_segs) in _find_card_cases().items():
        t = torch.from_numpy(raw.copy())
        before = _build.LAUNCHES["jdtc_unstuff"]
        got, ends = entropy_cuda.find_segments(t.to(cuda_device), n_segs)
        assert _build.LAUNCHES["jdtc_unstuff"] == before + 1
        want, want_ends = entropy_cuda._find_plain(t, n_segs)
        ends, want_ends = ends.cpu().numpy(), want_ends.numpy()
        found = int(want_ends[n_segs + 1])
        idx = [*range(min(found, n_segs)), n_segs, n_segs + 1, n_segs + 2]
        np.testing.assert_array_equal(ends[idx], want_ends[idx], err_msg=name)
        final = int(want_ends[n_segs]) + 8
        assert got.stream.numel() == raw.shape[0] + 8
        assert torch.equal(got.stream[:final].cpu(), want.stream[:final]), name
        if found == n_segs:
            assert torch.equal(got.sub_base.cpu(), want.sub_base), name


def _card_span():
    st = GLOBAL_METRICS.stages.get("card_span_pct")
    return (st.calls, st.total_items) if st else (0, 0.0)


def _request_streams():
    """The streams a DEVICE request takes from its header alone: the small
    ones, the corpus's files with markers, a photograph tiled, and two 4K
    requests."""
    out = {name: _stream(name) for name in STREAMS}
    out.update(_photo_streams())
    out["4k_restart_free"] = make_jpeg(3840, 2160, F420, 0, 20261016)
    out["4k_photo_dri"] = photo_jpeg(DRI_FILES[0], 3840, 2160, 240)
    return out


@pytest.mark.parametrize("name", ["420_ri4", "444_ri1", "gray_no_ri", "420_ri5_edges",
                                  "422_ri3", "china_420_file", "flower_422_file",
                                  "china_420_tiled", "4k_restart_free", "4k_photo_dri"])
def test_device_request_matches_the_full_parse(cuda_device, name):
    """decode and decode_rgb under DEVICE on the card, each request from its
    header parse alone (card_span_pct 100), bitwise the full parse's route
    (decode_structure), RGB and planes."""
    data = _request_streams()[name]
    calls, items = _card_span()
    got = jtt.decode(data, DEVICE, device=cuda_device)
    rgb = tdecoder.decode_rgb(data, DEVICE, device=cuda_device)
    assert _card_span() == (calls + 2, items + 200.0)
    want = tdecoder.decode_structure(parse(data, DEVICE), DEVICE, device=cuda_device)
    np.testing.assert_array_equal(got.rgb, want.rgb)
    np.testing.assert_array_equal(rgb, want.rgb)
    for a, b in zip(got.planes, want.planes):
        np.testing.assert_array_equal(a, b)


def _request_ladder():
    """The DEVICE error ladder (tests/test_torch_entropy_device.py's, made
    here without Pillow): a 64x64 gray stream with 1-4 random bytes
    overwritten (eight draws of seed 9), cut at 30, 70 and 95% of its
    length, chip_smoke's damaged DRI streams, a second scan
    (multiscan_jpeg), a segment after the scan, and the streams
    unharmed."""
    from jpeg_decoder_tpu_torch.benchmarks.inputs import multiscan_jpeg

    data = make_jpeg(64, 64, GRAY, 0, 9)
    dri = make_jpeg(64, 48, F420, 2, 1)
    rng = np.random.default_rng(9)
    out = {"gray": data, "dri": dri, "several_scans": multiscan_jpeg(75, 41, F420, 3),
           "app_after_the_scan": dri[:-2] + b"\xff\xe1\x00\x06abcd" + dri[-2:]}
    for i in range(8):
        bad = bytearray(data)
        for _k in range(rng.integers(1, 5)):
            bad[rng.integers(2, len(bad))] = rng.integers(0, 256)
        out[f"corrupt{i}"] = bytes(bad)
    for frac in (0.3, 0.7, 0.95):
        out[f"cut{int(frac * 100)}"] = data[: int(len(data) * frac)]
    from chip_smoke import damaged_streams

    out.update({f"damaged {k}": v[0] for k, v in damaged_streams(dri).items()})
    return out


def test_device_requests_raise_as_the_full_parse_does(cuda_device):
    """Every stream of the ladder through a DEVICE request on the card: the
    error class the full parse's route raises, or its RGB; card_span_pct
    100 only where the header parse's result stood, which needs the
    header's segment count, EOI and a clean status."""
    for name, data in _request_ladder().items():
        def outcome(fn):
            try:
                return "ok", fn().rgb
            except JpegError as e:
                return "error", type(e)

        calls, items = _card_span()
        got = outcome(lambda: jtt.decode(data, DEVICE, device=cuda_device))
        assert _card_span()[0] == calls + 1
        stood = _card_span()[1] == items + 100.0
        want = outcome(lambda: tdecoder.decode_structure(parse(data, DEVICE), DEVICE,
                                                         device=cuda_device))
        assert got[0] == want[0], name
        if got[0] == "error":
            assert got[1] is want[1] and not stood, name
        else:
            np.testing.assert_array_equal(got[1], want[1], err_msg=name)
        if name in ("gray", "dri"):
            assert stood, name
        if name in ("several_scans", "app_after_the_scan") or name.startswith("cut"):
            assert not stood, name


@pytest.mark.parametrize("entry", ["decode", "JpegDecoder", "decode_batch", "decode_stream",
                                   "decode_many"])
def test_pallas_paths_do_not_synchronise_before_k2(cuda_device, monkeypatch, entry):
    """Every PALLAS path, from the upload of the raw bytes (to_device) to
    K2's launch, under PyTorch's sync debug mode set to raise; the window
    opens and closes once per K2 call."""
    windows = []
    to_device, launch_as = entropy_cuda.to_device, _build.launch_as

    def opening(*a, **k):
        torch.cuda.set_sync_debug_mode("error")
        windows.append("open")
        return to_device(*a, **k)

    def closing(count_as, name, *a):
        if name == "jdtc_entropy_decode":
            torch.cuda.set_sync_debug_mode("default")
            windows.append("closed")
        return launch_as(count_as, name, *a)

    # every launch goes through launch_as (launch is launch_as under the
    # entry point's own name; K2's wrapper names its count)
    monkeypatch.setattr(entropy_cuda, "to_device", opening)
    monkeypatch.setattr(_build, "launch_as", closing)
    datas = [make_jpeg(64, 48, F420, 4, 400 + i) for i in range(4)]
    cfg = PALLAS
    try:
        if entry == "decode":
            jtt.decode(datas[0], cfg, device=cuda_device)
        elif entry == "JpegDecoder":
            jtt.JpegDecoder(cfg, device=cuda_device).decode(datas[0])
        elif entry == "decode_batch":
            jtt.BatchDecoder(cfg, device=cuda_device).decode_batch(datas)
        elif entry == "decode_stream":
            list(jtt.BatchDecoder(cfg, device=cuda_device).decode_stream(datas, batch_size=2))
        else:
            jtt.BatchDecoder(cfg, device=cuda_device).decode_many(datas[:2] + [_stream("444_ri1")])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert windows and windows == ["open", "closed"] * (len(windows) // 2)


def _idct_inputs(seed, by, bx):
    rng = np.random.default_rng(seed)
    coeffs = np.clip(np.rint(rng.laplace(0, 30, (by, bx, 64))), -2048, 2047)
    coeffs[0] = rng.integers(-32768, 32768, (bx, 64))
    qt = rng.integers(1, 256, 64).astype(np.int32)
    return torch.from_numpy(coeffs.astype(np.int16)), torch.from_numpy(qt)


@pytest.mark.parametrize("bits12", [False, True], ids=["8bit", "12bit"])
def test_k0_matches_plain(cuda_device, bits12):
    plane, qt = (t.to(cuda_device) for t in _idct_inputs(5, 40, 30))
    got = tidct.idct_plane(plane, qt, bits12)
    want = tidct.blocks_to_plane(
        tidct.idct_exact(plane.reshape(-1, 64), qt, bits12), 40, 30)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want.cpu())


#: K0's ragged shapes: (blocks rows..., blocks_x); one block wide, an odd
#: width (8-byte row stores), 350 blocks (not a multiple of the CTA's 128),
#: a stacked batch of three, the 4K luma width.
K0_SHAPES = {"bx1": (37, 1), "odd_bx": (19, 33), "ragged_cta": (7, 50),
             "batch": (3, 17, 12), "luma_4k_width": (3, 480)}


@pytest.mark.parametrize("bits12", [False, True], ids=["8bit", "12bit"])
@pytest.mark.parametrize("extremes", [False, True], ids=["laplace", "pm2048_q255"])
@pytest.mark.parametrize("shape", sorted(K0_SHAPES))
def test_k0_matches_plain_on_ragged_shapes(cuda_device, shape, extremes, bits12):
    """K0 bitwise against its plain version, one launch, its blocks counted
    as its units."""
    dims = K0_SHAPES[shape]
    rng = np.random.default_rng(sum(dims) + 17 * extremes)
    if extremes:
        coeffs = rng.integers(-2048, 2049, (*dims, 64))
        qt = np.full(64, 255)
    else:
        coeffs = np.clip(np.rint(rng.laplace(0, 30, (*dims, 64))), -2048, 2047)
        qt = rng.integers(1, 256, 64)
    plane = torch.from_numpy(coeffs.astype(np.int16)).to(cuda_device)
    qt = convert.quant_table_to_device(qt, cuda_device)
    _build.LAUNCHES.clear()
    _build.LAUNCH_UNITS.clear()
    got = tidct.idct_plane(plane, qt, bits12)
    assert _build.LAUNCHES == {"jdtc_idct_exact": 1}
    assert _build.LAUNCH_UNITS == {"jdtc_idct_exact": int(np.prod(dims))}
    rows = int(np.prod(dims[:-1]))
    want = tidct.blocks_to_plane(tidct.idct_exact(plane.reshape(-1, 64), qt, bits12),
                                 rows, dims[-1]).reshape(got.shape)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _random_blocks(seed, shape, lo=-1024, hi=1024):
    """Uniform coefficients with a random zero suffix per block (the JAX
    tests' _random_blocks)."""
    rng = np.random.default_rng(seed)
    blocks = rng.integers(lo, hi, (*shape, 64))
    cut = rng.integers(1, 64, shape)
    return torch.from_numpy(
        np.where(np.arange(64) < cut[..., None], blocks, 0).astype(np.int16))


@pytest.mark.parametrize("bits12", [False, True], ids=["8bit", "12bit"])
@pytest.mark.parametrize("shape", [(40, 30), (3, 17, 11)], ids=["plane", "batch"])
def test_k1_matches_plain(cuda_device, shape, bits12):
    plane = _random_blocks(7, shape).to(cuda_device)
    qt = convert.quant_table_to_device(
        np.random.default_rng(8).integers(1, 256, 64), cuda_device)
    _build.LAUNCHES.clear()
    got = tidct.idct_plane(plane, qt, bits12, IdctPrecision.FLOAT32)
    assert _build.LAUNCHES == {"jdtc_idct_float": 1}
    want = tidct.blocks_to_plane(
        tidct.idct_float(plane.reshape(-1, 64), qt, bits12),
        int(np.prod(shape[:-1])), shape[-1]).reshape(got.shape)
    torch.cuda.synchronize()
    d = (got.cpu().to(torch.int32) - want.cpu().to(torch.int32)).abs()
    assert int(d.max()) <= 1
    assert float((d != 0).float().mean()) <= 1e-3


#: K1's ragged shapes: (block rows..., blocks_x); one block wide, an odd
#: width, 350 blocks (not a multiple of the 64-block tile), a stacked batch
#: of three, the 4K luma plane
K1_SHAPES = {"bx1": (37, 1), "odd_bx": (19, 33), "ragged_tile": (7, 50),
             "batch": (3, 17, 12), "luma_4k": (270, 480)}


@pytest.mark.parametrize("bits12", [False, True], ids=["8bit", "12bit"])
@pytest.mark.parametrize("shape", sorted(K1_SHAPES))
def test_k1_matches_plain_aligned_or_not(cuda_device, shape, bits12):
    """K1 within 1 of its plain version on at most 1e-3 of the pixels; one
    launch, its blocks counted. The unaligned case, coefficients at an odd
    address (2-byte loads), bitwise the aligned one."""
    from jpeg_decoder_tpu_torch.benchmarks import pixel_sweep

    dims = K1_SHAPES[shape]
    plane = _random_blocks(sum(dims) + bits12, dims).to(cuda_device)
    qt = convert.quant_table_to_device(
        np.random.default_rng(sum(dims)).integers(1, 256, 64), cuda_device)
    unaligned = torch.empty(plane.numel() + 1, dtype=torch.int16, device=cuda_device)
    unaligned = unaligned[1:].view(plane.shape)
    unaligned.copy_(plane)
    _build.LAUNCHES.clear()
    _build.LAUNCH_UNITS.clear()
    got = tidct.idct_plane(plane, qt, bits12, IdctPrecision.FLOAT32)
    assert _build.LAUNCHES == {"jdtc_idct_float": 1}
    assert _build.LAUNCH_UNITS == {"jdtc_idct_float": int(np.prod(dims))}
    odd = tidct.idct_plane(unaligned, qt, bits12, IdctPrecision.FLOAT32)
    want = pixel_sweep.k1_plain(plane, qt, bits12)
    torch.cuda.synchronize()
    assert torch.equal(odd, got)
    d = (got.to(torch.int32) - want.to(torch.int32)).abs()
    assert int(d.max()) <= 1 and float((d != 0).float().mean()) <= 1e-3


def _pixel_planes(factors, h, w, seed, lead=()):
    rng = np.random.default_rng(seed)
    mh = max(f[0] for f in factors)
    mv = max(f[1] for f in factors)
    mcus_x, mcus_y = -(-w // (8 * mh)), -(-h // (8 * mv))
    return [
        torch.from_numpy(rng.integers(0, 256, (*lead, mcus_y * fv * 8, mcus_x * fh * 8),
                                      dtype=np.uint8))
        for fh, fv in factors
    ]


@pytest.mark.parametrize("lead", [(), (5,)], ids=["image", "batch"])
@pytest.mark.parametrize("quirks", QUIRKS, ids=lambda q: q.value)
@pytest.mark.parametrize("factors", [GRAY, F420, F444], ids=["gray", "420", "444"])
def test_k3_matches_plain(cuda_device, factors, quirks, lead):
    h, w = 67, 45
    planes = [p.to(cuda_device) for p in _pixel_planes(factors, h, w, 3, lead)]
    got = tcolor.planes_to_rgb(planes, h, w, factors, quirks)
    want = tcolor._planes_to_rgb_plain(planes, h, w, factors, quirks)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want.cpu())


@pytest.mark.parametrize("quirks", QUIRKS, ids=lambda q: q.value)
@pytest.mark.parametrize("backend", [EntropyBackend.PALLAS, EntropyBackend.NATIVE],
                         ids=lambda b: b.value)
@pytest.mark.parametrize("name", ["420_ri4", "gray_no_ri"])
def test_decode_on_cuda_matches_cpu(cuda_device, name, backend, quirks):
    data = _stream(name)
    cfg = DecodeConfig(entropy_backend=backend, quirks=quirks)
    _build.LAUNCHES.clear()
    got = jtt.decode(data, cfg, device=cuda_device)
    launches = dict(_build.LAUNCHES)
    want = jtt.decode(data, cfg, device="cpu")
    np.testing.assert_array_equal(got.rgb, want.rgb)
    for a, b in zip(got.planes, want.planes):
        np.testing.assert_array_equal(a, b)
    # three components under EXACT: K03 alone; gray: K0 and K3
    expected = ({"jdtc_pixel_exact": 1} if name == "420_ri4"
                else {"jdtc_idct_exact": 1, "jdtc_color": 1})
    if backend == EntropyBackend.PALLAS:
        expected |= {"jdtc_entropy_decode": 1, "jdtc_unstuff": 1}
    assert launches == expected


def _assert_float32_rgb(got, want):
    d = np.abs(np.asarray(got).astype(np.int32) - np.asarray(want).astype(np.int32))
    assert d.max() <= 3


@pytest.mark.parametrize("backend", BACKENDS, ids=lambda b: b.value)
def test_float32_decode_on_cuda_matches_cpu(cuda_device, backend):
    data = _stream("420_ri4")
    cfg = DecodeConfig(entropy_backend=backend, idct_precision=IdctPrecision.FLOAT32)
    _build.LAUNCHES.clear()
    got = jtt.JpegDecoder(cfg, device=cuda_device).decode(data)
    launches = dict(_build.LAUNCHES)
    want = jtt.decode(data, cfg, device="cpu")
    for a, b in zip(got.planes, want.planes):
        assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 1
    _assert_float32_rgb(got.rgb, want.rgb)
    # the colour stage of the card's own planes, on the CPU
    f = got.frame
    np.testing.assert_array_equal(got.rgb, tcolor.planes_to_rgb(
        [torch.from_numpy(p) for p in got.planes], f.height, f.width, F420,
        Quirks.REFERENCE).numpy())
    # three components: K13 alone
    assert launches["jdtc_pixel_float"] == 1
    assert not {"jdtc_idct_float", "jdtc_color", "jdtc_idct_exact"} & launches.keys()


@pytest.mark.parametrize("precision", PRECISIONS, ids=lambda p: p.value)
@pytest.mark.parametrize("backend", BACKENDS, ids=lambda b: b.value)
def test_batch_decoder_on_cuda_matches_cpu(cuda_device, backend, precision):
    """decode_batch, decode_stream and decode_many on the card against the
    same calls on the CPU; one K2u and one K2 call for the batch, then one
    K03 launch (EXACT) or one K13 launch (FLOAT32)."""
    cfg = DecodeConfig(entropy_backend=backend, idct_precision=precision)
    datas = [make_jpeg(64, 48, F420, 4, 300 + i) for i in range(6)]
    many = [datas[0], _stream("gray_no_ri"), datas[1], _stream("444_ri1")]
    card = jtt.BatchDecoder(cfg, device=cuda_device)
    cpu = jtt.BatchDecoder(cfg, device="cpu")
    _build.LAUNCHES.clear()
    got = card.decode_batch(datas)
    launches = dict(_build.LAUNCHES)
    expected = ({"jdtc_pixel_exact": 1} if precision == IdctPrecision.EXACT
                else {"jdtc_pixel_float": 1})
    if backend == EntropyBackend.PALLAS:
        expected["jdtc_entropy_decode"] = expected["jdtc_unstuff"] = 1
    assert launches == expected
    pairs = [(got, cpu.decode_batch(datas)),
             (np.concatenate(list(card.decode_stream(datas, batch_size=4))),
              np.concatenate(list(cpu.decode_stream(datas, batch_size=4))))]
    pairs += list(zip(card.decode_many(many), cpu.decode_many(many)))
    for g, w in pairs:
        assert g.shape == w.shape
        if precision == IdctPrecision.EXACT:
            np.testing.assert_array_equal(g, w)
        else:
            _assert_float32_rgb(g, w)
    # within the card, a batch gives each image its single-image decode
    for rgb, d in zip(got, datas):
        np.testing.assert_array_equal(rgb, jtt.decode(d, cfg, device=cuda_device).rgb)


# ---------------------------------------------------------------------------
# K03: the EXACT pixel stage of a 3-component frame in one kernel
# ---------------------------------------------------------------------------


K03_SAMPLINGS = {
    "420": F420,
    "422": ((2, 1), (1, 1), (1, 1)),
    "444": F444,
    "440": ((1, 2), (1, 1), (1, 1)),
    "411": ((4, 1), (1, 1), (1, 1)),
}
#: (sampling, h, w): ragged edges at two sizes, and the 4K frame
K03_GEOMETRIES = [(s, h, w) for s in sorted(K03_SAMPLINGS) for h, w in ((37, 45), (67, 101))]
K03_GEOMETRIES.append(("420", 2160, 3840))
#: (bits, quirks) pairs
K03_NUMERICS = [(8, Quirks.REFERENCE), (12, Quirks.CORRECT)]


def _k03_frame(h, w, factors, bits=8):
    mh = max(f[0] for f in factors)
    mv = max(f[1] for f in factors)
    return ttypes.FrameHeader(
        Encoding.BASELINE_DCT, bits, w, h,
        tuple(ttypes.Component(i + 1, fh, fv, min(i, 1), -(-w * fh // mh), -(-h * fv // mv))
              for i, (fh, fv) in enumerate(factors)))


def _k03_inputs(frame, seed, lead, device):
    """Random zigzag planes with a random zero suffix a block (wider under
    12-bit) and random tables, on `device`."""
    rng = np.random.default_rng(seed)
    span = 8192 if frame.precision == 12 else 1024
    planes, qts = [], []
    for c in frame.components:
        shape = (*lead, c.blocks_y, c.blocks_x)
        blocks = rng.integers(-span, span, (*shape, 64))
        cut = rng.integers(1, 65, shape)
        planes.append(torch.from_numpy(
            np.where(np.arange(64) < cut[..., None], blocks, 0).astype(np.int16)).to(device))
        qts.append(convert.quant_table_to_device(rng.integers(1, 256, 64), device))
    return planes, qts


def _assert_k03(got, want, want_planes):
    torch.cuda.synchronize()
    assert torch.equal(got[0].cpu(), want[0].cpu())
    if not want_planes:
        assert got[1] is None
        return
    for a, b in zip(got[1], want[1]):
        assert torch.equal(a.cpu(), b.cpu())


@pytest.mark.parametrize("want_planes", [True, False], ids=["planes", "rgb_only"])
@pytest.mark.parametrize("lead", [(), (2,)], ids=["image", "batch"])
@pytest.mark.parametrize("bits,quirks", K03_NUMERICS, ids=["8bit_reference", "12bit_correct"])
@pytest.mark.parametrize("geometry", K03_GEOMETRIES, ids=lambda g: f"{g[0]}_{g[1]}x{g[2]}")
def test_k03_matches_plain(cuda_device, geometry, bits, quirks, lead, want_planes):
    sampling, h, w = geometry
    frame = _k03_frame(h, w, K03_SAMPLINGS[sampling], bits)
    planes, qts = _k03_inputs(frame, h + w + bits, lead, cuda_device)
    _build.LAUNCHES.clear()
    got = tpixel.pixel_exact(planes, qts, frame, quirks, want_planes)
    assert _build.LAUNCHES == {"jdtc_pixel_exact": 1}
    _assert_k03(got, tpixel._pixel_exact_plain(planes, qts, frame, quirks), want_planes)


@pytest.mark.parametrize("strip", [1, 2, 3, 5, 16])
def test_k03_any_strip_size(cuda_device, strip):
    """Strips of other sizes (several a row, the last ragged) give the same
    bytes."""
    frame = _k03_frame(67, 101, F420)
    planes, qts = _k03_inputs(frame, 77, (3,), cuda_device)
    got = tpixel.pixel_exact(planes, qts, frame, Quirks.REFERENCE, True, strip=strip)
    _assert_k03(got, tpixel._pixel_exact_plain(planes, qts, frame, Quirks.REFERENCE), True)


def test_k03_refuses_a_geometry_that_is_not_tile_local(cuda_device):
    """7/12 rounds down in float32: column 864 reads the MCU before. The
    stage keeps K0 + K3 for it, and the wrapper refuses it."""
    frame = _k03_frame(8, 1000, ((12, 1), (7, 1), (7, 1)))
    planes, qts = _k03_inputs(frame, 5, (), cuda_device)
    with pytest.raises(ValueError, match="tile-local"):
        tpixel.pixel_exact(planes, qts, frame, Quirks.REFERENCE)
    key = tdecoder._stage_key(frame, tuple(np.asarray(q.cpu(), np.uint16).tobytes() for q in qts),
                              DecodeConfig())
    stage = tdecoder._build_pixel_stage(key, cuda_device)
    assert not stage.fused
    _build.LAUNCHES.clear()
    got = stage(*planes)
    assert _build.LAUNCHES == {"jdtc_idct_exact": 3, "jdtc_color": 1}
    _assert_k03(got, tpixel._pixel_exact_plain(planes, qts, frame, Quirks.REFERENCE), True)


# ---------------------------------------------------------------------------
# K13: the FLOAT32 pixel stage of a 3-component frame in one kernel
# ---------------------------------------------------------------------------


def _k1_k3(planes, qts, frame, quirks):
    """The launches K13 replaces: K1 per component, then K3."""
    pix = [tidct.idct_plane(p, q, frame.precision == 12, IdctPrecision.FLOAT32)
           for p, q in zip(planes, qts)]
    return tcolor.planes_to_rgb(pix, frame.height, frame.width,
                                tuple((c.hsf, c.vsf) for c in frame.components), quirks), pix


@pytest.mark.parametrize("want_planes", [True, False], ids=["planes", "rgb_only"])
@pytest.mark.parametrize("lead", [(), (2,)], ids=["image", "batch"])
@pytest.mark.parametrize("bits,quirks", K03_NUMERICS, ids=["8bit_reference", "12bit_correct"])
@pytest.mark.parametrize("geometry", K03_GEOMETRIES, ids=lambda g: f"{g[0]}_{g[1]}x{g[2]}")
def test_k13_matches_k1_k3(cuda_device, geometry, bits, quirks, lead, want_planes):
    """Bitwise K1 x 3 + K3 (one arithmetic, idct_float.cuh and color.cuh);
    against the plain version K1's rule, and RGB the plain colour stage of
    K13's own planes."""
    sampling, h, w = geometry
    frame = _k03_frame(h, w, K03_SAMPLINGS[sampling], bits)
    planes, qts = _k03_inputs(frame, h + w + bits, lead, cuda_device)
    _build.LAUNCHES.clear()
    got = tpixel.pixel_float(planes, qts, frame, quirks, want_planes)
    assert _build.LAUNCHES == {"jdtc_pixel_float": 1}
    _assert_k03(got, _k1_k3(planes, qts, frame, quirks), want_planes)
    if want_planes:
        plain = tpixel._pixel_float_plain(planes, qts, frame, quirks)
        for a, b in zip(got[1], plain[1]):
            d = (a.cpu().to(torch.int32) - b.cpu().to(torch.int32)).abs()
            assert int(d.max()) <= 1 and float((d != 0).float().mean()) <= 1e-3
        own = tcolor._planes_to_rgb_plain(got[1], h, w, K03_SAMPLINGS[sampling], quirks)
        assert torch.equal(got[0].cpu(), own.cpu())


@pytest.mark.parametrize("strip", [1, 2, 3, 5, 16])
def test_k13_any_strip_size(cuda_device, strip):
    """Strips of other sizes (several a row, the last ragged) give the same
    bytes."""
    frame = _k03_frame(67, 101, F420)
    planes, qts = _k03_inputs(frame, 78, (3,), cuda_device)
    got = tpixel.pixel_float(planes, qts, frame, Quirks.REFERENCE, True, strip=strip)
    _assert_k03(got, _k1_k3(planes, qts, frame, Quirks.REFERENCE), True)


def test_k13_refuses_a_geometry_that_is_not_tile_local(cuda_device):
    """The stage keeps K1 + K3 for it, and the wrapper refuses it."""
    frame = _k03_frame(8, 1000, ((12, 1), (7, 1), (7, 1)))
    planes, qts = _k03_inputs(frame, 6, (), cuda_device)
    with pytest.raises(ValueError, match="tile-local"):
        tpixel.pixel_float(planes, qts, frame, Quirks.REFERENCE)
    key = tdecoder._stage_key(
        frame, tuple(np.asarray(q.cpu(), np.uint16).tobytes() for q in qts),
        DecodeConfig(idct_precision=IdctPrecision.FLOAT32))
    stage = tdecoder._build_pixel_stage(key, cuda_device)
    assert not stage.fused
    _build.LAUNCHES.clear()
    got = stage(*planes)
    assert _build.LAUNCHES == {"jdtc_idct_float": 3, "jdtc_color": 1}
    _assert_k03(got, _k1_k3(planes, qts, frame, Quirks.REFERENCE), True)


# ---------------------------------------------------------------------------
# Batches above one launch's 65,535 images
# ---------------------------------------------------------------------------


def test_65536_images_launch_in_chunks_bitwise_per_chunk(cuda_device):
    """65,536 16x16 4:2:0 images (about 50 MB of coefficients): K03, K13 and
    K3 take two launches each, bitwise equal to a decode of each chunk
    alone."""
    n = _build.MAX_IMAGES + 1
    frame = _k03_frame(16, 16, F420)
    planes, qts = _k03_inputs(frame, 65536, (n,), cuda_device)
    cut = [(0, _build.MAX_IMAGES), (_build.MAX_IMAGES, n)]
    for fn in (tpixel.pixel_exact, tpixel.pixel_float):
        _build.LAUNCHES.clear()
        rgb, pix = fn(planes, qts, frame, Quirks.REFERENCE)
        assert sum(_build.LAUNCHES.values()) == 2
        for lo, hi in cut:
            part = fn([p[lo:hi] for p in planes], qts, frame, Quirks.REFERENCE)
            assert torch.equal(rgb[lo:hi], part[0])
            assert all(torch.equal(a[lo:hi], b) for a, b in zip(pix, part[1]))
        _build.LAUNCHES.clear()
        got = tcolor.planes_to_rgb(pix, 16, 16, F420, Quirks.REFERENCE)
        assert _build.LAUNCHES == {"jdtc_color": 2}
        assert torch.equal(got, rgb)


# ---------------------------------------------------------------------------
# K3f (fancy upsample + colour), K3c (K3 on four planes) and K5 (scaled IDCT)
# ---------------------------------------------------------------------------


#: Samplings of K3f and K3c (K3 on four planes): name -> factors, 3 and 4 components; 4:1:1 and
#: 4:2:1 keep a 4x ratio after the 2x passes.
UPSAMPLINGS = {
    "420": F420,
    "422": ((2, 1), (1, 1), (1, 1)),
    "440": ((1, 2), (1, 1), (1, 1)),
    "411": ((4, 1), (1, 1), (1, 1)),
    "421": ((4, 2), (1, 1), (1, 1)),
    "444": F444,
    "4x_444": ((1, 1),) * 4,
    "4x_420": ((2, 2), (1, 1), (1, 1), (2, 2)),
    "4x_422": ((2, 1), (1, 1), (1, 1), (2, 1)),
}
#: 4-component colour transforms: (exact, raw_cmyk)
TRANSFORMS = {"ycck_exact": (True, False), "ycck_float": (False, False),
              "cmyk": (True, True)}


def _upsample_cases(four):
    return [(s, t) for s in sorted(UPSAMPLINGS) if (len(UPSAMPLINGS[s]) == 4) == four
            for t in (sorted(TRANSFORMS) if four else ["ycbcr"])]


def _saturated_planes(factors, h, w, seed, lead, device):
    """Random planes with an all-255 corner (the fancy passes' 256) and an
    all-0 one."""
    planes = _pixel_planes(factors, h, w, seed, lead)
    for p in planes:
        p[..., :9, :9] = 255
        p[..., -9:, -9:] = 0
    return [p.to(device) for p in planes]


@pytest.mark.parametrize("lead", [(), (3,)], ids=["image", "batch"])
@pytest.mark.parametrize("quirks", QUIRKS, ids=lambda q: q.value)
@pytest.mark.parametrize("sampling,transform", _upsample_cases(False) + _upsample_cases(True))
def test_k3f_matches_plain(cuda_device, sampling, transform, quirks, lead):
    """K3f bitwise against the plain fancy_upsample + colour on the card and
    on the CPU, one launch for the batch."""
    factors = UPSAMPLINGS[sampling]
    exact, raw = TRANSFORMS.get(transform, (True, False))
    h, w = 67, 45
    planes = _saturated_planes(factors, h, w, 7, lead, cuda_device)
    _build.LAUNCHES.clear()
    got = tcolor.planes_to_rgb(planes, h, w, factors, quirks, "fancy", exact, raw)
    assert _build.LAUNCHES == {"jdtc_fancy": 1}
    want = tcolor._planes_to_rgb_plain(planes, h, w, factors, quirks, "fancy", exact, raw)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want.cpu())
    cpu = tcolor.planes_to_rgb([p.cpu() for p in planes], h, w, factors, quirks, "fancy",
                               exact, raw)
    assert torch.equal(got.cpu(), cpu)


@pytest.mark.parametrize("lead", [(), (3,)], ids=["image", "batch"])
@pytest.mark.parametrize("quirks", QUIRKS, ids=lambda q: q.value)
@pytest.mark.parametrize("sampling,transform", _upsample_cases(True))
def test_k3c_matches_plain(cuda_device, sampling, transform, quirks, lead):
    """K3c (K3's kernel on four planes) bitwise against the plain
    nearest-neighbour upsample + YCCK or CMYK on the card and on the CPU."""
    factors = UPSAMPLINGS[sampling]
    exact, raw = TRANSFORMS[transform]
    h, w = 67, 45
    planes = _saturated_planes(factors, h, w, 8, lead, cuda_device)
    _build.LAUNCHES.clear()
    got = tcolor.planes_to_rgb(planes, h, w, factors, quirks, "nn", exact, raw)
    assert _build.LAUNCHES == {"jdtc_color": 1}
    want = tcolor._planes_to_rgb_plain(planes, h, w, factors, quirks, "nn", exact, raw)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want.cpu())
    cpu = tcolor.planes_to_rgb([p.cpu() for p in planes], h, w, factors, quirks, "nn",
                               exact, raw)
    assert torch.equal(got.cpu(), cpu)


#: Output widths around K3's and K3f's run of 16 pixels: one pixel, one
#: run less one, one run and one, and the 4K width and 8 (a phase that
#: moves from row to row).
RAGGED_WIDTHS = [1, 15, 17, 3848]


@pytest.mark.parametrize("width", RAGGED_WIDTHS)
@pytest.mark.parametrize("upsample", ["nn", "fancy"])
@pytest.mark.parametrize("sampling,transform", [("gray", "gray")] + _upsample_cases(False)
                         + _upsample_cases(True))
def test_colour_kernels_match_plain_on_ragged_widths(cuda_device, sampling, transform, upsample,
                                                     width):
    """K3 (K3c on four planes) and K3f bitwise against their plain versions
    at widths that are not a multiple of the run, both quirks (the gray
    plane sheared at the image width under REFERENCE), a batch of two; the
    launch's units are its output pixels."""
    factors = GRAY if sampling == "gray" else UPSAMPLINGS[sampling]
    exact, raw = TRANSFORMS.get(transform, (True, False))
    h = 21
    planes = _saturated_planes(factors, h, width, width, (2,), cuda_device)
    entry = "jdtc_fancy" if upsample == "fancy" and len(factors) > 1 else "jdtc_color"
    for quirks in QUIRKS:
        args = (planes, h, width, factors, quirks, upsample, exact, raw)
        _build.LAUNCHES.clear()
        _build.LAUNCH_UNITS.clear()
        got = tcolor.planes_to_rgb(*args)
        assert _build.LAUNCHES == {entry: 1}
        assert _build.LAUNCH_UNITS == {entry: 2 * h * width}
        want = tcolor._planes_to_rgb_plain(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


#: Widths whose rows' heads differ: one run and one pixel, three MCUs, the
#: loader's 500 (heads cycle 0, 12, 8, 4) and the 4K width and 8.
HEAD_WIDTHS = [17, 45, 500, 3848]


@pytest.mark.parametrize("width", HEAD_WIDTHS)
@pytest.mark.parametrize("upsample", ["nn", "fancy"])
def test_colour_kernels_match_plain_at_every_output_head(cuda_device, upsample, width):
    """K3f (jdtc_fancy) and K3 (jdtc_color) on a batch of three 4:2:0
    images, their output placed at byte offsets 0-15 of a larger buffer so
    that every row head is taken: bitwise the plain version; no byte around
    the output written; each launch counts colour_vector_pct once, 100
    (every run, the partial ones too)."""
    h, lead = 7, (3,)
    planes = _saturated_planes(F420, h, width, width, lead, cuda_device)
    entry = "jdtc_fancy" if upsample == "fancy" else "jdtc_color"
    want = tcolor._planes_to_rgb_plain(planes, h, width, F420, Quirks.REFERENCE, upsample)
    size = want.numel()
    share = 100.0
    for offset in range(16):
        buf = torch.full((size + 32,), 0xA5, dtype=torch.uint8, device=cuda_device)
        out = buf[offset:offset + size].view(*lead, h, width, 3)
        before = GLOBAL_METRICS.stages.get("colour_vector_pct", StageStat())
        calls, items = before.calls, before.total_items
        tcolor._launch(entry, planes, lead, h, width, F420, Quirks.REFERENCE, tcolor.YCBCR,
                       True, out=out)
        st = GLOBAL_METRICS.stages.get("colour_vector_pct", StageStat())
        assert (st.calls, st.total_items) == (calls + 1, pytest.approx(items + share))
        torch.cuda.synchronize()
        assert torch.equal(out, want), offset
        assert bool((buf[:offset] == 0xA5).all()) and bool((buf[offset + size:] == 0xA5).all())


@pytest.mark.parametrize("name", ["fancy_420_exact", "ycck_exact"])
def test_launch_units_of_a_fancy_and_a_ycck_request(cuda_device, name):
    """A fancy request launches K0 x 3 + K3f, a YCCK request K0 x 4 + K3c
    (jdtc_color on four planes); their units are the coefficient blocks of
    each plane and the output pixels."""
    args, kw, route = NEW_PATHS[name]
    data = make_jpeg(*args)
    cfg = DecodeConfig(entropy_backend=EntropyBackend.NATIVE, **kw)
    _build.LAUNCHES.clear()
    _build.LAUNCH_UNITS.clear()
    got = jtt.JpegDecoder(cfg, device=cuda_device).decode(data)
    assert dict(_build.LAUNCHES) == route
    blocks = sum(p.size // 64 for p in got.planes)
    colour = "jdtc_fancy" if "fancy" in name else "jdtc_color"
    assert dict(_build.LAUNCH_UNITS) == {"jdtc_idct_exact": blocks,
                                         colour: got.frame.height * got.frame.width}


def test_k3c_ycck_exact_on_the_full_r_domain(cuda_device):
    """K3c under YCCK EXACT on a 4096x4096 4:4:4 frame that walks R's whole
    (y, cr, k) domain, against the float64 chain in NumPy
    (core/numerics.ycck_channels_to_rgb)."""
    from jpeg_decoder_tpu_torch.core import numerics

    y, cr, k = (torch.from_numpy(v) for v in np.meshgrid(
        np.arange(256, dtype=np.uint8), np.arange(256, dtype=np.uint8),
        np.arange(256, dtype=np.uint8), indexing="ij"))
    planes = [c.reshape(4096, 4096).contiguous() for c in
              (y, torch.full_like(y, 77), cr, k)]
    for quirks in QUIRKS:
        got = tcolor.planes_to_rgb([p.to(cuda_device) for p in planes], 4096, 4096,
                                   ((1, 1),) * 4, quirks, "nn", True, False)
        want = numerics.ycck_channels_to_rgb(*(p.numpy() for p in planes), quirks)
        np.testing.assert_array_equal(got.cpu().numpy(), want)


@pytest.mark.parametrize("bits12", [False, True], ids=["8bit", "12bit"])
@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("shape", [(40, 30), (3, 17, 11)], ids=["plane", "batch"])
def test_k5_matches_plain(cuda_device, shape, k, bits12):
    """K5 against its plain version (one torch.matmul, TF32 off): within 1
    on at most 1e-3 of the pixels, bitwise at k = 1 (one term)."""
    blocks = _random_blocks(k + 10 * bits12, shape, -2048 if bits12 else -1024,
                            2048 if bits12 else 1024).to(cuda_device)
    qt = convert.quant_table_to_device(np.random.default_rng(k).integers(1, 256, 64),
                                       cuda_device)
    _build.LAUNCHES.clear()
    got = tidct.idct_plane(blocks, qt, bits12, IdctPrecision.EXACT, k)
    assert _build.LAUNCHES == {"jdtc_idct_scaled": 1}
    assert got.shape == (*shape[:-2], shape[-2] * k, shape[-1] * k)
    *lead, by, bx = shape
    rows = int(np.prod(lead, dtype=np.int64)) * by
    want = tidct.blocks_to_plane(
        tidct.idct_matmul_scaled(blocks.reshape(-1, 64), qt, k, bits12), rows, bx, k)
    d = (got.reshape(rows * k, bx * k).cpu().to(torch.int32)
         - want.cpu().to(torch.int32)).abs()
    if bits12:
        d = torch.minimum(d, 256 - d)  # the 12-bit rescale's low byte
    if k == 1:
        assert int(d.max()) == 0
    assert int(d.max()) <= 1 and float((d != 0).float().mean()) <= 1e-3
    # the CPU's plain version, the same rule
    cpu = tidct.idct_plane(blocks.cpu(), qt.cpu(), bits12, IdctPrecision.EXACT, k)
    d = (got.cpu().to(torch.int32) - cpu.to(torch.int32)).abs()
    if bits12:
        d = torch.minimum(d, 256 - d)
    assert int(d.max()) <= 1 and float((d != 0).float().mean()) <= 1e-3


#: K5's cases: name -> (leading shape, each component's (by, bx), the
#: distinct tables): a 4:2:0 frame whose luma plane spans several blocks of
#: threads, four planes on four tables (K5's largest parameters), a batch
#: of three, a gray plane and a component of one block
K5_LAUNCH_CASES = {
    "420": ((), [(40, 60), (20, 30), (20, 30)], 2),
    "four_tables": ((), [(9, 40), (9, 40), (9, 40), (9, 40)], 4),
    "batch": ((3,), [(17, 11), (9, 6), (9, 6)], 2),
    "gray": ((), [(23, 31)], 1),
    "one_block": ((), [(1, 1), (16, 17), (1, 1)], 3),
}


@pytest.mark.parametrize("bits12", [False, True], ids=["8bit", "12bit"])
@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("name", sorted(K5_LAUNCH_CASES))
def test_k5_one_launch_is_its_model(cuda_device, name, k, bits12):
    """K5 covers every component in one launch, bitwise the CPU model of
    its walk (ops/idct._idct_scaled_walk_plain, the fmaf chain emulated
    exactly)."""
    lead, dims, n_tables = K5_LAUNCH_CASES[name]
    rng = np.random.default_rng(len(name) * 7 + k + bits12)
    lo, hi = (-2048, 2048) if bits12 else (-1024, 1024)
    planes = [_random_blocks(rng.integers(1 << 30), (*lead, by, bx), lo, hi) for by, bx in dims]
    tables = [rng.integers(1, 256, 64).astype(np.int32) for _ in range(n_tables)]
    qts = [tables[i % n_tables] for i in range(len(dims))]
    on_card = [p.to(cuda_device) for p in planes]
    _build.LAUNCHES.clear()
    got = tidct.idct_planes_scaled(on_card, qts, k, bits12)
    assert _build.LAUNCHES == {"jdtc_idct_scaled": 1}
    model = tidct._idct_scaled_walk_plain(planes, qts, k, bits12)
    assert all(torch.equal(g.cpu(), m) for g, m in zip(got, model))


F4 = ((1, 1),) * 4
#: name -> (stream arguments of make_jpeg, config, the pixel stage's launches)
NEW_PATHS = {
    "fancy_420_exact": ((64, 48, F420, 4, 31), dict(upsample="fancy"),
                        {"jdtc_idct_exact": 3, "jdtc_fancy": 1}),
    "fancy_422_float32": ((72, 40, ((2, 1), (1, 1), (1, 1)), 3, 32),
                          dict(upsample="fancy", idct_precision=IdctPrecision.FLOAT32),
                          {"jdtc_idct_float": 3, "jdtc_fancy": 1}),
    "scale4_420": ((64, 48, F420, 4, 33), dict(scale=4),
                   {"jdtc_idct_scaled": 1, "jdtc_color": 1}),
    "scale2_gray": ((100, 37, GRAY, 0, 34), dict(scale=2),
                    {"jdtc_idct_scaled": 1, "jdtc_color": 1}),
    "scale1_fancy_420": ((64, 48, F420, 4, 35), dict(scale=1, upsample="fancy"),
                         {"jdtc_idct_scaled": 1, "jdtc_fancy": 1}),
    "ycck_exact": ((40, 24, F4, 1, 36, 2), dict(),
                   {"jdtc_idct_exact": 4, "jdtc_color": 1}),
    "cmyk_correct": ((40, 24, F4, 1, 37, 0), dict(quirks=Quirks.CORRECT),
                     {"jdtc_idct_exact": 4, "jdtc_color": 1}),
    "ycck_float32_fancy": ((48, 32, ((2, 2), (1, 1), (1, 1), (2, 2)), 2, 38, 2),
                           dict(upsample="fancy", idct_precision=IdctPrecision.FLOAT32),
                           {"jdtc_idct_float": 4, "jdtc_fancy": 1}),
    "ycck_scale4": ((40, 24, F4, 1, 39, 0), dict(scale=4),
                    {"jdtc_idct_scaled": 1, "jdtc_color": 1}),
}


@pytest.mark.parametrize("backend", BACKENDS, ids=lambda b: b.value)
@pytest.mark.parametrize("name", sorted(NEW_PATHS))
def test_new_paths_on_cuda_match_cpu(cuda_device, name, backend):
    """Fancy, scaled and 4-component decodes on the card against the same
    decode on the CPU, through the route of PixelStage: EXACT bitwise;
    FLOAT32 and scaled planes within 1 and RGB within 3, and bitwise the
    colour stage of the card's own planes."""
    args, kw, route = NEW_PATHS[name]
    data = make_jpeg(*args)
    cfg = DecodeConfig(entropy_backend=backend, **kw)
    _build.LAUNCHES.clear()
    got = jtt.JpegDecoder(cfg, device=cuda_device).decode(data)
    launches = dict(_build.LAUNCHES)
    if backend == EntropyBackend.PALLAS:
        route = route | {"jdtc_entropy_decode": 1, "jdtc_unstuff": 1}
    assert launches == route
    want = jtt.decode(data, cfg, device="cpu")
    assert got.rgb.shape == want.rgb.shape
    if cfg.idct_precision == IdctPrecision.EXACT and cfg.scale == 8:
        np.testing.assert_array_equal(got.rgb, want.rgb)
        for a, b in zip(got.planes, want.planes):
            np.testing.assert_array_equal(a, b)
        return
    for a, b in zip(got.planes, want.planes):
        assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 1
    _assert_float32_rgb(got.rgb, want.rgb)
    f = got.frame
    h, w = -(-f.height * cfg.scale // 8), -(-f.width * cfg.scale // 8)
    raw = f.ncs == 4 and cfg.quirks == Quirks.CORRECT and f.adobe_transform == 0
    np.testing.assert_array_equal(got.rgb, tcolor.planes_to_rgb(
        [torch.from_numpy(p) for p in got.planes], h, w,
        tuple((c.hsf, c.vsf) for c in f.components), cfg.quirks, cfg.upsample,
        cfg.idct_precision == IdctPrecision.EXACT, raw,
        cfg.quirks == Quirks.REFERENCE and cfg.scale == 8).numpy())


@pytest.mark.parametrize("name", ["fancy_420_exact", "scale4_420", "ycck_exact",
                                  "ycck_float32_fancy"])
def test_new_paths_batch_on_cuda(cuda_device, name):
    """BatchDecoder (PALLAS) on the card: one K2u and one K2 call, the
    pixel stage's launches once for the batch, each RGB bitwise its
    single-image decode on the card."""
    args, kw, route = NEW_PATHS[name]
    datas = [make_jpeg(*args[:4], args[4] + 100 * i, *args[5:]) for i in range(4)]
    cfg = DecodeConfig(entropy_backend=EntropyBackend.PALLAS, **kw)
    _build.LAUNCHES.clear()
    got = jtt.BatchDecoder(cfg, device=cuda_device).decode_batch(datas)
    assert dict(_build.LAUNCHES) == route | {"jdtc_entropy_decode": 1, "jdtc_unstuff": 1}
    for rgb, d in zip(got, datas):
        np.testing.assert_array_equal(rgb, jtt.decode(d, cfg, device=cuda_device).rgb)


@pytest.mark.parametrize("scale", [8, 4, 1])
@pytest.mark.parametrize("precision", PRECISIONS, ids=lambda p: p.value)
def test_scan_decoder_finish_on_cuda_matches_cpu(cuda_device, tmp_path, precision, scale):
    """ScanDecoder (core/checkpoint.py) on a progressive stream of the
    port's encoder, checkpointed after two scans and resumed: finish on the
    card bitwise finish on the CPU (RGB and planes) and, at full size,
    JpegDecoder's RGB on the card; the pixel stage's launches are the
    route's (K13 or K03 at full size, K5 once at scale < 8)."""
    from jpeg_decoder_tpu_torch.core import checkpoint
    from jpeg_decoder_tpu_torch.io.parser import parse as tparse

    rng = np.random.default_rng(51)
    img = rng.integers(0, 256, (48, 80, 3), dtype=np.uint8)
    data = jtt.encode(img, jtt.EncodeConfig(progressive=True), device="cpu")
    cfg = DecodeConfig(idct_precision=precision, scale=scale)
    ck = tmp_path / "c.npz"
    d = checkpoint.ScanDecoder(tparse(data), cfg, device=cuda_device)
    d.step()
    d.step()
    d.checkpoint(ck)
    out = {}
    for dev in (cuda_device, "cpu"):
        r = checkpoint.ScanDecoder.restore(ck, tparse(data), cfg, device=dev)
        while not r.finished:
            r.step()
        _build.LAUNCHES.clear()
        out[str(dev)] = r.finish()
        if dev == cuda_device:
            launches = dict(_build.LAUNCHES)
    got, want = out[str(cuda_device)], out["cpu"]
    if scale < 8:
        assert launches == {"jdtc_idct_scaled": 1, "jdtc_color": 1}
    else:
        assert launches == {("jdtc_pixel_exact" if precision == IdctPrecision.EXACT
                             else "jdtc_pixel_float"): 1}
    if precision == IdctPrecision.EXACT and scale == 8:
        np.testing.assert_array_equal(got.rgb, want.rgb)
        for a, b in zip(got.planes, want.planes):
            np.testing.assert_array_equal(a, b)
    else:  # the kernels' rule against their plain versions
        for a, b in zip(got.planes, want.planes):
            assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 1
        _assert_float32_rgb(got.rgb, want.rgb)
    if scale == 8:
        np.testing.assert_array_equal(
            got.rgb, jtt.JpegDecoder(cfg, device=cuda_device).decode(data).rgb)


@pytest.mark.parametrize("args", [[], ["--scale", "1/2"], ["--precision", "float32"],
                                  ["--streamed", "--chunks", "2"], ["--striped"]],
                         ids=["plain", "scale", "float32", "streamed", "striped"])
def test_cli_decode_on_cuda_is_the_library_call(cuda_device, tmp_path, args):
    """The CLI's decode on the card (its default device) writes the bytes of
    the library call on the card."""
    from jpeg_decoder_tpu_torch import cli
    from jpeg_decoder_tpu_torch.parallel import stripes

    src = tmp_path / "in.jpg"
    src.write_bytes(make_jpeg(96, 64, F420, 2, 61))
    out = tmp_path / "out.npy"
    assert cli.main(["decode", str(src), str(out), *args]) == 0
    cfg = DecodeConfig(idct_precision=IdctPrecision.FLOAT32 if "float32" in args
                       else IdctPrecision.EXACT, scale=4 if "--scale" in args else 8)
    if "--streamed" in args:
        want = stripes.decode_streamed(src.read_bytes(), cfg, n_chunks=2, device=cuda_device)
    elif "--striped" in args:
        want = stripes.decode_striped(src.read_bytes(), cfg, device=cuda_device)
    else:
        want = jtt.decode(src.read_bytes(), cfg, device=cuda_device).rgb
    np.testing.assert_array_equal(np.load(out), want)


# ---------------------------------------------------------------------------
# The probes PK1-PK7: every variant, bitwise (all integer)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("key", [v.key for v in probes.VARIANTS])
def test_probe_matches_plain(cuda_device, key):
    """The kernel against the plain version on the card and on the CPU, in
    both table placements where the table fits shared memory; the launch is
    counted."""
    variant = probes.BY_KEY[key]
    steps = 256 if key == "H5" else 96
    t = probes.tensors_for(variant, cuda_device)
    before = _build.LAUNCHES[variant.kernel]
    got = variant.run(t, steps)
    assert _build.LAUNCHES[variant.kernel] == before + 1
    assert torch.equal(got, variant.run(t, steps, plain=True))
    assert _build.LAUNCHES[variant.kernel] == before + 1  # the plain version launches none
    assert torch.equal(got.cpu(), variant.run(probes.tensors_for(variant, "cpu"), steps))
    if probes.placement_of(variant, t) == "table in shared memory":
        assert torch.equal(got, variant.run(t, steps, placement="global"))
        assert torch.equal(got, variant.run(t, steps, placement="shared"))


def test_symbol_step_probe_from_a_random_state_matches_plain(cuda_device):
    """From the script's constant state all lanes stay equal and a wrong
    exchange between a column's lanes would not show."""
    variant = probes.BY_KEY["H4"]
    rng = np.random.default_rng(4)
    state = tuple(torch.from_numpy(a).to(cuda_device) for a in (
        rng.integers(0, 2**32, (8, 128), dtype=np.uint32).view(np.int32),
        rng.integers(16, 33, (8, 128), dtype=np.int32),
        rng.integers(-2**31, 2**31, (8, 128), dtype=np.int64).astype(np.int32)))
    t = probes.tensors_for(variant, cuda_device)
    got = variant.run(t, 300, state=state)
    assert torch.equal(got, variant.run(t, 300, state=state, plain=True))
    assert len(torch.unique(got)) > 512


def test_vshift_probe_any_op_count(cuda_device):
    """1 and 10 operations a step are the kernel's two unrolled bodies; any
    other count is refused."""
    t = probes.tensors_for(probes.BY_KEY["G4a"], cuda_device)
    for n_ops in (1, 10):
        assert torch.equal(probes.vshift_chain(t["x"], t["sh"], 64, n_ops),
                           probes.vshift_chain(t["x"], t["sh"], 64, n_ops, plain=True))
    with pytest.raises(ValueError, match="n_ops"):
        probes.vshift_chain(t["x"], t["sh"], 64, 3)


def test_probe_start_out_of_range_is_clamped_on_the_card(cuda_device):
    """A CPU tensor's bad start raises; a card's is clamped by the kernel
    (no read outside the table), without a host look at the values."""
    variant = probes.BY_KEY["G2"]
    t = probes.tensors_for(variant, cuda_device)
    bad = t["idx0"].clone()
    bad[0, 0], bad[1, 1] = -5, 10**6
    fixed = bad.clamp(0, t["tab"].shape[0] - 1)
    assert torch.equal(probes.gather_chain(t["tab"], bad, 64),
                       probes.gather_chain(t["tab"], fixed, 64))
    with pytest.raises(ValueError, match="start indices"):
        probes.gather_chain(t["tab"].cpu(), bad.cpu(), 64)


def test_gather_probe_entry_point_on_the_card(cuda_device, capsys):
    from jpeg_decoder_tpu_torch.benchmarks import gather_probe

    records = gather_probe.main(["--round", "all", "--steps", "64", "512", "--reps", "3"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(records) == 21 and len(lines) == 21
    assert all(" ns/step" in ln and "W]" in ln for ln in lines)


# ---------------------------------------------------------------------------
# K4: the encoder's device stage
# ---------------------------------------------------------------------------

#: subsampling -> (its factors, gray); "gray2d" is a 2-D image
K4_SAMPLINGS = {
    **{s: (f, False) for s, f in tenc._SAMPLING.items()},
    "gray": (GRAY, True),
    "gray2d": (GRAY, True),
}


def _encode_image(h, w, seed, gray2d=False):
    """A smooth gradient with noise, and uniform noise in its lower half."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1),
                     (xx + yy) * 127 // max(h + w - 2, 1)], -1)
    img = np.clip(base + rng.integers(-8, 9, base.shape), 0, 255)
    img[h // 2 :] = rng.integers(0, 256, img[h // 2 :].shape)
    img = img.astype(np.uint8)
    return img[..., 1].copy() if gray2d else img


@pytest.mark.parametrize("quality", [10, 85, 100])
@pytest.mark.parametrize("size", [(1, 1), (8, 8), (16, 16), (33, 47), (41, 57), (48, 48),
                                  (270, 333)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("sampling", sorted(K4_SAMPLINGS))
def test_k4_matches_plain(cuda_device, sampling, size, quality):
    """Every coefficient of every component bitwise the plain version's on
    the same image, on the card and on the CPU; planes of one block (1x1,
    8x8, 16x16) take the matrix-vector order."""
    factors, _ = K4_SAMPLINGS[sampling]
    img = _encode_image(*size, seed=quality, gray2d=sampling == "gray2d")
    kq = tfdct.fdct_tables(tenc.quality_qtables(quality), cuda_device)
    src = torch.from_numpy(img).to(cuda_device)
    got = tfdct.encode_planes(src, factors, kq)
    plain = tfdct._planes_plain(src, factors, kq)
    cpu = tfdct.encode_planes(src.cpu(), factors, kq.cpu())
    torch.cuda.synchronize()
    for a, b, c in zip(got, plain, cpu, strict=True):
        assert torch.equal(a, b) and torch.equal(a.cpu(), c)


@pytest.mark.parametrize("quality", [10, 85, 100])
def test_k4_4k_matches_plain(cuda_device, quality):
    """A 3840x2160 4:2:0 image: 15 runs of 16 MCUs a row; its 194,400
    blocks bitwise the plain version's; one launch, its blocks counted."""
    img = torch.from_numpy(_encode_image(2160, 3840, quality)).to(cuda_device)
    kq = tfdct.fdct_tables(tenc.quality_qtables(quality), cuda_device)
    _build.LAUNCHES.clear()
    _build.LAUNCH_UNITS.clear()
    got = tfdct.encode_planes(img, F420, kq)
    assert _build.LAUNCHES == {"jdtc_fdct": 1}
    assert _build.LAUNCH_UNITS == {"jdtc_fdct": 194_400}
    plain = tfdct._planes_plain(img, F420, kq)
    for a, b in zip(got, plain, strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("runs,extra", [(1, -1), (1, 1), (2, 3), (3, 1)])
def test_k4_ragged_runs(cuda_device, runs, extra):
    """MCU rows of `runs` full runs and `extra` MCUs (one short of a run;
    several runs a row, the last ragged, a component's blocks not a
    multiple of four), the last MCU cut by the image's edge, give the plain
    version's coefficients."""
    for factors in (F420, tenc._SAMPLING["mixed"], GRAY):
        width = (runs * tfdct.run_mcus(factors) + extra) * max(f[0] for f in factors) * 8 - 3
        img = torch.from_numpy(_encode_image(67, width, runs)).to(cuda_device)
        kq = tfdct.fdct_tables(tenc.quality_qtables(85)[: 1 if len(factors) == 1 else 2],
                                cuda_device)
        got = tfdct.encode_planes(img, factors, kq)
        for a, b in zip(got, tfdct._planes_plain(img, factors, kq), strict=True):
            assert torch.equal(a, b)


def test_launches_of_an_encode_and_a_fancy_float32_request(cuda_device):
    """An encode is one K4 launch (its blocks its units); a fancy FLOAT32
    request K1 x 3 + K3f."""
    img = _encode_image(48, 64, 5)
    _build.LAUNCHES.clear()
    _build.LAUNCH_UNITS.clear()
    jtt.JpegEncoder(jtt.EncodeConfig(subsampling="420"), device=cuda_device).encode(img)
    assert dict(_build.LAUNCHES) == {"jdtc_fdct": 1}
    assert dict(_build.LAUNCH_UNITS) == {"jdtc_fdct": 6 * 8 + 2 * 3 * 4}
    args, kw, route = NEW_PATHS["fancy_422_float32"]
    cfg = DecodeConfig(entropy_backend=EntropyBackend.NATIVE, upsample="fancy",
                       idct_precision=IdctPrecision.FLOAT32)
    _build.LAUNCHES.clear()
    jtt.JpegDecoder(cfg, device=cuda_device).decode(make_jpeg(*args))
    assert dict(_build.LAUNCHES) == {"jdtc_idct_float": 3, "jdtc_fancy": 1} == route


@pytest.mark.parametrize("cfg", [
    dict(subsampling="420", restart_interval=3),
    dict(subsampling="mixed", huffman="optimized", restart_interval=1),
    dict(subsampling="444", progressive=True),
    dict(subsampling="gray", quality=40),
], ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items()))
def test_encode_on_cuda_matches_cpu(cuda_device, cfg):
    """Bytes of the card's encode equal the CPU's; one K4 launch per
    image, no plain version and no Python packer."""
    imgs = [_encode_image(33, 47, 1), _encode_image(64, 80, 2), _encode_image(17, 9, 3),
            _encode_image(8, 8, 4)]
    enc = jtt.JpegEncoder(jtt.EncodeConfig(**cfg), device=cuda_device)
    want = [jtt.encode(i, jtt.EncodeConfig(**cfg), device="cpu") for i in imgs]
    _build.LAUNCHES.clear()
    tfdct.PLAIN_CALLS.clear()
    tenc.FALLBACKS.clear()
    got = [enc.encode(i) for i in imgs] + list(enc.encode_stream(imgs))
    assert got == want + want
    assert _build.LAUNCHES["jdtc_fdct"] == 2 * len(imgs)
    assert not tfdct.PLAIN_CALLS and not tenc.FALLBACKS


def test_k4_refuses_what_it_does_not_take(cuda_device):
    kq = tfdct.fdct_tables(tenc.quality_qtables(85), cuda_device)
    img = torch.zeros((16, 16, 3), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError, match="the encoder's samplings"):
        tfdct.encode_planes(img, ((2, 4), (1, 1), (1, 1)), kq)
    flat = torch.empty(16 * 16 // 64 * 3 * 64 + 1, dtype=torch.int16, device=cuda_device)
    with pytest.raises(ValueError, match="8-byte aligned"):
        tfdct.encode_planes(img, ((1, 1),) * 3, kq, flat[1:])
    with pytest.raises(ValueError, match="uint8"):
        tfdct.encode_planes(img.float(), F420, kq)
    with pytest.raises(ValueError, match="kq"):
        tfdct.encode_planes(img, F420, kq.double())
    with pytest.raises(ValueError, match="components"):
        tfdct.encode_planes(img[..., 0].contiguous(), F420, kq)


# ---------------------------------------------------------------------------
# K6n and K6f: streamed and striped decode (parallel/stripes.py)
# ---------------------------------------------------------------------------

#: (h, w, factors, stripes): the last is not tile-local (7/12 leaves its MCU
#: from row 864), so K0 + K3 run it with the clamp live at one MCU row a
#: stripe
K6_CASES = {
    "420": (216, 40, F420, 5),
    "422": (203, 72, ((2, 1), (1, 1), (1, 1)), 4),
    "444": (61, 45, F444, 3),
    "gray": (77, 19, GRAY, 4),
    "ycck": (100, 40, F420 + ((2, 2),), 3),
    "ratio_2x4": (100, 32, ((2, 4), (1, 1), (1, 1)), 4),
    "refused_7_12": (1000, 8, ((1, 12), (1, 7), (1, 7)), 11),
    "420_4k": (2160, 3840, F420, 8),
}


def _k6_key(name, precision, upsample="nn", quirks=Quirks.REFERENCE, bits=8):
    h, w, factors, n = K6_CASES[name]
    frame = _k03_frame(h, w, factors, bits)
    rng = np.random.default_rng(len(name))
    qts = tuple(rng.integers(1, 64, 64).astype(np.uint16).tobytes() for _ in factors)
    return (frame, qts, precision, quirks, upsample, 8), n


def _k6_planes(stage, rows, seed, device):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.integers(-300, 300, (n, c.blocks_x, 64)).astype(np.int16))
            .to(device) for n, c in zip(rows, stage.frame.components)]


@pytest.mark.parametrize("bits,quirks", K03_NUMERICS, ids=["8bit_reference", "12bit_correct"])
@pytest.mark.parametrize("name", sorted(K6_CASES))
def test_k6n_chunks_match_plain(cuda_device, name, bits, quirks):
    """ChunkStage, EXACT: each chunk's launches (K03 with the chunk's
    origin, or K0 + K3 with it) bitwise the plain route, one K6n launch a
    chunk."""
    key, n = _k6_key(name, IdctPrecision.EXACT, quirks=quirks, bits=bits)
    stage = tstripes.ChunkStage(key, n, cuda_device)
    for k in (0, n // 2, n - 1):
        planes = _k6_planes(stage, stage.lby, k, cuda_device)
        _build.LAUNCHES.clear()
        got = stage(k, *planes)
        assert _build.LAUNCHES["K6n"] == 1
        assert "jdtc_pixel_exact" not in _build.LAUNCHES and "jdtc_color" not in _build.LAUNCHES
        assert torch.equal(got.cpu(), stage(k, *planes, plain=True).cpu())


@pytest.mark.parametrize("name", sorted(K6_CASES))
def test_k6n_float32_chunks_match_k1_k3(cuda_device, name):
    """ChunkStage, FLOAT32: K13 with the chunk's origin bitwise K1 x 3 + K3
    with it (one order of the 64 products); RGB within 3 of the plain route
    (a sample within 1, and a chroma step of 1 moves R or B by up to
    1.772)."""
    key, n = _k6_key(name, IdctPrecision.FLOAT32)
    stage = tstripes.ChunkStage(key, n, cuda_device)
    k = n - 1
    planes = _k6_planes(stage, stage.lby, k, cuda_device)
    got = stage(k, *planes)
    stripes = tcolor.Stripes(k * stage.hs, stage.hs)
    pix = [tidct.idct_plane(p, q, False, IdctPrecision.FLOAT32)
           for p, q in zip(planes, stage._qts())]
    split = stage._colour(pix, stage.hs, "nn", stripes)
    assert torch.equal(got.cpu(), split.cpu())
    plain = stage(k, *planes, plain=True)
    assert (got.cpu().int() - plain.cpu().int()).abs().max() <= 3


@pytest.mark.parametrize("upsample", ["nn", "fancy"])
@pytest.mark.parametrize("name", sorted(K6_CASES))
def test_k6_stripe_stage_matches_plain(cuda_device, name, upsample):
    """StripeStage, EXACT: every stripe in one launch per kernel (K6n; K6f
    under fancy: K0 per component, then K3f under the striped rule) bitwise
    the JAX program stripe by stripe."""
    key, n = _k6_key(name, IdctPrecision.EXACT, upsample,
                     Quirks.CORRECT if upsample == "fancy" else Quirks.REFERENCE)
    stage = tstripes.StripeStage(key, n, cuda_device)
    planes = _k6_planes(stage, [n * lby for lby in stage.lby], 7, cuda_device)
    _build.LAUNCHES.clear()
    got = stage(*planes)
    kind = "K6f" if upsample == "fancy" and len(stage.factors) > 1 else "K6n"
    assert _build.LAUNCHES[kind] == 1
    assert got.shape == (stage.pad_h, stage.frame.width, 3)
    assert torch.equal(got.cpu(), stage(*planes, plain=True).cpu())


def test_k6f_diverges_in_the_last_row_of_a_padded_4k_frame(cuda_device):
    """3840x2160 4:2:0 in 8 stripes: 135 MCU rows padded to 136. Under
    fancy upsampling K6f differs from the whole-image K3f in row 2159
    alone (the vertical pass's neighbour below it is the padding's copy of
    the last block row), as the JAX stripes do."""
    key, n = _k6_key("420_4k", IdctPrecision.EXACT, "fancy", Quirks.CORRECT)
    stage = tstripes.StripeStage(key, n, cuda_device)
    frame = stage.frame
    planes = _k6_planes(stage, [c.blocks_y for c in frame.components], 3, cuda_device)
    padded = [tstripes._pad_plane_rows(p, n * lby) for p, lby in zip(planes, stage.lby)]
    got = stage(*padded)[: frame.height]
    pixel = [tidct.idct_plane(p, q) for p, q in zip(planes, stage._qts())]
    whole = tcolor.planes_to_rgb(pixel, frame.height, frame.width, stage.factors,
                                 Quirks.CORRECT, "fancy")
    rows = torch.nonzero((got != whole).any(dim=2).any(dim=1)).flatten().tolist()
    assert rows == [2159]


def _photo_frame():
    """A 2048x1536 4:2:0 frame of the corpus photograph's blocks with a
    restart marker per MCU row (3.1 MP; 96 MCU rows)."""
    return photo_jpeg(DRI_FILES[0], 2048, 1536, 128)


@pytest.mark.parametrize("precision", PRECISIONS, ids=lambda p: p.value)
@pytest.mark.parametrize("backend", BACKENDS, ids=lambda b: b.value)
def test_streamed_and_striped_match_jpeg_decoder(cuda_device, backend, precision):
    """decode_streamed (4 chunks: stripe-local entropy under NATIVE, the
    device planes sliced under PALLAS) and decode_striped (8 stripes)
    bitwise the card's whole-image JpegDecoder on a 3.1 MP frame whose MCU
    rows fill the stripes (no padding)."""
    data = _photo_frame()
    cfg = DecodeConfig(entropy_backend=backend, idct_precision=precision)
    want = jtt.JpegDecoder(cfg, device=cuda_device).decode_rgb(data)
    _build.LAUNCHES.clear()
    np.testing.assert_array_equal(
        tstripes.decode_streamed(data, cfg, n_chunks=4, device=cuda_device), want)
    assert _build.LAUNCHES["K6n"] == 4
    np.testing.assert_array_equal(
        tstripes.decode_striped(data, cfg, n_stripes=8, device=cuda_device), want)
    assert _build.LAUNCHES["K6n"] == 5


def test_striped_fancy_matches_jpeg_decoder(cuda_device):
    data = _photo_frame()
    cfg = DecodeConfig(upsample="fancy", quirks=Quirks.CORRECT)
    want = jtt.JpegDecoder(cfg, device=cuda_device).decode_rgb(data)
    _build.LAUNCHES.clear()
    np.testing.assert_array_equal(
        tstripes.decode_streamed(data, cfg, n_chunks=4, device=cuda_device), want)
    np.testing.assert_array_equal(
        tstripes.decode_striped(data, cfg, n_stripes=8, device=cuda_device), want)
    assert _build.LAUNCHES["K6f"] == 2 and _build.LAUNCHES["jdtc_idct_exact"] == 6


# ---------------------------------------------------------------------------
# K6h: one stripe of a mesh's stripe axis (StripeStage.stripe), and the mesh
# ---------------------------------------------------------------------------


def _resident_exchanges(stage, stripe_planes):
    """Each stripe's exchange(first, last): its neighbours' edge rows (of
    their K0/K1 planes on the card), its own at the two ends."""
    edges = [stage.edge_rows([tidct.idct_plane(p, q, stage.bits12, stage.precision)
                              for p, q in zip(planes, stage._qts())])
             for planes in stripe_planes]
    n = len(edges)
    return [lambda first, last, k=k: (edges[k - 1][2] if k else first,
                                      edges[k + 1][1] if k < n - 1 else last)
            for k in range(n)]


def _stripe_by_stripe(stage, planes, plain=False):
    parts = stage._stripes(planes)
    exchanges = _resident_exchanges(stage, parts)
    return torch.cat([stage.stripe(k, p, exchanges[k], plain=plain)
                      for k, p in enumerate(parts)])


@pytest.mark.parametrize("precision", PRECISIONS, ids=lambda p: p.value)
@pytest.mark.parametrize("n", [2, 8])
def test_k6h_stripe_by_stripe_matches_k6f_at_4k(cuda_device, n, precision):
    """3840x2160 4:2:0 under fancy upsampling in n stripes, each decoded
    alone (K0 or K1, then one K6h launch with its neighbours' edge rows):
    bitwise the one-launch K6f over the padded frame and, under EXACT, the
    plain version (the JAX program's stripe)."""
    key, _ = _k6_key("420_4k", precision, "fancy", Quirks.CORRECT)
    stage = tstripes.StripeStage(key, n, cuda_device)
    planes = _k6_planes(stage, [n * lby for lby in stage.lby], 11, cuda_device)
    _build.LAUNCHES.clear()
    got = _stripe_by_stripe(stage, planes)
    assert _build.LAUNCHES["K6h"] == n and "K6f" not in _build.LAUNCHES
    assert torch.equal(got, stage(*planes))
    if precision == IdctPrecision.EXACT:
        assert torch.equal(got.cpu(), _stripe_by_stripe(stage, planes, plain=True).cpu())


@pytest.mark.parametrize("name", sorted(set(K6_CASES) - {"420_4k"}))
def test_k6h_stripe_by_stripe_matches_k6f_and_plain(cuda_device, name):
    """Every geometry of K6_CASES under fancy upsampling, a stripe at a time:
    bitwise K6f and the plain version; a K6h launch a stripe where a
    component's vertical pass reads a halo row (4:2:0, YCCK), else the
    stripe's K3f (K6f) or, gray, K3 (K6n) launch: the (2, 4) ratio takes
    the rule, 4:2:2 only the horizontal pass."""
    key, n = _k6_key(name, IdctPrecision.EXACT, "fancy", Quirks.CORRECT)
    stage = tstripes.StripeStage(key, n, cuda_device)
    planes = _k6_planes(stage, [n * lby for lby in stage.lby], 13, cuda_device)
    _build.LAUNCHES.clear()
    got = _stripe_by_stripe(stage, planes)
    halo = name in ("420", "ycck")
    assert _build.LAUNCHES["K6h"] == (n if halo else 0)
    assert torch.equal(got, stage(*planes))
    assert torch.equal(got.cpu(), _stripe_by_stripe(stage, planes, plain=True).cpu())


def test_one_rank_nccl_mesh_is_bitwise_no_mesh(cuda_device, tmp_path):
    """A one-rank NCCL group (a process of its own, benchmarks/mesh_ranks.py):
    BatchDecoder(mesh).decode_batch of eight 640x352 requests (PALLAS and
    NATIVE, EXACT and FLOAT32), decode_striped(mesh) (fancy and
    nearest-neighbour) and dryrun_multichip(1), each bitwise the call
    without a mesh, K6h launched on the fancy stripes."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    if not torch.distributed.is_nccl_available():
        pytest.skip("this torch has no NCCL")
    for i in range(8):
        (tmp_path / f"batch{i}.jpg").write_bytes(make_jpeg(640, 352, F420, 40, 400 + i))
    r = subprocess.run([sys.executable, "-m", "jpeg_decoder_tpu_torch.benchmarks.mesh_ranks",
                        str(tmp_path), "--rank", "0", "--world", "1", "--backend", "nccl",
                        "--cases", "batches", "stripes", "dryrun"],
                       cwd=Path(__file__).resolve().parent.parent, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    rec = json.loads((tmp_path / "rank0.json").read_text())
    cases = {k: v for k, v in rec.items() if isinstance(v, dict) and "bitwise" in v}
    assert len(cases) == 8 and all(v["bitwise"] for v in cases.values()), cases
    assert cases["decode_striped mesh fancy exact"]["launches"]["K6h"] == 1
    assert cases["BatchDecoder mesh pallas exact decode_batch"]["launches"] == {
        "jdtc_unstuff": 1, "jdtc_entropy_decode": 1, "jdtc_pixel_exact": 1}


def test_streamed_sink_gets_card_tensors(cuda_device):
    data = _photo_frame()
    got = []
    tstripes.decode_streamed(data, DecodeConfig(), n_chunks=3, device=cuda_device,
                             sink=lambda k, rgb, r0, take: got.append(rgb[:take].cpu()))
    want = jtt.JpegDecoder(device=cuda_device).decode_rgb(data)
    np.testing.assert_array_equal(torch.cat(got).numpy(), want)


def test_this_file_leaves_jax_and_the_jax_package_unloaded(cuda_device):
    assert jax_free()
