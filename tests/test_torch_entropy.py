"""The port's device entropy backend (jpeg_decoder_tpu_torch/ops/
entropy_cuda.py) on the CPU, i.e. its plain lockstep version, against the
oracle planes -- the JAX package's own reference for its Pallas kernel
(tests/test_entropy_pallas.py) -- bitwise, with the same guards and error
classes. The stream is parsed once by each package: the oracle reads the
JAX package's structure (`jparse`), the port its own (`parse`); the error
classes named here are the port's, held against the JAX package's by name
and base-class chain."""

import io

import numpy as np
import pytest
import torch

import jpeg_decoder_tpu as jt
from jpeg_decoder_tpu.core import oracle
from jpeg_decoder_tpu.core.types import CoefficientPlanes
from jpeg_decoder_tpu.io.parser import parse as jparse
from jpeg_decoder_tpu.ops import entropy_pallas
from jpeg_decoder_tpu.utils import errors as jerrors
from jpeg_decoder_tpu.utils.config import EncodeConfig
from jpeg_decoder_tpu_torch import (
    DecodeConfig,
    EntropyBackend,
    JpegEntropyError,
    JpegError,
    JpegTruncatedError,
    JpegUnsupportedError,
    convert,
)
from jpeg_decoder_tpu_torch.io.parser import parse
from jpeg_decoder_tpu_torch.ops import entropy_cuda

from . import corpus
from .torch_crossing import assert_same_error_class

CFG = DecodeConfig(entropy_backend=EntropyBackend.PALLAS)
JCFG = jt.DecodeConfig(entropy_backend=jt.EntropyBackend.PALLAS)


def _oracle_planes(data):
    """(the port's structure, the JAX package's oracle planes) of a stream."""
    s = jparse(data)
    planes = CoefficientPlanes(s.frame)
    for scan in s.scans:
        oracle.decode_sequential_scan(s, scan, planes)
    return parse(data), planes


def _port_planes(s, device="cpu"):
    planes, _ = entropy_cuda.entropy_decode(
        s, CFG, convert.zero_planes(s.frame, device))
    return [p.cpu().numpy() for p in planes]


def _assert_matches_oracle(data):
    s, want = _oracle_planes(data)
    got = _port_planes(s)
    for ci in range(s.frame.ncs):
        np.testing.assert_array_equal(got[ci], want.plane(ci))
    return s


def _encode(arr, **kw):
    from jpeg_decoder_tpu.models import encoder

    return encoder.encode(arr, EncodeConfig(quality=90, **kw))


@pytest.mark.parametrize("name,data", corpus.baseline_corpus()[:6],
                         ids=lambda v: v if isinstance(v, str) else "")
def test_plain_matches_oracle_baseline(name, data):
    _assert_matches_oracle(data)


@pytest.mark.parametrize("name,dri,plain", corpus.dri_corpus(),
                         ids=lambda v: v if isinstance(v, str) else "")
def test_plain_matches_oracle_restart_segments(name, dri, plain):
    s = _assert_matches_oracle(dri)
    assert s.scans[0].span.num_segments > 1


@pytest.mark.parametrize("name,data,arr", corpus.exotic_sampling_corpus()[:3],
                         ids=lambda v: v if isinstance(v, str) else "")
def test_plain_matches_oracle_exotic_sampling(name, data, arr):
    _assert_matches_oracle(data)


def test_plain_matches_oracle_many_segments():
    """More than 256 segments: 13 x 25 one-MCU restart segments."""
    arr = np.random.default_rng(77).integers(0, 256, (100, 200, 3), dtype=np.uint8)
    s = _assert_matches_oracle(_encode(arr, subsampling="444", restart_interval=1))
    assert s.scans[0].span.num_segments > 256


def test_plain_matches_oracle_multiscan_sequential():
    arr = np.random.default_rng(3).integers(0, 256, (24, 40, 3), dtype=np.uint8)
    s = _assert_matches_oracle(corpus.multiscan_sequential(arr, redefine_dht=True))
    assert len(s.scans) == 3


def _damaged(damage):
    """A damaged corpus stream. "truncate": a restart-free stream's entropy
    data cut in half. "8" / "40": 16 bytes of 0xA5 at that offset into a DRI
    stream's entropy data (they happen to form valid codes). "ff": eight
    stuffed 0xFF00 pairs at offset 8 there, 64 one-bits that no code of its
    tables matches. "ff_cut": that, and the stream's last restart segment
    cut in half, so one segment has a bad code and another runs out."""
    if damage == "truncate":
        data = corpus.baseline_corpus()[0][1]
        span = parse(data).scans[0].span
        return data[: span.start + (span.end - span.start) // 2]
    data = corpus.dri_corpus()[0][1]
    span = parse(data).scans[0].span
    bad = bytearray(data)
    at = span.start + (8 if damage.startswith("ff") else int(damage))
    bad[at : at + 16] = b"\xff\x00" * 8 if damage.startswith("ff") else b"\xa5" * 16
    if damage == "ff_cut":
        lo, hi = list(span.segment_bounds())[-1]
        bad = bad[: lo + (hi - lo) // 2] + bad[span.end :]
    return bytes(bad)


#: What the JAX backend (entropy_pallas) does with each damaged stream: the
#: error class it raises, or None where the stream decodes. A bad code is
#: reported before truncation (entropy_pallas.py:769-783), hence "ff_cut".
#: test_damaged_outcomes_match_pallas_interpret holds this table against it.
DAMAGED = {
    "truncate": JpegTruncatedError,
    "8": None,
    "40": None,
    "ff": JpegEntropyError,
    "ff_cut": JpegEntropyError,
}


def _outcome(decode, data, parse=parse, base=JpegError):
    """decode(structure)'s planes, or the exact class of the JpegError it
    raised (`parse` and `base` are the package's whose `decode` it is)."""
    try:
        return decode(parse(data))
    except base as e:
        return type(e)


def test_truncated_raises():
    assert _outcome(_port_planes, _damaged("truncate")) is JpegTruncatedError


@pytest.mark.parametrize("damage", ["8", "40", "ff", "ff_cut"])
def test_corrupt_raises_or_matches_oracle(damage):
    """A damaged stream raises exactly the JAX backend's error class, or --
    where the garbage forms valid codes -- decodes as the oracle reads it."""
    data = _damaged(damage)
    got = _outcome(_port_planes, data)
    if DAMAGED[damage] is not None:
        assert got is DAMAGED[damage]
        assert_same_error_class(got, getattr(jerrors, got.__name__))
        return
    assert isinstance(got, list)
    s, want = _oracle_planes(data)
    for ci in range(s.frame.ncs):
        np.testing.assert_array_equal(got[ci], want.plane(ci))


def test_bad_code_is_reported_before_truncation():
    """A segment with a bad code and one that overran: the bad code wins."""
    seg_off = np.array([0, 10, 20], dtype=np.int64)
    status = torch.tensor([[0, 8 * 10 + 8], [1, 3]], dtype=torch.int64)
    with pytest.raises(JpegError) as ei:
        entropy_cuda.check_status(status, seg_off)
    assert ei.type is JpegEntropyError
    with pytest.raises(JpegError) as ei:
        entropy_cuda.check_status(status[:1], seg_off[:2])
    assert ei.type is JpegTruncatedError


def test_rejects_progressive():
    s = parse(corpus.progressive_corpus()[0][1])
    with pytest.raises(JpegUnsupportedError):
        _port_planes(s)


def _large_restart_free():
    from PIL import Image

    arr = np.random.default_rng(8).integers(0, 256, (256, 256), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr, "L").save(buf, "JPEG", quality=85)  # 1024 MCUs
    return buf.getvalue()


def test_rejects_large_restart_free():
    with pytest.raises(JpegUnsupportedError):
        _port_planes(parse(_large_restart_free()))


def test_batchable_agrees_with_jax():
    datas = [d for _, d in corpus.baseline_corpus()[:4]]
    datas += [d for _, d, _ in corpus.dri_corpus()[:2]]
    datas += [corpus.progressive_corpus()[0][1], _large_restart_free()]
    flags = [entropy_cuda.batchable(parse(d)) for d in datas]
    assert flags == [entropy_pallas.batchable(jparse(d)) for d in datas]
    assert True in flags and False in flags


@pytest.mark.slow
def test_plain_matches_pallas_interpret():
    data = corpus.dri_corpus()[0][1]
    s = parse(data)
    want, _ = entropy_pallas.entropy_decode(jparse(data), JCFG, interpret=True)
    got = _port_planes(s)
    for ci in range(s.frame.ncs):
        np.testing.assert_array_equal(got[ci], want.plane(ci))



def _pallas_planes(s):
    want, _ = entropy_pallas.entropy_decode(s, JCFG, interpret=True)
    return [want.plane(ci) for ci in range(s.frame.ncs)]


@pytest.mark.slow
@pytest.mark.parametrize("damage", sorted(DAMAGED))
def test_damaged_outcomes_match_pallas_interpret(damage):
    """The DAMAGED table is the JAX backend's own outcome, and the port's."""
    data = _damaged(damage)
    want = _outcome(_pallas_planes, data, jparse, jerrors.JpegError)
    got = _outcome(_port_planes, data)
    if DAMAGED[damage] is not None:
        assert got is DAMAGED[damage]
        assert_same_error_class(got, want)
        return
    assert isinstance(want, list) and isinstance(got, list)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# The batched launch (entropy_decode_batch): one K2 launch per group
# ---------------------------------------------------------------------------


def _rgb_stream(seed, h, w, subsampling, ri_blocks):
    arr = np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)
    return corpus.make_jpeg(arr, "RGB", quality=85, subsampling=subsampling,
                            restart_marker_blocks=ri_blocks)


def _batch_planes(structures, device="cpu"):
    return [convert.zero_planes(s.frame, device) for s in structures]


def _count_launches(monkeypatch):
    calls = []
    orig = entropy_cuda.decode_segments

    def spy(*args, **kwargs):
        calls.append(args[2].numel())  # segments of the launch
        return orig(*args, **kwargs)

    monkeypatch.setattr(entropy_cuda, "decode_segments", spy)
    return calls


def test_batch_matches_oracle_two_groups(monkeypatch):
    """Segments of several images share one launch per group: (ri, P, unit
    schedule, tables) -- other geometries in one group, another restart
    interval or sampling in another (tests/test_entropy_pallas.py
    test_pallas_batched_multi_image)."""
    datas = [_rgb_stream(s, 48, 64, 2, 4) for s in range(3)]
    datas.append(_rgb_stream(3, 32, 96, 2, 4))   # same group, other geometry
    datas.append(_rgb_stream(4, 24, 40, 0, 3))   # second group (4:4:4)
    datas.append(_rgb_stream(5, 40, 24, 0, 3))
    structures = [parse(d) for d in datas]
    calls = _count_launches(monkeypatch)
    results = entropy_cuda.entropy_decode_batch(structures, CFG, _batch_planes(structures))
    assert len(calls) == 2
    assert sum(calls) == sum(s.scans[0].span.num_segments for s in structures)
    for d, s, (planes, qts) in zip(datas, structures, results):
        _, want = _oracle_planes(d)
        assert sorted(qts) == sorted(s.scans[0].quant_tables)
        for ci in range(s.frame.ncs):
            np.testing.assert_array_equal(planes[ci].numpy(), want.plane(ci))


def test_batch_of_more_than_32_images_matches_single_decodes(monkeypatch):
    """Forty gray 16x16 streams (four one-MCU segments each): 160 segments
    of 40 images in one launch, each image's planes those of its own
    single-image decode."""
    rng = np.random.default_rng(40)
    datas = [corpus.make_jpeg(rng.integers(0, 256, (16, 16), dtype=np.uint8), "L",
                              quality=85, restart_marker_blocks=1) for _ in range(40)]
    structures = [parse(d) for d in datas]
    calls = _count_launches(monkeypatch)
    results = entropy_cuda.entropy_decode_batch(structures, CFG, _batch_planes(structures))
    assert calls == [160]
    for s, (planes, _qts) in zip(structures, results):
        np.testing.assert_array_equal(planes[0].numpy(), _port_planes(s)[0])


@pytest.mark.parametrize(
    "members,error",
    [(["good", "ff"], JpegEntropyError),
     (["ff_cut", "good"], JpegEntropyError),
     (["truncate", "good"], JpegTruncatedError),
     (["truncate", "ff"], JpegTruncatedError),
     (["ff", "truncate"], JpegEntropyError)],
    ids=["bad_code", "bad_code_and_cut", "truncated", "first_group_first",
         "bad_code_group_first"],
)
def test_batch_damaged_members_raise_the_jax_class(members, error):
    """A damaged member raises its class from the batch, each group's
    status read in group order, a bad code before truncation within a
    group (entropy_pallas._run_lane_jobs)."""
    datas = [corpus.dri_corpus()[0][1] if m == "good" else _damaged(m) for m in members]
    structures = [parse(d) for d in datas]
    assert all(entropy_cuda.batchable(s) for s in structures)
    with pytest.raises(JpegError) as ei:
        entropy_cuda.entropy_decode_batch(structures, CFG, _batch_planes(structures))
    assert ei.type is error


@pytest.mark.parametrize("which", ["progressive", "large_restart_free"])
def test_batch_rejects_what_the_backend_does_not_take(which):
    data = (corpus.progressive_corpus()[0][1] if which == "progressive"
            else _large_restart_free())
    structures = [parse(corpus.dri_corpus()[0][1]), parse(data)]
    with pytest.raises(JpegUnsupportedError):
        entropy_cuda.entropy_decode_batch(structures, CFG, _batch_planes(structures))


def test_decode_segments_rejects_a_segment_of_no_image():
    s = parse(corpus.dri_corpus()[0][1])
    args, _ = entropy_cuda.launch_args([entropy_cuda.prepare_scan(s, s.scans[0])], "cpu")
    args[2][-1] = 1  # seg_img: an image the launch does not have
    with pytest.raises(ValueError):
        entropy_cuda.decode_segments(*args, [convert.zero_planes(s.frame, "cpu")])


def test_launch_args_reject_scans_of_two_groups():
    packs = [entropy_cuda.prepare_scan(s, s.scans[0])
             for s in (parse(corpus.dri_corpus()[0][1]), parse(corpus.dri_corpus()[1][1]))]
    assert packs[0].key != packs[1].key
    with pytest.raises(ValueError):
        entropy_cuda.launch_args(packs, "cpu")
