"""The port's device entropy backend (jpeg_decoder_tpu_torch/ops/
entropy_cuda.py) on the CPU, i.e. its plain lockstep version, against the
oracle planes -- the JAX package's own reference for its Pallas kernel
(tests/test_entropy_pallas.py) -- bitwise, with the same guards and error
classes."""

import io

import numpy as np
import pytest
import torch

from jpeg_decoder_tpu.core import oracle
from jpeg_decoder_tpu.core.types import CoefficientPlanes
from jpeg_decoder_tpu.io.parser import parse
from jpeg_decoder_tpu.ops import entropy_pallas
from jpeg_decoder_tpu.utils.config import DecodeConfig, EncodeConfig, EntropyBackend
from jpeg_decoder_tpu.utils.errors import (
    JpegEntropyError,
    JpegError,
    JpegTruncatedError,
    JpegUnsupportedError,
)
from jpeg_decoder_tpu_torch import convert
from jpeg_decoder_tpu_torch.ops import entropy_cuda

from . import corpus

CFG = DecodeConfig(entropy_backend=EntropyBackend.PALLAS)


def _oracle_planes(data):
    s = parse(data)
    planes = CoefficientPlanes(s.frame)
    for scan in s.scans:
        oracle.decode_sequential_scan(s, scan, planes)
    return s, planes


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


def _outcome(decode, data):
    """decode(structure)'s planes, or the exact class of the JpegError it
    raised."""
    try:
        return decode(parse(data))
    except JpegError as e:
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
    assert flags == [entropy_pallas.batchable(parse(d)) for d in datas]
    assert True in flags and False in flags


@pytest.mark.slow
def test_plain_matches_pallas_interpret():
    s = parse(corpus.dri_corpus()[0][1])
    want, _ = entropy_pallas.entropy_decode(s, CFG, interpret=True)
    got = _port_planes(s)
    for ci in range(s.frame.ncs):
        np.testing.assert_array_equal(got[ci], want.plane(ci))



def _pallas_planes(s):
    want, _ = entropy_pallas.entropy_decode(s, CFG, interpret=True)
    return [want.plane(ci) for ci in range(s.frame.ncs)]


@pytest.mark.slow
@pytest.mark.parametrize("damage", sorted(DAMAGED))
def test_damaged_outcomes_match_pallas_interpret(damage):
    """The DAMAGED table is the JAX backend's own outcome, and the port's."""
    data = _damaged(damage)
    want = _outcome(_pallas_planes, data)
    got = _outcome(_port_planes, data)
    if DAMAGED[damage] is not None:
        assert want is DAMAGED[damage] and got is want
        return
    assert isinstance(want, list) and isinstance(got, list)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
