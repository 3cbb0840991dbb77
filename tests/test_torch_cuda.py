"""The port's CUDA kernels (K0, K2, K3) against their plain PyTorch versions,
and the decode path on the card against the same path on the CPU: bitwise.

This file imports neither JAX nor Pillow, so that it runs on a machine with
a card and without them:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

(--noconftest because tests/conftest.py imports JAX.) Without a card every
test here skips. Inputs are random coefficients made from a numpy seed and
packed by the native runtime (chip_smoke.make_jpeg).
"""

import numpy as np
import pytest
import torch

import jpeg_decoder_tpu_torch as jtt
from chip_smoke import make_jpeg
from jpeg_decoder_tpu_torch import (
    DecodeConfig,
    EntropyBackend,
    JpegError,
    Quirks,
    _build,
    convert,
)
from jpeg_decoder_tpu_torch.ops import color as tcolor
from jpeg_decoder_tpu_torch.ops import entropy_cuda
from jpeg_decoder_tpu_torch.ops import idct as tidct
from jpeg_decoder_tpu_torch.shared import parse

pytestmark = pytest.mark.cuda

F420 = ((2, 2), (1, 1), (1, 1))
F444 = ((1, 1), (1, 1), (1, 1))
GRAY = ((1, 1),)
QUIRKS = [Quirks.REFERENCE, Quirks.CORRECT]
PALLAS = DecodeConfig(entropy_backend=EntropyBackend.PALLAS)

#: (w, h, sampling, restart interval, seed): a DRI 4:2:0 stream, one
#: segment per MCU, and a restart-free gray stream whose width is not a
#: multiple of 8.
STREAMS = {
    "420_ri4": (64, 48, F420, 4, 1),
    "444_ri1": (40, 24, F444, 1, 2),
    "gray_no_ri": (100, 37, GRAY, 0, 3),
}


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
    scan = s.scans[0]
    tabs = convert.tables_to_device(s.frame, scan, cuda_device)
    ri, stream, seg_off = entropy_cuda.pack_scan(
        s, scan, tabs.total_mcus, tabs.units.shape[0])
    args = (torch.from_numpy(stream).to(cuda_device),
            torch.from_numpy(seg_off).to(cuda_device),
            ri, tabs.total_mcus, tabs.units, tabs.huffman)
    got = convert.zero_planes(s.frame, cuda_device)
    want = convert.zero_planes(s.frame, cuda_device)
    st_k = entropy_cuda.decode_segments(*args, got)
    st_p = entropy_cuda._decode_segments_plain(*args, want)
    torch.cuda.synchronize()
    assert torch.equal(st_k.cpu(), st_p.cpu())
    entropy_cuda.check_status(st_k, seg_off)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b.cpu())


def _decode_planes_or_error(s, device):
    try:
        planes, _ = entropy_cuda.entropy_decode(
            s, PALLAS, convert.zero_planes(s.frame, device))
    except JpegError as e:
        return type(e)
    return [p.cpu() for p in planes]


def _damaged(damage):
    """A restart-free stream cut short (the EOI kept, so parse() succeeds),
    or 16 garbage bytes at an offset into a DRI stream's entropy data."""
    if damage == "truncate":
        data = _stream("gray_no_ri")
        span = parse(data).scans[0].span
        return data[: span.start + (span.end - span.start) // 2] + data[span.end:]
    data = bytearray(_stream("420_ri4"))
    off = parse(bytes(data)).scans[0].span.start + int(damage[len("corrupt"):])
    data[off : off + 16] = b"\xA5" * 16
    return bytes(data)


@pytest.mark.parametrize("damage", ["truncate", "corrupt8", "corrupt40"])
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
    if damage == "truncate":
        assert want is jtt.JpegTruncatedError


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


@pytest.mark.parametrize("quirks", QUIRKS, ids=lambda q: q.value)
@pytest.mark.parametrize("factors", [GRAY, F420, F444], ids=["gray", "420", "444"])
def test_k3_matches_plain(cuda_device, factors, quirks):
    h, w = 67, 45
    rng = np.random.default_rng(3)
    mh = max(f[0] for f in factors)
    mv = max(f[1] for f in factors)
    mcus_x, mcus_y = -(-w // (8 * mh)), -(-h // (8 * mv))
    planes = [
        torch.from_numpy(rng.integers(0, 256, (mcus_y * fv * 8, mcus_x * fh * 8),
                                      dtype=np.uint8)).to(cuda_device)
        for fh, fv in factors
    ]
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
    expected = {"jdtc_idct_exact", "jdtc_color"}
    if backend == EntropyBackend.PALLAS:
        expected.add("jdtc_entropy_decode")
    assert set(launches) == expected
