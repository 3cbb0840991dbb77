"""The card checks' input makers (jpeg_decoder_tpu_torch/benchmarks/inputs.py)
for 4-component frames: the Adobe APP14 marker that pack_jpeg writes is what
the port's parser reads back, make_jpeg packs 4 components, and photo_jpeg
tiles a 4-component photograph (tests/wild_files/transcoded/
hopper_cmyk_adobe.jpg) with its own coefficients and colour transform. The
JAX package decodes each stream to the same planes as the port."""

from pathlib import Path

import numpy as np
import pytest

import jpeg_decoder_tpu as jt
import jpeg_decoder_tpu_torch as jtt
from jpeg_decoder_tpu.models import decoder as jdecoder
from jpeg_decoder_tpu_torch import DecodeConfig
from jpeg_decoder_tpu_torch.benchmarks import inputs
from jpeg_decoder_tpu_torch.core import types
from jpeg_decoder_tpu_torch.models import host

HOPPER_CMYK = (Path(__file__).resolve().parent / "wild_files" / "transcoded"
               / "hopper_cmyk_adobe.jpg")
F4 = ((1, 1),) * 4


@pytest.mark.parametrize("transform", [None, 0, 1, 2])
def test_pack_jpeg_writes_the_adobe_marker_the_parser_reads(transform):
    """make_jpeg (through pack_jpeg) with and without the APP14 marker: the
    port's parser and the JAX package's read the same transform, and the
    JAX package decodes the 4 components to the port's planes."""
    data = inputs.make_jpeg(24, 16, F4, 1, 5, transform)
    frame = jtt.parse(data).frame
    assert frame.ncs == 4
    assert frame.adobe_transform == transform
    assert jt.parse(data).frame.adobe_transform == transform
    _, planes, _ = host.host_decode(data, DecodeConfig())
    _, want, _ = jdecoder.host_decode(data)
    for a, b in zip(planes.planes, want.planes):
        np.testing.assert_array_equal(a, b)


def test_adobe_marker_is_ignored_by_three_component_frames():
    data = inputs.make_jpeg(24, 16, ((2, 2), (1, 1), (1, 1)), 1, 6, 0)
    assert jtt.parse(data).frame.adobe_transform is None


def test_make_jpeg_packs_four_components_at_ten_units():
    """4 components, 10 data units an MCU (the most JPEG allows): the
    planes the native host decoder reads are make_jpeg's own random
    coefficients."""
    factors = ((2, 2), (1, 1), (1, 1), (2, 2))
    data = inputs.make_jpeg(48, 32, factors, 2, 7, 2)
    frame, planes, qts = host.host_decode(data, DecodeConfig())
    rng = np.random.default_rng(7)
    for (fh, fv), got in zip(factors, planes.planes):
        shape = (2 * fv, 3 * fh, 64)
        want = np.clip(np.rint(rng.laplace(0.0, 4.0, shape)), -1023, 1023)
        want[..., 0] = rng.integers(-60, 61, shape[:2])
        np.testing.assert_array_equal(got, want.astype(np.int16))
    assert sorted(qts) == [0, 1]
    np.testing.assert_array_equal(qts[0], types.standard_luminance_qtable())


def test_photo_jpeg_tiles_a_four_component_photograph():
    """hopper_cmyk_adobe.jpg (512x600 4:4:4, APP14 transform 0) tiled to
    1280x720 with a restart marker every 20 MCUs: its own blocks, tables
    and transform; PALLAS takes it."""
    data = inputs.photo_jpeg(HOPPER_CMYK, 1280, 720, 20)
    s = jtt.parse(data)
    assert (s.frame.width, s.frame.height, s.frame.ncs) == (1280, 720, 4)
    assert s.frame.adobe_transform == 0
    assert s.scans[0].restart_interval == 20
    src_frame, src, src_qts = host.host_decode(HOPPER_CMYK.read_bytes(), DecodeConfig())
    _, got, qts = host.host_decode(data, DecodeConfig())
    for a, b in zip(got.planes, src.planes):
        tile = np.tile(b, (2, 3, 1))[: a.shape[0], : a.shape[1]]
        np.testing.assert_array_equal(a, tile)
    np.testing.assert_array_equal(qts[0], src_qts[src_frame.components[0].qtid])
    cfg = DecodeConfig(entropy_backend=jtt.EntropyBackend.PALLAS)
    pallas = jtt.decode(inputs.photo_jpeg(HOPPER_CMYK, 160, 96, 4), cfg, device="cpu")
    native = jtt.decode(inputs.photo_jpeg(HOPPER_CMYK, 160, 96, 4), device="cpu")
    np.testing.assert_array_equal(pallas.rgb, native.rgb)


def test_photo_jpeg_refuses_twelve_bit_files(tmp_path):
    from .test_12bit import _make_12bit_gray

    path = tmp_path / "gray12.jpg"
    path.write_bytes(_make_12bit_gray(nb_y=2, nb_x=2, restart_interval=1)[0])
    with pytest.raises(ValueError, match="8-bit"):
        inputs.photo_jpeg(path, 32, 32, 1)
