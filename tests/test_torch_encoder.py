"""The port's encoder (jpeg_decoder_tpu_torch.encode, JpegEncoder) on the CPU
against the JAX package's (jpeg_decoder_tpu.encode): whole files byte for
byte, for every sampling, both table modes, restart intervals, progressive
output and the quality ladder; encode_stream against per-image encode; the
round trip through the port's own parser and native entropy decoder back to
the stage's planes; and the errors. The port runs with device="cpu", its
kernels' plain versions; the JAX side jits its device stage on the CPU.

Each side gets its own package's EncodeConfig (convert.encode_config_from
crosses by field names). One image size serves the whole-file cases, so
that the JAX stages compile once per sampling and quality."""

import numpy as np
import pytest
import torch

import jpeg_decoder_tpu as jt
import jpeg_decoder_tpu_torch as jtt
from jpeg_decoder_tpu.models import encoder as jenc
from jpeg_decoder_tpu.utils.errors import JpegConfigError as JaxJpegConfigError
from jpeg_decoder_tpu_torch import convert
from jpeg_decoder_tpu_torch.io.parser import parse
from jpeg_decoder_tpu_torch.models import encoder as tenc
from jpeg_decoder_tpu_torch.native import runtime as native_runtime
from jpeg_decoder_tpu_torch.ops import fdct as tfdct
from jpeg_decoder_tpu_torch.utils.errors import JpegConfigError

from .torch_crossing import assert_same_error_class

SAMPLINGS = ["444", "422", "420", "411", "440", "mixed", "gray"]
SIZE = (37, 53)


def _image(h, w, seed, gray2d=False):
    """A gradient with noise in the top half and uniform noise below: few
    symbols per block there, every symbol class here."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1),
                     (xx + yy) * 127 // max(h + w - 2, 1)], -1)
    img = np.clip(base + rng.integers(-6, 7, base.shape), 0, 255)
    img[h // 2 :] = rng.integers(0, 256, img[h // 2 :].shape)
    img = img.astype(np.uint8)
    return img[..., 1].copy() if gray2d else img


IMG = _image(*SIZE, seed=1)


def _both(img, **kw) -> tuple[bytes, bytes]:
    """(the port's bytes, the JAX package's bytes) for one config."""
    cfg = jt.EncodeConfig(**kw)
    return jtt.encode(img, convert.encode_config_from(cfg), device="cpu"), jt.encode(img, cfg)


@pytest.mark.parametrize("ri", [0, 1, 3])
@pytest.mark.parametrize("huffman", ["annex_k", "optimized"])
@pytest.mark.parametrize("sampling", SAMPLINGS)
def test_encode_matches_jax(sampling, huffman, ri):
    got, want = _both(IMG, subsampling=sampling, huffman=huffman, restart_interval=ri,
                      quality=80)
    assert got == want


@pytest.mark.parametrize("huffman", ["annex_k", "optimized"])
def test_encode_gray_2d_matches_jax(huffman):
    got, want = _both(_image(*SIZE, seed=2, gray2d=True), huffman=huffman, restart_interval=2)
    assert got == want


@pytest.mark.parametrize("sampling", ["420", "444", "gray"])
def test_encode_progressive_matches_jax(sampling):
    got, want = _both(IMG, subsampling=sampling, progressive=True)
    assert got[:4] == b"\xff\xd8\xff\xe0" and b"\xff\xc2" in got
    assert got == want


@pytest.mark.parametrize("quality", [1, 5, 25, 50, 75, 90, 95, 100])
def test_encode_quality_ladder_matches_jax(quality):
    got, want = _both(IMG, quality=quality, restart_interval=1)
    assert got == want


@pytest.mark.parametrize("size", [(1, 1), (8, 8), (16, 16), (9, 250)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_encode_small_and_wide_images_match_jax(size):
    """Planes of one block (the JAX stage's matrix-vector order) and a
    4:2:0 chroma plane 128 samples wide (its box sums by rows)."""
    for sampling in ("420", "444", "gray"):
        got, want = _both(_image(*size, seed=size[1]), subsampling=sampling)
        assert got == want, sampling


def test_encode_stream_matches_encode():
    imgs = [IMG, _image(16, 24, 3), _image(41, 57, 4, gray2d=True), _image(8, 8, 5)]
    enc = jtt.JpegEncoder(jtt.EncodeConfig(quality=70, restart_interval=2), device="cpu")
    tenc.FALLBACKS.clear()
    got = list(enc.encode_stream(imgs))
    assert got == [enc.encode(i) for i in imgs]
    assert got == list(jenc.JpegEncoder(jt.EncodeConfig(quality=70, restart_interval=2))
                       .encode_stream(imgs))
    assert list(enc.encode_stream([])) == []
    assert list(enc.encode_stream(iter(imgs[:1]))) == got[:1]
    assert not tenc.FALLBACKS


@pytest.mark.parametrize("sampling", ["420", "mixed", "gray"])
def test_round_trip_gives_the_stage_planes(sampling):
    """The port's bytes, parsed and entropy-decoded by the port's native
    host decoder, give exactly the planes the device stage made."""
    cfg = jtt.EncodeConfig(quality=80, subsampling=sampling, restart_interval=3)
    data = jtt.encode(IMG, cfg, device="cpu")
    planes, _ = native_runtime.entropy_decode(parse(data), jtt.DecodeConfig())
    qts = tenc.quality_qtables(cfg.quality)
    gray = sampling == "gray"
    stage = tenc.EncodeStage(*SIZE, sampling, (qts[0].tobytes(), qts[1].tobytes()), gray,
                             torch.device("cpu"))
    _, want = stage(torch.from_numpy(IMG))
    assert len(planes.planes) == len(want)
    for got, w in zip(planes.planes, want):
        np.testing.assert_array_equal(got, w.numpy())


def test_python_packer_fallback_is_counted_and_byte_identical(monkeypatch):
    """Without the native runtime the Python packer and symbol count run,
    give the same bytes, and FALLBACKS counts each use."""
    want = jtt.encode(IMG, jtt.EncodeConfig(huffman="optimized", restart_interval=2),
                      device="cpu")
    monkeypatch.setattr(native_runtime, "available", lambda: False)
    tenc.FALLBACKS.clear()
    got = jtt.encode(IMG, jtt.EncodeConfig(huffman="optimized", restart_interval=2),
                     device="cpu")
    assert got == want
    assert tenc.FALLBACKS == {"pack": 1, "count": 1}


@pytest.mark.parametrize("bad", ["4d", "2ch", "float", "int16"])
def test_bad_inputs_raise_the_ports_config_error(bad):
    img = {"4d": np.zeros((2, 8, 8, 3), np.uint8), "2ch": np.zeros((8, 8, 2), np.uint8),
           "float": np.zeros((8, 8, 3), np.float32), "int16": np.zeros((8, 8), np.int16)}[bad]
    with pytest.raises(JpegConfigError) as got:
        jtt.encode(img, device="cpu")
    with pytest.raises(JaxJpegConfigError) as want:
        jt.encode(img)
    assert_same_error_class(type(got.value), type(want.value))
    assert not isinstance(got.value, jt.JpegError)


def test_config_crossing_and_the_cuda_default():
    cfg = jt.EncodeConfig(quality=33, subsampling="mixed", restart_interval=4,
                          huffman="optimized", progressive=True)
    ours = convert.encode_config_from(cfg)
    assert type(ours) is jtt.EncodeConfig and ours == jtt.EncodeConfig(
        quality=33, subsampling="mixed", restart_interval=4, huffman="optimized",
        progressive=True)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            jtt.JpegEncoder()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            jtt.encode(IMG)


def test_the_stage_is_cached_per_key():
    qts = tenc.quality_qtables(85)
    qb = (qts[0].tobytes(), qts[1].tobytes())
    a = tenc._build_encode_stage(16, 16, "420", qb, False, torch.device("cpu"))
    assert a is tenc._build_encode_stage(16, 16, "420", qb, False, torch.device("cpu"))
    assert a is not tenc._build_encode_stage(16, 16, "444", qb, False, torch.device("cpu"))
    assert a.kq.shape == (2, 64, 64) and a.factors == tenc._SAMPLING["420"]
    np.testing.assert_array_equal(a.kq[1].numpy(), tfdct.fdct_table(qts[1]))
