"""The port's batch serving path (jpeg_decoder_tpu_torch.BatchDecoder on
device="cpu", i.e. the plain versions of every kernel) against
jpeg_decoder_tpu.parallel.batch.BatchDecoder(cfg, mesh=None).

The JAX side runs its NATIVE config: its PALLAS batch runs the lockstep
kernel in interpret mode, which its own tests slow-mark, and its entropy
backends are bitwise equal to each other. The port runs both its PALLAS
(batched K2's plain version) and NATIVE configs.

Tolerances: EXACT RGB bitwise. FLOAT32 RGB within 3 of the JAX package's:
each pixel plane may differ by 1 (the +-1 LSB contract; the two products sum
in other orders), and a chroma step of 1 moves R or B by up to 1.772, so a
channel can move by 1 from luma and 2 from chroma. Within the port every
batched RGB is bitwise equal to its single-image decode.

The unqualified config, enums and error classes are the port's; the JAX
side is given its own package's, members crossing by name.
"""

import functools

import numpy as np
import pytest

import jpeg_decoder_tpu as jt
import jpeg_decoder_tpu_torch as jtt
from jpeg_decoder_tpu.parallel import batch as jbatch
from jpeg_decoder_tpu.utils.errors import JpegFormatError as JaxJpegFormatError
from jpeg_decoder_tpu_torch import (
    DecodeConfig,
    EntropyBackend,
    IdctPrecision,
    JpegFormatError,
)
from jpeg_decoder_tpu_torch.io.parser import parse
from jpeg_decoder_tpu_torch.ops import entropy_cuda

from . import corpus
from .torch_crossing import assert_same_error_class

BACKENDS = [EntropyBackend.PALLAS, EntropyBackend.NATIVE]
PRECISIONS = list(IdctPrecision)
#: FLOAT32 RGB tolerance against the JAX package (module docstring)
FLOAT32_RGB_TOL = 3


def _rgb_stream(seed, h, w, subsampling=2, ri_blocks=4):
    arr = np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)
    return corpus.make_jpeg(arr, "RGB", quality=85, subsampling=subsampling,
                            restart_marker_blocks=ri_blocks)


#: Six same-geometry 48x64 4:2:0 requests, eight restart segments each.
DATAS = [_rgb_stream(s, 48, 64) for s in range(6)]


def _port(backend, precision):
    return jtt.BatchDecoder(
        DecodeConfig(entropy_backend=backend, idct_precision=precision),
        device="cpu")


@functools.lru_cache(maxsize=None)
def _jax(precision):
    cfg = jt.DecodeConfig(idct_precision=jt.IdctPrecision[precision.name])
    return jbatch.BatchDecoder(cfg, mesh=None)


def _assert_rgb(got, want, precision):
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.uint8
    if precision == IdctPrecision.EXACT:
        np.testing.assert_array_equal(got, want)
    else:
        d = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert d.max() <= FLOAT32_RGB_TOL


def _assert_matches_single(rgbs, datas, cfg):
    for rgb, d in zip(rgbs, datas):
        np.testing.assert_array_equal(rgb, jtt.decode(d, cfg, device="cpu").rgb)


@functools.lru_cache(maxsize=None)
def _jax_batch(precision):
    return _jax(precision).decode_batch(DATAS)


@pytest.mark.parametrize("precision", PRECISIONS, ids=lambda p: p.value)
@pytest.mark.parametrize("backend", BACKENDS, ids=lambda b: b.value)
def test_decode_batch_matches_jax(backend, precision):
    dec = _port(backend, precision)
    got = dec.decode_batch(DATAS)
    assert got.shape == (6, 48, 64, 3)
    _assert_rgb(got, _jax_batch(precision), precision)
    _assert_matches_single(got, DATAS, dec.cfg)


@pytest.mark.parametrize("precision", PRECISIONS, ids=lambda p: p.value)
@pytest.mark.parametrize("backend", BACKENDS, ids=lambda b: b.value)
def test_decode_stream_matches_jax(backend, precision):
    """Batches of 4 and 2, the host stage of the second overlapping the
    device stage of the first; the JAX stream of the same batches."""
    got = list(_port(backend, precision).decode_stream(iter(DATAS), batch_size=4))
    assert [g.shape[0] for g in got] == [4, 2]
    want = np.concatenate(list(_jax(precision).decode_stream(DATAS, batch_size=4)))
    _assert_rgb(np.concatenate(got), want, precision)
    np.testing.assert_array_equal(np.concatenate(got),
                                  _port(backend, precision).decode_batch(DATAS))


#: A mixed request list: two geometries, a second restart interval, a
#: restart-free gray request whose width is not a multiple of 8.
MANY = [DATAS[0], _rgb_stream(10, 32, 32), DATAS[1],
        _rgb_stream(11, 32, 32, ri_blocks=2),
        corpus.make_jpeg(np.random.default_rng(12).integers(0, 256, (21, 27), dtype=np.uint8),
                         "L", quality=85),
        DATAS[2]]


@pytest.mark.parametrize("precision", PRECISIONS, ids=lambda p: p.value)
@pytest.mark.parametrize("backend", BACKENDS, ids=lambda b: b.value)
def test_decode_many_matches_jax(backend, precision):
    dec = _port(backend, precision)
    got = dec.decode_many(MANY)
    want = _jax(precision).decode_many(MANY)
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        _assert_rgb(g, w, precision)
    _assert_matches_single(got, MANY, dec.cfg)


def _mixed_fallback_datas():
    """tests/test_entropy_pallas.py test_batchdecoder_pallas_mixed_fallback:
    128x1024 4:2:0 (512 MCUs); the middle member is restart-free, over the
    backend's 256-MCU single-segment bound."""
    return [_rgb_stream(20, 128, 1024, ri_blocks=2),
            _rgb_stream(21, 128, 1024, ri_blocks=0),
            _rgb_stream(22, 128, 1024, ri_blocks=2)]


@pytest.mark.parametrize("precision", PRECISIONS, ids=lambda p: p.value)
def test_pallas_mixed_fallback_matches_jax(precision, monkeypatch):
    """The batchable members decode in one K2 launch; the restart-free one
    takes the native host decode into its slice of the same batch."""
    datas = _mixed_fallback_datas()
    assert [entropy_cuda.batchable(parse(d)) for d in datas] == [True, False, True]
    launches = []
    orig = entropy_cuda.decode_segments

    def spy(*args, **kwargs):
        launches.append(len(args[-1]))  # images in the launch
        return orig(*args, **kwargs)

    monkeypatch.setattr(entropy_cuda, "decode_segments", spy)
    got = _port(EntropyBackend.PALLAS, precision).decode_batch(datas)
    assert launches == [2]
    _assert_rgb(got, _jax(precision).decode_batch(datas), precision)
    np.testing.assert_array_equal(
        got, _port(EntropyBackend.NATIVE, precision).decode_batch(datas))


@pytest.mark.parametrize("precision", PRECISIONS, ids=lambda p: p.value)
@pytest.mark.parametrize("backend", BACKENDS, ids=lambda b: b.value)
def test_mixed_geometry_raises_format_error(backend, precision):
    datas = [DATAS[0], MANY[1]]
    with pytest.raises(JaxJpegFormatError):
        _jax(precision).decode_batch(datas)
    with pytest.raises(JpegFormatError):
        _port(backend, precision).decode_batch(datas)
    assert_same_error_class(JpegFormatError, JaxJpegFormatError)


def test_empty_requests():
    dec = _port(EntropyBackend.PALLAS, IdctPrecision.EXACT)
    assert dec.decode_batch([]).shape == (0, 0, 0, 3)
    assert list(dec.decode_stream([])) == []
    assert dec.decode_many([]) == []


def test_module_decode_batch_and_config_checks():
    """The module's decode_batch; and BatchDecoder(scale=4) gives the JAX
    BatchDecoder's [B, h/2, w/2, 3] (scale 4 is the FLOAT32 product under
    either contract: RGB within 3)."""
    got = jtt.decode_batch(DATAS[:2], DecodeConfig(), device="cpu")
    np.testing.assert_array_equal(got, _jax_batch(IdctPrecision.EXACT)[:2])
    small = jtt.BatchDecoder(DecodeConfig(scale=4), device="cpu").decode_batch(DATAS[:2])
    want = jbatch.BatchDecoder(jt.DecodeConfig(scale=4), mesh=None).decode_batch(DATAS[:2])
    assert small.shape == (2, 24, 32, 3)
    _assert_rgb(small, want, IdctPrecision.FLOAT32)


# ---------------------------------------------------------------------------
# Fancy upsampling, scaled decode and 4 components
# ---------------------------------------------------------------------------


def _four_streams(transform):
    """Four same-geometry 4-component streams (random coefficients packed
    by the port's native runtime, a restart marker every 2 MCUs) with
    APP14 transform `transform`."""
    from jpeg_decoder_tpu_torch.benchmarks.inputs import make_jpeg

    return [make_jpeg(40, 24, ((1, 1),) * 4, 2, 60 + i, transform) for i in range(4)]


#: name -> (config fields, the streams)
BATCH_CONFIGS = {
    "fancy": (dict(upsample="fancy"), DATAS[:4]),
    "fancy_float32": (dict(upsample="fancy", idct_precision=IdctPrecision.FLOAT32),
                      DATAS[:4]),
    "scale4": (dict(scale=4), DATAS[:4]),
    "scale2_float32": (dict(scale=2, idct_precision=IdctPrecision.FLOAT32), DATAS[:4]),
    "ycck": (dict(), _four_streams(2)),
    "cmyk_correct_fancy": (dict(quirks=jtt.Quirks.CORRECT, upsample="fancy"),
                           _four_streams(0)),
    "host_pixels_flag": (dict(use_device=False), DATAS[:4]),
}


@pytest.mark.parametrize("backend", BACKENDS, ids=lambda b: b.value)
@pytest.mark.parametrize("name", sorted(BATCH_CONFIGS))
def test_new_configs_batch_match_jax(name, backend):
    """decode_batch against the JAX BatchDecoder(mesh=None) (which never
    reads use_device: the pixel stage runs on the device), and each batched
    RGB bitwise its single-image decode. EXACT at full size bitwise, except
    YCCK, which is held bitwise against the JAX package's host chain and
    within 1 of its jitted stage (ROADMAP.md §3); FLOAT32 and scaled
    decodes within 3."""
    fields, datas = BATCH_CONFIGS[name]
    cfg = DecodeConfig(entropy_backend=backend, **fields)
    dec = jtt.BatchDecoder(cfg, device="cpu")
    got = dec.decode_batch(datas)
    jcfg = jt.DecodeConfig(
        idct_precision=jt.IdctPrecision[cfg.idct_precision.name],
        quirks=jt.Quirks[cfg.quirks.name], upsample=cfg.upsample, scale=cfg.scale,
        use_device=cfg.use_device)
    want = jbatch.BatchDecoder(jcfg, mesh=None).decode_batch(datas)
    k = cfg.scale
    assert got.shape == want.shape == (len(datas), -(-parse(datas[0]).frame.height * k // 8),
                                      -(-parse(datas[0]).frame.width * k // 8), 3)
    exact = cfg.idct_precision == IdctPrecision.EXACT and k == 8
    if name == "ycck":
        host = np.stack([jt.decode(d, jcfg.replace(use_device=False)).rgb for d in datas])
        np.testing.assert_array_equal(got, host)
        assert np.abs(got.astype(np.int32) - want).max() <= 1
    else:
        _assert_rgb(got, want, IdctPrecision.EXACT if exact else IdctPrecision.FLOAT32)
    _assert_matches_single(got, datas, cfg)
    if cfg.use_device:
        return
    # the batch path is the device stage whatever use_device says
    np.testing.assert_array_equal(
        got, jtt.BatchDecoder(cfg.replace(use_device=True), device="cpu").decode_batch(datas))
