"""The port's checkpoint/resume (jpeg_decoder_tpu_torch/core/checkpoint.py)
against the JAX package's (jpeg_decoder_tpu/core/checkpoint.py) on the CPU:
the six cases of tests/test_checkpoint.py, each held against the JAX
ScanDecoder (RGB and pixel planes bitwise; the port's finish runs its pixel
stage with device="cpu", the kernels' plain versions), checkpoint files
across the two packages both ways, and the host path's divergence from the
decoder's (ROADMAP.md §3: with use_device=False, finish is nearest-neighbour
and full size whatever the config asks).
"""

import numpy as np
import pytest

import jpeg_decoder_tpu as jt
import jpeg_decoder_tpu_torch as jtt
from jpeg_decoder_tpu.core import checkpoint as jcheckpoint
from jpeg_decoder_tpu.core import oracle as joracle
from jpeg_decoder_tpu.io.parser import parse as jparse
from jpeg_decoder_tpu.utils import errors as jerrors
from jpeg_decoder_tpu_torch.core import checkpoint, oracle
from jpeg_decoder_tpu_torch.io.parser import parse
from jpeg_decoder_tpu_torch.models import decoder as tdecoder
from jpeg_decoder_tpu_torch.utils import errors

from . import corpus

CFG = jtt.DecodeConfig(entropy_backend=jtt.EntropyBackend.NUMPY)
JCFG = jt.DecodeConfig(entropy_backend=jt.EntropyBackend.NUMPY)
PROGRESSIVE = dict(corpus.progressive_corpus())
BASELINE = dict(corpus.baseline_corpus())


def _port(data, cfg=CFG):
    return checkpoint.ScanDecoder(parse(data), cfg, device="cpu")


def _jax(data, cfg=JCFG):
    return jcheckpoint.ScanDecoder(jparse(data), cfg)


def _run(d, steps=None):
    while not d.finished and (steps is None or d.scans_done < steps):
        d.step()
    return d


def _assert_same_image(got, want):
    """RGB and pixel planes bitwise. The JAX finish hands a gray frame's one
    plane back as the list of its rows (it iterates the stage's plane
    array); the port gives a list of one plane a component, as both
    packages' decoders do (ROADMAP.md §3)."""
    assert got.rgb.shape == want.rgb.shape
    np.testing.assert_array_equal(got.rgb, want.rgb)
    planes = list(want.planes)
    if got.frame.ncs == 1 and len(planes) != 1:
        planes = [np.stack(planes)]
    assert len(got.planes) == len(planes) == got.frame.ncs
    for a, b in zip(got.planes, planes):
        np.testing.assert_array_equal(a, np.asarray(b))


#: every progressive stream of the corpus, and a baseline one of each kind
FULL = {**PROGRESSIVE,
        "gray_odd_q85": BASELINE["gray_odd_q85"], "rgb420_odd_q85": BASELINE["rgb420_odd_q85"],
        "cmyk_q90": BASELINE["cmyk_q90"]}


@pytest.mark.parametrize("name", sorted(FULL))
def test_scan_decoder_matches_jax(name):
    """A full scan-by-scan decode: the port's ScanDecoder bitwise the JAX
    ScanDecoder (RGB and planes) and the port's oracle."""
    data = FULL[name]
    d = _run(_port(data))
    assert d.total_scans == len(parse(data).scans)
    got = d.finish()
    _assert_same_image(got, _run(_jax(data)).finish())
    np.testing.assert_array_equal(got.rgb, oracle.decode(data).rgb)


@pytest.mark.parametrize("cut", [1, 2, 3])
@pytest.mark.parametrize("name", ["prog_444", "prog_420", "prog_420_noise"])
def test_checkpoint_roundtrip_mid_stream(tmp_path, name, cut):
    """A progressive stream checkpointed after `cut` scans and resumed by a
    new decoder over a fresh parse: bitwise the JAX ScanDecoder's full
    decode and the JAX oracle."""
    data = FULL[name]
    d = _run(_port(data), cut)
    ck = tmp_path / "mid.npz"
    d.checkpoint(ck)
    d2 = checkpoint.ScanDecoder.restore(ck, parse(data), CFG, device="cpu")
    assert d2.scans_done == cut and not d2.finished
    got = _run(d2).finish()
    _assert_same_image(got, _run(_jax(data)).finish())
    np.testing.assert_array_equal(got.rgb, joracle.decode(data).rgb)


@pytest.mark.parametrize("steps", [1, 2])
def test_partial_progressive_renders_as_jax(steps):
    """Finishing early gives the JAX package's lower-quality image, bitwise:
    the progressive preview."""
    data = PROGRESSIVE["prog_420"]
    got = _run(_port(data), steps).finish()
    _assert_same_image(got, _run(_jax(data), steps).finish())
    assert got.rgb.shape == (80, 96, 3)
    full = oracle.decode(data).rgb
    assert not np.array_equal(got.rgb, full)
    assert np.abs(got.rgb.astype(int) - full.astype(int)).mean() < 30


@pytest.mark.parametrize("where", [0.25, 0.5, 0.9])
def test_corrupt_checkpoint_raises_the_ports_error(tmp_path, where):
    """A damaged file raises the port's JpegFormatError (not the JAX
    package's class), whether the damage breaks the archive or the digest;
    the JAX package raises too."""
    data = BASELINE["gray_64_q85"]
    ck = tmp_path / "c.npz"
    _run(_port(data), 1).checkpoint(ck)
    raw = bytearray(ck.read_bytes())
    raw[int(len(raw) * where)] ^= 0xFF
    ck.write_bytes(bytes(raw))
    with pytest.raises(errors.JpegFormatError) as ei:
        checkpoint.ScanDecoder.restore(ck, parse(data), CFG, device="cpu")
    assert not isinstance(ei.value, jerrors.JpegError)
    with pytest.raises(Exception):
        jcheckpoint.ScanDecoder.restore(ck, jparse(data), JCFG)


def test_digest_mismatch_is_a_format_error(tmp_path):
    """Planes altered and saved again under the old digest: the digest
    check refuses them in both packages."""
    data = BASELINE["gray_64_q85"]
    ck = tmp_path / "c.npz"
    d = _run(_port(data), 1)
    d.checkpoint(ck)
    with np.load(ck) as z:
        arrays = dict(z)
    arrays["plane_0"] = arrays["plane_0"].copy()
    arrays["plane_0"][0, 0, 0] += 1
    np.savez_compressed(ck, **arrays)
    with pytest.raises(errors.JpegFormatError, match="digest"):
        checkpoint.load_checkpoint(ck)
    with pytest.raises(jerrors.JpegFormatError, match="digest"):
        jcheckpoint.load_checkpoint(ck)


def test_geometry_mismatch_rejected(tmp_path):
    a, b = BASELINE["gray_64_q85"], BASELINE["rgb444_q90"]
    ck = tmp_path / "c.npz"
    _run(_port(a), 1).checkpoint(ck)
    with pytest.raises(errors.JpegError, match="geometry"):
        checkpoint.ScanDecoder.restore(ck, parse(b), CFG, device="cpu")
    with pytest.raises(jerrors.JpegError, match="geometry"):
        jcheckpoint.ScanDecoder.restore(ck, jparse(b), JCFG)


@pytest.mark.parametrize("name", ["gray_64_q85", "prog_gray"])
def test_step_past_end_raises(name):
    data = FULL.get(name) or BASELINE[name]
    d = _run(_port(data))
    with pytest.raises(errors.JpegError, match="already decoded"):
        d.step()
    j = _run(_jax(data))
    with pytest.raises(jerrors.JpegError, match="already decoded"):
        j.step()


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("name", ["prog_444", "prog_420_noise", "rgb420_odd_q85"])
def test_checkpoint_files_cross_packages(tmp_path, name, writer):
    """A file written by either package restores in the other: the same
    cursor, tables and planes, and the same image when finished."""
    data = FULL[name]
    ck = tmp_path / f"{writer}.npz"
    (_run(_port(data), 1) if writer == "port" else _run(_jax(data), 1)).checkpoint(ck)
    mine = checkpoint.ScanDecoder.restore(ck, parse(data), CFG, device="cpu")
    theirs = jcheckpoint.ScanDecoder.restore(ck, jparse(data), JCFG)
    assert mine.scans_done == theirs.scans_done == 1
    assert sorted(mine.qts) == sorted(theirs.qts)
    for t in mine.qts:
        np.testing.assert_array_equal(mine.qts[t], theirs.qts[t])
    for a, b in zip(mine.planes.planes, theirs.planes.planes):
        np.testing.assert_array_equal(a, b)
    _assert_same_image(_run(mine).finish(), _run(theirs).finish())


def test_checkpoint_metadata_is_the_jax_packages(tmp_path):
    """Both packages write the same metadata (format version, frame, cursor,
    tables and the digest over them) for the same decode."""
    data = PROGRESSIVE["prog_420"]
    mine, theirs = tmp_path / "mine.npz", tmp_path / "theirs.npz"
    _run(_port(data), 2).checkpoint(mine)
    _run(_jax(data), 2).checkpoint(theirs)
    with np.load(mine) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files)
        for f in a.files:
            np.testing.assert_array_equal(a[f], b[f])


FINISH_CONFIGS = {
    "fancy": dict(upsample="fancy"),
    "correct": dict(quirks=jtt.Quirks.CORRECT),
}


@pytest.mark.parametrize("config", sorted(FINISH_CONFIGS))
@pytest.mark.parametrize("name", ["prog_420", "rgb420_odd_q85"])
def test_finish_follows_the_config_as_jax(name, config):
    """finish runs the pixel stage the config asks for (fancy upsampling,
    CORRECT quirks), bitwise the JAX finish."""
    data = FULL[name]
    cfg = CFG.replace(**FINISH_CONFIGS[config])
    jcfg = JCFG.replace(upsample=cfg.upsample, quirks=jt.Quirks[cfg.quirks.name])
    _assert_same_image(_run(_port(data, cfg)).finish(), _run(_jax(data, jcfg)).finish())


@pytest.mark.parametrize("scale", [1, 2, 4])
def test_finish_scaled_is_the_decoders_scaled_decode(scale):
    """At scale < 8 finish is the pixel stage of the scaled decode: bitwise
    the port's own decode of the stream at that scale (both run
    PixelStage), the size the scale gives."""
    data = BASELINE["rgb420_odd_q85"]
    cfg = CFG.replace(scale=scale)
    got = _run(_port(data, cfg)).finish()
    want = jtt.decode(data, cfg, device="cpu")
    _assert_same_image(got, want)
    assert got.rgb.shape == (-(-67 * scale // 8), -(-45 * scale // 8), 3)


@pytest.mark.parametrize("config", [dict(upsample="fancy"), dict(scale=4),
                                    dict(scale=2, upsample="fancy")],
                         ids=["fancy", "scale4", "scale2_fancy"])
def test_host_finish_is_nearest_neighbour_at_full_size(config):
    """The deliberate divergence (ROADMAP.md §3): with use_device=False,
    finish is the NumPy oracle's EXACT IDCT and nearest-neighbour colour at
    full size, whatever the upsampling and scale, as the JAX finish;
    the decoder's host path instead runs the fancy passes, and raises at
    scale != 8, in both packages."""
    data = BASELINE["rgb420_odd_q85"]
    cfg = CFG.replace(use_device=False, **config)
    got = _run(_port(data, cfg)).finish()
    jcfg = JCFG.replace(use_device=False, upsample=cfg.upsample, scale=cfg.scale)
    _assert_same_image(got, _run(_jax(data, jcfg)).finish())
    nn = oracle.decode(data)
    assert got.rgb.shape == (67, 45, 3)
    np.testing.assert_array_equal(got.rgb, nn.rgb)
    if cfg.scale != 8:
        with pytest.raises(errors.JpegConfigError, match="scale"):
            jtt.decode(data, cfg, device="cpu")
    else:
        fancy = jtt.decode(data, cfg, device="cpu").rgb
        assert not np.array_equal(fancy, got.rgb)


def test_scan_decoder_defaults_to_the_card():
    """Without a card the default device raises, as every entry point's;
    device="cpu" must be asked for."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is valid")
    data = BASELINE["gray_64_q85"]
    with pytest.raises(RuntimeError, match="cuda"):
        checkpoint.ScanDecoder(parse(data), CFG)
    assert _port(data).device.type == "cpu"
    assert tdecoder.device_stage_for is not None
