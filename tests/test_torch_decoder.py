"""The port's decode path end to end on the CPU (jpeg_decoder_tpu_torch.decode
with device="cpu", i.e. the plain versions of every kernel) against
jpeg_decoder_tpu.decode: RGB and pixel planes bitwise equal. The JAX side
runs its NATIVE config (its PALLAS config would run the lockstep kernel in
interpret mode, which its own tests slow-mark; its entropy backends are
bitwise equal to each other)."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jpeg_decoder_tpu as jt
import jpeg_decoder_tpu_torch as jtt
from jpeg_decoder_tpu.utils.config import (
    DecodeConfig,
    EntropyBackend,
    IdctPrecision,
    Quirks,
)
from jpeg_decoder_tpu.utils.errors import JpegUnsupportedError

from . import corpus
from .test_12bit import _make_12bit_gray

REPO = Path(__file__).resolve().parent.parent
BACKENDS = [EntropyBackend.PALLAS, EntropyBackend.NATIVE]


def _image(shape, seed):
    """A gradient with mild noise: few AC symbols per block, so the plain
    lockstep entropy loop stays quick."""
    rng = np.random.default_rng(seed)
    h, w = shape[:2]
    base = corpus._gradient(h, w)[..., : shape[2]] if len(shape) == 3 else \
        corpus._gradient(h, w)[..., 0]
    return np.clip(base + rng.integers(-6, 7, shape), 0, 255).astype(np.uint8)


CASES = {
    "dri_420": corpus.dri_corpus()[2][1],
    "dri_444": corpus.make_jpeg(_image((24, 40, 3), 1), "RGB", quality=85,
                                subsampling=0, restart_marker_rows=1),
    "baseline_420": corpus.make_jpeg(_image((35, 29, 3), 2), "RGB", quality=85,
                                     subsampling=2),
    "baseline_444": corpus.make_jpeg(_image((16, 24, 3), 3), "RGB", quality=85,
                                     subsampling=0),
    "gray_odd_width": corpus.make_jpeg(_image((31, 23), 4), "L", quality=85),
    "gray_12bit_dri": _make_12bit_gray(nb_y=4, nb_x=3, restart_interval=3)[0],
}


def _assert_same(got, want):
    np.testing.assert_array_equal(got.rgb, want.rgb)
    assert len(got.planes) == len(want.planes)
    for a, b in zip(got.planes, want.planes):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("backend", BACKENDS, ids=lambda b: b.value)
@pytest.mark.parametrize("name", sorted(CASES))
def test_decode_matches_jax(name, backend):
    data = CASES[name]
    got = jtt.decode(data, DecodeConfig(entropy_backend=backend), device="cpu")
    _assert_same(got, jt.decode(data, DecodeConfig()))


@pytest.mark.parametrize("backend", BACKENDS, ids=lambda b: b.value)
@pytest.mark.parametrize("name", ["gray_odd_width", "dri_420"])
def test_decode_matches_jax_correct_quirks(name, backend):
    data = CASES[name]
    cfg = DecodeConfig(quirks=Quirks.CORRECT, entropy_backend=backend)
    got = jtt.decode(data, cfg, device="cpu")
    _assert_same(got, jt.decode(data, DecodeConfig(quirks=Quirks.CORRECT)))


def test_decoder_handle_serves_several_requests(tmp_path):
    dec = jtt.JpegDecoder(DecodeConfig(entropy_backend=EntropyBackend.PALLAS),
                          device="cpu")
    # dri_420's geometry and tables: the JAX side reuses its compiled stage
    datas = [corpus.make_jpeg(_image((64, 64, 3), s), "RGB", quality=88,
                              subsampling=2, restart_marker_blocks=4)
             for s in range(3)]
    for data in datas:
        want = jt.decode(data)
        np.testing.assert_array_equal(dec.decode_rgb(data), want.rgb)
    path = tmp_path / "a.jpg"
    path.write_bytes(datas[0])
    _assert_same(jtt.decode_file(path, device="cpu"), jt.decode(datas[0]))


@pytest.mark.parametrize("stage", ["host_decode", "stream", "batch"])
def test_host_stages_match_jax(stage):
    """The copied host half (fused native path, classic fallback for a
    progressive stream, PlanePool reuse) gives the JAX package's planes."""
    from jpeg_decoder_tpu.models import decoder as jdec
    from jpeg_decoder_tpu_torch.models import host

    datas = [CASES[n] for n in sorted(CASES)] + [corpus.progressive_corpus()[0][1]]
    pool = host.PlanePool()
    run = {
        "host_decode": lambda: [host.host_decode(d, pool=pool) for d in datas],
        "stream": lambda: list(host.host_decode_stream(datas, pool=pool)),
        "batch": lambda: list(host.host_decode_batch(datas, pool=pool, max_workers=2)),
    }[stage]
    for _ in range(2):  # the second pass takes its planes from the pool
        for (frame, planes, qts), d in zip(run(), datas):
            want_frame, want_planes, want_qts = jdec.host_decode(d)
            assert frame == want_frame and sorted(qts) == sorted(want_qts)
            for a, b in zip(planes.planes, want_planes.planes):
                np.testing.assert_array_equal(a, b)
            pool.release(planes)


def test_host_decode_pallas_planes_on_device():
    from jpeg_decoder_tpu.models import decoder as jdec
    from jpeg_decoder_tpu_torch.models import host

    data = CASES["dri_420"]
    cfg = DecodeConfig(entropy_backend=EntropyBackend.PALLAS)
    frame, planes, _ = host.host_decode(data, cfg, device="cpu")
    _, want, _ = jdec.host_decode(data)
    assert all(isinstance(p, torch.Tensor) for p in planes)
    for a, b in zip(planes, want.planes):
        np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize(
    "cfg",
    [DecodeConfig(idct_precision=IdctPrecision.FLOAT32),
     DecodeConfig(upsample="fancy"),
     DecodeConfig(scale=4),
     DecodeConfig(use_device=False),
     DecodeConfig(entropy_backend=EntropyBackend.DEVICE)],
    ids=["float32", "fancy", "scale4", "host_pixels", "device_entropy"],
)
def test_outside_the_slice_raises(cfg):
    with pytest.raises(JpegUnsupportedError):
        jtt.decode(CASES["dri_420"], cfg, device="cpu")


@pytest.mark.parametrize("backend", BACKENDS, ids=lambda b: b.value)
def test_four_components_raise(backend):
    cmyk = dict(corpus.baseline_corpus())["cmyk_q90"]
    with pytest.raises(JpegUnsupportedError):
        jtt.decode(cmyk, DecodeConfig(entropy_backend=backend), device="cpu")


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError):
        jtt.decode(CASES["dri_420"])
    with pytest.raises(RuntimeError):
        jtt.JpegDecoder(device="cuda")


def test_port_never_imports_jax():
    """Importing the port (its shared host layers included) and one PALLAS
    decode leave JAX unloaded (in a subprocess: this test process imported
    JAX in conftest)."""
    code = (
        "import sys\n"
        "import jpeg_decoder_tpu_torch as jtt\n"
        "from jpeg_decoder_tpu_torch import shared\n"
        "from tests import corpus\n"
        "data = corpus.dri_corpus()[2][1]\n"
        "cfg = jtt.DecodeConfig(entropy_backend=jtt.EntropyBackend.PALLAS)\n"
        "img = jtt.decode(data, cfg, device='cpu')\n"
        "assert img.rgb.shape == (64, 64, 3)\n"
        "print('jax' in sys.modules, any(m.startswith('jax.') for m in sys.modules),\n"
        "      shared.jax_free())\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["False", "False", "True"]
