"""The port's decode path end to end on the CPU (jpeg_decoder_tpu_torch.decode
with device="cpu", i.e. the plain versions of every kernel) against
jpeg_decoder_tpu.decode. EXACT: RGB and pixel planes bitwise equal. FLOAT32:
pixel planes within +-1 of the JAX package's FLOAT32 planes and of EXACT
(the JAX contract; the products sum in other orders), and RGB bitwise equal
to the colour stage applied to the returned planes. The JAX side runs its
NATIVE config (its PALLAS config would run the lockstep kernel in interpret
mode, which its own tests slow-mark; its entropy backends are bitwise equal
to each other). Each side gets its own package's config objects: the
unqualified DecodeConfig and enums here are the port's, `jt.` the JAX
package's."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jpeg_decoder_tpu as jt
import jpeg_decoder_tpu_torch as jtt
from jpeg_decoder_tpu_torch import (
    DecodeConfig,
    EntropyBackend,
    IdctPrecision,
    Quirks,
)

from . import corpus
from .torch_crossing import assert_same_error_class, assert_same_fields
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
    _assert_same(got, jt.decode(data, jt.DecodeConfig()))


@pytest.mark.parametrize("backend", BACKENDS, ids=lambda b: b.value)
@pytest.mark.parametrize("name", ["gray_odd_width", "dri_420"])
def test_decode_matches_jax_correct_quirks(name, backend):
    data = CASES[name]
    cfg = DecodeConfig(quirks=Quirks.CORRECT, entropy_backend=backend)
    got = jtt.decode(data, cfg, device="cpu")
    _assert_same(got, jt.decode(data, jt.DecodeConfig(quirks=jt.Quirks.CORRECT)))


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
            assert_same_fields(frame, want_frame)
            assert sorted(qts) == sorted(want_qts)
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


def _assert_within_1(got_planes, want_planes):
    assert len(got_planes) == len(want_planes)
    for a, b in zip(got_planes, want_planes):
        assert a.shape == b.shape
        assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 1


def _colour_of(img, quirks=Quirks.REFERENCE):
    from jpeg_decoder_tpu_torch.ops import color as tcolor

    f = img.frame
    return tcolor.planes_to_rgb(
        [torch.from_numpy(p) for p in img.planes], f.height, f.width,
        tuple((c.hsf, c.vsf) for c in f.components), quirks).numpy()


def jcfg(cfg: DecodeConfig):
    """The JAX package's config with the same fields (its own enums)."""
    return jt.DecodeConfig(
        idct_precision=jt.IdctPrecision[cfg.idct_precision.name],
        quirks=jt.Quirks[cfg.quirks.name], upsample=cfg.upsample, scale=cfg.scale,
        use_device=cfg.use_device)


def _assert_rgb_within(got, want, tol):
    assert got.shape == want.shape
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= tol


@pytest.mark.parametrize("backend", BACKENDS, ids=lambda b: b.value)
@pytest.mark.parametrize("name", sorted(CASES))
def test_float32_decode_matches_jax(name, backend):
    data = CASES[name]
    cfg = DecodeConfig(entropy_backend=backend, idct_precision=IdctPrecision.FLOAT32)
    got = jtt.decode(data, cfg, device="cpu")
    want = jt.decode(data, jt.DecodeConfig(idct_precision=jt.IdctPrecision.FLOAT32))
    _assert_within_1(got.planes, want.planes)
    exact = jtt.decode(data, DecodeConfig(entropy_backend=backend), device="cpu")
    _assert_within_1(got.planes, exact.planes)
    np.testing.assert_array_equal(got.rgb, _colour_of(got))


@pytest.mark.parametrize(
    "cfg",
    [DecodeConfig(upsample="fancy"),
     DecodeConfig(scale=4),
     DecodeConfig(use_device=False),
     DecodeConfig(entropy_backend=EntropyBackend.DEVICE)],
    ids=["fancy", "scale4", "host_pixels", "device_entropy"],
)
def test_outside_the_slice_raises(cfg):
    """The configs that once raised as outside the port: fancy, scale 4,
    use_device=False and the DEVICE entropy backend now decode as the JAX
    package does (EXACT at full size bitwise; scale 4 is the FLOAT32
    product under either contract: planes within 1, RGB within 3). DEVICE
    is held against the JAX package's DEVICE backend (its while_loop). The
    name is the one the test had while all four raised."""
    data = CASES["dri_420"]
    want_cfg = jcfg(cfg)
    if cfg.entropy_backend == EntropyBackend.DEVICE:
        want_cfg = jt.DecodeConfig(entropy_backend=jt.EntropyBackend.DEVICE)
    got = jtt.decode(data, cfg, device="cpu")
    want = jt.decode(data, want_cfg)
    if cfg.scale == 8:
        _assert_same(got, want)
    else:
        _assert_within_1(got.planes, want.planes)
        _assert_rgb_within(got.rgb, want.rgb, 3)


@pytest.mark.parametrize("backend", BACKENDS, ids=lambda b: b.value)
def test_four_components_raise(backend):
    """A 4-component frame (Pillow's CMYK, APP14 transform 0: YCCK under
    REFERENCE quirks) decodes per backend, bitwise the JAX package's. The
    name is the one the test had while 4-component frames raised."""
    cmyk = dict(corpus.baseline_corpus())["cmyk_q90"]
    got = jtt.decode(cmyk, DecodeConfig(entropy_backend=backend), device="cpu")
    assert got.frame.ncs == 4
    _assert_same(got, jt.decode(cmyk, jt.DecodeConfig()))


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError):
        jtt.decode(CASES["dri_420"])
    with pytest.raises(RuntimeError):
        jtt.JpegDecoder(device="cuda")


def test_port_never_imports_jax():
    """Importing the port (its own host layers included), one PALLAS
    decode, one FLOAT32 decode and one BatchDecoder PALLAS batch leave JAX
    unloaded (in a subprocess: this test process imported JAX in
    conftest)."""
    code = (
        "import sys\n"
        "import jpeg_decoder_tpu_torch as jtt\n"
        "from jpeg_decoder_tpu_torch.utils import jax_free\n"
        "from tests import corpus\n"
        "data = corpus.dri_corpus()[2][1]\n"
        "cfg = jtt.DecodeConfig(entropy_backend=jtt.EntropyBackend.PALLAS)\n"
        "img = jtt.decode(data, cfg, device='cpu')\n"
        "assert img.rgb.shape == (64, 64, 3)\n"
        "f32 = jtt.DecodeConfig(idct_precision=jtt.IdctPrecision.FLOAT32)\n"
        "assert jtt.decode(data, f32, device='cpu').rgb.shape == (64, 64, 3)\n"
        "rgb = jtt.BatchDecoder(cfg, device='cpu').decode_batch([data, data])\n"
        "assert rgb.shape == (2, 64, 64, 3)\n"
        "print('jax' in sys.modules, any(m.startswith('jax.') for m in sys.modules),\n"
        "      jax_free())\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["False", "False", "True"]


@pytest.mark.parametrize("collect_metrics", [True, False], ids=["on", "off"])
def test_collect_metrics_traces_the_device_stage(collect_metrics):
    """DecodeConfig.collect_metrics names the pixel stage in a torch.profiler
    record, as the reference names it in its trace; off, it adds no range."""
    import torch.profiler

    cfg = DecodeConfig(collect_metrics=collect_metrics)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        jtt.decode(CASES["dri_420"], cfg, device="cpu")
    names = {e.key for e in prof.key_averages()}
    assert ("jpegtpu.device_stage" in names) is collect_metrics


def test_public_exports_decode_like_the_reference():
    """parse, decode_oracle and host_decode_batch from the port's top level
    give the JAX package's results on the same bytes."""
    data = CASES["dri_420"]
    assert_same_fields(jtt.parse(data).frame, jt.parse(data).frame)
    assert jtt.__version__ == jt.__version__
    _assert_same(jtt.decode_oracle(data), jt.decode_oracle(data))
    got = list(jtt.host_decode_batch([data, CASES["dri_444"]], jtt.DecodeConfig(),
                                     None, 2))
    want = list(jt.host_decode_batch([data, CASES["dri_444"]], jt.DecodeConfig(), None, 2))
    assert len(got) == len(want) == 2
    for (gf, gp, _), (wf, wp, _) in zip(got, want):
        assert_same_fields(gf, wf)
        for a, b in zip(gp.planes, wp.planes):
            np.testing.assert_array_equal(a, b)
    assert isinstance(jtt.parse(data), jtt.JpegStructure)
    assert isinstance(got[0][1], jtt.CoefficientPlanes)
    assert isinstance(got[0][0], jtt.FrameHeader)
    rgb = _image((24, 40, 3), 7)
    assert jtt.encode(rgb, device="cpu") == jt.encode(rgb)
    assert jtt.EncodeConfig().quality == jt.EncodeConfig().quality


# ---------------------------------------------------------------------------
# Fancy upsampling, scaled decode, 4 components and the host pixel path
# ---------------------------------------------------------------------------


HOPPER_CMYK = (REPO / "tests" / "wild_files" / "transcoded" / "hopper_cmyk_adobe.jpg").read_bytes()
FLOAT32 = IdctPrecision.FLOAT32
#: Streams: a 4:2:0 DRI one, Pillow's CMYK (40x56, restart-free but under
#: 256 MCUs, so PALLAS takes it) and a foreign encoder's Adobe CMYK
#: (512x600, restart-free, 4800 MCUs: NATIVE only, as the JAX backend's
#: guard refuses it under PALLAS). Both CMYK files carry APP14 transform 0:
#: YCCK under REFERENCE quirks, raw CMYK under CORRECT.
NEW_CASES = {"dri_420": CASES["dri_420"],
             "cmyk_q90": dict(corpus.baseline_corpus())["cmyk_q90"],
             "hopper_cmyk": HOPPER_CMYK}
NEW_CONFIGS = {
    "fancy": dict(upsample="fancy"),
    "fancy_float32": dict(upsample="fancy", idct_precision=FLOAT32),
    "fancy_correct": dict(upsample="fancy", quirks=Quirks.CORRECT),
    "scale1": dict(scale=1),
    "scale2_correct": dict(scale=2, quirks=Quirks.CORRECT),
    "scale4": dict(scale=4),
    "scale4_float32_fancy": dict(scale=4, idct_precision=FLOAT32, upsample="fancy"),
    "correct": dict(quirks=Quirks.CORRECT),
    "float32": dict(idct_precision=FLOAT32),
}
NEW_RUNS = [(n, c, b) for n in sorted(NEW_CASES) for c in sorted(NEW_CONFIGS)
            for b in BACKENDS
            if not (n == "hopper_cmyk" and (b == EntropyBackend.PALLAS
                                            or c not in ("fancy", "scale4", "correct",
                                                         "float32")))]


def _colour_stage(img, cfg):
    """The port's colour stage of a decode's own planes, as PixelStage
    calls it."""
    from jpeg_decoder_tpu_torch.ops import color as tcolor

    f = img.frame
    raw = f.ncs == 4 and cfg.quirks == Quirks.CORRECT and f.adobe_transform == 0
    return tcolor.planes_to_rgb(
        [torch.from_numpy(p) for p in img.planes], -(-f.height * cfg.scale // 8),
        -(-f.width * cfg.scale // 8), tuple((c.hsf, c.vsf) for c in f.components),
        cfg.quirks, cfg.upsample, cfg.idct_precision == IdctPrecision.EXACT, raw,
        cfg.quirks == Quirks.REFERENCE and cfg.scale == 8).numpy()


@pytest.mark.parametrize("name,config,backend", NEW_RUNS,
                         ids=[f"{n}-{c}-{b.value}" for n, c, b in NEW_RUNS])
def test_new_configs_match_jax(name, config, backend):
    """Whole decodes against jpeg_decoder_tpu.decode. EXACT at full size:
    planes bitwise, RGB bitwise the JAX package's host path (its float64
    chain, the reference's) and its device path wherever that agrees with
    its host path (its jitted YCCK differs by 1 on a few inputs, ROADMAP.md
    §3). FLOAT32, and every scaled decode (the FLOAT32 product under either
    contract): planes within 1, RGB within 3 and bitwise the colour stage of
    the port's own planes."""
    data = NEW_CASES[name]
    cfg = DecodeConfig(entropy_backend=backend, **NEW_CONFIGS[config])
    got = jtt.decode(data, cfg, device="cpu")
    want = jt.decode(data, jcfg(cfg))
    assert got.rgb.shape == want.rgb.shape
    assert [p.shape for p in got.planes] == [p.shape for p in want.planes]
    if cfg.idct_precision == IdctPrecision.EXACT and cfg.scale == 8:
        host = jt.decode(data, jcfg(cfg.replace(use_device=False)))
        for a, b in zip(got.planes, want.planes):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(got.rgb, host.rgb)
        agree = want.rgb == host.rgb
        np.testing.assert_array_equal(got.rgb[agree], want.rgb[agree])
        assert np.abs(got.rgb.astype(np.int32) - want.rgb).max() <= 1
        return
    _assert_within_1(got.planes, want.planes)
    _assert_rgb_within(got.rgb, want.rgb, 3)
    np.testing.assert_array_equal(got.rgb, _colour_stage(got, cfg))


#: (stream, backend): hopper_cmyk NATIVE only (a restart-free scan of 4800
#: MCUs, which both packages' PALLAS backends refuse)
HOST_RUNS = [(n, b) for n in ["dri_420", "cmyk_q90", "gray_odd_width", "hopper_cmyk"]
             for b in BACKENDS if not (n == "hopper_cmyk" and b == EntropyBackend.PALLAS)]


@pytest.mark.parametrize("quirks", [Quirks.REFERENCE, Quirks.CORRECT], ids=lambda q: q.value)
@pytest.mark.parametrize("upsample", ["nn", "fancy"])
@pytest.mark.parametrize("name,backend", HOST_RUNS, ids=[f"{n}-{b.value}" for n, b in HOST_RUNS])
def test_use_device_false_matches_jax(name, backend, upsample, quirks):
    """The host pixel path, bitwise the JAX package's use_device=False,
    fancy and 4 components included."""
    data = NEW_CASES.get(name) or CASES[name]
    cfg = DecodeConfig(entropy_backend=backend, use_device=False, upsample=upsample,
                       quirks=quirks)
    _assert_same(jtt.decode(data, cfg, device="cpu"), jt.decode(data, jcfg(cfg)))


@pytest.mark.parametrize("scale", [1, 2, 4])
def test_use_device_false_scaled_raises_config_error(scale):
    from jpeg_decoder_tpu.utils.errors import JpegConfigError as JaxJpegConfigError
    from jpeg_decoder_tpu_torch.utils.errors import JpegConfigError

    cfg = DecodeConfig(use_device=False, scale=scale)
    with pytest.raises(JpegConfigError, match="scale"):
        jtt.decode(CASES["dri_420"], cfg, device="cpu")
    with pytest.raises(JaxJpegConfigError, match="scale"):
        jt.decode(CASES["dri_420"], jcfg(cfg))
    assert_same_error_class(JpegConfigError, JaxJpegConfigError)


def _stage_of(data, cfg):
    from jpeg_decoder_tpu_torch.models import decoder as tdecoder

    s = jtt.parse(data)
    return tdecoder.device_stage_for(
        s.frame, {t: q.values for t, q in s.scans[0].quant_tables.items()}, cfg, "cpu")


@pytest.mark.parametrize("config,fused", [
    ("nn", True), ("nn_float32", True), ("fancy", False), ("fancy_float32", False),
    ("scale4", False), ("scale1_float32", False), ("four_components", False),
])
def test_fused_flag_per_config(config, fused):
    """PixelStage.fused (one K03 or K13 launch on the card) only for 3
    components, nearest-neighbour, full size: a fancy request routed to K03
    would return nearest-neighbour pixels without raising."""
    kw = {"nn": {}, "nn_float32": dict(idct_precision=FLOAT32),
          "fancy": dict(upsample="fancy"),
          "fancy_float32": dict(upsample="fancy", idct_precision=FLOAT32),
          "scale4": dict(scale=4), "scale1_float32": dict(scale=1, idct_precision=FLOAT32),
          "four_components": {}}[config]
    data = NEW_CASES["cmyk_q90" if config == "four_components" else "dri_420"]
    cfg = DecodeConfig(**kw)
    assert _stage_of(data, cfg).fused is fused
    if cfg.upsample == "fancy":
        # the fancy decode is not the nearest-neighbour one, and is JAX's
        fancy = jtt.decode(data, cfg, device="cpu").rgb
        nn = jtt.decode(data, cfg.replace(upsample="nn"), device="cpu").rgb
        assert not np.array_equal(fancy, nn)
        _assert_rgb_within(fancy, jt.decode(data, jcfg(cfg)).rgb,
                           0 if cfg.idct_precision == IdctPrecision.EXACT else 3)


@pytest.mark.parametrize("upsample", ["nn", "fancy"])
def test_decoder_handle_and_file_decode_new_configs(tmp_path, upsample):
    """JpegDecoder and decode_file serve 4-component and scaled requests
    with the same stage cache."""
    path = tmp_path / "cmyk.jpg"
    path.write_bytes(NEW_CASES["cmyk_q90"])
    dec = jtt.JpegDecoder(DecodeConfig(upsample=upsample, quirks=Quirks.CORRECT), device="cpu")
    want = jt.decode(NEW_CASES["cmyk_q90"], jt.DecodeConfig(upsample=upsample,
                                                            quirks=jt.Quirks.CORRECT))
    np.testing.assert_array_equal(dec.decode_rgb(NEW_CASES["cmyk_q90"]), want.rgb)
    cfg = DecodeConfig(upsample=upsample, quirks=Quirks.CORRECT)
    _assert_same(jtt.decode_file(path, cfg, device="cpu"), want)
    small = jtt.decode_file(path, cfg.replace(scale=2), device="cpu")
    assert small.rgb.shape == (10, 14, 3)


def _counters():
    from jpeg_decoder_tpu_torch.utils.metrics import GLOBAL_METRICS

    return {k: (st.calls, st.total_items) for k, st in GLOBAL_METRICS.stages.items()
            if k in ("readback_mb", "readback_pinned_pct")}


def _counted(before, after, name):
    """(calls, items) recorded under `name` between two _counters()."""
    c0, n0 = before.get(name, (0, 0.0))
    c1, n1 = after.get(name, (0, 0.0))
    return c1 - c0, n1 - n0


@pytest.mark.parametrize("precision", list(IdctPrecision), ids=lambda p: p.value)
@pytest.mark.parametrize("upsample", ["nn", "fancy"])
@pytest.mark.parametrize("name", ["baseline_420", "baseline_444", "gray_odd_width"])
def test_decode_rgb_reads_back_rgb_alone(monkeypatch, name, upsample, precision):
    """decode_rgb asks the pixel stage for no planes, and its RGB is bitwise
    decode's; decode still asks for them and returns them. `copy_out` counts
    readback_mb (the bytes read back) and readback_pinned_pct (0 on the
    CPU) once a request."""
    from jpeg_decoder_tpu_torch.models import decoder as tdecoder

    asked = []
    forward = tdecoder.PixelStage.forward

    def spy(self, *planes, want_planes=True):
        asked.append(want_planes)
        return forward(self, *planes, want_planes=want_planes)

    monkeypatch.setattr(tdecoder.PixelStage, "forward", spy)
    data = CASES[name]
    cfg = DecodeConfig(upsample=upsample, idct_precision=precision)
    c0 = _counters()
    rgb = jtt.JpegDecoder(cfg, device="cpu").decode_rgb(data)
    c1 = _counters()
    img = jtt.decode(data, cfg, device="cpu")
    c2 = _counters()
    assert asked == [False, True]
    np.testing.assert_array_equal(rgb, img.rgb)
    assert len(img.planes) == (1 if name.startswith("gray") else 3)
    assert all(p.dtype == np.uint8 and p.size for p in img.planes)
    assert _counted(c0, c1, "readback_mb") == (1, pytest.approx(rgb.nbytes / 1e6))
    assert _counted(c0, c1, "readback_pinned_pct") == (1, 0.0)
    planes_mb = sum(p.nbytes for p in img.planes) / 1e6
    assert _counted(c1, c2, "readback_mb") == (1, pytest.approx(rgb.nbytes / 1e6 + planes_mb))
    assert _counted(c1, c2, "readback_pinned_pct") == (1, 0.0)


@pytest.mark.parametrize("pin", [False, True])
def test_pinned_budget_books_and_gives_back(monkeypatch, pin):
    """convert's pinned budget: a booking past PINNED_BUDGET_BYTES is
    refused and books nothing, a booking given back makes room again; a
    read-back from the CPU is pageable whatever `pin` says, and books
    nothing."""
    from jpeg_decoder_tpu_torch import convert

    monkeypatch.setattr(convert, "PINNED_BUDGET_BYTES", 3 << 20)
    monkeypatch.setattr(convert, "_pinned_held", 0)
    assert convert._take_pinned(2 << 20) and not convert._take_pinned(2 << 20)
    assert convert._take_pinned(1 << 20) and not convert._take_pinned(1)
    assert convert._pinned_held == 3 << 20
    convert._give_pinned(2 << 20)
    assert convert._take_pinned(2 << 20) and convert._pinned_held == 3 << 20
    convert._give_pinned(3 << 20)
    t = torch.arange(24, dtype=torch.uint8).reshape(2, 4, 3)
    arr, pinned = convert.to_host(t, pin=pin)
    assert not pinned and convert._pinned_held == 0
    np.testing.assert_array_equal(arr, t.numpy())
    # a booked read-back's bytes come back when its last holder goes
    assert convert._take_pinned(1 << 20)
    arr = convert._booked(torch.empty(t.shape, dtype=t.dtype).copy_(t).numpy(), 1 << 20)
    view, tensor = arr[1:], torch.from_numpy(arr)
    del arr
    assert convert._pinned_held == 1 << 20
    del view
    assert convert._pinned_held == 1 << 20
    np.testing.assert_array_equal(tensor.numpy(), t.numpy())
    del tensor
    assert convert._pinned_held == 0
