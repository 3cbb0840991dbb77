"""The port's DEVICE entropy backend (jpeg_decoder_tpu_torch/ops/
entropy_device.py) on the CPU, i.e. the plain lockstep loop that K2
replaces on the card, against the JAX package's DEVICE backend
(jpeg_decoder_tpu/ops/entropy_device.py, its lax.while_loop) bitwise:
planes through each package's entropy_decode, RGB through each package's
decode. The JAX while_loop compiles once per scan geometry, so four
geometries go through it (a restart-free gray scan of 272 MCUs, a
restart-free 4:2:0 scan of 288, a gray gradient in two restart segments
of 4100 MCUs, whose lockstep output passes the Pallas kernel's 512 MB
bound, and the corpus's 64x64 gray stream of the corruption and truncation
ladder); the other streams (several scans, 12-bit, long codes,
use_device=False, the batch and CLI paths) are held against the JAX
package's NATIVE planes and RGB. Also: the PALLAS route keeps its guards
in both packages, and the model of K2's schedule with the chunked scan
and dc passes over one long restart-free segment. A request's route: a
one-scan stream that ends at EOI decodes from its header parse alone
(`card_span_pct` 100), every other stream (several scans, DNL, a
truncated scan, a segment after the scan) as before (0), each bitwise
what the full parse gives; the DEVICE layout on the header cache is keyed
by the header's bytes alone. The unqualified config and error classes are
the port's, `jt.` the JAX package's."""

import numpy as np
import pytest

import jpeg_decoder_tpu as jt
from jpeg_decoder_tpu.io.parser import parse as jparse
from jpeg_decoder_tpu.models import decoder as jdecoder
from jpeg_decoder_tpu.ops import entropy_device as jentropy_device
from jpeg_decoder_tpu_torch import (
    DecodeConfig,
    EntropyBackend,
    JpegError,
    JpegUnsupportedError,
    cli,
    convert,
)
from jpeg_decoder_tpu_torch import decode as tdecode
from jpeg_decoder_tpu_torch.benchmarks.inputs import multiscan_jpeg
from jpeg_decoder_tpu_torch.io.parser import parse, parse_headers_cached
from jpeg_decoder_tpu_torch.models import decoder as tdecoder
from jpeg_decoder_tpu_torch.models import host
from jpeg_decoder_tpu_torch.ops import entropy_cuda, entropy_device
from jpeg_decoder_tpu_torch.parallel.batch import BatchDecoder
from jpeg_decoder_tpu_torch.utils.metrics import GLOBAL_METRICS

from . import corpus
from .test_12bit import _make_12bit_gray
from .test_long_codes import _make_stream as _long_code_stream
from .test_markers_edge import _gray_stream
from .test_review_regressions import _component_separate_stream
from .torch_crossing import assert_same_error_class, dc_only_stream

CFG = DecodeConfig(entropy_backend=EntropyBackend.DEVICE)
JCFG = jt.DecodeConfig(entropy_backend=jt.EntropyBackend.DEVICE)
PALLAS = DecodeConfig(entropy_backend=EntropyBackend.PALLAS)
JPALLAS = jt.DecodeConfig(entropy_backend=jt.EntropyBackend.PALLAS)


def _gray_gradient(h, w):
    return corpus._gradient(h, w)[..., 0].copy()


def _noisy(shape, seed):
    """A gradient with mild noise: few AC symbols a block."""
    rng = np.random.default_rng(seed)
    h, w = shape[:2]
    base = corpus._gradient(h, w) if len(shape) == 3 else _gray_gradient(h, w)
    return np.clip(base + rng.integers(-6, 7, shape), 0, 255).astype(np.uint8)


#: The streams that go through the JAX while_loop, each a geometry of its
#: own, and each one the PALLAS route refuses.
JAX_DEVICE_STREAMS = {
    # 17 x 16 MCUs, no restart markers
    "gray_272_restart_free": lambda: corpus.make_jpeg(_noisy((128, 136), 5), "L", quality=85),
    # 18 x 16 MCUs of 4:2:0, no restart markers
    "420_288_restart_free": lambda: corpus.make_jpeg(_noisy((256, 288, 3), 6), "RGB",
                                                     quality=85, subsampling=2),
    # 100 x 82 blocks in two segments of 4100 MCUs: ri * P > 4096
    "gray_gradient_two_long_segments": lambda: corpus.make_jpeg(
        _gray_gradient(656, 800), "L", quality=85, restart_marker_blocks=4100),
}


def _planes(planes):
    return [p.numpy() for p in planes]


def _assert_planes(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", sorted(JAX_DEVICE_STREAMS))
def test_device_matches_the_jax_device_backend(name):
    data = JAX_DEVICE_STREAMS[name]()
    s = parse(data)
    got, qts = entropy_device.entropy_decode(s, CFG, device="cpu")
    js = jparse(data)
    want, jqts = jentropy_device.entropy_decode(js, JCFG)
    _assert_planes(_planes(got), [want.plane(ci) for ci in range(js.frame.ncs)])
    assert sorted(qts) == sorted(jqts)
    img = tdecode(data, CFG, device="cpu")
    jimg = jt.decode(data, JCFG)
    np.testing.assert_array_equal(img.rgb, jimg.rgb)
    _assert_planes(img.planes, jimg.planes)
    # a stream the PALLAS route refuses, in both packages
    with pytest.raises(JpegUnsupportedError):
        tdecode(data, PALLAS, device="cpu")
    with pytest.raises(jt.JpegUnsupportedError):
        jt.decode(data, JPALLAS)


def test_two_long_segments_pass_the_lockstep_bound():
    data = JAX_DEVICE_STREAMS["gray_gradient_two_long_segments"]()
    s = parse(data)
    assert s.scans[0].span.num_segments == 2
    assert s.scans[0].restart_interval > 4096  # one data unit a gray MCU
    assert entropy_cuda._segments_too_long(s.scans[0].restart_interval, 1)
    assert not entropy_cuda.batchable(s)


def test_restart_free_300_mcus_still_raises_on_pallas():
    """PALLAS keeps the JAX Pallas kernel's guard in both packages; DEVICE
    decodes the same stream, bitwise the JAX package's NATIVE decode."""
    data = corpus.make_jpeg(_noisy((120, 160), 7), "L", quality=85)   # 20 x 15 MCUs
    s = parse(data)
    assert s.scans[0].restart_interval == 0
    with pytest.raises(JpegUnsupportedError) as mine:
        tdecode(data, PALLAS, device="cpu")
    with pytest.raises(jt.JpegUnsupportedError) as theirs:
        jt.decode(data, JPALLAS)
    assert_same_error_class(type(mine.value), type(theirs.value))
    with pytest.raises(JpegUnsupportedError):
        entropy_cuda.prepare_scan(s, s.scans[0])
    assert not entropy_cuda.batchable(s)
    pack = entropy_cuda.prepare_scan(s, s.scans[0], entropy_cuda.check_scan_device)
    assert pack.ri == 300 and pack.bounds.shape == (1, 2)
    img = tdecode(data, CFG, device="cpu")
    want = jt.decode(data)
    np.testing.assert_array_equal(img.rgb, want.rgb)
    _assert_planes(img.planes, want.planes)


def _jax_native_planes(data):
    js = jparse(data)
    planes, _ = jdecoder._entropy_decode(js, jt.DecodeConfig())
    return [planes.plane(ci) for ci in range(js.frame.ncs)]


def _several_scans():
    rng = np.random.default_rng(41)
    return _component_separate_stream(rng)[0]


def _several_scans_redefined_tables():
    arr = np.random.default_rng(3).integers(0, 256, (40, 56, 3), dtype=np.uint8)
    return corpus.multiscan_sequential(arr, redefine_dht=True)


#: Streams held against the JAX package's NATIVE planes and RGB.
NATIVE_STREAMS = {
    "several_scans": _several_scans,
    "several_scans_redefined_tables": _several_scans_redefined_tables,
    "several_scans_port_writer_420": lambda: multiscan_jpeg(75, 41, ((2, 2), (1, 1), (1, 1)), 3),
    "12bit_restart_free": lambda: _make_12bit_gray(nb_y=20, nb_x=15)[0],
    "12bit_restart_segments": lambda: _make_12bit_gray(nb_y=4, nb_x=4, restart_interval=4)[0],
    "long_codes": lambda: _long_code_stream(np.random.default_rng(1234))[0],
    "four_components": lambda: dict(corpus.baseline_corpus())["cmyk_q90"],
    "exotic_sampling": lambda: corpus.exotic_sampling_corpus()[0][1],
}


@pytest.mark.parametrize("name", sorted(NATIVE_STREAMS))
def test_device_matches_the_jax_native_decode(name):
    data = NATIVE_STREAMS[name]()
    s = parse(data)
    got, _ = entropy_device.entropy_decode(s, CFG, device="cpu")
    _assert_planes(_planes(got), _jax_native_planes(data))
    img = tdecode(data, CFG, device="cpu")
    want = jt.decode(data)
    np.testing.assert_array_equal(img.rgb, want.rgb)
    _assert_planes(img.planes, want.planes)
    if name.startswith("several_scans"):
        assert len(s.scans) == 3


def test_use_device_false():
    data = JAX_DEVICE_STREAMS["420_288_restart_free"]()
    cfg = DecodeConfig(entropy_backend=EntropyBackend.DEVICE, use_device=False)
    img = tdecode(data, cfg, device="cpu")
    want = jt.decode(data, jt.DecodeConfig(use_device=False))
    np.testing.assert_array_equal(img.rgb, want.rgb)
    _assert_planes(img.planes, want.planes)


def test_host_decode_gives_device_planes_and_leaves_the_pool_alone():
    data = JAX_DEVICE_STREAMS["gray_272_restart_free"]()
    pool = host.PlanePool()
    frame, planes, _ = host.host_decode(data, CFG, pool, device="cpu")
    assert isinstance(planes, list) and not pool._pool
    _assert_planes(_planes(planes), _jax_native_planes(data))
    got = list(host.host_decode_batch([data, data], CFG, pool, max_workers=2, device="cpu"))
    for _frame, p, _qts in got:
        _assert_planes(_planes(p), _jax_native_planes(data))


def test_batch_decoder_takes_device_members_one_at_a_time():
    restart_free = JAX_DEVICE_STREAMS["gray_272_restart_free"]()
    other = corpus.make_jpeg(_noisy((128, 136), 8), "L", quality=85)
    dri = corpus.dri_corpus()[2][1]
    dec = BatchDecoder(CFG, device="cpu")
    rgb = dec.decode_batch([restart_free, other])
    np.testing.assert_array_equal(rgb, np.stack([jt.decode(restart_free).rgb,
                                                 jt.decode(other).rgb]))
    for got, d in zip(dec.decode_many([restart_free, dri, other]), [restart_free, dri, other]):
        np.testing.assert_array_equal(got, jt.decode(d).rgb)


def test_cli_decode_batch_with_the_device_backend(tmp_path):
    from jpeg_decoder_tpu import cli as jcli

    paths = []
    for i, name in enumerate(["gray_272_restart_free", "420_288_restart_free"]):
        p = tmp_path / f"in{i}.jpg"
        p.write_bytes(JAX_DEVICE_STREAMS[name]())
        paths.append(str(p))
    for who, main, extra in (("port", cli.main, ["--device", "cpu"]), ("jax", jcli.main, [])):
        assert main(["decode-batch", *paths, "--out-dir", str(tmp_path / who), "--format",
                     "npy", "--backend", "device", *extra]) == 0
    for i in range(2):
        assert ((tmp_path / "port" / f"in{i}.npy").read_bytes()
                == (tmp_path / "jax" / f"in{i}.npy").read_bytes())


def _outcome(decode, data):
    """("ok", rgb) or ("error", class)."""
    try:
        return "ok", decode(data).rgb
    except JpegError as e:
        return "error", type(e)
    except jt.JpegError as e:
        return "error", type(e)


def _ladder():
    """tests/test_robustness.py's inputs for the device backends: the corpus's
    first stream with 1-4 random bytes overwritten (eight draws of seed 9),
    and cut at 30, 70 and 95% of its length."""
    name, data = corpus.baseline_corpus()[0]
    rng = np.random.default_rng(9)
    out = {}
    for i in range(8):
        bad = bytearray(data)
        for _k in range(rng.integers(1, 5)):
            bad[rng.integers(2, len(bad))] = rng.integers(0, 256)
        out[f"corrupt{i}"] = bytes(bad)
    for frac in (0.3, 0.7, 0.95):
        out[f"cut{int(frac * 100)}"] = data[: int(len(data) * frac)]
    out["progressive"] = corpus.progressive_corpus()[0][1]
    return out


LADDER = _ladder()


@pytest.mark.parametrize("name", sorted(LADDER))
def test_errors_match_the_jax_device_backend(name):
    """The corruption and truncation ladder and a progressive stream: the
    same error class as the JAX DEVICE backend, or the same RGB."""
    data = LADDER[name]
    cfg = DecodeConfig(entropy_backend=EntropyBackend.DEVICE, use_device=False)
    jcfg = jt.DecodeConfig(entropy_backend=jt.EntropyBackend.DEVICE, use_device=False)
    got = _outcome(lambda d: tdecode(d, cfg, device="cpu"), data)
    want = _outcome(lambda d: jt.decode(d, jcfg), data)
    assert got[0] == want[0], (got, want)
    if got[0] == "error":
        assert_same_error_class(got[1], want[1])
    else:
        np.testing.assert_array_equal(got[1], want[1])
    if name == "progressive":
        assert got[1].__name__ == "JpegUnsupportedError"


def test_bad_code_is_reported_before_truncation():
    """A restart-free stream with 64 one-bits in its entropy data, then cut:
    the bad code is raised, as the JAX backend raises it."""
    data = JAX_DEVICE_STREAMS["gray_272_restart_free"]()
    span = parse(data).scans[0].span
    bad = bytearray(data)
    bad[span.start + 8 : span.start + 24] = b"\xff\x00" * 8
    bad = bytes(bad[: (span.start + span.end) // 2 + 16])
    got = _outcome(lambda d: tdecode(d, CFG, device="cpu"), bad)
    want = _outcome(lambda d: jt.decode(d, JCFG), bad)
    assert got[0] == want[0] == "error"
    assert got[1].__name__ == "JpegEntropyError"
    assert_same_error_class(got[1], want[1])


@pytest.mark.parametrize("sub_bytes,scan_chunk,dc_chunk",
                         [(entropy_cuda.SUB_BYTES, 2, 64), (16, 8, 100), (8, 3, 7)])
def test_schedule_model_over_one_long_segment(sub_bytes, scan_chunk, dc_chunk):
    """The model of K2's schedule (_decode_segments_subseq_plain) over one
    restart-free segment of many subsequences, more than a block of records
    (256 subsequences) at the smaller sizes, with the scan and dc passes in
    several chunks: status and planes bitwise the plain lockstep loop and
    the JAX DEVICE backend."""
    data = JAX_DEVICE_STREAMS["420_288_restart_free"]()
    s = parse(data)
    pack = entropy_cuda.prepare_scan(s, s.scans[0], entropy_cuda.check_scan_device)
    args, _ = entropy_cuda.launch_args([pack], "cpu")
    assert args[1].numel() == 2  # one segment
    want = convert.zero_planes(s.frame, "cpu")
    st_plain = entropy_cuda.decode_segments(*args, [want])
    got = convert.zero_planes(s.frame, "cpu")
    st_model, rec = entropy_cuda._decode_segments_subseq_plain(
        *args, [got], sub_bytes=sub_bytes, scan_chunk=scan_chunk, dc_chunk=dc_chunk)
    assert (st_model == st_plain).all()
    _assert_planes(_planes(got), _planes(want))
    n_subs = int(rec["sub_base"][-1])
    assert rec["scan_chunks"] == -(-n_subs // scan_chunk) > 1
    assert rec["dc_chunks"] == -(-288 * 6 // dc_chunk) > 1
    if sub_bytes < entropy_cuda.SUB_BYTES:
        assert n_subs > 256
    js = jparse(data)
    jwant, _ = jentropy_device.entropy_decode(js, JCFG)
    _assert_planes(_planes(got), [jwant.plane(ci) for ci in range(3)])


def test_device_without_a_card_raises():
    """No fallback: the DEVICE route on the default device "cuda" raises
    where there is no card, as the PALLAS route does."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    data = JAX_DEVICE_STREAMS["gray_272_restart_free"]()
    with pytest.raises(RuntimeError, match="cuda"):
        tdecode(data, CFG)
    with pytest.raises(RuntimeError, match="cuda"):
        entropy_device.entropy_decode(parse(data), CFG)


def _card_span():
    st = GLOBAL_METRICS.stages.get("card_span_pct")
    return (st.calls, st.total_items) if st else (0, 0.0)


def _result(fn):
    """What a decode returned, or the class it raised."""
    try:
        return fn()
    except JpegError as e:
        return type(e)


def _app_after_the_scan():
    data = corpus.baseline_corpus()[0][1]
    assert data[-2:] == b"\xff\xd9"
    return data[:-2] + b"\xff\xe1\x00\x06abcd" + data[-2:]


#: name -> (stream, the card_span_pct a DEVICE request of it counts, the
#: K2u calls without bounds it makes: none where the header alone sends it
#: to the full parse, a DNL-pending height or a first scan of some of the
#: frame's components)
ROUTES = {
    "one_scan_to_eoi": (lambda: corpus.baseline_corpus()[0][1], 100.0, 1),
    "one_scan_with_markers": (lambda: corpus.dri_corpus()[0][1], 100.0, 1),
    "several_scans": (_several_scans, 0.0, 0),
    "several_scans_redefined_tables": (_several_scans_redefined_tables, 0.0, 0),
    "dnl_height": (lambda: _gray_stream(3, 2, height_in_sof=0, dnl_height=24)[0], 0.0, 0),
    "dnl_after_a_height": (lambda: _gray_stream(3, 2, height_in_sof=24, dnl_height=16)[0],
                           0.0, 1),
    "truncated": (lambda: LADDER["cut95"], 0.0, 1),
    "app_after_the_scan": (_app_after_the_scan, 0.0, 1),
}


@pytest.mark.parametrize("entry", ["decode", "decode_rgb"])
@pytest.mark.parametrize("name", sorted(ROUTES))
def test_request_route_and_counter(name, entry, monkeypatch):
    """A DEVICE request counts card_span_pct once: 100 where the header
    parse and K2u's segments gave the result, 0 where the request took the
    full parse; either way the RGB and planes (or the error class) are the
    full parse's (decode_structure, the route every request took before).
    K2u without bounds runs only where the header allows one scan."""
    make, pct, tries = ROUTES[name]
    data = make()
    found = []
    find = entropy_cuda.find_segments
    monkeypatch.setattr(entropy_cuda, "find_segments",
                        lambda *a: found.append(1) or find(*a))
    calls, items = _card_span()
    got = _result(lambda: getattr(tdecoder, entry)(data, CFG, device="cpu"))
    assert _card_span() == (calls + 1, items + pct)
    assert len(found) == tries
    want = _result(lambda: tdecoder.decode_structure(parse(data, CFG), CFG, device="cpu"))
    if isinstance(want, type):
        assert got is want
    elif entry == "decode_rgb":
        np.testing.assert_array_equal(got, want.rgb)
    else:
        np.testing.assert_array_equal(got.rgb, want.rgb)
        _assert_planes(got.planes, want.planes)


def test_device_layout_is_keyed_by_the_header_bytes():
    """Two streams whose bytes up to the first entropy byte are equal share
    one cached header parse and one DEVICE layout, computed once, and each
    decodes from it bitwise its full parse; a stream with another header
    (another restart interval) gets its own."""
    a = dc_only_stream([5, -3, 32767, 9, 1, 2], nb_x=3, restart_interval=2)
    b = dc_only_stream([-7, 100, 3, 0, 255, -1], nb_x=3, restart_interval=2)
    c = dc_only_stream([5, -3, 32767, 9, 1, 2], nb_x=3, restart_interval=3)
    hp_a, hp_b = parse_headers_cached(a, CFG), parse_headers_cached(b, CFG)
    assert a[: hp_a.entropy_start] == b[: hp_b.entropy_start] and a != b
    assert hp_a is hp_b
    layout = entropy_device.header_layout(hp_a)
    assert layout is hp_a.device_layout and entropy_device.header_layout(hp_b) is layout
    assert layout.n_segs == 3 and layout.args[2] == 2
    hp_c = parse_headers_cached(c, CFG)
    assert hp_c is not hp_a and entropy_device.header_layout(hp_c).n_segs == 2
    for data in (a, b, c):
        calls, items = _card_span()
        got = tdecode(data, CFG, device="cpu")
        assert _card_span() == (calls + 1, items + 100.0)
        want = tdecoder.decode_structure(parse(data, CFG), CFG, device="cpu")
        np.testing.assert_array_equal(got.rgb, want.rgb)
        _assert_planes(got.planes, want.planes)
