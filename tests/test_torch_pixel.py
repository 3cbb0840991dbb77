"""The port's one-step pixel stage (jpeg_decoder_tpu_torch/ops/pixel.py, the
plain versions of kernels K03 and K13) against the JAX package's
build_stage_raw, on random int16 coefficient planes made from a numpy seed.
EXACT (K03): bitwise (tolerance 0: EXACT is a bit-exact contract), five
samplings, ragged edges, 8- and 12-bit, both quirks, single images and a
batch of three. FLOAT32 (K13): pixel planes within 1 of JAX's (the JAX
contract is +-1 LSB; the two sum the 64 products in other orders), RGB
bitwise the plain colour stage of the port's own planes and within
FLOAT32_RGB_TOL of JAX's; 4:2:0, 4:2:2 and 4:4:4, 8- and 12-bit, both
quirks, single and batched. Also the route's guard (`tile_local`, `fits`)
against a brute-force check over every 3-component sampling with factors
1..4, the PixelStage routes and `want_planes`, the launch chunking of
batches above 65,535 images, and the C entry points' argument lists
against `_build.SIGNATURES` (no compiler runs here)."""

import ctypes
import itertools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jpeg_decoder_tpu.core import types as jtypes
from jpeg_decoder_tpu.io.markers import Encoding as JaxEncoding
from jpeg_decoder_tpu.models import decoder as jdecoder
from jpeg_decoder_tpu.utils.config import IdctPrecision as JaxIdctPrecision
from jpeg_decoder_tpu.utils.config import Quirks as JaxQuirks
from jpeg_decoder_tpu_torch import DecodeConfig, IdctPrecision, Quirks, _build
from jpeg_decoder_tpu_torch.benchmarks import pixel_sweep
from jpeg_decoder_tpu_torch.core import types as ttypes
from jpeg_decoder_tpu_torch.io.markers import Encoding
from jpeg_decoder_tpu_torch.models import decoder as tdecoder
from jpeg_decoder_tpu_torch.ops import color, pixel

SAMPLINGS = {
    "420": ((2, 2), (1, 1), (1, 1)),
    "422": ((2, 1), (1, 1), (1, 1)),
    "444": ((1, 1), (1, 1), (1, 1)),
    "440": ((1, 2), (1, 1), (1, 1)),
    "411": ((4, 1), (1, 1), (1, 1)),
}
SIZES = [(37, 45), (67, 101)]  # (h, w): neither a multiple of an MCU
QUIRKS = [Quirks.REFERENCE, Quirks.CORRECT]
#: a sampling the parser takes (factors up to 15) whose ratio 7/12 rounds
#: down in float32 far enough that column 864, the first of its MCU, reads
#: the MCU before (the only such pair of factors up to 15); and a frame of it
NOT_LOCAL = ((12, 1), (7, 1), (7, 1))
NOT_LOCAL_HW = (8, 1000)
FLOAT32 = IdctPrecision.FLOAT32
#: FLOAT32 RGB tolerance against the JAX package: a chroma step of 1 moves
#: R or B by up to 1.772 (tests/test_torch_batch.py)
FLOAT32_RGB_TOL = 3


def _frames(h, w, factors, bits):
    """The port's FrameHeader and the JAX package's, with the parser's
    integer component sizes."""
    mh = max(f[0] for f in factors)
    mv = max(f[1] for f in factors)
    dims = [(-(-w * fh // mh), -(-h * fv // mv)) for fh, fv in factors]
    port = ttypes.FrameHeader(
        Encoding.BASELINE_DCT, bits, w, h,
        tuple(ttypes.Component(i + 1, fh, fv, min(i, 1), x, y)
              for i, ((fh, fv), (x, y)) in enumerate(zip(factors, dims))))
    jax = jtypes.FrameHeader(
        JaxEncoding.BASELINE_DCT, bits, w, h,
        tuple(jtypes.Component(i + 1, fh, fv, min(i, 1), x, y)
              for i, ((fh, fv), (x, y)) in enumerate(zip(factors, dims))))
    return port, jax


def _inputs(frame, seed, lead=()):
    """Random zigzag planes (uniform coefficients with a random zero suffix
    a block, the 12-bit ones wider) and one table per component."""
    rng = np.random.default_rng(seed)
    span = 8192 if frame.precision == 12 else 1024
    planes = []
    for c in frame.components:
        shape = (*lead, c.blocks_y, c.blocks_x)
        blocks = rng.integers(-span, span, (*shape, 64))
        cut = rng.integers(1, 65, shape)
        planes.append(np.where(np.arange(64) < cut[..., None], blocks, 0).astype(np.int16))
    qts = [rng.integers(1, 256, 64).astype(np.uint16) for _ in frame.components]
    return planes, qts


def _jax_stage(jframe, planes, qts, quirks, precision=IdctPrecision.EXACT):
    key = (jframe, tuple(q.tobytes() for q in qts), JaxIdctPrecision[precision.name],
           JaxQuirks[quirks.name], "nn", 8)
    rgb, pix = jdecoder.build_stage_raw(key)(*(jnp.asarray(p.astype(np.int32)) for p in planes))
    return np.asarray(rgb), [np.asarray(p) for p in pix]


def _torch(planes, qts):
    return ([torch.from_numpy(p) for p in planes],
            [torch.from_numpy(q.astype(np.int32)) for q in qts])


def _assert_same(got, want):
    rgb, planes = got
    np.testing.assert_array_equal(rgb.numpy(), want[0])
    assert len(planes) == len(want[1])
    for a, b in zip(planes, want[1]):
        np.testing.assert_array_equal(a.numpy(), b)


# ---------------------------------------------------------------------------
# The guard
# ---------------------------------------------------------------------------


N_MAX = 4096
#: (h, w) pairs at which tile_local is checked, up to 4096
GUARD_SIZES = [(1, 1), (7, 45), (37, 101), (67, 8), (1080, 1920), (2160, 3840),
               (4095, 17), (N_MAX, N_MAX)]


def _first_escape(sf, msf, n=N_MAX):
    """Brute force, index by index: the first output index below n whose
    sample (uint32)(float32(i) * (float32(sf) / float32(msf))) lies outside
    its MCU, or n."""
    ratio = np.float32(sf) / np.float32(msf)
    for i in range(n):
        src = int(np.float32(i) * ratio)
        if src // (8 * sf) != i // (8 * msf):
            return i
    return n


@pytest.fixture(scope="module")
def escapes():
    pairs = [(sf, msf) for msf in range(1, 5) for sf in range(1, msf + 1)]
    return {p: _first_escape(*p) for p in pairs + [(7, 12), (12, 12)]}


def _brute_force_local(factors, h, w, escapes):
    mh = max(f[0] for f in factors)
    mv = max(f[1] for f in factors)
    return all(escapes[(fv, mv)] >= h and escapes[(fh, mh)] >= w for fh, fv in factors)


@pytest.mark.parametrize("mh,mv", list(itertools.product(range(1, 5), repeat=2)),
                         ids=lambda v: str(v))
def test_tile_local_matches_brute_force(mh, mv, escapes):
    """Every 3-component sampling with factors 1..4 and these maxima (the
    frames _check_frame takes), at sizes up to 4096: the guard agrees with
    the index-by-index check, and holds."""
    pairs = list(itertools.product(range(1, 5), repeat=2))
    sets = [f for f in itertools.product(pairs, repeat=3)
            if max(x[0] for x in f) == mh and max(x[1] for x in f) == mv]
    assert sets
    for factors in sets:
        for h, w in GUARD_SIZES:
            want = _brute_force_local(factors, h, w, escapes)
            assert pixel.tile_local(factors, h, w) == want, (factors, h, w)
            assert want


def test_tile_local_refuses_a_ratio_that_rounds_down(escapes):
    assert escapes[(7, 12)] == 864
    h, w = NOT_LOCAL_HW
    assert not pixel.tile_local(NOT_LOCAL, h, w)
    assert not _brute_force_local(NOT_LOCAL, h, w, escapes)
    # up to the first escape the guard holds
    assert pixel.tile_local(NOT_LOCAL, h, 864) and not pixel.tile_local(NOT_LOCAL, h, 865)
    port, _ = _frames(h, w, NOT_LOCAL, 8)
    assert not pixel.fits(port)


def test_fits_needs_three_components_on_the_mcu_grid():
    port, _ = _frames(37, 45, SAMPLINGS["420"], 8)
    assert pixel.fits(port)
    gray = ttypes.FrameHeader(Encoding.BASELINE_DCT, 8, 45, 37,
                              (ttypes.Component(1, 1, 1, 0, 45, 37),))
    assert not pixel.fits(gray)
    # a chroma plane one block wider than the MCU grid (the parser's float32
    # ceil can give that)
    c0, c1, c2 = port.components
    wide = ttypes.FrameHeader(Encoding.BASELINE_DCT, 8, 45, 37,
                              (c0, ttypes.Component(2, 1, 1, 1, c1.x + 8, c1.y), c2))
    assert not pixel.fits(wide)


# ---------------------------------------------------------------------------
# The plain versions against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quirks", QUIRKS, ids=lambda q: q.value)
@pytest.mark.parametrize("bits", [8, 12], ids=["8bit", "12bit"])
@pytest.mark.parametrize("h,w", SIZES, ids=lambda v: str(v))
@pytest.mark.parametrize("sampling", sorted(SAMPLINGS))
def test_tiled_plain_matches_plain_and_jax(sampling, h, w, bits, quirks):
    port, jframe = _frames(h, w, SAMPLINGS[sampling], bits)
    planes, qts = _inputs(port, h * w + bits + len(sampling))
    want = _jax_stage(jframe, planes, qts, quirks)
    tp, tq = _torch(planes, qts)
    _assert_same(pixel._pixel_exact_plain(tp, tq, port, quirks), want)
    _assert_same(pixel._pixel_tiled_plain(tp, tq, port, quirks), want)
    # strips of one and two MCUs: several strips a row, the last ragged
    for strip in (1, 2):
        _assert_same(pixel._pixel_tiled_plain(tp, tq, port, quirks, strip=strip), want)
    # the wrapper on CPU tensors is the plain composition
    _assert_same(pixel.pixel_exact(tp, tq, port, quirks), want)


@pytest.mark.parametrize("quirks", QUIRKS, ids=lambda q: q.value)
@pytest.mark.parametrize("sampling", ["420", "422", "411"])
def test_tiled_plain_batch_matches_jax_per_image(sampling, quirks):
    """A batch of three stacked [3, by, bx, 64]: each image as the JAX stage
    makes it alone (jax.vmap's counterpart)."""
    port, jframe = _frames(67, 101, SAMPLINGS[sampling], 8)
    planes, qts = _inputs(port, 41, lead=(3,))
    tp, tq = _torch(planes, qts)
    tiled = pixel._pixel_tiled_plain(tp, tq, port, quirks, strip=2)
    plain = pixel._pixel_exact_plain(tp, tq, port, quirks)
    assert tiled[0].shape == (3, 67, 101, 3)
    for i in range(3):
        want = _jax_stage(jframe, [p[i] for p in planes], qts, quirks)
        _assert_same((tiled[0][i], [p[i] for p in tiled[1]]), want)
        _assert_same((plain[0][i], [p[i] for p in plain[1]]), want)


def test_tiled_plain_refuses_a_geometry_that_is_not_tile_local():
    port, _ = _frames(*NOT_LOCAL_HW, NOT_LOCAL, 8)
    planes, qts = _inputs(port, 5)
    with pytest.raises(RuntimeError, match="outside the strip"):
        pixel._pixel_tiled_plain(*_torch(planes, qts), port, Quirks.REFERENCE)


def test_float_tiled_plain_refuses_a_geometry_that_is_not_tile_local():
    port, _ = _frames(*NOT_LOCAL_HW, NOT_LOCAL, 8)
    planes, qts = _inputs(port, 5)
    with pytest.raises(RuntimeError, match="outside the strip"):
        pixel._pixel_tiled_plain(*_torch(planes, qts), port, Quirks.REFERENCE,
                                 precision=FLOAT32)


def test_tiled_plain_without_planes():
    port, _ = _frames(37, 45, SAMPLINGS["420"], 8)
    tp, tq = _torch(*_inputs(port, 9))
    rgb, planes = pixel._pixel_tiled_plain(tp, tq, port, Quirks.REFERENCE,
                                           want_planes=False)
    assert planes is None
    assert torch.equal(rgb, pixel._pixel_exact_plain(tp, tq, port, Quirks.REFERENCE)[0])


# ---------------------------------------------------------------------------
# FLOAT32: K13's plain version against the JAX package
# ---------------------------------------------------------------------------


def _assert_float_planes(got, want, share_tol=None):
    """Pixel planes within 1 of `want` (and, when given, differing on at most
    `share_tol` of the pixels)."""
    for a, b in zip(got, want):
        d = np.abs(np.asarray(a).astype(np.int32) - np.asarray(b).astype(np.int32))
        assert d.max() <= 1
        if share_tol is not None:
            assert (d != 0).mean() <= share_tol


def _assert_own_colour(got, frame, quirks):
    """RGB bitwise the plain colour stage of the planes it came with."""
    rgb, planes = got
    factors = tuple((c.hsf, c.vsf) for c in frame.components)
    own = color._planes_to_rgb_plain(planes, frame.height, frame.width, factors, quirks)
    assert torch.equal(rgb, own)


@pytest.mark.parametrize("batch", [(), (2,)], ids=["image", "batch"])
@pytest.mark.parametrize("quirks", QUIRKS, ids=lambda q: q.value)
@pytest.mark.parametrize("bits", [8, 12], ids=["8bit", "12bit"])
@pytest.mark.parametrize("sampling", ["420", "422", "444"])
def test_float_plain_matches_jax(sampling, bits, quirks, batch):
    port, jframe = _frames(37, 45, SAMPLINGS[sampling], bits)
    planes, qts = _inputs(port, 100 * bits + len(batch) + len(sampling), lead=batch)
    tp, tq = _torch(planes, qts)
    got = pixel._pixel_float_plain(tp, tq, port, quirks)
    _assert_own_colour(got, port, quirks)
    # the wrapper on CPU tensors is the plain composition
    wrapped = pixel.pixel_float(tp, tq, port, quirks)
    assert torch.equal(wrapped[0], got[0])
    assert all(torch.equal(a, b) for a, b in zip(wrapped[1], got[1]))
    n = batch[0] if batch else 1
    for i in range(n):
        one = (lambda t: t[i]) if batch else (lambda t: t)
        want = _jax_stage(jframe, [one(p) for p in planes], qts, quirks, FLOAT32)
        _assert_float_planes([one(p) for p in got[1]], want[1])
        d = np.abs(one(got[0]).numpy().astype(np.int32) - want[0].astype(np.int32))
        assert d.max() <= FLOAT32_RGB_TOL


@pytest.mark.parametrize("strip", [None, 1, 2])
@pytest.mark.parametrize("sampling", ["420", "422", "411"])
def test_float_tiled_plain_matches_plain(sampling, strip):
    """K13's schedule, strip by strip, on a batch of two: every sample read
    from its own strip; the strips' FLOAT32 planes within 1 of the whole
    planes' (one BLAS product over other row counts may sum in another
    order), RGB their own colour stage."""
    port, _ = _frames(67, 101, SAMPLINGS[sampling], 12)
    planes, qts = _inputs(port, 43, lead=(2,))
    tp, tq = _torch(planes, qts)
    tiled = pixel._pixel_tiled_plain(tp, tq, port, Quirks.CORRECT, strip=strip,
                                     precision=FLOAT32)
    plain = pixel._pixel_float_plain(tp, tq, port, Quirks.CORRECT)
    assert tiled[0].shape == (2, 67, 101, 3)
    _assert_float_planes(tiled[1], plain[1], 1e-3)
    _assert_own_colour(tiled, port, Quirks.CORRECT)


def test_default_strip_per_contract():
    for factors in SAMPLINGS.values():
        blocks = sum(fh * fv for fh, fv in factors)
        for precision in IdctPrecision:
            g = pixel.default_strip(factors, precision)
            assert g >= 1 and g * blocks <= max(pixel.STRIP_BLOCKS[precision], blocks)
    assert pixel.default_strip(SAMPLINGS["420"]) == pixel.default_strip(
        SAMPLINGS["420"], IdctPrecision.EXACT)


# ---------------------------------------------------------------------------
# Batches above one launch's 65,535 images
# ---------------------------------------------------------------------------


def test_image_chunks_ranges_and_offsets(monkeypatch):
    # the grid's limit: 65,536 images are two launches
    big = torch.zeros((_build.MAX_IMAGES + 1, 3), dtype=torch.uint8)
    chunks = _build.image_chunks(big.shape[0], big)
    assert [(f, n) for f, n, _ in chunks] == [(0, 65535), (65535, 1)]
    assert chunks[1][2][0].value == big[65535].data_ptr()
    assert _build.image_chunks(0, big) == []
    # several launches, the last ragged, at a small limit
    monkeypatch.setattr(_build, "MAX_IMAGES", 3)
    coeff = torch.zeros((7, 2, 3, 64), dtype=torch.int16)
    rgb = torch.zeros((7, 5, 4, 3), dtype=torch.uint8)
    chunks = _build.image_chunks(7, coeff, rgb, None)
    assert [(first, count) for first, count, _ in chunks] == [(0, 3), (3, 3), (6, 1)]
    for first, _count, (c, r, none) in chunks:
        assert c.value == coeff[first].data_ptr()
        assert r.value == rgb[first].data_ptr()
        assert not none.value
    # one image without a batch dimension: one launch from the start
    plane = torch.zeros((2, 3, 64), dtype=torch.int16)
    ((first, count, (p,)),) = _build.image_chunks(1, plane)
    assert (first, count, p.value) == (0, 1, plane.data_ptr())


# ---------------------------------------------------------------------------
# PixelStage: the route and want_planes
# ---------------------------------------------------------------------------


def _stage(frame, qts, precision=IdctPrecision.EXACT, quirks=Quirks.REFERENCE):
    cfg = DecodeConfig(idct_precision=precision, quirks=quirks)
    key = tdecoder._stage_key(frame, tuple(q.tobytes() for q in qts), cfg)
    return tdecoder._build_pixel_stage(key, torch.device("cpu"))


ROUTES = {
    "420_exact": (SAMPLINGS["420"], IdctPrecision.EXACT, True),
    "411_exact": (SAMPLINGS["411"], IdctPrecision.EXACT, True),
    "420_float32": (SAMPLINGS["420"], IdctPrecision.FLOAT32, True),
    "not_tile_local_exact": (NOT_LOCAL, IdctPrecision.EXACT, False),
}


@pytest.mark.parametrize("batch", [(), (3,)], ids=["image", "batch"])
@pytest.mark.parametrize("name", sorted(ROUTES))
def test_pixel_stage_without_planes_gives_the_same_rgb(name, batch):
    factors, precision, fused = ROUTES[name]
    h, w = NOT_LOCAL_HW if factors == NOT_LOCAL else (37, 45)
    port, _ = _frames(h, w, factors, 8)
    planes, qts = _inputs(port, 3, lead=batch)
    stage = _stage(port, qts, precision)
    assert stage.fused is fused
    tp = [torch.from_numpy(p) for p in planes]
    rgb, pix = stage(*tp)
    rgb_only, none = stage(*tp, want_planes=False)
    assert none is None and len(pix) == 3
    assert rgb.shape == (*batch, h, w, 3)
    assert torch.equal(rgb, rgb_only)
    # either route is the plain composition
    plain = pixel._pixel_plain(tp, [torch.from_numpy(q.astype(np.int32)) for q in qts],
                               port, Quirks.REFERENCE, precision=precision)
    _assert_same((rgb, pix), (plain[0].numpy(), [p.numpy() for p in plain[1]]))


def test_gray_stage_is_not_fused():
    gray = ttypes.FrameHeader(Encoding.BASELINE_DCT, 8, 45, 37,
                              (ttypes.Component(1, 1, 1, 0, 45, 37),))
    qt = np.arange(1, 65, dtype=np.uint16)
    stage = _stage(gray, [qt])
    assert not stage.fused
    plane = torch.from_numpy(np.zeros((5, 6, 64), dtype=np.int16))
    rgb, none = stage(plane, want_planes=False)
    assert none is None and rgb.shape == (37, 45, 3)


# ---------------------------------------------------------------------------
# The C entry points against _build.SIGNATURES (no nvcc here)
# ---------------------------------------------------------------------------


_CTYPE = {"int": ctypes.c_int, "int64_t": ctypes.c_int64, "float": ctypes.c_float}


def _ctype(param):
    """A C parameter's ctypes type: every pointer is c_void_p."""
    kind = re.sub(r"\s+\w+$", "", param).replace("const ", "").replace(" ", "")
    return ctypes.c_void_p if kind.endswith("*") else _CTYPE[kind]


def _c_params(name):
    for path in sorted(_build.SRC_DIR.glob("*.cu")):
        m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", path.read_text())
        if m:
            return [_ctype(p.strip()) for p in m.group(1).split(",") if p.strip()]
    raise AssertionError(f"no C entry point {name}")


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_entry_point_matches_its_signature(name):
    assert _c_params(name) == list(_build.SIGNATURES[name])


def test_every_source_is_built_and_headers_are_hashed(tmp_path, monkeypatch):
    assert sorted(_build.SOURCES) == sorted(p.name for p in _build.SRC_DIR.glob("*.cu"))
    for path in _build.SRC_DIR.iterdir():
        (tmp_path / path.name).write_bytes(path.read_bytes())
    monkeypatch.setattr(_build, "SRC_DIR", tmp_path)
    # every shared header, K13's two included
    headers = sorted(p.name for p in tmp_path.glob("*.cuh"))
    assert {"idct_exact.cuh", "idct_float.cuh", "strip.cuh", "color.cuh"} <= set(headers)
    for name in headers:
        before = _build._source_hash()
        header = tmp_path / name
        header.write_text(header.read_text() + "\n")
        assert _build._source_hash() != before, name


@pytest.mark.parametrize("name,headers", [
    ("pixel_exact.cu", ("idct_exact.cuh", "strip.cuh")),
    ("pixel_float.cu", ("idct_float.cuh", "strip.cuh")),
    ("idct_float.cu", ("idct_float.cuh",)),
    ("idct_exact.cu", ("idct_exact.cuh",)),
    ("color.cu", ("color.cuh",)),
    ("idct_scaled.cu", ("idct_float.cuh",)),
])
def test_kernels_share_their_arithmetic_through_headers(name, headers):
    """K03 and K13 take the strip skeleton from one header, K1, K13 and K5
    the FLOAT32 arithmetic from another (and the colour step through
    strip.cuh's color.cuh, which K3 and K3f include), so that the bytes
    cannot drift apart."""
    text = (_build.SRC_DIR / name).read_text()
    for header in headers:
        assert f'#include "{header}"' in text
    assert '#include "color.cuh"' in (_build.SRC_DIR / "strip.cuh").read_text()


@pytest.mark.parametrize("name", sorted(pixel_sweep.VARIANTS))
def test_sweep_variants_edit_the_sources(name):
    """Each of pixel_sweep's VARIANTS finds every source text it edits, as
    often as it expects, so that a copy it builds differs from the tree
    where it says it does."""
    _kernel, edits, _bitwise = pixel_sweep.VARIANTS[name]
    for file, pattern, replacement, count in edits:
        text = (_build.SRC_DIR / file).read_text()
        edited, n = re.subn(pattern, replacement, text, flags=re.M)
        assert n == count and edited != text, (file, pattern)
