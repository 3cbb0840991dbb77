"""The port's streamed and striped decode (jpeg_decoder_tpu_torch.parallel.
stripes on device="cpu": the JAX program stripe by stripe in plain PyTorch)
against jpeg_decoder_tpu.parallel.stripes: decode_striped on the 8-device
CPU mesh that tests/conftest.py forces (make_mesh(n_data=1, n_stripe=8))
and decode_streamed, on the same bytes.

Tolerances: EXACT RGB bitwise (tolerance 0: EXACT is a bit-exact contract).
FLOAT32 RGB within 1 of the JAX package's (its IDCT there is idct_matmul;
the port's is a float32 product summed in another order). The port follows
the JAX stripes where they differ from whole-image decode (ROADMAP.md §3):
the 4:2:0 frame of height 208 under fancy upsampling differs from the
port's own whole-image decode in row 207 alone, the gray frame under
REFERENCE quirks takes CORRECT addressing, raw Adobe CMYK takes the YCCK
transform, and a (2, 4)-ratio component takes the nearest-neighbour rule.

Each stage's kernel route (StripeStage._launches, ChunkStage._launches: the
wrappers K03/K13 or K0/K1 + K3 and K3f with the stripe rule, run here as
their plain versions) is held bitwise against its plain route (the JAX
program transliterated), and the stripe rule's rows (ops/color.nn_rows,
the kernels' colour::nn_row) against the JAX slice-and-clip on every chunk
of tall geometries. JAX results are computed once a case (lru_cache)."""

import functools

import numpy as np
import pytest
import torch

import jpeg_decoder_tpu as jt
from jpeg_decoder_tpu.core import numerics as jnumerics
from jpeg_decoder_tpu.io.parser import parse as jparse
from jpeg_decoder_tpu.parallel import mesh as jmesh
from jpeg_decoder_tpu.parallel import stripes as jstripes
import jpeg_decoder_tpu_torch as jtt
from jpeg_decoder_tpu_torch import DecodeConfig, EntropyBackend, IdctPrecision, Quirks
from jpeg_decoder_tpu_torch.benchmarks.inputs import make_jpeg
from jpeg_decoder_tpu_torch.io.parser import parse
from jpeg_decoder_tpu_torch.ops import color as tcolor
from jpeg_decoder_tpu_torch.ops import pixel as tpixel
from jpeg_decoder_tpu_torch.parallel import stripes as tstripes

CPU = torch.device("cpu")
N_STRIPES = 8
F420 = ((2, 2), (1, 1), (1, 1))
F444 = ((1, 1),) * 3
F422 = ((2, 1), (1, 1), (1, 1))
NATIVE = DecodeConfig()
FANCY = NATIVE.replace(upsample="fancy", quirks=Quirks.CORRECT)
FLOAT32 = IdctPrecision.FLOAT32


def _jax_cfg(cfg: DecodeConfig):
    """The JAX package's DecodeConfig with the port config's fields."""
    return jt.DecodeConfig(
        quirks=jt.Quirks[cfg.quirks.name],
        idct_precision=jt.IdctPrecision[cfg.idct_precision.name],
        entropy_backend=jt.EntropyBackend[cfg.entropy_backend.name],
        upsample=cfg.upsample, scale=cfg.scale)


def _mcus_x(w, factors):
    return -(-w // (8 * max(f[0] for f in factors)))


def _stream(w, h, factors, seed, aligned=True, **kw):
    """Random coefficients (inputs.make_jpeg), a restart marker per MCU row
    (`aligned`: stripe-local entropy) or none."""
    return make_jpeg(w, h, factors, _mcus_x(w, factors) if aligned else 0, seed, **kw)


#: name -> (bytes, port config); JAX decodes the same bytes under _jax_cfg.
STRIPED = {
    "420_128x64": (_stream(64, 128, F420, 1), NATIVE),
    "444_64x64": (_stream(64, 64, F444, 2), NATIVE),
    "444_h24_nn": (_stream(24, 24, F444, 3, aligned=False), NATIVE),
    "444_h24_fancy": (_stream(24, 24, F444, 3, aligned=False), FANCY),
    **{f"420_h{h}_{up}": (_stream(48, h, F420, 4), cfg)
       for h in (123, 200, 208) for up, cfg in (("nn", NATIVE), ("fancy", FANCY))},
    "gray_61_reference": (_stream(61, 40, ((1, 1),), 5), NATIVE),
    "gray_61_correct": (_stream(61, 40, ((1, 1),), 5), NATIVE.replace(quirks=Quirks.CORRECT)),
    "ycck": (_stream(40, 48, F420 + ((2, 2),), 6, adobe_transform=2), NATIVE),
    "cmyk_correct": (_stream(40, 48, F444 + ((1, 1),), 7, adobe_transform=0),
                     NATIVE.replace(quirks=Quirks.CORRECT)),
    "ratio_2x4_fancy": (_stream(32, 100, ((2, 4), (1, 1), (1, 1)), 8), FANCY),
    "12bit_420": (_stream(64, 48, F420, 9, precision=12), NATIVE),
}


@functools.lru_cache(maxsize=None)
def _mesh():
    return jmesh.make_mesh(n_data=1, n_stripe=N_STRIPES)


@functools.lru_cache(maxsize=None)
def _jax_striped(name):
    data, cfg = STRIPED[name]
    return jstripes.decode_striped(data, _jax_cfg(cfg), _mesh())


def _assert_rgb(got, want, cfg):
    assert got.shape == want.shape and got.dtype == np.uint8
    if cfg.idct_precision == IdctPrecision.EXACT:
        np.testing.assert_array_equal(got, want)
    else:
        assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1


@pytest.mark.parametrize("name", sorted(STRIPED))
def test_striped_matches_jax(name):
    """decode_striped, 8 stripes: bitwise JAX's on the same bytes (FLOAT32
    within 1); the kernel route bitwise the plain route."""
    data, cfg = STRIPED[name]
    got = tstripes.decode_striped(data, cfg, n_stripes=N_STRIPES, device=CPU)
    _assert_rgb(got, _jax_striped(name), cfg)
    stage, planes = tstripes._striped_planes(parse(data, cfg), cfg, N_STRIPES, CPU)
    np.testing.assert_array_equal(stage._launches(planes).numpy(), stage(*planes).numpy())


@pytest.mark.parametrize("name, rows", [
    ("420_h208_fancy", [207]),      # divergence 1: the padding's first row below row 207
    ("420_h208_nn", []),
    ("420_h200_fancy", []),
    ("gray_61_reference", None),    # divergence 2: no width-stride shear
    ("gray_61_correct", []),
    ("cmyk_correct", None),         # divergence 3: YCCK, not raw CMYK
    ("ratio_2x4_fancy", None),      # divergence 4: the rule, not the passes
])
def test_divergences_from_whole_image_decode(name, rows):
    """Where the JAX stripes differ from whole-image decode, the port's
    stripes differ from the port's own whole-image decode the same way:
    in exactly `rows` (None: somewhere)."""
    data, cfg = STRIPED[name]
    got = tstripes.decode_striped(data, cfg, n_stripes=N_STRIPES, device=CPU)
    whole = jtt.decode(data, cfg, device=CPU).rgb
    differ = sorted(set(np.argwhere(got != whole)[:, 0].tolist()))
    if rows is None:
        assert differ
    else:
        assert differ == rows
    np.testing.assert_array_equal(got, _jax_striped(name))


#: decode_streamed's geometries (tests/test_parallel.py TestStreamed): name
#: -> (sampling, h, w, restart interval in MCUs, n_chunks)
STREAMED = {
    "420_aligned": (F420, 128, 64, 4, 2),
    "420_no_dri": (F420, 123, 64, 0, 4),
    "444_aligned": (F444, 64, 48, 6, 4),
    "gray_aligned": (((1, 1),), 77, 40, 5, 2),
    "422_aligned": (F422, 80, 64, 8, 4),
    "420_unaligned_dri": (F420, 200, 96, 11, 4),
}


def _streamed_stream(name):
    factors, h, w, ri, _n = STREAMED[name]
    return make_jpeg(w, h, factors, ri, 53)


@functools.lru_cache(maxsize=None)
def _jax_streamed(name, precision=IdctPrecision.EXACT):
    cfg = NATIVE.replace(idct_precision=precision)
    return jstripes.decode_streamed(_streamed_stream(name), _jax_cfg(cfg),
                                    n_chunks=STREAMED[name][4])


@pytest.mark.parametrize("backend", [EntropyBackend.NATIVE, EntropyBackend.PALLAS],
                         ids=lambda b: b.value)
@pytest.mark.parametrize("name", sorted(STREAMED))
def test_streamed_matches_jax(name, backend):
    """decode_streamed through chunk-local entropy (NATIVE, restart rows
    aligned with the chunks) or whole-image entropy (no or unaligned
    restarts; PALLAS, whose planes are sliced on the device): bitwise the
    JAX package's decode_streamed, and its own decode_striped's rows."""
    data = _streamed_stream(name)
    cfg = NATIVE.replace(entropy_backend=backend)
    got = tstripes.decode_streamed(data, cfg, n_chunks=STREAMED[name][4], device=CPU)
    np.testing.assert_array_equal(got, _jax_streamed(name))


def test_streamed_float32_within_one():
    data = _streamed_stream("420_aligned")
    cfg = NATIVE.replace(idct_precision=FLOAT32)
    got = tstripes.decode_streamed(data, cfg, n_chunks=2, device=CPU)
    _assert_rgb(got, _jax_streamed("420_aligned", FLOAT32), cfg)


def _frame(h, w, factors, bits=8):
    """A port FrameHeader of sampling `factors` (the parser's integer
    component sizes)."""
    from jpeg_decoder_tpu_torch.core import types
    from jpeg_decoder_tpu_torch.io.markers import Encoding

    mh = max(f[0] for f in factors)
    mv = max(f[1] for f in factors)
    return types.FrameHeader(
        Encoding.BASELINE_DCT, bits, w, h,
        tuple(types.Component(i + 1, fh, fv, min(i, 1), -(-w * fh // mh), -(-h * fv // mv))
              for i, (fh, fv) in enumerate(factors)))


#: (h, w, factors, n_chunks): a chunk of ChunkStage's geometries; the last
#: is not tile-local (7/12 leaves its MCU from row 864) and runs K0/K1 + K3
#: with the clamp live, one MCU row a chunk
CHUNK_CASES = {
    "420": (216, 40, F420, 5),
    "422": (203, 40, F422, 4),
    "444": (61, 45, F444, 3),
    "gray": (77, 19, ((1, 1),), 4),
    "ycck": (100, 40, F420 + ((2, 2),), 3),
    "vertical_3x": (216, 24, ((1, 3), (1, 1), (1, 1)), 5),
    "refused_7_12": (1000, 8, ((1, 12), (1, 7), (1, 7)), 11),
}


@pytest.mark.parametrize("precision", list(IdctPrecision), ids=lambda p: p.value)
@pytest.mark.parametrize("name", sorted(CHUNK_CASES))
def test_chunk_kernel_route_matches_plain_route(name, precision):
    """ChunkStage: every chunk's kernel route (K03/K13, or K0/K1 + K3, with
    the chunk origin) bitwise its plain route (the JAX chunk_fn), on random
    coefficient planes; for tile-local 3-component geometries under EXACT
    also the strip schedule under the stripe rule (the samples of every
    strip inside its own tile)."""
    h, w, factors, n = CHUNK_CASES[name]
    frame = _frame(h, w, factors)
    rng = np.random.default_rng(len(name))
    qts = tuple(rng.integers(1, 64, 64).astype(np.uint16).tobytes() for _ in factors)
    key = (frame, qts, precision, Quirks.REFERENCE, "nn", 8)
    stage = tstripes.ChunkStage(key, n, CPU)
    assert stage.fused == (len(factors) == 3 and name != "refused_7_12")
    for k in range(n):
        planes = [torch.from_numpy(rng.integers(-300, 300, (lby, c.blocks_x, 64)).astype(np.int16))
                  for lby, c in zip(stage.lby, frame.components)]
        want = stage(k, *planes)
        assert want.shape == (stage.hs, w, 3)
        np.testing.assert_array_equal(stage._launches(k, planes).numpy(), want.numpy())
        if stage.fused and precision == IdctPrecision.EXACT:
            tiled, _ = tpixel._pixel_tiled_plain(
                planes, stage._qts(), stage.stripe_frame, Quirks.REFERENCE, False, strip=2,
                stripes=tcolor.Stripes(k * stage.hs, stage.hs))
            np.testing.assert_array_equal(tiled.numpy(), want.numpy())


def stage_key(frame, data, cfg):
    from jpeg_decoder_tpu_torch.models import host

    _planes, qts = host._entropy_decode(parse(data, cfg), cfg)
    return tstripes._stage_for(frame, qts, cfg)


#: (vsf, max_vsf) of tall geometries: every ratio of factors up to 4, and
#: 7/12, whose float32 ratio rounds down far enough to leave its MCU
RATIOS = [(1, 2), (1, 3), (2, 3), (1, 4), (3, 4), (7, 12)]


@pytest.mark.parametrize("vsf, vmax", RATIOS)
def test_stripe_rows_match_the_jax_slice_and_clip(vsf, vmax):
    """nn_rows under stripes (the kernels' colour::nn_row) against the JAX
    rule on every chunk of tall padded frames (up to 65,535 rows) and for
    the whole padded frame in one launch (chunk k's rows offset by k
    stripes)."""
    ratio = np.float32(vsf) / np.float32(vmax)
    for mcus_y, n in ((65535 // (8 * vmax), 7), (8191 // vmax, 16), (97, 8), (13, 8)):
        pad_h = -(-mcus_y // n) * n * 8 * vmax
        hs = pad_h // n
        local = hs * vsf // vmax
        table = jnumerics._nn_index_f32(pad_h, ratio)
        whole = tcolor.nn_rows(pad_h, vsf, vmax, tcolor.Stripes(0, hs))
        for k in range(n):
            want = np.clip(table[k * hs:(k + 1) * hs] - k * local, 0, local - 1)
            got = tcolor.nn_rows(hs, vsf, vmax, tcolor.Stripes(k * hs, hs))
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(whole[k * hs:(k + 1) * hs], want + k * local)


def test_the_clamp_is_live_for_a_refused_geometry():
    """7/12 leaves its MCU from row 864: with one MCU row a chunk the JAX
    rule clamps the source of the chunk at row 864 into the chunk, where
    the whole-frame rule reads the chunk before; the padded geometry is
    refused by the guard, so K0 + K3 run it."""
    got = tcolor.nn_rows(96, 7, 12, tcolor.Stripes(864, 96))
    whole = tcolor.nn_rows(960, 7, 12)[864:]
    assert got[0] == 0 and whole[0] < 9 * 56
    h, w, factors, _n = CHUNK_CASES["refused_7_12"]
    assert not tpixel.fits(_frame(h, w, factors).with_height(1056, reference_quirks=False))


def test_entropy_decode_striped_matches_jax():
    """Stripe-local host entropy: each stripe's planes bitwise the JAX
    package's (padding rows replicated); None off NATIVE."""
    data, cfg = STRIPED["420_h200_nn"]
    got = tstripes.entropy_decode_striped(parse(data, cfg), cfg, N_STRIPES)
    want = jstripes.entropy_decode_striped(jparse(data), _jax_cfg(cfg), N_STRIPES)
    assert got is not None and want is not None
    for gs, ws in zip(got[0], want[0]):
        for g, w in zip(gs, ws):
            np.testing.assert_array_equal(g, w)
    assert sorted(got[1]) == sorted(want[1])
    for backend in (EntropyBackend.NUMPY, EntropyBackend.PALLAS):
        other = cfg.replace(entropy_backend=backend)
        assert tstripes.entropy_decode_striped(parse(data, other), other, N_STRIPES) is None
    unaligned = _streamed_stream("420_unaligned_dri")
    assert tstripes.entropy_decode_striped(parse(unaligned), NATIVE, 4) is None


def test_fancy_and_single_chunk_go_to_striped():
    """decode_streamed hands fancy upsampling and a single chunk to
    decode_striped (one stripe on the CPU), where a sink raises."""
    data, cfg = STRIPED["420_128x64"]
    fancy = FANCY
    np.testing.assert_array_equal(
        tstripes.decode_streamed(data, fancy, n_chunks=4, device=CPU),
        tstripes.decode_striped(data, fancy, n_stripes=1, device=CPU))
    np.testing.assert_array_equal(
        tstripes.decode_streamed(data, fancy, n_chunks=4, device=CPU),
        jtt.decode(data, fancy, device=CPU).rgb)
    for c, n in ((fancy, 4), (cfg, 1)):
        with pytest.raises(ValueError, match="sink"):
            tstripes.decode_streamed(data, c, n_chunks=n, sink=lambda *a: None, device=CPU)


def test_sink_receives_each_real_chunk():
    """sink(k, rgb, r0, take): chunk k's [hs, W, 3] tensor, its first take
    rows the image's rows r0..; chunks wholly in padding are not sent, and
    nothing is returned."""
    data = _streamed_stream("420_no_dri")
    seen = {}
    out = tstripes.decode_streamed(
        data, NATIVE, n_chunks=4, device=CPU,
        sink=lambda k, rgb, r0, take: seen.setdefault(k, (rgb.clone(), r0, take)))
    assert out is None
    want = tstripes.decode_streamed(data, NATIVE, n_chunks=4, device=CPU)
    rows = [rgb[:take].numpy() for _k, (rgb, _r0, take) in sorted(seen.items())]
    np.testing.assert_array_equal(np.concatenate(rows), want)
    assert [(r0, take) for _rgb, r0, take in seen.values()] == [(0, 32), (32, 32), (64, 32),
                                                                (96, 27)]


def test_stages_are_built_once_a_key():
    """One ChunkStage for every chunk of a decode_streamed call, one
    StripeStage a decode_striped key."""
    data = _streamed_stream("420_aligned")
    tstripes.make_chunk_stage.cache_clear()
    tstripes.decode_streamed(data, NATIVE, n_chunks=4, device=CPU)
    assert tstripes.make_chunk_stage.cache_info().misses == 1
    tstripes.build_striped_stage.cache_clear()
    for _ in range(2):
        tstripes.decode_striped(data, NATIVE, n_stripes=4, device=CPU)
    info = tstripes.build_striped_stage.cache_info()
    assert (info.misses, info.hits) == (1, 1)


def test_scale_below_8_raises_value_error():
    """Striped decode is full-scale only: ValueError, as the JAX package's."""
    data, cfg = STRIPED["420_128x64"]
    scaled = cfg.replace(scale=4)
    with pytest.raises(ValueError, match="full-scale"):
        tstripes.decode_striped(data, scaled, n_stripes=N_STRIPES, device=CPU)
    with pytest.raises(ValueError, match="full-scale"):
        jstripes.decode_striped(data, _jax_cfg(scaled), _mesh())
    with pytest.raises(ValueError, match="full-scale"):
        tstripes.decode_streamed(data, scaled, n_chunks=4, device=CPU)
    with pytest.raises(ValueError, match="NN-only"):
        tstripes.ChunkStage(stage_key(parse(data).frame, data, FANCY), 4, CPU)


def test_halo_exchange_rows():
    """Each stripe's halo rows are its neighbours' edge rows, the outer
    edges replicated."""
    xs = [torch.arange(6).reshape(2, 3) + 10 * k for k in range(3)]
    ext = tstripes._halo_exchange_rows(xs)
    assert [e[0].tolist() for e in ext] == [[0, 1, 2], [3, 4, 5], [13, 14, 15]]
    assert [e[-1].tolist() for e in ext] == [[10, 11, 12], [20, 21, 22], [23, 24, 25]]
    whole = tcolor.fancy_v2x(torch.cat(xs).float())
    np.testing.assert_array_equal(
        torch.cat(tstripes._fancy_upsample_v2x_striped([x.float() for x in xs])).numpy(),
        whole.numpy())
