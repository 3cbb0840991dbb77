"""The port's colour stage (jpeg_decoder_tpu_torch/ops/color.py) against the
JAX package: bitwise, on the same numpy inputs, except YCCK under FLOAT32
(within 1: float32 chains that the two frameworks may round otherwise).

YCCK under EXACT is held on the whole input domain of R and B (16.7 M
(y, cr, k) and (y, cb, k) triples each) against the JAX function as it is
called (op by op) and against the float64 chain of core/numerics (the
reference's statements). The JAX package's jitted stage, which fuses the
same df32 operations, differs from both on a few inputs (ROADMAP.md §3):
the port follows the chain.

The CPU model of K3's and K3f's run schedule (ops/color.
_planes_to_rgb_runs_plain, its stores _store_runs) is held bitwise against
the plain version and the JAX stage at widths that are not a multiple of the
run, under the stripe rule, at every output address modulo 16 and with
misaligned planes; the launch's `colour_vector_pct` (vector_share) against
the model's paths."""

import collections

import jax
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from jpeg_decoder_tpu.core import numerics as jnumerics
from jpeg_decoder_tpu.ops import color as jcolor
from jpeg_decoder_tpu.utils.config import Quirks as JaxQuirks
from jpeg_decoder_tpu_torch.core import numerics as tnumerics
from jpeg_decoder_tpu_torch.ops import color as tcolor
from jpeg_decoder_tpu_torch.utils.config import Quirks


QUIRKS = [Quirks.REFERENCE, Quirks.CORRECT]


@pytest.mark.parametrize(
    "hsf,vsf,mh,mv", [(1, 1, 1, 1), (1, 1, 2, 1), (1, 1, 1, 2), (1, 1, 2, 2),
                      (1, 1, 4, 1)],
    ids=["1x1", "2x1", "1x2", "2x2", "4x1"],
)
def test_nn_upsample_matches_jax(hsf, vsf, mh, mv):
    rng = np.random.default_rng(hsf * 7 + mh * 3 + mv)
    out_h, out_w = 37, 45
    plane = rng.integers(0, 256, (-(-out_h * vsf // mv) + 8, -(-out_w * hsf // mh) + 8),
                         dtype=np.uint8)
    got = tcolor.nn_upsample(torch.from_numpy(plane), out_h, out_w, hsf, vsf, mh, mv)
    want = jcolor.nn_upsample(jnp.asarray(plane), out_h, out_w, hsf, vsf, mh, mv)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("quirks", QUIRKS, ids=lambda q: q.value)
def test_ycbcr_to_rgb_matches_jax(quirks):
    rng = np.random.default_rng(11)
    y, cb, cr = rng.integers(0, 256, (3, 96, 128), dtype=np.uint8)
    # every extreme corner of the (y, cb, cr) cube
    corners = np.array(np.meshgrid([0, 1, 254, 255], [0, 1, 128, 255],
                                   [0, 1, 128, 255])).reshape(3, -1)
    y[0, : corners.shape[1]], cb[0, : corners.shape[1]], cr[0, : corners.shape[1]] = corners
    got = tcolor.ycbcr_to_rgb(*(torch.from_numpy(c) for c in (y, cb, cr)), quirks)
    want = jcolor.ycbcr_to_rgb(*(jnp.asarray(c) for c in (y, cb, cr)), True,
                               JaxQuirks[quirks.name])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_gray_to_rgb_matches_jax():
    y = np.random.default_rng(5).integers(0, 256, (13, 29), dtype=np.uint8)
    got = tcolor.gray_to_rgb(torch.from_numpy(y))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jcolor.gray_to_rgb(jnp.asarray(y))))


def _pixel_planes(h, w, factors, seed):
    """Random uint8 pixel planes at their MCU-padded sizes."""
    rng = np.random.default_rng(seed)
    mh = max(f[0] for f in factors)
    mv = max(f[1] for f in factors)
    mcus_x, mcus_y = -(-w // (8 * mh)), -(-h // (8 * mv))
    return [rng.integers(0, 256, (mcus_y * fv * 8, mcus_x * fh * 8), dtype=np.uint8)
            for fh, fv in factors]


def _jax_stage_rgb(planes, h, w, factors, quirks, upsample="nn", exact=True,
                   raw_cmyk=False):
    """build_stage_raw's colour half (models/decoder.py:115-160)."""
    if len(planes) == 1:
        p = jnp.asarray(planes[0])
        if quirks == Quirks.REFERENCE:
            idx = np.arange(h)[:, None] * w + np.arange(w)[None, :]
            y = p.reshape(-1)[jnp.asarray(idx)]
        else:
            y = p[:h, :w]
        return np.asarray(jcolor.gray_to_rgb(y))
    mh = max(f[0] for f in factors)
    mv = max(f[1] for f in factors)
    up = jcolor.nn_upsample if upsample == "nn" else jcolor.fancy_upsample
    chans = [up(jnp.asarray(p), h, w, fh, fv, mh, mv) for p, (fh, fv) in zip(planes, factors)]
    jq = JaxQuirks[quirks.name]
    if len(planes) == 3:
        return np.asarray(jcolor.ycbcr_to_rgb(*chans, True, jq))
    if raw_cmyk:
        return np.asarray(jcolor.cmyk_to_rgb(*chans))
    return np.asarray(jcolor.ycck_to_rgb(*chans, exact, jq))


@pytest.mark.parametrize("quirks", QUIRKS, ids=lambda q: q.value)
@pytest.mark.parametrize(
    "h,w,factors",
    [(37, 45, ((1, 1),)), (37, 45, ((2, 2), (1, 1), (1, 1))),
     (24, 40, ((1, 1), (1, 1), (1, 1)))],
    ids=["gray_shear", "420", "444"],
)
def test_planes_to_rgb_matches_jax_stage(h, w, factors, quirks):
    planes = _pixel_planes(h, w, factors, h + w + len(factors))
    got = tcolor.planes_to_rgb([torch.from_numpy(p) for p in planes], h, w,
                               factors, quirks)
    np.testing.assert_array_equal(got.numpy(), _jax_stage_rgb(planes, h, w, factors, quirks))


@pytest.mark.parametrize("quirks", QUIRKS, ids=lambda q: q.value)
@pytest.mark.parametrize(
    "h,w,factors",
    [(37, 45, ((1, 1),)), (37, 45, ((2, 2), (1, 1), (1, 1))),
     (24, 40, ((1, 1), (1, 1), (1, 1)))],
    ids=["gray_shear", "420", "444"],
)
def test_planes_to_rgb_batch_matches_jax_per_image(h, w, factors, quirks):
    """A leading batch dimension: [B, rows, stride] planes -> [B, h, w, 3],
    each image as the JAX stage makes it alone (jax.vmap's counterpart)."""
    batch = [_pixel_planes(h, w, factors, 100 + i) for i in range(3)]
    stacked = [torch.from_numpy(np.stack([b[c] for b in batch]))
               for c in range(len(factors))]
    got = tcolor.planes_to_rgb(stacked, h, w, factors, quirks)
    assert got.shape == (3, h, w, 3)
    for i, planes in enumerate(batch):
        np.testing.assert_array_equal(got[i].numpy(),
                                      _jax_stage_rgb(planes, h, w, factors, quirks))


def test_planes_to_rgb_rejects_mismatched_batches():
    planes = [torch.from_numpy(p) for p in _pixel_planes(16, 16, ((1, 1),) * 3, 1)]
    with pytest.raises(ValueError):
        tcolor.planes_to_rgb([planes[0][None], planes[1], planes[2]], 16, 16,
                             ((1, 1),) * 3, Quirks.REFERENCE)


# ---------------------------------------------------------------------------
# Fancy upsampling, YCCK and CMYK
# ---------------------------------------------------------------------------


#: (hsf, vsf, max_hsf, max_vsf): every branch of fancy_upsample
FANCY_PAIRS = [(1, 1, 2, 2), (1, 1, 2, 1), (1, 1, 1, 2), (1, 1, 4, 1), (1, 1, 4, 2),
               (2, 2, 2, 2), (2, 1, 4, 2)]


@pytest.mark.parametrize("rows,cols", [(16, 24), (13, 21)], ids=["even", "odd"])
@pytest.mark.parametrize("hsf,vsf,mh,mv", FANCY_PAIRS,
                         ids=[f"{a}x{b}_of_{c}x{d}" for a, b, c, d in FANCY_PAIRS])
def test_fancy_upsample_matches_jax(hsf, vsf, mh, mv, rows, cols):
    """Bitwise, on planes with an all-255 corner (where the two passes give
    256 before the clamp) and an all-0 one; the output cropped short of the
    plane's extent, so that the edges replicated are the plane's."""
    rng = np.random.default_rng(rows * cols + 10 * mh + mv)
    plane = rng.integers(0, 256, (rows, cols), dtype=np.uint8)
    plane[:4, :4] = 255
    plane[-4:, -4:] = 0
    out_h, out_w = rows * mv // vsf - 3, cols * mh // hsf - 5
    got = tcolor.fancy_upsample(torch.from_numpy(plane), out_h, out_w, hsf, vsf, mh, mv)
    want = jcolor.fancy_upsample(jnp.asarray(plane), out_h, out_w, hsf, vsf, mh, mv)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the passes alone, in float32
    x = plane.astype(np.float32)
    np.testing.assert_array_equal(tcolor.fancy_h2x(torch.from_numpy(x)).numpy(),
                                  np.asarray(jcolor.fancy_h2x(jnp.asarray(x))))
    np.testing.assert_array_equal(tcolor.fancy_v2x(torch.from_numpy(x)).numpy(),
                                  np.asarray(jcolor.fancy_v2x(jnp.asarray(x))))


def _domain(channel):
    """(y, cb, cr, k) uint8 arrays that walk R's whole (y, cr, k) domain
    (channel 0) or B's (y, cb, k) (channel 2), the other chroma at 128."""
    y, c, k = (a.ravel() for a in np.meshgrid(
        np.arange(256, dtype=np.uint8), np.arange(256, dtype=np.uint8),
        np.arange(256, dtype=np.uint8), indexing="ij"))
    mid = np.full_like(y, 128)
    return (y, mid, c, k) if channel == 0 else (y, c, mid, k)


@pytest.mark.parametrize("channel", [0, 2], ids=["R", "B"])
def test_ycck_exact_matches_jax_and_numerics_on_the_full_domain(channel):
    """YCCK EXACT bitwise against the JAX function (op by op) and the
    float64 chain, both quirks, over every (y, chroma, k) of R or B."""
    chans = _domain(channel)
    step = 1 << 22
    for quirks in QUIRKS:
        jq = JaxQuirks[quirks.name]
        for lo in range(0, chans[0].size, step):
            part = [c[lo: lo + step] for c in chans]
            got = tcolor.ycck_to_rgb(*map(torch.from_numpy, part), True, quirks).numpy()
            np.testing.assert_array_equal(
                got[:, channel], tnumerics.ycck_channels_to_rgb(*part, quirks)[:, channel])
            np.testing.assert_array_equal(
                got[:, channel], jnumerics.ycck_channels_to_rgb(*part, jq)[:, channel])
            want = np.asarray(jcolor.ycck_to_rgb(*map(jnp.asarray, part), True, jq))
            np.testing.assert_array_equal(got[:, channel], want[:, channel])


@pytest.mark.parametrize("quirks", QUIRKS, ids=lambda q: q.value)
def test_ycck_matches_jax_on_a_random_million(quirks):
    """Every channel (G depends on all four samples) on a random million:
    EXACT bitwise against the JAX function and the float64 chain; FLOAT32
    within 1 of the JAX function, called op by op and jitted. On this
    sample the port's FLOAT32 equals the op-by-op JAX function everywhere
    and differs by 1 from the jitted one on about 1e-5 of the values
    (2.5e-5 REFERENCE, 1.1e-5 CORRECT, seed 3, in a CPU run of this test)."""
    rng = np.random.default_rng(3)
    chans = rng.integers(0, 256, (4, 1 << 20), dtype=np.uint8)
    jq = JaxQuirks[quirks.name]
    got = tcolor.ycck_to_rgb(*map(torch.from_numpy, chans), True, quirks).numpy()
    np.testing.assert_array_equal(got, jnumerics.ycck_channels_to_rgb(*chans, jq))
    np.testing.assert_array_equal(got, np.asarray(
        jcolor.ycck_to_rgb(*map(jnp.asarray, chans), True, jq)))
    got = tcolor.ycck_to_rgb(*map(torch.from_numpy, chans), False, quirks).numpy()
    eager = np.asarray(jcolor.ycck_to_rgb(*map(jnp.asarray, chans), False, jq))
    jitted = np.asarray(jax.jit(lambda *x: jcolor.ycck_to_rgb(*x, False, jq))(
        *map(jnp.asarray, chans)))
    for want in (eager, jitted):
        d = np.abs(got.astype(np.int32) - want)
        assert d.max() <= 1
        assert (d != 0).mean() <= 1e-4


#: Inputs (y, cb, cr, k) on which the JAX package's jitted YCCK EXACT differs
#: from its op-by-op function and the float64 chain (ROADMAP.md §3): the
#: pixel (172, 52) of tests/wild_files/transcoded/hopper_cmyk_adobe.jpg,
#: whose R is 128, and R and B cases of the full-domain sweep.
JIT_DIVERGENCES = [((127, 115, 128, 255), 0, 128), ((65, 128, 128, 153), 0, 114),
                   ((75, 128, 128, 17), 0, 12), ((6, 27, 128, 143), 2, 239)]


@pytest.mark.parametrize("sample,channel,value", JIT_DIVERGENCES)
def test_ycck_exact_follows_the_chain_where_jitted_jax_does_not(sample, channel, value):
    """REFERENCE quirks: the port gives the float64 chain's byte."""
    chans = [np.array([v], dtype=np.uint8) for v in sample]
    got = tcolor.ycck_to_rgb(*map(torch.from_numpy, chans), True, Quirks.REFERENCE).numpy()
    assert got[0, channel] == value
    assert jnumerics.ycck_channels_to_rgb(*chans, JaxQuirks.REFERENCE)[0, channel] == value


def test_cmyk_to_rgb_matches_jax_on_the_full_domain():
    """Every (c, k) pair, in each of the three channels."""
    c, k = (a.ravel() for a in np.meshgrid(np.arange(256, dtype=np.uint8),
                                           np.arange(256, dtype=np.uint8), indexing="ij"))
    chans = (c, np.roll(c, 1), np.roll(c, 2), k)
    got = tcolor.cmyk_to_rgb(*map(torch.from_numpy, chans)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jcolor.cmyk_to_rgb(*map(jnp.asarray, chans))))
    np.testing.assert_array_equal(got, jnumerics.cmyk_channels_to_rgb(*chans))


F4 = ((1, 1),) * 4
#: name -> (h, w, factors, upsample, exact, raw_cmyk)
STAGES = {
    "fancy_420": (37, 45, ((2, 2), (1, 1), (1, 1)), "fancy", True, False),
    "fancy_422": (37, 45, ((2, 1), (1, 1), (1, 1)), "fancy", True, False),
    "fancy_411": (37, 45, ((4, 1), (1, 1), (1, 1)), "fancy", True, False),
    "fancy_421": (37, 45, ((4, 2), (1, 1), (1, 1)), "fancy", True, False),
    "ycck_exact": (24, 40, F4, "nn", True, False),
    "ycck_float32": (24, 40, F4, "nn", False, False),
    "cmyk": (24, 40, F4, "nn", True, True),
    "ycck_420_fancy": (37, 45, ((2, 2), (1, 1), (1, 1), (2, 2)), "fancy", True, False),
    "cmyk_422_fancy": (37, 45, ((2, 1), (1, 1), (1, 1), (2, 1)), "fancy", True, True),
}


@pytest.mark.parametrize("quirks", QUIRKS, ids=lambda q: q.value)
@pytest.mark.parametrize("name", sorted(STAGES))
def test_planes_to_rgb_new_stages_match_jax(name, quirks):
    """4 components and fancy upsampling, single and batched, against the
    JAX stage's colour half (op by op): bitwise, YCCK FLOAT32 within 1."""
    h, w, factors, upsample, exact, raw = STAGES[name]
    batch = [_pixel_planes(h, w, factors, 200 + i) for i in range(2)]
    for planes in batch:
        planes[0][:9, :9] = 255
    stacked = [torch.from_numpy(np.stack([b[c] for b in batch])) for c in range(len(factors))]
    got = tcolor.planes_to_rgb(stacked, h, w, factors, quirks, upsample, exact, raw)
    assert got.shape == (2, h, w, 3)
    for i, planes in enumerate(batch):
        single = tcolor.planes_to_rgb([torch.from_numpy(p) for p in planes], h, w, factors,
                                      quirks, upsample, exact, raw)
        assert torch.equal(single, got[i])
        want = _jax_stage_rgb(planes, h, w, factors, quirks, upsample, exact, raw)
        d = np.abs(single.numpy().astype(np.int32) - want)
        assert d.max() <= (0 if exact else 1)


@pytest.mark.parametrize("factors,flags", [
    (((1, 1),), [0]),
    (((2, 2), (1, 1), (1, 1)), [0, tcolor._NN, tcolor._NN]),
    (((2, 1), (1, 1), (1, 1)), [0, tcolor._NN, tcolor._NN]),
    (((1, 1),) * 3, [0, 0, 0]),
    (((2, 2), (1, 1), (1, 1), (2, 2)), [0, tcolor._NN, tcolor._NN, 0]),
], ids=["gray", "420", "422", "444", "4x_420"])
def test_nn_geometry_reads_full_factor_planes_in_place(factors, flags):
    """K3's geometry: a component at the full factors is read in place (the
    rule's index at ratio 1 is the pixel's own), the others by the rule at
    their ratio."""
    mh, mv = max(f[0] for f in factors), max(f[1] for f in factors)
    shapes = [(16 * fv // mv, 32 * fh // mh) for fh, fv in factors]
    geom, ratios = tcolor.upsample_geometry(shapes, 16, 32, factors, False)
    assert [g[2] for g in geom] == flags
    for (fh, fv), (hr, vr) in zip(factors, ratios):
        assert (hr, vr) == (fh / mh, fv / mv)
    for i in (0, 15):
        assert tnumerics._nn_index_f32(i + 1, np.float32(1.0))[i] == i


def test_colour_modes_match_the_kernels_enum():
    """The host numbers the colour transforms as csrc/color.cuh's Mode does."""
    from jpeg_decoder_tpu_torch import _build

    text = (_build.SRC_DIR / "color.cuh").read_text()
    enum = text[text.index("enum Mode {") + len("enum Mode {"):]
    enum = enum[: enum.index("}")]
    got = {k.strip(): int(v) for k, v in (e.split("=") for e in enum.split(","))}
    assert got == {"kYCbCr": tcolor.YCBCR, "kYcckExact": tcolor.YCCK_EXACT,
                   "kYcckFloat": tcolor.YCCK_FLOAT, "kCmyk": tcolor.CMYK,
                   "kGray": tcolor.GRAY}


def test_upsample_geometry_refuses_a_plane_too_small():
    """K3f's and K3's geometry: the flags of each branch, and the bounds
    check the kernels rely on."""
    geom, ratios = tcolor.upsample_geometry([(16, 32), (8, 8), (8, 8)], 16, 32,
                                            ((4, 2), (1, 1), (1, 1)), True)
    # the full-resolution component is cropped; the others take the
    # vertical pass, then the nearest-neighbour rule at 1/4 across
    assert [g[2] for g in geom] == [0, tcolor._V2X | tcolor._NN, tcolor._V2X | tcolor._NN]
    assert ratios[1] == (0.25, 1.0)
    geom, _ = tcolor.upsample_geometry([(16, 16), (8, 8), (8, 8)], 16, 16,
                                       ((2, 2), (1, 1), (1, 1)), True)
    assert [g[2] for g in geom] == [0, tcolor._H2X | tcolor._V2X, tcolor._H2X | tcolor._V2X]
    with pytest.raises(ValueError, match="smaller"):
        tcolor.upsample_geometry([(16, 16), (8, 7), (8, 8)], 16, 16,
                                 ((2, 2), (1, 1), (1, 1)), True)
    with pytest.raises(ValueError, match="smaller"):
        tcolor.upsample_geometry([(16, 16)] * 3 + [(15, 16)], 16, 16, F4, False)


# ---------------------------------------------------------------------------
# K3's and K3f's run schedule (csrc/color.cu colour_run_kernel) on the CPU
# ---------------------------------------------------------------------------


#: name -> (factors, upsample, exact, raw_cmyk): the samplings of the run
#: schedule's CPU model, each of its per-component paths.
RUN_CASES = {
    "gray": (((1, 1),), "nn", True, False),
    "420_nn": (((2, 2), (1, 1), (1, 1)), "nn", True, False),
    "420_fancy": (((2, 2), (1, 1), (1, 1)), "fancy", True, False),
    "422_fancy": (((2, 1), (1, 1), (1, 1)), "fancy", True, False),
    "440_fancy": (((1, 2), (1, 1), (1, 1)), "fancy", True, False),
    "411_fancy": (((4, 1), (1, 1), (1, 1)), "fancy", True, False),
    "421_fancy": (((4, 2), (1, 1), (1, 1)), "fancy", True, False),
    "ycck_exact_444": (F4, "nn", True, False),
    "ycck_420_fancy": (((2, 2), (1, 1), (1, 1), (2, 2)), "fancy", True, False),
    "cmyk_422_fancy": (((2, 1), (1, 1), (1, 1), (2, 1)), "fancy", True, True),
}


def _saturated(h, w, factors, seed, n=2):
    """n images' planes with an all-255 corner (the fancy passes' 256)."""
    batch = [_pixel_planes(h, w, factors, seed + i) for i in range(n)]
    for planes in batch:
        for p in planes:
            p[:9, :9] = 255
    return batch


@pytest.mark.parametrize("w", [1, 15, 17, 45])
@pytest.mark.parametrize("name", sorted(RUN_CASES))
def test_run_schedule_matches_plain_and_jax(name, w):
    """The CPU model of K3's and K3f's run schedule (runs of 16 pixels, the
    vector paths and the per-pixel rule, the stores realigned to the row's
    head, the masked ends)
    bitwise against the plain colour stage and the JAX stage's colour half,
    at widths that are not a multiple of the run, an odd height, a batch of
    two, both quirks, an aligned and a misaligned output and planes."""
    factors, upsample, exact, raw = RUN_CASES[name]
    h = 19
    batch = _saturated(h, w, factors, 300 + w)
    stacked = [torch.from_numpy(np.stack([b[c] for b in batch])) for c in range(len(factors))]
    for quirks in QUIRKS:
        want = tcolor._planes_to_rgb_plain(stacked, h, w, factors, quirks, upsample, exact, raw)
        for out_head, plane_head in ((0, 0), (5, 8)):
            got = tcolor._planes_to_rgb_runs_plain(
                stacked, h, w, factors, quirks, upsample, exact, raw, out_head=out_head,
                plane_heads=[plane_head] * len(factors))
            assert torch.equal(got, want)
        for i, planes in enumerate(batch):
            jax_rgb = _jax_stage_rgb(planes, h, w, factors, quirks, upsample, exact, raw)
            np.testing.assert_array_equal(want[i].numpy(), jax_rgb)


def test_run_schedule_takes_every_path():
    """At the 4K width a 4:2:0 fancy frame takes the vector loads on every
    run; a width 8 more (3848) moves the rows' heads row by row, and still
    every run takes them, the partial run at each row's end too (its loads
    stay inside the padded planes); misaligned planes take the per-pixel
    rule."""
    factors = ((2, 2), (1, 1), (1, 1))
    for w, out_head, plane_head, expect in (
            (3840, 0, 0, {"vector"}), (3848, 0, 0, {"vector"}), (3848, 5, 0, {"vector"}),
            (3840, 0, 4, {"pixel"})):
        planes = [torch.from_numpy(p) for p in _saturated(4, w, factors, 7, 1)[0]]
        paths = collections.Counter()
        got = tcolor._planes_to_rgb_runs_plain(planes, 4, w, factors, Quirks.REFERENCE,
                                               "fancy", out_head=out_head,
                                               plane_heads=[plane_head] * 3, paths=paths)
        assert set(paths) == expect
        assert torch.equal(got, tcolor._planes_to_rgb_plain(planes, 4, w, factors,
                                                             Quirks.REFERENCE, "fancy"))


@pytest.mark.parametrize("out_head", range(16))
@pytest.mark.parametrize("w", [45, 500])
def test_run_schedule_at_every_output_head(w, out_head):
    """With the output at each address modulo 16, a batch of two 4:2:0
    fancy images (the loader's 500 wide, whose rows' heads cycle 0, 12, 8,
    4, and 45) is bitwise the plain version, and every run takes the
    vector loads, the partial run at the row's end too."""
    factors = ((2, 2), (1, 1), (1, 1))
    h = 5
    batch = _saturated(h, w, factors, 40 + w)
    stacked = [torch.from_numpy(np.stack([b[c] for b in batch])) for c in range(3)]
    paths = collections.Counter()
    got = tcolor._planes_to_rgb_runs_plain(stacked, h, w, factors, Quirks.REFERENCE, "fancy",
                                           out_head=out_head, paths=paths)
    assert torch.equal(got, tcolor._planes_to_rgb_plain(stacked, h, w, factors,
                                                        Quirks.REFERENCE, "fancy"))
    assert paths == {"vector": 2 * h * -(-w // 16)}


def _launch_share(planes, h, w, factors, upsample, quirks, plane_head):
    """vector_share over the geometry _launch gives the kernel, each plane
    at address `plane_head`."""
    fancy = upsample == "fancy" and len(planes) > 1
    g, r = tcolor.launch_geometry([p.shape[-2:] for p in planes], h, w, factors, fancy,
                                  quirks == Quirks.REFERENCE)
    return tcolor.vector_share(g, r, [plane_head] * len(planes), fancy)


@pytest.mark.parametrize("w", [15, 17, 45, 500, 3840, 3848])
def test_colour_vector_pct_is_the_models_share(w):
    """The launch's closed-form colour_vector_pct equals the share of runs
    the CPU model takes by the vector loads, at output heads 0, 4, 5 and
    12, aligned and misaligned planes, on 4:2:0 fancy (the loader's),
    gray (its plane read at the image width under REFERENCE) and 4:1:1
    fancy (the chroma has no vector form: no run is all vector)."""
    h = 3
    for name in ("420_fancy", "gray", "411_fancy"):
        factors, upsample, exact, raw = RUN_CASES[name]
        planes = [torch.from_numpy(p) for p in _pixel_planes(h, w, factors, w)]
        for plane_head in (0, 4):
            want = _launch_share(planes, h, w, factors, upsample, Quirks.REFERENCE, plane_head)
            for out_head in (0, 4, 5, 12):
                paths = collections.Counter()
                tcolor._planes_to_rgb_runs_plain(
                    planes, h, w, factors, Quirks.REFERENCE, upsample, exact, raw,
                    out_head=out_head, plane_heads=[plane_head] * len(factors), paths=paths)
                assert want == pytest.approx(100.0 * paths["vector"] / sum(paths.values()))
    # the loader's launch (500 x 375): all 32 runs of a row
    loader = [torch.zeros(s, dtype=torch.uint8) for s in ((384, 512), (192, 256), (192, 256))]
    assert _launch_share(loader, 375, 500, RUN_CASES["420_fancy"][0], "fancy",
                         Quirks.REFERENCE, 0) == 100.0


@pytest.mark.parametrize("upsample", ["nn", "fancy"])
@pytest.mark.parametrize("factors", [((2, 2), (1, 1), (1, 1)), ((1, 1), (2, 4), (1, 1)), F4],
                         ids=["420", "2x4", "444_four"])
def test_run_schedule_under_the_stripe_rule(factors, upsample):
    """With `stripes` (striped and streamed decode: the launch's first row
    of the padded frame and the stripe height), the model follows the
    plain version's stripe rule: a whole padded frame in stripes of one
    MCU row, and a chunk that starts two stripes down."""
    mh = max(f[0] for f in factors)
    mv = max(f[1] for f in factors)
    h, w = 8 * mv * 6, 8 * mh * 5 + 16
    planes = [torch.from_numpy(p) for p in _saturated(h, w, factors, 11, 1)[0]]
    for stripes in (tcolor.Stripes(0, 8 * mv), tcolor.Stripes(16 * mv, 16 * mv)):
        chunk = [p[stripes.row0 * f[1] // mv:].contiguous() for p, f in zip(planes, factors)]
        hh = h - stripes.row0
        want = tcolor._planes_to_rgb_plain(chunk, hh, w, factors, Quirks.REFERENCE, upsample,
                                           stripes=stripes)
        got = tcolor._planes_to_rgb_runs_plain(chunk, hh, w, factors, Quirks.REFERENCE,
                                               upsample, stripes=stripes)
        assert torch.equal(got, want)


def test_run_phase_aligns_every_row():
    """Whatever a row's head (its first RGB byte's address modulo 16), the
    kernel's stores (_store_runs) put every byte of the row once, each
    16-byte store on a 16-byte boundary, and store byte by byte only the
    ends of each CTA's row segment of 256 pixels: the lead bytes before its
    first chunk and what lies past its last one, at most 16 bytes a
    segment and 15 more at the row's end."""
    w = 600  # three segments, the last cut by the row's end
    row = np.random.default_rng(3).integers(0, 256, (1, 1, 608, 3), dtype=np.uint8)
    for head in range(16):
        stores = collections.Counter()
        got = tcolor._store_runs(row, w, head, stores)
        np.testing.assert_array_equal(got, row[0, 0, :w].reshape(-1))
        assert set(stores) <= {1, 16} and 16 * stores[16] + stores[1] == 3 * w
        assert stores[1] <= (16 * 3 + 15 if head else 3 * (w % 16))
