"""The port's encode device stage (jpeg_decoder_tpu_torch/ops/fdct.py) on the
CPU against the JAX package's (jpeg_decoder_tpu/ops/fdct.py and
models/encoder._build_device_stage), each JAX function jitted on the CPU as
the JAX package's own tests run it. Every comparison is bitwise:

  * rgb_to_ycbcr on all 16,777,216 RGB triples, as one 4096x4096 image;
  * box_subsample on random float32 planes, for every box the samplings use,
    in both orders XLA:CPU sums a 2x2 box in;
  * fdct_quantize at q = 1, 10, 50, 85 and 100, luma and chroma tables, on
    100,000 integer-valued and 100,000 float-valued blocks in all; and
    chains summed in another order differ from JAX on the same blocks, so
    the comparison has teeth;
  * the whole stage (encode_planes) for the 7 samplings, gray as a 2-D
    image and as RGB, at odd sizes.

The port's plain versions are what its kernel K4 is held against on the card
(tests/test_torch_cuda.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jpeg_decoder_tpu.models import encoder as jenc
from jpeg_decoder_tpu.ops import fdct as jfdct
from jpeg_decoder_tpu_torch.models import encoder as tenc
from jpeg_decoder_tpu_torch.ops import fdct as tfdct

QUALITIES = [1, 10, 50, 85, 100]
#: blocks per (quality, table, kind) case: 5 x 2 cases of each kind make
#: 100,000 integer-valued and 100,000 float-valued blocks
BLOCKS = 10_000


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain FDCT is 64 x 17 small tensor operations a chain: run them
    on one thread, so that they do not wait on threads that other test
    processes on the same cores hold (several times slower under
    pytest-xdist otherwise)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def test_tables_match_jax():
    np.testing.assert_array_equal(tfdct.dct8_matrix(), jfdct.dct8_matrix())
    np.testing.assert_array_equal(_bits(tfdct.fdct_matrix_zz()), _bits(jfdct.fdct_matrix_zz()))
    for q in QUALITIES:
        for got, want in zip(tenc.quality_qtables(q), jenc.quality_qtables(q), strict=True):
            np.testing.assert_array_equal(got, want)


def test_rgb_to_ycbcr_matches_jax_on_every_triple():
    v = np.arange(1 << 24, dtype=np.uint32)
    rgb = np.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255], -1).astype(np.uint8)
    rgb = rgb.reshape(4096, 4096, 3)
    want = jax.jit(jfdct.rgb_to_ycbcr)(jnp.asarray(rgb))
    got = tfdct.rgb_to_ycbcr(torch.from_numpy(rgb))
    for name, g, w in zip("Y Cb Cr".split(), got, want, strict=True):
        assert np.array_equal(_bits(g.numpy()), _bits(w)), name


@pytest.mark.parametrize("fh,fv,width", [(2, 2, 160), (2, 2, 128), (2, 1, 160), (1, 2, 160),
                                         (4, 1, 160), (1, 1, 160)])
def test_box_subsample_matches_jax(fh, fv, width):
    """At these widths the jitted JAX function sums a 2x2 box as the stage
    does: in one raster chain 80 samples out, by rows 64 out (XLA:CPU picks
    the order by the shape; box_by_rows). The other order differs."""
    rng = np.random.default_rng(fh * 10 + fv + width)
    plane = (rng.random((96, width)) * 255).astype(np.float32)
    plane[:8] = rng.integers(0, 256, (8, width))  # integer-valued rows too
    want = jax.jit(lambda x: jfdct.box_subsample(x, fh, fv))(jnp.asarray(plane))
    got = tfdct.box_subsample(torch.from_numpy(plane), fh, fv)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    if (fh, fv) == (2, 2):
        assert tfdct.box_by_rows(fh, fv, width // fh) == (width == 128)
        other = tfdct.box_subsample(torch.from_numpy(plane), fh, fv,
                                    not tfdct.box_by_rows(fh, fv, width // fh))
        assert (_bits(other.numpy()) != _bits(want)).sum() > 0


def test_pad_edge_and_plane_to_blocks_match_jax():
    rng = np.random.default_rng(3)
    plane = (rng.random((13, 21)) * 255).astype(np.float32)
    want = jax.jit(lambda x: jfdct.pad_edge(x, 24, 32))(jnp.asarray(plane))
    got = tfdct.pad_edge(torch.from_numpy(plane), 24, 32)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    want_b = jax.jit(lambda x: jfdct.plane_to_blocks(x, 3, 4))(want)
    np.testing.assert_array_equal(_bits(tfdct.plane_to_blocks(got, 3, 4).numpy()),
                                  _bits(want_b))


def _blocks(kind: str, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "int":
        return rng.integers(0, 256, (BLOCKS, 64)).astype(np.float32)
    return (rng.random((BLOCKS, 64)) * 255).astype(np.float32)


@pytest.mark.parametrize("kind", ["int", "float"])
@pytest.mark.parametrize("table", [0, 1], ids=["luma", "chroma"])
@pytest.mark.parametrize("quality", QUALITIES)
def test_fdct_quantize_matches_jax(quality, table, kind):
    qt = jenc.quality_qtables(quality)[table]
    blocks = _blocks(kind, quality * 4 + table * 2 + (kind == "int"))
    want = jax.jit(lambda x: jfdct.fdct_quantize(x, qt))(jnp.asarray(blocks))
    got = tfdct.fdct_quantize(torch.from_numpy(blocks), qt)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _chain(x: torch.Tensor, kq: torch.Tensor, order, fused: bool) -> np.ndarray:
    """The FDCT with the chain summed in `order`, fused or as float32
    products and sums: what the test holds the pinned order against."""
    acc = torch.zeros((x.shape[0], 64), dtype=torch.float32)
    for i in order:
        if fused:
            acc = tfdct._fma32(x[:, i : i + 1], kq[i], acc)
        else:
            acc = acc + x[:, i : i + 1] * kq[i]
    return (torch.sign(acc) * torch.floor(acc.abs() + 0.5)).to(torch.int32).numpy()


def test_fdct_check_has_teeth():
    """On the same float-valued blocks the forward fused chain gives JAX's
    coefficients, and a reversed chain or a chain of separate float32
    products and sums does not."""
    qt = jenc.quality_qtables(100)[0]  # all ones: a flip shows most often
    blocks = np.concatenate([_blocks("float", 7), _blocks("float", 8)])
    want = np.asarray(jax.jit(lambda x: jfdct.fdct_quantize(x, qt))(jnp.asarray(blocks)))
    x = torch.from_numpy(blocks) - 128.0
    kq = torch.from_numpy(tfdct.fdct_table(qt))
    np.testing.assert_array_equal(_chain(x, kq, range(64), True), want)
    assert (_chain(x, kq, range(63, -1, -1), True) != want).sum() > 0
    assert (_chain(x, kq, range(64), False) != want).sum() > 0


def test_fma32_rounds_once():
    """a * b + c where a float64 sum cast to float32 rounds twice: with
    a = 1 + 2^-12, b = 2^-24 (1 - 2^-12 + 2^-24) and c = 1, the exact sum is
    1 + 2^-24 + 2^-60, just above a float32 midpoint. Float64 rounds it to
    the midpoint, which then rounds to even, 1; one rounding gives
    1 + 2^-23."""
    a = torch.tensor([1.0 + 2.0 ** -12], dtype=torch.float32)
    b = torch.tensor([2.0 ** -24 * (1.0 - 2.0 ** -12 + 2.0 ** -24)], dtype=torch.float32)
    c = torch.ones(1, dtype=torch.float32)
    assert (a.double() * b.double() + c.double()).float().item() == 1.0
    assert tfdct._fma32(a, b, c).item() == 1.0 + 2.0 ** -23
    assert tfdct._fma32(-a, b, -c).item() == -(1.0 + 2.0 ** -23)


#: the device stage's cases: subsampling (or "gray2d"), and the sizes
STAGE_SAMPLINGS = ["444", "422", "420", "411", "440", "mixed", "gray", "gray2d"]
#: (20, 140): 4:2:0 chroma 72 samples wide, a 2x2 box summed in one chain
STAGE_SIZES = [(33, 47), (41, 57), (48, 48), (20, 140)]


def _image(h, w, seed, gray2d):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    img[: h // 2] = np.clip(img[: h // 2] // 8 + np.arange(w)[None, :, None] * 3, 0, 255)
    return img[..., 0].copy() if gray2d else img


@pytest.mark.parametrize("size", STAGE_SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("sampling", STAGE_SAMPLINGS)
def test_device_stage_matches_jax(sampling, size):
    gray2d = sampling == "gray2d"
    sub = "gray" if gray2d else sampling
    img = _image(*size, seed=size[0] + len(sampling), gray2d=gray2d)
    qts = jenc.quality_qtables(75)
    qt_bytes = (qts[0].tobytes(), qts[1].tobytes())
    gray = sub == "gray"
    stage, factors, _ = jenc._build_device_stage(*size, sub, qt_bytes, gray)
    want = [np.asarray(c) for c in stage(jnp.asarray(img))]
    kq = tfdct.fdct_tables(qts[: 1 if gray else 2], "cpu")
    tfdct.PLAIN_CALLS.clear()
    got = tfdct.encode_planes(torch.from_numpy(img), factors, kq)
    assert tfdct.PLAIN_CALLS["encode_planes"] == 1
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.int16
        np.testing.assert_array_equal(g.numpy(), w)
    # the planes are views of one flat buffer, component after component
    assert got[0].untyped_storage().data_ptr() == got[-1].untyped_storage().data_ptr()


def test_encode_planes_writes_into_out_and_checks_it():
    img = torch.from_numpy(_image(16, 24, 1, False))
    factors = tenc._SAMPLING["420"]
    kq = tfdct.fdct_tables(tenc.quality_qtables(50), "cpu")
    _, _, comps = tfdct.plane_layout(16, 24, factors)
    n = sum(by * bx * 64 for by, bx, _, _ in comps)
    out = torch.full((n,), 7, dtype=torch.int16)
    planes = tfdct.encode_planes(img, factors, kq, out)
    assert torch.equal(torch.cat([p.reshape(-1) for p in planes]), out)
    with pytest.raises(ValueError, match="out must be"):
        tfdct.encode_planes(img, factors, kq, torch.empty(n + 1, dtype=torch.int16))


def test_plane_layout_matches_jax_geometry():
    for sub, factors in tenc._SAMPLING.items():
        for h, w in STAGE_SIZES:
            mx, my, comps = tfdct.plane_layout(h, w, factors)
            _, jf, (jx, jy) = jenc._build_device_stage(h, w, sub, (b"\x01" * 128,) * 2, False)
            assert (mx, my) == (jx, jy) and tuple(factors) == tuple(jf)
            for (by, bx, box_h, box_v), (fh, fv) in zip(comps, factors):
                assert (by, bx) == (my * fv, mx * fh)
                assert (box_h * fh, box_v * fv) == (max(f[0] for f in factors),
                                                    max(f[1] for f in factors))
