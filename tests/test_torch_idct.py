"""The port's IDCT (jpeg_decoder_tpu_torch/ops/idct.py) against the JAX
package, on the same numpy inputs.

EXACT: bitwise (tolerance 0, EXACT is a bit-exact contract), 8- and 12-bit,
including extreme coefficients and quantization tables up to 255.
FLOAT32: the JAX contract, +-1 LSB (utils/config.py IdctPrecision). The
port's plain K1 (x @ K after a float32 dequant, as idct_pallas) and the
JAX package's idct_matmul (x @ diag(qt)K) and idct_pallas sum in other
orders, so a floor can flip: at most 1e-3 of the pixels may differ, by 1.

The EXACT kernels' two exact rewrites of the chain (csrc/idct_exact.cuh:
the halvings in float32, the output store in integers) are held here
against the float64 forms they replace, bitwise, on their edge cases.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from jpeg_decoder_tpu.core import numerics
from jpeg_decoder_tpu.core import types as jtypes
from jpeg_decoder_tpu.core.types import standard_luminance_qtable
from jpeg_decoder_tpu.ops import idct as jidct
from jpeg_decoder_tpu.ops import pallas_kernels
from jpeg_decoder_tpu_torch.core.types import INV_ZIGZAG, ZIGZAG
from jpeg_decoder_tpu_torch.ops import idct as tidct
from jpeg_decoder_tpu_torch.utils.config import IdctPrecision

CSRC = Path(tidct.__file__).resolve().parent.parent / "csrc"
#: FLOAT32 tolerance: |diff| <= 1 on at most this share of the pixels
FLOAT32_SHARE = 1e-3



def _inputs(seed: int, n: int = 512):
    """[n, 64] int16 zigzag coefficients and a natural-order table: a mix
    of typical values, full-range extremes and all-zero blocks."""
    rng = np.random.default_rng(seed)
    coeffs = np.clip(np.rint(rng.laplace(0, 30, (n, 64))), -2048, 2047)
    coeffs[: n // 4] = rng.integers(-32768, 32768, (n // 4, 64))
    coeffs[n // 4 : n // 4 + 8] = 0
    coeffs[n // 4 + 8] = 32767
    coeffs[n // 4 + 9] = -32768
    qt = rng.integers(1, 256, 64).astype(np.uint16)
    qt[:4] = (1, 255, 255, 1)
    return coeffs.astype(np.int16), qt


def _numerics_reference(coeffs, qt, bits12):
    deq = numerics.dequantize(coeffs.astype(np.int32), qt)
    pix = numerics.idct_2d_exact(deq.reshape(-1, 8, 8), bits12=bits12)
    if bits12:
        pix = numerics.rescale_12bit(pix)
    return pix.reshape(-1, 64)


@pytest.mark.parametrize("bits12", [False, True], ids=["8bit", "12bit"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_idct_exact_matches_jax_and_numerics(seed, bits12):
    coeffs, qt = _inputs(seed)
    got = tidct.idct_exact(torch.from_numpy(coeffs), qt, bits12).numpy()
    jax_out = np.asarray(
        jidct.idct_exact(jnp.asarray(coeffs.astype(np.int32)), qt, bits12))
    np.testing.assert_array_equal(got, jax_out)
    np.testing.assert_array_equal(got, _numerics_reference(coeffs, qt, bits12))


def test_dequantize_blocks_matches_jax():
    coeffs, qt = _inputs(3)
    got = tidct.dequantize_blocks(torch.from_numpy(coeffs), qt).numpy()
    want = np.asarray(
        jidct.dequantize_blocks(jnp.asarray(coeffs.astype(np.int32)), qt))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("by,bx", [(1, 1), (3, 5), (6, 2)])
def test_blocks_to_plane_matches_jax(by, bx):
    rng = np.random.default_rng(by * 10 + bx)
    pix = rng.integers(0, 256, (by * bx, 64), dtype=np.uint8)
    got = tidct.blocks_to_plane(torch.from_numpy(pix), by, bx).numpy()
    want = np.asarray(jidct.blocks_to_plane(jnp.asarray(pix), by, bx))
    np.testing.assert_array_equal(got, want)


def test_idct_plane_on_cpu_is_the_plain_version():
    coeffs, qt = _inputs(4, n=6 * 4)
    plane = torch.from_numpy(coeffs.reshape(6, 4, 64))
    got = tidct.idct_plane(plane, torch.from_numpy(qt.astype(np.int32)))
    want = tidct.blocks_to_plane(tidct.idct_exact(plane.reshape(-1, 64), qt), 6, 4)
    assert got.shape == (48, 32) and got.dtype == torch.uint8
    assert torch.equal(got, want)


def _random_blocks(seed, n, lo=-1024, hi=1024):
    """tests/test_device_ops.py _random_blocks: uniform coefficients with a
    random zero suffix per block."""
    rng = np.random.default_rng(seed)
    blocks = rng.integers(lo, hi, (n, 64)).astype(np.int32)
    cut = rng.integers(1, 64, n)
    return np.where(np.arange(64)[None, :] < cut[:, None], blocks, 0).astype(np.int16)


def _assert_float32_close(got, want):
    d = np.abs(got.astype(np.int32) - np.asarray(want).astype(np.int32))
    assert d.max() <= 1
    assert (d != 0).mean() <= FLOAT32_SHARE


def test_idct_matrix_zz_matches_jax():
    np.testing.assert_array_equal(tidct.idct_matrix_zz(), jidct.idct_matrix_zz())


def test_idct_float_matches_idct_pallas_interpret():
    """The plain K1 against the TPU kernel itself, in interpret mode, on an
    odd block count (test_device_ops.py TestPallasIdct)."""
    qt = standard_luminance_qtable()
    blocks = _random_blocks(1, 1111)
    want = pallas_kernels.idct_pallas(jnp.asarray(blocks.astype(np.int32)), qt,
                                      interpret=True)
    got = tidct.idct_float(torch.from_numpy(blocks), qt).numpy()
    _assert_float32_close(got, want)


@pytest.mark.parametrize("bits12", [False, True], ids=["8bit", "12bit"])
@pytest.mark.parametrize("seed", [0, 1])
def test_idct_float_matches_idct_matmul(seed, bits12):
    coeffs, qt = _inputs(seed)
    if not bits12:  # 8-bit streams carry coefficients of at most 11 bits
        coeffs = np.clip(coeffs, -2048, 2047)
    got = tidct.idct_float(torch.from_numpy(coeffs), qt, bits12).numpy()
    want = jidct.idct_matmul(jnp.asarray(coeffs.astype(np.int32)), qt, bits12)
    _assert_float32_close(got, want)


@pytest.mark.parametrize("bits12", [False, True], ids=["8bit", "12bit"])
def test_idct_float_within_1_of_exact(bits12):
    qt = standard_luminance_qtable()
    blocks = torch.from_numpy(_random_blocks(2, 2048))
    got = tidct.idct_float(blocks, qt, bits12).numpy()
    _assert_float32_close(got, tidct.idct_exact(blocks, qt, bits12).numpy())


def test_idct_float_pins_true_float32_and_restores():
    """The product runs with TF32 off and float32 precision "highest"; the
    caller's settings come back afterwards."""
    seen = []
    orig = tidct.idct_matrix_on

    def spy(device):  # called inside the pinned block, for the product
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.get_float32_matmul_precision()))
        return orig(device)

    torch.backends.cuda.matmul.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    tidct.idct_matrix_on = spy
    try:
        tidct.idct_float(torch.from_numpy(_random_blocks(3, 4)),
                         standard_luminance_qtable())
        after = (torch.backends.cuda.matmul.allow_tf32,
                 torch.get_float32_matmul_precision())
    finally:
        tidct.idct_matrix_on = orig
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
    assert seen == [(False, "highest")]
    assert after == (True, "high")


@pytest.mark.parametrize("precision", list(IdctPrecision), ids=lambda p: p.value)
def test_idct_plane_batch_rows_match_single_planes(precision):
    """Stacked [B, by, bx, 64] planes give each image's plane unchanged."""
    coeffs, qt = _inputs(5, n=3 * 4 * 5)
    stack = torch.from_numpy(np.clip(coeffs, -2048, 2047).reshape(3, 4, 5, 64))
    qt_t = torch.from_numpy(qt.astype(np.int32))
    got = tidct.idct_plane(stack, qt_t, False, precision)
    assert got.shape == (3, 32, 40) and got.dtype == torch.uint8
    for i in range(3):
        assert torch.equal(got[i], tidct.idct_plane(stack[i], qt_t, False, precision))


def _cuda_table(name: str, var: str) -> list[int]:
    body = re.search(var + r"\[64\] = \{([^}]*)\}", (CSRC / name).read_text()).group(1)
    return [int(x) for x in body.replace("\n", " ").split(",")]


def test_kernel_zigzag_tables_match_core():
    """The zigzag tables the CUDA kernels carry are the port's core/types'
    own, which are the JAX package's."""
    np.testing.assert_array_equal(ZIGZAG, jtypes.ZIGZAG)
    np.testing.assert_array_equal(INV_ZIGZAG, jtypes.INV_ZIGZAG)
    # K1's and K13's, in the header they share
    assert _cuda_table("idct_float.cuh", "kZigzag") == [int(x) for x in ZIGZAG]
    # K0's and K03's, in the header they share
    assert _cuda_table("idct_exact.cuh", "kInvZigzag") == [int(x) for x in INV_ZIGZAG]
    # K5's bands: the zigzag positions of the k x k lowest frequencies
    for k in (2, 4):
        body = re.search(rf"kBand{k}\[{k * k}\] = \{{([^}}]*)\}}",
                         (CSRC / "idct_scaled.cu").read_text()).group(1)
        band = [z for z in range(64) if ZIGZAG[z] // 8 < k and ZIGZAG[z] % 8 < k]
        assert [int(x) for x in body.split(",")] == band
        assert np.flatnonzero(tidct.idct_matrix_zz_scaled(k).any(axis=1)).tolist() == band


# ---------------------------------------------------------------------------
# Scaled decode (scale k in {1, 2, 4}): the plain K5
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_idct_matrix_zz_scaled_matches_jax(k):
    np.testing.assert_array_equal(tidct.idct_matrix_zz_scaled(k),
                                  jidct.idct_matrix_zz_scaled(k))


@pytest.mark.parametrize("bits12", [False, True], ids=["8bit", "12bit"])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_idct_matmul_scaled_matches_jax(k, bits12):
    """The plain K5 against idct_matmul_scaled: within 1 on at most 1e-3 of
    the pixels (both fold the table into M_k; the products sum in other
    orders), bitwise at k = 1, where the sum has one term. 12-bit samples
    are compared modulo 256 (the rescale's low byte)."""
    coeffs, qt = _inputs(20 + k)
    if not bits12:
        coeffs = np.clip(coeffs, -2048, 2047)
    got = tidct.idct_matmul_scaled(torch.from_numpy(coeffs), qt, k, bits12).numpy()
    want = np.asarray(jidct.idct_matmul_scaled(jnp.asarray(coeffs.astype(np.int32)), qt, k,
                                               bits12))
    assert got.shape == want.shape == (coeffs.shape[0], k * k)
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    d = np.minimum(d, 256 - d)
    if k == 1:
        assert d.max() == 0
    assert d.max() <= 1
    assert (d != 0).mean() <= FLOAT32_SHARE


@pytest.mark.parametrize("k", [1, 2, 4])
def test_blocks_to_plane_tile_matches_jax(k):
    rng = np.random.default_rng(k)
    pix = rng.integers(0, 256, (3 * 5, k * k), dtype=np.uint8)
    got = tidct.blocks_to_plane(torch.from_numpy(pix), 3, 5, k).numpy()
    np.testing.assert_array_equal(got, np.asarray(jidct.blocks_to_plane(jnp.asarray(pix), 3, 5,
                                                                        k)))


@pytest.mark.parametrize("precision", list(IdctPrecision), ids=lambda p: p.value)
@pytest.mark.parametrize("k", [1, 2, 4])
def test_idct_plane_scaled_is_the_plain_version_under_either_contract(k, precision):
    """idct_plane at scale < 8 runs idct_matmul_scaled, whatever the
    contract (the JAX package's scaled decode ignores EXACT), and stacked
    planes give each image's plane."""
    coeffs, qt = _inputs(6, n=3 * 4 * 5)
    stack = torch.from_numpy(np.clip(coeffs, -2048, 2047).reshape(3, 4, 5, 64))
    qt_t = torch.from_numpy(qt.astype(np.int32))
    got = tidct.idct_plane(stack, qt_t, False, precision, k)
    assert got.shape == (3, 4 * k, 5 * k)
    for i in range(3):
        want = tidct.blocks_to_plane(
            tidct.idct_matmul_scaled(stack[i].reshape(-1, 64), qt, k), 4, 5, k)
        assert torch.equal(got[i], want)


# ---------------------------------------------------------------------------
# K5's one-launch schedule (csrc/idct_scaled.cu idct_scaled_kernel)
# ---------------------------------------------------------------------------

#: name -> (the leading shape, each component's (by, bx), its table's index
#: of three): one plane over several blocks of threads, 4:2:0 (the luma
#: plane 3 blocks of threads, chroma one, ragged), four planes on two
#: tables, a batch of three images, and a component of one block
K5_CASES = {
    "gray": ((), [(23, 31)], [0]),
    "420": ((), [(20, 30), (10, 15), (10, 15)], [0, 1, 1]),
    "four_planes": ((), [(9, 40), (9, 40), (9, 40), (9, 40)], [0, 1, 1, 0]),
    "batch_420": ((3,), [(8, 12), (4, 6), (4, 6)], [0, 1, 1]),
    "one_block": ((), [(1, 1), (16, 17), (1, 1)], [2, 0, 1]),
}


def _k5_case(name, bits12):
    lead, dims, table_of = K5_CASES[name]
    rng = np.random.default_rng(len(name) + bits12)
    lo, hi = (-2048, 2048) if bits12 else (-1024, 1024)
    planes = [torch.from_numpy(_random_blocks(rng.integers(1 << 30), int(np.prod(lead)) * by * bx,
                                              lo, hi).reshape(*lead, by, bx, 64))
              for by, bx in dims]
    tables = [rng.integers(1, 256, 64).astype(np.uint16) for _ in range(3)]
    tables[0][:4] = (1, 255, 255, 1)
    return planes, [tables[t] for t in table_of]


@pytest.mark.parametrize("bits12", [False, True], ids=["8bit", "12bit"])
@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("name", sorted(K5_CASES))
def test_k5_walk_model_matches_jax(name, k, bits12):
    """The CPU model of K5's walk (one launch for all components: the
    descriptor, components from block-of-threads boundaries, the fmaf
    chain over the band) takes every block once and stores every pixel
    once (else it raises), and equals the JAX package's
    idct_matmul_scaled + blocks_to_plane per image and component: bitwise
    at k = 1, within 1 on at most 1e-3 of the pixels at k = 2 and 4 (the
    two sum the band in other orders); 12-bit samples modulo 256 (the
    rescale's low byte). The plain K5 (idct_planes_scaled on CPU tensors)
    keeps the same rule against the model."""
    planes, qts = _k5_case(name, bits12)
    got = tidct._idct_scaled_walk_plain(planes, qts, k, bits12)
    plain = tidct.idct_planes_scaled(planes, qts, k, bits12)
    mine, jax_pix, plain_pix = [], [], []
    for g, p, c, q in zip(got, plain, planes, qts):
        *lead, by, bx, _ = c.shape
        assert g.shape == p.shape == (*lead, by * k, bx * k)
        for i, img in enumerate(c.reshape(-1, by, bx, 64)):
            pix = jidct.idct_matmul_scaled(jnp.asarray(img.reshape(-1, 64).numpy().astype(
                np.int32)), q, k, bits12)
            jax_pix.append(np.asarray(jidct.blocks_to_plane(pix, by, bx, k)).ravel())
            mine.append(g.reshape(-1, by * k, bx * k)[i].numpy().ravel())
            plain_pix.append(p.reshape(-1, by * k, bx * k)[i].numpy().ravel())
    # the rule over the call's pixels, as chip_smoke.py's K1_SHARE
    mine = np.concatenate(mine).astype(np.int32)
    for other in (np.concatenate(jax_pix), np.concatenate(plain_pix)):
        d = np.abs(mine - other.astype(np.int32))
        d = np.minimum(d, 256 - d)
        assert d.max() <= (0 if k == 1 else 1)
        assert (d != 0).mean() <= FLOAT32_SHARE


def test_k5_walk_model_checks_its_walk(monkeypatch):
    """A layout whose second component starts on the first one's blocks of
    threads leaves blocks of the first untaken, and is refused."""
    planes, qts = _k5_case("420", False)
    layout = tidct.scaled_layout

    def overlapping(*args):
        desc, folded = layout(*args)
        desc[1, 3] = 0
        return desc, folded

    monkeypatch.setattr(tidct, "scaled_layout", overlapping)
    with pytest.raises(RuntimeError, match="other than once"):
        tidct._idct_scaled_walk_plain(planes, qts, 2)


def test_k5_constants_match_the_kernel():
    """The walk's block of threads and most components (ops/idct.py) are the
    kernel's (csrc/idct_scaled.cu kThreads, kMaxComps)."""
    src = (CSRC / "idct_scaled.cu").read_text()
    assert int(re.search(r"constexpr int kThreads = (\d+);", src).group(1)) == tidct.K5_THREADS
    assert int(re.search(r"constexpr int kMaxComps = (\d+);", src).group(1)) == \
        tidct.K5_MAX_COMPS


@pytest.mark.parametrize("name", sorted(K5_CASES))
def test_scaled_layout_starts_each_component_on_a_block_of_threads(name):
    """Rows are the leading dimensions times by; the first block of threads
    of each component follows the last one's, rounded up to K5_THREADS
    blocks; equal tables share one folded band, in order of first use."""
    planes, qts = _k5_case(name, False)
    desc, folded = tidct.scaled_layout(planes, qts, 4)
    lead, dims, table_of = K5_CASES[name]
    cta = 0
    for (rows, bx, t, first), (by, bxx), p in zip(desc, dims, planes):
        assert (rows, bx, first) == (int(np.prod(lead)) * by, bxx, cta)
        cta += -(-rows * bx // tidct.K5_THREADS)
    assert len(folded) == len(set(table_of))
    for (_, _, t, _), q in zip(desc, qts):
        np.testing.assert_array_equal(folded[t], tidct.folded_band(
            np.asarray(q, np.int32).tobytes(), 4))


@pytest.mark.parametrize("k", [1, 2, 4])
def test_folded_band_is_the_torch_fold(k):
    """The host's float32 fold (K5's parameters) is bitwise the torch fold of
    the plain version, idct_matrix_scaled_on(dev, k) * qt_zz[:, None], on
    its band rows, for random tables and the extremes 1, 255 and 65535."""
    rng = np.random.default_rng(40 + k)
    for qt in (rng.integers(1, 256, 64), rng.integers(1, 65536, 64), np.full(64, 255),
               np.ones(64)):
        qt = qt.astype(np.int32)
        got = tidct.folded_band(qt.tobytes(), k).reshape(k * k, k * k)
        qt_zz = torch.from_numpy(qt)[torch.as_tensor(ZIGZAG, dtype=torch.long)].to(torch.float32)
        fold = tidct.idct_matrix_scaled_on(torch.device("cpu"), k) * qt_zz[:, None]
        np.testing.assert_array_equal(got.view(np.uint32),
                                      fold[list(tidct.band_z(k))].numpy().view(np.uint32))


# ---------------------------------------------------------------------------
# K0's and K03's exact rewrites (csrc/idct_exact.cuh half, store)
# ---------------------------------------------------------------------------


def _float32_patterns(n, seed):
    """n random float32 bit patterns (every class: subnormals included), the
    zeros, the smallest subnormals and normals and the largest finite
    values, NaNs dropped."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    special = np.array([0x00000000, 0x80000000, 0x00000001, 0x80000001, 0x007FFFFF,
                        0x807FFFFF, 0x00800000, 0x80800000, 0x00800001, 0x7F7FFFFF,
                        0xFF7FFFFF, 0x7F800000, 0xFF800000, 0x3F800000, 0x3F800001],
                       dtype=np.uint32)
    x = np.concatenate([bits, special]).view(np.float32)
    return x[~np.isnan(x)]


def test_halving_in_float32_is_exact():
    """The twelve halvings of each pass: float32(0.5 * float64(x)) ==
    float32(0.5) * x, bitwise, for 4 M float32 patterns, subnormals (whose
    halves round), both zeros and the largest finite values included."""
    x = _float32_patterns(4_000_000, 11)
    with np.errstate(all="ignore"):
        model = (0.5 * x.astype(np.float64)).astype(np.float32)
        fast = np.float32(0.5) * x
    np.testing.assert_array_equal(model.view(np.uint32), fast.view(np.uint32))
    assert (x.view(np.uint32) & 0x7F800000 == 0).sum() > 1000  # subnormals were drawn


def _store_f64(x, bits12):
    """csrc/idct_exact.cuh store_f64, the earlier form, in NumPy float64:
    0.25 x + the level shift rounded once, clamped, truncated; 12-bit: the
    int16 wrap and trunc(v / 4096 * 255)."""
    d = 0.25 * x.astype(np.float64) + (2048.0 if bits12 else 128.0)
    d = np.where(np.isnan(d), 0.0, np.clip(d, 0.0, 65535.0 if bits12 else 255.0))
    v = np.trunc(d).astype(np.int64)
    if not bits12:
        return v.astype(np.uint8)
    v16 = ((v & 0xFFFF) ^ 0x8000) - 0x8000
    return (np.trunc(v16 / 4096.0 * 255.0).astype(np.int64) & 0xFF).astype(np.uint8)


def _store_edges(bits12):
    """The store's edge cases: the tiny negatives on both sides of the
    bound where float64 rounds the sum up to the level shift (2^-45, 2^-41
    for 12-bit) and of the half of it, subnormals, the zeros, every quarter
    step around the integers the clamps and the level shift meet, the int16
    wrap of 12-bit, and the largest values."""
    tiny = 2.0 ** (-41 if bits12 else -45)
    near = [np.nextafter(np.float32(v), np.float32(t)) for v in (-tiny, -tiny / 2, -tiny * 2)
            for t in (-1.0, 1.0)]
    shift = 2048.0 if bits12 else 128.0
    top = 65535.0 if bits12 else 255.0
    steps = np.concatenate([np.arange(-4 * shift - 16, -4 * shift + 16, 0.25),
                            np.arange(-16, 16, 0.25),
                            np.arange(4 * (top - shift) - 16, 4 * (top - shift) + 16, 0.25),
                            np.arange(4 * (32767 - shift) - 16, 4 * (32767 - shift) + 16, 0.25)])
    lsb = [np.nextafter(np.float32(s), np.float32(t)) for s in steps[::3] for t in (-1e9, 1e9)]
    x = np.concatenate([np.array([-tiny, -tiny / 2, -tiny * 2, tiny, -1e-30, -1e-38, -1e-44,
                                  0.0, -0.0, 3.4e38, -3.4e38, 1e-45, -1e-45]),
                        np.array(near, dtype=np.float64), steps,
                        np.array(lsb, dtype=np.float64)]).astype(np.float32)
    return np.concatenate([x, _float32_patterns(1_000_000, 13 + bits12)])


@pytest.mark.parametrize("bits12", [False, True], ids=["8bit", "12bit"])
def test_integer_store_is_the_float64_store(bits12):
    """The integer store (store_integer, the kernels' `store`) bitwise the
    float64 form on its edge cases and a million random float32 patterns;
    and on the normal range, where 0.25 x is exact in float32, the plain
    version's _quantize_output."""
    x = _store_edges(bits12)
    with np.errstate(all="ignore"):
        np.testing.assert_array_equal(tidct.store_integer(x, bits12), _store_f64(x, bits12))
    normal = x[np.isfinite(x) & ((np.abs(x) >= 2.0 ** -100) | (x == 0))]
    plain = tidct._quantize_output(0.25 * torch.from_numpy(normal), bits12).numpy()
    np.testing.assert_array_equal(tidct.store_integer(normal, bits12), plain)


@pytest.mark.parametrize("bits12", [False, True], ids=["8bit", "12bit"])
def test_integer_store_needs_its_tiny_negative_case(bits12):
    """Just below zero and above -2^-45 (-2^-41) the float64 sum rounds up
    to the level shift, where floor gives one less: the case the store takes
    apart. Just beyond the bound float64 gives the floor. (In 12-bit the
    rescale sends 2047 and 2048 to the same byte, 127, so there the case
    changes no output; the store keeps it so that its level-shifted value is
    the float64 form's.)"""
    tiny = 2.0 ** (-41 if bits12 else -45)
    x = np.array([-1e-30, -tiny, np.nextafter(np.float32(-tiny), np.float32(-1))],
                 dtype=np.float32)
    shift = 2048 if bits12 else 128
    d = np.trunc(0.25 * x.astype(np.float64) + shift)
    assert d.tolist() == [shift, shift, shift - 1]
    floor = np.floor(0.25 * x.astype(np.float64)) + shift
    assert floor.tolist() == [shift - 1] * 3
    np.testing.assert_array_equal(tidct.store_integer(x, bits12), _store_f64(x, bits12))


def test_floor_quarter_reads_the_floor_off_the_bits():
    """floor_quarter: the float32 1.5 * 2^23 + floor(0.25 y) carries
    floor(0.25 y) in its bits less 0x4B400000, across the clamped range of
    both stores (quarter steps and their float32 neighbours)."""
    y = np.arange(-8200.0, 262144.0, 0.25, dtype=np.float64)
    f = np.floor(0.25 * y)
    t = (f + 12582912.0).astype(np.float32)
    assert np.array_equal(t.astype(np.float64), f + 12582912.0)  # exact in float32
    np.testing.assert_array_equal(t.view(np.int32).astype(np.int64) - 0x4B400000, f)


def test_idct_exact_source_halves_in_float32_and_stores_in_integers():
    """The kernels' header takes the rewrites: the twelve halvings of a pass
    go through `half`, K0 instantiates the design's spelling, and the store
    has no float64 left."""
    src = (CSRC / "idct_exact.cuh").read_text()
    idct8 = src[src.index("static __device__ __forceinline__ void idct8"):]
    idct8 = idct8[:idct8.index("\n}\n")]
    assert idct8.count("half<kHalveInFloat>(") == 12
    assert "mul(0.5," not in idct8
    store = src[src.index("static __device__ __forceinline__ uint8_t store(float x"):]
    store = store[:store.index("\n}\n")]
    assert not any(op in store for op in ("double", "__dmul", "__dadd", "__ddiv", "mul(", "add("))
    assert "constexpr int kArithmetic = 2;" in (CSRC / "idct_exact.cu").read_text()


# ---------------------------------------------------------------------------
# K1's schedule (csrc/idct_float.cu): the CPU model of its tiles and register
# tile, ops/idct._idct_float_tiled_plain
# ---------------------------------------------------------------------------

#: K1's ragged shapes: (block rows..., blocks_x); one block wide, an odd
#: width, 350 blocks (not a multiple of the 64-block tile), a stacked batch
K1_SHAPES = {"bx1": (37, 1), "odd_bx": (19, 33), "ragged_tile": (7, 50),
             "batch": (3, 17, 12)}


@pytest.mark.parametrize("bits12", [False, True], ids=["8bit", "12bit"])
@pytest.mark.parametrize("shape", sorted(K1_SHAPES))
def test_k1_schedule_model_is_the_chain(shape, bits12):
    """Every pixel stored once, bitwise the chain in its order (fmaf, z =
    0..63 from 0, then the store) on the plane's blocks in raster order;
    within 1 on at most 1e-3 of the pixels of the plain K1 and of the JAX
    package's FLOAT32 IDCT (idct_pallas in interpret mode, 8-bit only;
    idct_matmul for 12-bit)."""
    dims = K1_SHAPES[shape]
    rng = np.random.default_rng(sum(dims) + bits12)
    n = int(np.prod(dims))
    coeffs = _random_blocks(sum(dims), n).reshape(*dims, 64)
    qt = rng.integers(1, 256, 64).astype(np.int32)
    qt[:4] = (1, 255, 255, 1)
    plane = torch.from_numpy(coeffs)
    got = tidct._idct_float_tiled_plain(plane, qt, bits12)
    x = plane.reshape(-1, 64).to(torch.float32) * torch.from_numpy(qt[ZIGZAG].astype(np.float32))
    pix = tidct._quantize_output_float(tidct.idct_float_chain(x), bits12)
    rows = n // dims[-1]
    chain = tidct.blocks_to_plane(pix, rows, dims[-1]).reshape(got.shape)
    assert torch.equal(got, chain)
    blocks = got.reshape(rows, 8, dims[-1], 8).permute(0, 2, 1, 3).reshape(-1, 64).numpy()
    _assert_float32_close(blocks, tidct.idct_float(plane.reshape(-1, 64), qt, bits12).numpy())
    flat = jnp.asarray(coeffs.reshape(-1, 64).astype(np.int32))
    want = (jidct.idct_matmul(flat, qt, bits12) if bits12
            else pallas_kernels.idct_pallas(flat, qt, interpret=True))
    _assert_float32_close(blocks, want)


def test_k1_schedule_model_checks_its_stores():
    """A tile mapping that stores a pixel twice (or not at all) is refused."""
    plane = torch.from_numpy(_random_blocks(4, 70).reshape(7, 10, 64))
    qt = standard_luminance_qtable()
    orig = tidct.K1_GROUPS
    tidct.K1_GROUPS = 4  # blocks g + 4 j of a 64-block tile: half are missed
    try:
        with pytest.raises(RuntimeError, match="other than once"):
            tidct._idct_float_tiled_plain(plane, qt)
    finally:
        tidct.K1_GROUPS = orig


def test_idct_float_chain_order_matters():
    """The chain's order has teeth: summed in reverse, some pixels of these
    float-valued blocks differ after the store."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy((rng.random((4096, 64)) * 2000 - 1000).astype(np.float32))
    fwd = tidct._quantize_output_float(tidct.idct_float_chain(x), False)
    from jpeg_decoder_tpu_torch.ops.fdct import _fma32

    k = tidct.idct_matrix_on(torch.device("cpu"))
    acc = torch.zeros((4096, 64), dtype=torch.float32)
    for z in range(63, -1, -1):
        acc = _fma32(x[:, z : z + 1], k[z], acc)
    assert (tidct._quantize_output_float(acc, False) != fwd).sum() > 0
