"""The port's EXACT IDCT (jpeg_decoder_tpu_torch/ops/idct.py) against the
JAX package: bitwise (tolerance 0, EXACT is a bit-exact contract), on the
same numpy inputs, 8- and 12-bit, including extreme coefficients and
quantization tables up to 255."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from jpeg_decoder_tpu.core import numerics
from jpeg_decoder_tpu.ops import idct as jidct
from jpeg_decoder_tpu_torch.ops import idct as tidct



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

