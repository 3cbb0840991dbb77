"""The port's colour stage (jpeg_decoder_tpu_torch/ops/color.py) against the
JAX package: bitwise, on the same numpy inputs."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from jpeg_decoder_tpu.ops import color as jcolor
from jpeg_decoder_tpu.utils.config import Quirks
from jpeg_decoder_tpu_torch.ops import color as tcolor


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
    want = jcolor.ycbcr_to_rgb(*(jnp.asarray(c) for c in (y, cb, cr)), True, quirks)
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


def _jax_stage_rgb(planes, h, w, factors, quirks):
    """build_stage_raw's colour half (models/decoder.py:115-144)."""
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
    chans = [jcolor.nn_upsample(jnp.asarray(p), h, w, fh, fv, mh, mv)
             for p, (fh, fv) in zip(planes, factors)]
    return np.asarray(jcolor.ycbcr_to_rgb(*chans, True, quirks))


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

