"""The port's entry for a one-card check (counterpart of the JAX package's
`entry()` in the repository's __graft_entry__.py).

entry(device) -> (fn, example_args): the decode's device stage,
models/decoder.PixelStage (dequant + dezigzag + IDCT + chroma upsample +
colour conversion; on the card the kernel K13 under FLOAT32), on the
coefficient planes of a tiny 4:2:0 image that the port's own encoder wrote,
as tensors on `device`. fn(*example_args) is the [32, 32, 3] uint8 RGB.

    python -m jpeg_decoder_tpu_torch.entry [--device cpu]

The JAX module's multi-chip dry run (`dryrun_multichip`) belongs to the
port's mesh and multihost slice (ROADMAP.md item 10) and is not here.
"""

from __future__ import annotations

import argparse

import numpy as np


def _tiny_coeffs(h: int = 32, w: int = 32, quality: int = 85):
    """Encode a deterministic tiny 4:2:0 image with the port's encoder (its
    CPU path) and return (frame, coefficient planes, quant tables, config):
    the JAX entry's image, config and tables."""
    from .io.parser import parse
    from .models import host
    from .models.encoder import encode
    from .utils.config import DecodeConfig, EncodeConfig, EntropyBackend, IdctPrecision

    rng = np.random.default_rng(1234)
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    data = encode(img, EncodeConfig(quality=quality, subsampling="420"), device="cpu")
    cfg = DecodeConfig(entropy_backend=EntropyBackend.NUMPY,
                       idct_precision=IdctPrecision.FLOAT32)
    structure = parse(data, cfg)
    planes, qts = host._entropy_decode(structure, cfg)
    return structure.frame, planes, qts, cfg


def entry(device="cuda"):
    """(fn, example_args) for the one-card check: fn is the pixel stage's
    RGB of the tiny image's coefficient planes, example_args those planes
    on `device` (default the card)."""
    from . import convert
    from .models import decoder

    device = convert.resolve_device(device)
    frame, planes, qts, cfg = _tiny_coeffs()
    stage = decoder.device_stage_for(frame, qts, cfg, device)

    def forward(*coeff_planes):
        rgb, _planes = stage(*coeff_planes, want_planes=False)
        return rgb

    return forward, tuple(convert.planes_to_device(planes, device))


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ns = ap.parse_args()
    fn, args = entry(ns.device)
    out = fn(*args)
    print("entry ok:", tuple(out.shape), out.dtype, out.device)
