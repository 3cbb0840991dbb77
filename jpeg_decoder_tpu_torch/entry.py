"""The port's entry points for a one-card check and a multi-rank dry run
(counterparts of `entry()` and `dryrun_multichip()` in the repository's
__graft_entry__.py).

entry(device) -> (fn, example_args): the decode's device stage,
models/decoder.PixelStage (dequant + dezigzag + IDCT + chroma upsample +
colour conversion; on the card the kernel K13 under FLOAT32), on the
coefficient planes of a tiny 4:2:0 image that the port's own encoder wrote,
as tensors on `device`. fn(*example_args) is the [32, 32, 3] uint8 RGB.

dryrun_multichip(n_devices, device) -> (rgb, coeffs): one DP x SP step on
a mesh of n_devices ranks of the process group in force (one rank without
a group): the batched, striped fancy decode with the halo exchange, then
the re-encode leg's FDCT and quantize.

    python -m jpeg_decoder_tpu_torch.entry [--device cpu]
    torchrun --nproc-per-node 2 -m jpeg_decoder_tpu_torch.entry --dryrun 2
"""

from __future__ import annotations

import argparse
import os

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


def dryrun_multichip(n_devices: int, device="cuda"):
    """One DP x SP step on an n_devices mesh of the process group in force
    (or of this process alone, n_devices 1), tiny shapes: the counterpart
    of __graft_entry__.dryrun_multichip. The stripe axis has 2 ranks where
    n_devices is even, else 1; the data axis the rest. The tiny 4:2:0
    image, (16 x stripes) x 32, FLOAT32, is decoded under fancy upsampling,
    two copies a data rank: rank k of the stripe axis decodes stripe k (K1,
    then K6h with the halo rows its neighbours sent), the stripes gathered.
    Then the re-encode leg: the FDCT and quantize of each decoded image's
    first channel at quality 85 (K4's one-component path, the JAX step's
    fdct_quantize(plane_to_blocks(rgb[..., 0]))). Returns, on every rank,
    the whole batch's (RGB [B, H, W, 3], int32 coefficients [B, blocks, 64]) as
    NumPy arrays, B = 2 x data ranks."""
    import torch

    from . import convert
    from .models.encoder import quality_qtables
    from .ops import fdct as fdct_ops
    from .parallel import mesh as mesh_mod
    from .parallel import stripes as stripes_mod

    device = convert.resolve_device(device)
    n_stripe = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    n_data = n_devices // n_stripe
    mesh = mesh_mod.make_mesh(n_data=n_data, n_stripe=n_stripe)
    data_axis, stripe_axis = mesh_mod.batch_sharding(mesh), mesh_mod.stripe_sharding(mesh)
    frame, planes, qts, cfg = _tiny_coeffs(h=16 * n_stripe, w=32)
    cfg = cfg.replace(upsample="fancy")
    stage = stripes_mod.build_striped_stage(stripes_mod._stage_for(frame, qts, cfg), n_stripe,
                                            device)
    k = stripe_axis.index
    mine = [torch.from_numpy(np.ascontiguousarray(stripes_mod._stripe_rows(p, k, lby)))
            .to(device) for p, lby in zip(planes.planes, stage.lby)]
    batch = 2 * n_data
    exchange = stripe_axis.halo_exchange if n_stripe > 1 else None
    rgb = torch.stack([stripe_axis.gather(stage.stripe(k, mine, exchange)).to(device)
                       for _ in data_axis.local(range(batch))])
    kq = fdct_ops.fdct_tables([quality_qtables(85)[0]], device)
    coeffs = torch.stack([fdct_ops.encode_planes(img[..., 0].contiguous(), ((1, 1),), kq)[0]
                          .reshape(-1, 64) for img in rgb]).to(torch.int32)  # gloo has no int16
    rgb, coeffs = data_axis.gather(rgb), data_axis.gather(coeffs)
    assert rgb.shape[0] == batch and rgb.shape[-1] == 3, tuple(rgb.shape)
    assert coeffs.shape[-1] == 64, tuple(coeffs.shape)
    return rgb.cpu().numpy(), coeffs.cpu().numpy()


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dryrun", type=int, metavar="N",
                    help="run dryrun_multichip(N) instead, under torchrun's environment")
    ns = ap.parse_args()
    if ns.dryrun is None:
        fn, args = entry(ns.device)
        out = fn(*args)
        print("entry ok:", tuple(out.shape), out.dtype, out.device)
    else:
        from .parallel import multihost

        if "WORLD_SIZE" in os.environ:
            multihost.initialize(backend="gloo" if ns.device == "cpu" else None)
        rgb, coeffs = dryrun_multichip(ns.dryrun, ns.device)
        print(f"dryrun_multichip({ns.dryrun}) ok: rgb {rgb.shape}, coefficients {coeffs.shape}")
