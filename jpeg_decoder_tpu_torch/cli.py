"""Command-line interface: decode / decode-batch / encode / info / bench
(counterpart of jpeg_decoder_tpu/cli.py).

The reference's CLI is `jpeg_decoder <file>` -> SDL2 window
(reference/src/jpeg_decoder.c:29-141) and a non-compiling encoder program
(jpeg_encoder.c). This CLI covers both, file-based (PNG/PPM/NPY out) with
an optional viewer (--show). PNG and --show need Pillow, imported only
when used; PPM and NPY need nothing beyond NumPy.

Every command runs on `--device` (default "cuda": the card's kernels;
"cpu" runs their plain PyTorch versions). The CLI is a one-process
program: `--stripes N` cuts a --striped decode in N stripes of MCU rows on
one device (default: the CUDA devices, one on the CPU), where the JAX CLI
stripes over its device mesh; a mesh of ranks (parallel/mesh.py) is the
library's, under torchrun or multihost.initialize.

    python -m jpeg_decoder_tpu_torch.cli decode in.jpg out.npy [--backend ...]
    python -m jpeg_decoder_tpu_torch.cli decode-batch a.jpg b.jpg --out-dir d --format npy
    python -m jpeg_decoder_tpu_torch.cli encode in.npy out.jpg [--quality 85]
    python -m jpeg_decoder_tpu_torch.cli info in.jpg [--json]
    python -m jpeg_decoder_tpu_torch.cli bench in.jpg [--repeat 5]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

from .utils.config import DecodeConfig, EncodeConfig, EntropyBackend, IdctPrecision, Quirks


def _write_image(path: Path, rgb: np.ndarray) -> None:
    suffix = path.suffix.lower()
    if suffix == ".npy":
        np.save(path, rgb)
        return
    if suffix in (".ppm", ".pnm"):
        with open(path, "wb") as f:
            f.write(b"P6\n%d %d\n255\n" % (rgb.shape[1], rgb.shape[0]))
            f.write(rgb.tobytes())
        return
    from PIL import Image

    Image.fromarray(rgb, "RGB").save(path)


def _read_image(path: Path) -> np.ndarray:
    if path.suffix.lower() == ".npy":
        return np.load(path)
    from PIL import Image

    im = Image.open(path)
    if im.mode == "L":
        return np.asarray(im)
    return np.asarray(im.convert("RGB"))


_SCALE_FLAGS = {"1/8": 1, "1/4": 2, "1/2": 4, "1": 8}


def _decode_cfg(args) -> DecodeConfig:
    return DecodeConfig(
        entropy_backend=EntropyBackend(args.backend),
        idct_precision=IdctPrecision(args.precision),
        quirks=Quirks(args.quirks),
        use_device=not args.no_device,
        upsample=args.upsample,
        scale=_SCALE_FLAGS[getattr(args, "scale", "1")],
        num_threads=args.threads,
        collect_metrics=getattr(args, "metrics", False),
    )


def _device(args):
    from .convert import resolve_device

    return resolve_device(args.device)


def cmd_decode(args) -> int:
    cfg = _decode_cfg(args)
    device = _device(args)

    t0 = time.perf_counter()
    if args.streamed or args.striped:
        # Gigapixel routes (parallel/stripes): --streamed bounds the card's
        # memory to one chunk's intermediates; --striped cuts the device
        # stage in --stripes stripes of MCU rows, all resident. Both consume
        # the file memmapped.
        if cfg.scale != 8:
            print("--scale is not supported with --streamed/--striped",
                  file=sys.stderr)
            return 2
        from .parallel import stripes as stripes_mod

        mm = np.memmap(args.input, dtype=np.uint8, mode="r")
        if args.streamed:
            rgb = stripes_mod.decode_streamed(mm, cfg, n_chunks=args.chunks, device=device)
        else:
            rgb = stripes_mod.decode_striped(mm, cfg, n_stripes=args.stripes, device=device)
        h, w = rgb.shape[:2]
    else:
        from .models.decoder import decode_file

        # memmap streaming input: bytes page in lazily, so peak RSS is
        # bounded by planes + output rather than 2x file size.
        img = decode_file(Path(args.input), cfg, device)
        rgb = img.rgb
        h, w = rgb.shape[:2]  # == frame dims except under --scale
    dt = time.perf_counter() - t0
    if args.out:
        _write_image(Path(args.out), rgb)
    if args.show:
        from PIL import Image

        Image.fromarray(rgb, "RGB").show()
    mp = w * h / 1e6
    print(
        f"{w}x{h} ({mp:.2f} MP) in {dt*1e3:.1f} ms"
        f" = {mp/dt:.1f} MP/s",
        file=sys.stderr,
    )
    if args.metrics:
        from .utils.metrics import GLOBAL_METRICS

        print(json.dumps(GLOBAL_METRICS.summary(), indent=2), file=sys.stderr)
    return 0


def cmd_decode_batch(args) -> int:
    """Decode MANY JPEGs with cross-image host concurrency.

    The host entropy stages of up to --jobs images run at once
    (models/host.host_decode_batch); the pixel stage finishes each image
    as its planes arrive, in input order. This is the serving shape for
    progressive streams, whose bit-serial scan chains cannot fill the cores
    one image at a time."""
    cfg = _decode_cfg(args)
    device = _device(args)
    from .models.decoder import _pixel_stage
    from .models.host import PlanePool, host_decode_batch

    paths = [Path(p) for p in args.inputs]
    out_dir = Path(args.out_dir) if args.out_dir else None
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
    pool = PlanePool()
    datas = (np.memmap(p, dtype=np.uint8, mode="r") for p in paths)
    t0 = time.perf_counter()
    total_mp = 0.0
    for path, (frame, planes, qts) in zip(
        paths, host_decode_batch(datas, cfg, pool, max_workers=args.jobs, device=device)
    ):
        img = _pixel_stage(frame, planes, qts, cfg, device)
        if not isinstance(planes, list):  # PALLAS and DEVICE planes are device tensors
            pool.release(planes)
        total_mp += frame.width * frame.height / 1e6
        if out_dir is not None:
            _write_image(out_dir / f"{path.stem}.{args.format}", img.rgb)
    dt = time.perf_counter() - t0
    print(
        f"{len(paths)} images, {total_mp:.2f} MP in {dt*1e3:.1f} ms"
        f" = {total_mp/dt:.1f} MP/s aggregate",
        file=sys.stderr,
    )
    if args.metrics:
        from .utils.metrics import GLOBAL_METRICS

        print(json.dumps(GLOBAL_METRICS.summary(), indent=2), file=sys.stderr)
    return 0


def cmd_encode(args) -> int:
    from .models.encoder import encode

    img = _read_image(Path(args.input))
    cfg = EncodeConfig(
        quality=args.quality,
        subsampling="gray" if img.ndim == 2 else args.subsampling,
        restart_interval=args.restart_interval,
        huffman="optimized" if args.optimize else "annex_k",
        progressive=args.progressive,
    )
    data = encode(img, cfg, _device(args))
    Path(args.out).write_bytes(data)
    print(f"{len(data)} bytes", file=sys.stderr)
    return 0


def cmd_info(args) -> int:
    from .io.parser import parse
    from .utils.debug import structure_summary

    data = Path(args.input).read_bytes()
    s = parse(data)
    if args.json:
        print(json.dumps(structure_summary(s), indent=2))
    else:
        from .utils.debug import print_structure

        print_structure(s)
    return 0


def cmd_bench(args) -> int:
    cfg = _decode_cfg(args)
    device = _device(args)
    from .models.decoder import decode

    data = Path(args.input).read_bytes()
    img = decode(data, cfg, device)  # warm (kernel build, stage cache)
    times = []
    for _ in range(max(args.repeat, 1)):
        t0 = time.perf_counter()
        img = decode(data, cfg, device)
        times.append(time.perf_counter() - t0)
    # megapixels of the source frame, also under --scale (the JAX CLI's
    # count, kept: ROADMAP.md §3)
    mp = img.width * img.height / 1e6
    t = float(np.median(times))
    print(json.dumps({
        "metric": "cli_decode_throughput",
        "value": round(mp / t, 2),
        "unit": "MP/s",
        "median_ms": round(t * 1e3, 2),
    }))
    if args.metrics:
        from .utils.metrics import GLOBAL_METRICS

        print(json.dumps(GLOBAL_METRICS.summary(), indent=2), file=sys.stderr)
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="jpeg_decoder_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def add_device_opt(sp):
        sp.add_argument("--device", default="cuda",
                        help="torch device of the pixel stage and the encoder's device"
                             " stage (default cuda: the card's kernels; cpu runs their"
                             " plain PyTorch versions)")

    def add_decode_opts(sp):
        sp.add_argument("--backend", default="native",
                        choices=[e.value for e in EntropyBackend])
        sp.add_argument("--precision", default="exact",
                        choices=[e.value for e in IdctPrecision])
        sp.add_argument("--quirks", default="reference",
                        choices=[q.value for q in Quirks])
        sp.add_argument("--upsample", default="nn", choices=["nn", "fancy"])
        sp.add_argument("--scale", default="1",
                        choices=["1/8", "1/4", "1/2", "1"],
                        help="fractional scaled decode: output is "
                             "ceil(dim * scale); 1/8 decodes thumbnails "
                             "straight from the DC band")
        sp.add_argument("--no-device", action="store_true",
                        help="run the pixel stage on the host (NumPy)")
        sp.add_argument("--threads", type=int, default=0)
        sp.add_argument("--metrics", action="store_true",
                        help="print per-stage timing summary to stderr")
        add_device_opt(sp)

    d = sub.add_parser("decode", help="JPEG -> PNG/PPM/NPY")
    d.add_argument("input")
    d.add_argument("out", nargs="?")
    d.add_argument("--show", action="store_true", help="open a viewer window")
    d.add_argument("--streamed", action="store_true",
                   help="bounded-memory chunked decode for gigapixel files "
                        "(one ~32 MP chunk resident at a time)")
    d.add_argument("--chunks", type=int, default=None,
                   help="with --streamed: number of chunks (default: "
                        "~32 MP of output per chunk)")
    d.add_argument("--striped", action="store_true",
                   help="MCU-row-striped decode, every stripe resident, one "
                        "launch per kernel")
    d.add_argument("--stripes", type=int, default=None,
                   help="with --striped: number of stripes (default: the CUDA "
                        "devices, one on the CPU)")
    add_decode_opts(d)
    d.set_defaults(fn=cmd_decode)

    db = sub.add_parser(
        "decode-batch",
        help="decode many JPEGs with cross-image host concurrency",
    )
    db.add_argument("inputs", nargs="+")
    db.add_argument("--out-dir", default=None,
                    help="write one image per input here (default: timing only)")
    db.add_argument("--format", default="png", choices=["png", "ppm", "npy"])
    db.add_argument("--jobs", type=int, default=0,
                    help="images decoding concurrently (default: all cores)")
    add_decode_opts(db)
    db.set_defaults(fn=cmd_decode_batch)

    e = sub.add_parser("encode", help="PNG/NPY -> JPEG")
    e.add_argument("input")
    e.add_argument("out")
    e.add_argument("--quality", type=int, default=85)
    e.add_argument("--subsampling", default="420",
                   choices=["444", "422", "420", "gray",
                            "411", "440", "mixed"],
                   help="chroma sampling; 411/440/mixed are the exotic-"
                        "but-legal T.81 factor sets (Pillow cannot write "
                        "them — this encoder is their corpus source)")
    e.add_argument("--restart-interval", type=int, default=0)
    e.add_argument("--optimize", action="store_true",
                   help="two-pass optimized Huffman tables")
    e.add_argument("--progressive", action="store_true",
                   help="progressive (SOF2) spectral-selection output")
    add_device_opt(e)
    e.set_defaults(fn=cmd_encode)

    i = sub.add_parser("info", help="dump parsed structure")
    i.add_argument("input")
    i.add_argument("--json", action="store_true")
    i.set_defaults(fn=cmd_info)

    b = sub.add_parser("bench", help="time repeated decodes of one file")
    b.add_argument("input")
    b.add_argument("--repeat", type=int, default=5)
    add_decode_opts(b)
    b.set_defaults(fn=cmd_bench)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
