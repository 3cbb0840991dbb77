#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main decode path once on one CUDA card.

    python3 chip_smoke.py        (from the repository root; needs one card)

Phases, each of which exits non-zero on failure:
  1. check the card; build the kernels (csrc/*.cu, nvcc, sm_90a);
  2. make the inputs without JAX or Pillow: random int16 coefficient planes
     of a 3840x2160 4:2:0 frame, packed by the native runtime with the
     Annex K tables and a restart marker per MCU row (135 segments), four
     seeds, plus a small gray stream whose width is not a multiple of 8;
  3. each kernel against its plain PyTorch version on the card, bitwise,
     at the 4K shapes the main path gives it: K2 (entropy; also on a
     reduced 640x352 stream, and at 4K against the native host decoder),
     K0 (IDCT) and K3 (colour);
  4. the main path: JpegDecoder(DecodeConfig(entropy_backend=PALLAS),
     device="cuda") answers the four 4K requests and the gray one, with
     every launch counter > 0 afterwards, and every RGB and pixel plane
     bitwise equal to the JAX-free EXACT reference (core.oracle over the
     native planes); then the default NATIVE config, the same way;
  5. per-image stage times with CUDA events (H2D, K2, K0, K3, D2H) and the
     end-to-end time of each request.
The last lines are the kernels' JSON record, the card's name and power
limit, and {"ok": true, "device": {...}}. The script imports the JAX
package's shared host layers only through jpeg_decoder_tpu_torch.shared,
and fails if anything loaded JAX.
"""

from __future__ import annotations

import functools
import json
import statistics
import subprocess
import sys
import time

import numpy as np

W, H = 3840, 2160
RI = W // 16                     # one restart marker per MCU row
SEEDS = (20261016, 1, 2, 3)      # the four 4K requests
SMALL = (640, 352, 40)           # w, h, ri of the K2-vs-plain stream
GRAY = (100, 37)                 # gray request, width not a multiple of 8
F420 = ((2, 2), (1, 1), (1, 1))


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if r.returncode != 0:
        fail(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------


def make_jpeg(w: int, h: int, factors, ri: int, seed: int) -> bytes:
    """A baseline JPEG of random coefficients: DC in [-60, 60], AC
    Laplace(4) rounded and clipped to +-1023, so every DC difference and AC
    value lies in the Annex K categories. Packed by the native runtime."""
    from jpeg_decoder_tpu_torch.shared import huffman, runtime, types, writer

    if not runtime.available():
        fail("the native runtime did not build")
    rng = np.random.default_rng(seed)
    hmax = max(f[0] for f in factors)
    vmax = max(f[1] for f in factors)
    mcus_x, mcus_y = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    planes, rows = [], []
    for ci, (fh, fv) in enumerate(factors):
        shape = (mcus_y * fv, mcus_x * fh, 64)
        p = np.clip(np.rint(rng.laplace(0.0, 4.0, shape)), -1023, 1023)
        p[..., 0] = rng.integers(-60, 61, shape[:2])
        planes.append(p.astype(np.int16))
        t = 0 if ci == 0 else 1
        # models/encoder._unit_layout: (comp, fh, fv, j, k, sci, dc, ac)
        rows += [(ci, fh, fv, j, k, ci, t, t)
                 for j in range(fv) for k in range(fh)]
    n_tab = 1 if len(factors) == 1 else 2
    dc_specs = [huffman.annex_k_dc_luminance(), huffman.annex_k_dc_chrominance()][:n_tab]
    ac_specs = [huffman.annex_k_ac_luminance(), huffman.annex_k_ac_chrominance()][:n_tab]
    entropy = runtime.encode_scan_planes(
        planes, mcus_x, mcus_x * mcus_y, np.asarray(rows, dtype=np.int32),
        [huffman.build_encode_table(s) for s in dc_specs],
        [huffman.build_encode_table(s) for s in ac_specs], ri,
    )
    qts = [types.standard_luminance_qtable(),
           types.standard_chrominance_qtable()][:n_tab]
    parts = [writer.soi()]
    parts += [writer.dqt(i, q) for i, q in enumerate(qts)]
    parts.append(writer.sof(
        w, h, [(ci + 1, fh, fv, 0 if ci == 0 else 1)
               for ci, (fh, fv) in enumerate(factors)]))
    parts += [writer.dht(s) for s in dc_specs + ac_specs]
    if ri:
        parts.append(writer.dri(ri))
    parts.append(writer.sos([(ci + 1, 0 if ci == 0 else 1, 0 if ci == 0 else 1)
                             for ci in range(len(factors))]))
    parts += [entropy, writer.eoi()]
    return b"".join(parts)


@functools.lru_cache(maxsize=None)
def reference(data: bytes, quirks):
    """The JAX-free EXACT reference: native host planes, then core.oracle
    (the JAX package's use_device=False pixel path)."""
    from jpeg_decoder_tpu_torch import DecodeConfig
    from jpeg_decoder_tpu_torch.models import host
    from jpeg_decoder_tpu_torch.shared import oracle

    frame, planes, qts = host.host_decode(data, DecodeConfig())
    pix = oracle.pixels_from_coeffs(frame, planes, qts)
    return planes, pix, oracle.color_convert(frame, pix, quirks)


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of fn() over `reps` runs, CUDA events."""
    import torch

    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def max_abs_err(a, b) -> int:
    a = a.to("cpu").numpy().astype(np.int64)
    b = b.to("cpu").numpy().astype(np.int64)
    if a.shape != b.shape:
        fail(f"shape mismatch {a.shape} vs {b.shape}")
    return int(np.abs(a - b).max()) if a.size else 0


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def check_k2(dev, small: bytes, big: bytes, record: dict) -> None:
    """K2 against its plain version on the same inputs, bitwise: at the 4K
    shape the main path gives it and on a reduced stream. At 4K the
    kernel's planes are also held against the native host decoder's."""
    import torch
    from jpeg_decoder_tpu_torch import DecodeConfig, convert
    from jpeg_decoder_tpu_torch.models import host
    from jpeg_decoder_tpu_torch.ops import entropy_cuda
    from jpeg_decoder_tpu_torch.shared import parse

    err = 0
    for data in (small, big):
        s = parse(data)
        scan = s.scans[0]
        tabs = convert.tables_to_device(s.frame, scan, dev)
        ri, stream, seg_off = entropy_cuda.pack_scan(
            s, scan, tabs.total_mcus, tabs.units.shape[0])
        args = (torch.from_numpy(stream).to(dev),
                torch.from_numpy(seg_off).to(dev),
                ri, tabs.total_mcus, tabs.units, tabs.huffman)
        got = convert.zero_planes(s.frame, dev)
        want = convert.zero_planes(s.frame, dev)
        box = {}
        plain_ms = cuda_ms(lambda: box.update(
            st=entropy_cuda._decode_segments_plain(*args, want)), 1)
        st_k = entropy_cuda.decode_segments(*args, got)
        e = max(max_abs_err(st_k, box["st"]),
                *[max_abs_err(a, b) for a, b in zip(got, want)])
        err = max(err, e)
        entropy_cuda.check_status(st_k, seg_off)
        ms = cuda_ms(lambda: entropy_cuda.decode_segments(*args, got), 5)
        shape = (f"{s.frame.width}x{s.frame.height} 4:2:0,"
                 f" {len(seg_off) - 1} segments")
        log(f"K2 entropy: kernel {ms:.3f} ms, plain {plain_ms:.1f} ms"
            f" ({shape}); max_abs_err {e}")
    # the last pass was the 4K one: its numbers go in the record
    _, native_planes, _ = host.host_decode(big, DecodeConfig())
    native_err = max(max_abs_err(a, torch.from_numpy(b))
                     for a, b in zip(got, native_planes.planes))
    if native_err != 0:
        fail(f"K2 planes differ from the native host decoder's at 4K"
             f" (max_abs_err {native_err})")
    log("K2 entropy: 4K planes bitwise equal to the native host decoder's")
    record.update(max_abs_err=err, ms=ms, plain_ms=plain_ms, shape=shape)


def check_k0(dev, big: bytes, record: dict) -> None:
    import torch
    from jpeg_decoder_tpu_torch import DecodeConfig, convert
    from jpeg_decoder_tpu_torch.models import host
    from jpeg_decoder_tpu_torch.ops import idct
    from jpeg_decoder_tpu_torch.shared import types

    _, planes, _ = host.host_decode(big, DecodeConfig())
    coeffs = torch.from_numpy(planes.planes[0]).to(dev)
    by, bx, _ = coeffs.shape
    qt = convert.quant_table_to_device(types.standard_luminance_qtable(), dev)

    def plain(c, q, bits12):
        return idct.blocks_to_plane(idct.idct_exact(c.reshape(-1, 64), q, bits12), by, bx)

    err = max_abs_err(idct.idct_plane(coeffs, qt), plain(coeffs, qt, False))
    # extremes and the 12-bit store, on random coefficients at the 4K shape
    rng = np.random.default_rng(7)
    wild = torch.from_numpy(rng.integers(-2048, 2048, coeffs.shape, dtype=np.int16)).to(dev)
    q255 = convert.quant_table_to_device(rng.integers(1, 256, 64), dev)
    for bits12 in (False, True):
        err = max(err, max_abs_err(idct.idct_plane(wild, q255, bits12),
                                   plain(wild, q255, bits12)))
    ms = cuda_ms(lambda: idct.idct_plane(coeffs, qt), 10)
    plain_ms = cuda_ms(lambda: plain(coeffs, qt, False), 3)
    record.update(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                  shape=f"luma plane {by}x{bx} blocks")
    log(f"K0 idct_exact: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms"
        f" ({record['shape']}); max_abs_err {err} (8-bit, 12-bit, extremes)")


def check_k3(dev, big: bytes, gray: bytes, record: dict) -> None:
    import torch
    from jpeg_decoder_tpu_torch import Quirks
    from jpeg_decoder_tpu_torch.ops import color

    err = 0
    for data, w, h, factors in ((big, W, H, F420), (gray, GRAY[0], GRAY[1], ((1, 1),))):
        _, pix, _ = reference(data, Quirks.REFERENCE)
        planes = [torch.from_numpy(p).to(dev) for p in pix]
        for q in (Quirks.REFERENCE, Quirks.CORRECT):
            err = max(err, max_abs_err(
                color.planes_to_rgb(planes, h, w, factors, q),
                color._planes_to_rgb_plain(planes, h, w, factors, q)))
        if data is big:
            args = (planes, h, w, factors, Quirks.REFERENCE)
            ms = cuda_ms(lambda: color.planes_to_rgb(*args), 10)
            plain_ms = cuda_ms(lambda: color._planes_to_rgb_plain(*args), 3)
    record.update(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                  shape=f"{W}x{H} 4:2:0 planes")
    log(f"K3 color: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms"
        f" ({record['shape']}); max_abs_err {err} (both quirks, gray shear)")


def main_path(dev, requests, card: str) -> dict:
    """Both configs through the public entry points, against the reference.
    Returns backend -> launch counts of its run (the counts are cleared just
    before the run and read just after it)."""
    from jpeg_decoder_tpu_torch import (
        DecodeConfig,
        EntropyBackend,
        JpegDecoder,
        Quirks,
        _build,
    )

    runs = {}
    for cfg in (DecodeConfig(entropy_backend=EntropyBackend.PALLAS),
                DecodeConfig()):
        dec = JpegDecoder(cfg, device=dev)
        _build.LAUNCHES.clear()
        outs, e2e = [], []
        for data in requests:
            t0 = time.perf_counter()
            outs.append(dec.decode(data))
            e2e.append((time.perf_counter() - t0) * 1e3)
        launches = dict(_build.LAUNCHES)
        for data, img in zip(requests, outs):
            _, pix, rgb = reference(data, Quirks.REFERENCE)
            if not np.array_equal(img.rgb, rgb):
                fail(f"{cfg.entropy_backend.value}: RGB differs from the reference")
            if not all(np.array_equal(a, b) for a, b in zip(img.planes, pix)):
                fail(f"{cfg.entropy_backend.value}: pixel planes differ from the reference")
        name = cfg.entropy_backend.value
        log(f"main path {name}: {len(requests)} requests bitwise equal to the"
            f" reference; launches {launches}")
        log(f"main path {name}: end-to-end ms per request (host clock)"
            f" {[round(t, 3) for t in e2e]} [{card}]")
        runs[name] = launches
    return runs


def stage_times(dev, requests, card: str) -> None:
    """Per-image CUDA-event times of the PALLAS path's device stages."""
    import torch
    from jpeg_decoder_tpu_torch import DecodeConfig, EntropyBackend, convert
    from jpeg_decoder_tpu_torch.models import decoder
    from jpeg_decoder_tpu_torch.ops import entropy_cuda
    from jpeg_decoder_tpu_torch.shared import parse

    cfg = DecodeConfig(entropy_backend=EntropyBackend.PALLAS)
    for i, data in enumerate(requests):
        t0 = time.perf_counter()
        s = parse(data)
        scan = s.scans[0]
        tabs = convert.tables_to_device(s.frame, scan, dev)
        ri, stream, seg_off = entropy_cuda.pack_scan(
            s, scan, tabs.total_mcus, tabs.units.shape[0])
        host_ms = (time.perf_counter() - t0) * 1e3
        planes = convert.zero_planes(s.frame, dev)
        box = {}
        h2d = cuda_ms(lambda: box.update(
            st=torch.from_numpy(stream).to(dev), so=torch.from_numpy(seg_off).to(dev)), 1)
        k2 = cuda_ms(lambda: box.update(status=entropy_cuda.decode_segments(
            box["st"], box["so"], ri, tabs.total_mcus, tabs.units, tabs.huffman,
            planes)), 1)
        entropy_cuda.check_status(box["status"], seg_off)
        stage = decoder.device_stage_for(
            s.frame, {t: q.values for t, q in scan.quant_tables.items()}, cfg, dev)
        k0 = cuda_ms(lambda: box.update(pix=[
            decoder.idct_ops.idct_plane(p, getattr(stage, f"qt{ci}"), stage.bits12)
            for ci, p in enumerate(planes)]), 1)
        k3 = cuda_ms(lambda: box.update(rgb=decoder.color_ops.planes_to_rgb(
            box["pix"], s.frame.height, s.frame.width, stage.factors,
            stage.quirks)), 1)
        d2h = cuda_ms(lambda: box["rgb"].cpu(), 1)
        log(f"stage times image {i}: host parse+unstuff {host_ms:.3f} ms,"
            f" H2D {h2d:.3f} ms ({stream.nbytes} B), K2 {k2:.3f} ms,"
            f" K0 {k0:.3f} ms, K3 {k3:.3f} ms, D2H rgb {d2h:.3f} ms [{card}]")


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    try:
        from jpeg_decoder_tpu_torch import _build, shared
    except ImportError as e:
        fail(f"the port is not importable next to this script: {e}")
    card = card_line()
    log(f"card: {card}")
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    _build.build()
    _build.library()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s [{card}]")

    t0 = time.perf_counter()
    requests = [make_jpeg(W, H, F420, RI, seed) for seed in SEEDS]
    gray = make_jpeg(GRAY[0], GRAY[1], ((1, 1),), 0, 11)
    small = make_jpeg(SMALL[0], SMALL[1], F420, SMALL[2], 12)
    log(f"inputs: {len(requests)} x {W}x{H} 4:2:0, ri {RI},"
        f" {[len(r) for r in requests]} bytes; made in"
        f" {time.perf_counter() - t0:.1f} s")

    kernels = {
        "jdtc_entropy_decode": dict(
            name="K2 entropy_decode", route="cuda",
            source="jpeg_decoder_tpu_torch/csrc/entropy_decode.cu",
            replaces="jpeg_decoder_tpu/ops/entropy_pallas.py:607"),
        "jdtc_idct_exact": dict(
            name="K0 idct_exact", route="cuda",
            source="jpeg_decoder_tpu_torch/csrc/idct_exact.cu",
            replaces="jpeg_decoder_tpu/ops/idct.py:189"),
        "jdtc_color": dict(
            name="K3 color", route="cuda",
            source="jpeg_decoder_tpu_torch/csrc/color.cu",
            replaces="jpeg_decoder_tpu/ops/color.py:138"),
    }
    check_k2(dev, small, requests[0], kernels["jdtc_entropy_decode"])
    check_k0(dev, requests[0], kernels["jdtc_idct_exact"])
    check_k3(dev, requests[0], gray, kernels["jdtc_color"])
    for rec in kernels.values():
        if rec["max_abs_err"] != 0:
            fail(f"{rec['name']} disagrees with its plain version"
                 f" (max_abs_err {rec['max_abs_err']}; tolerance 0)")

    pallas_launches = main_path(dev, requests + [gray], card)["pallas"]
    for key, rec in kernels.items():
        rec["launches"] = pallas_launches.get(key, 0)
        if rec["launches"] == 0:
            fail(f"{rec['name']} was not launched by the main path")
    stage_times(dev, requests, card)
    if not shared.jax_free():
        fail("JAX or a JAX-importing layer of jpeg_decoder_tpu was loaded")

    log(json.dumps({"kernels": list(kernels.values())}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
