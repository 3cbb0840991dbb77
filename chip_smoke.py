#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main decode and encode paths once on one CUDA card.

    python3 chip_smoke.py        (from the repository root; needs one card)

Phases, each of which exits non-zero on failure:
  1. check the card; build the kernels (csrc/*.cu, one nvcc per source,
     all started together, sm_90a);
  2. make the inputs without JAX or Pillow: random int16 coefficient planes
     of a 3840x2160 4:2:0 frame, packed by the native runtime with the
     Annex K tables and a restart marker per MCU row (135 segments), eight
     seeds (dense blocks, an end-of-block code in one of eight); the same
     frame without restart markers; four 640x352 streams with restart
     interval 40; a small gray stream whose width is not a multiple of 8;
     and real blocks: two files of the test corpus that a foreign encoder
     wrote with restart markers (tests/wild_files/transcoded: a photograph,
     640x427 4:2:0, and a drawing, 161x161 4:2:2), and the coefficients of
     two photographs of that corpus tiled to 3840x2160 4:2:0 with a marker
     per MCU row (benchmarks/inputs.photo_jpeg), and the corpus's
     4-component photograph (hopper_cmyk_adobe.jpg, 4:4:4, Adobe APP14
     transform 0) tiled to 3840x2160 with a marker per MCU row; for the
     encoder, the JAX-free EXACT decode of the first photograph's 4K tile,
     a uniform random 3840x2160 image from a seed, a 33x47 and an 8x8
     RGB image and a 41x57 gray one;
  3. each kernel against its plain PyTorch version on the card, at the
     shapes the main paths give it: K2 (entropy) bitwise, on a 640x352
     stream (where its per-subsequence records are also held against the
     schedule's model on the CPU, and damaged streams must raise the plain
     version's error classes) and at 4K, where it is also held against the
     native host decoder; batched K2 bitwise, the eight 4K requests (1080
     segments) in one launch against eight single-image launches and the
     native host planes, and four 640x352 streams against the batched plain
     version; on the two foreign files against the plain version and the
     native host decoder, and on the two 4K frames of photographs' blocks
     against the native host decoder; each K2 line gives the subsequences, the launches of pass 2
     and the time of each pass; K2u (unstuffing, one pass, then K2's
     layout) bitwise against its plain version and the host's per-segment
     unstuffing, stream, offsets and layout, on a 640x352 stream, at 4K and
     for the eight 4K requests in one call, each timed the card alone
     beside a device-to-device copy of the raw bytes and raw[keep]
     (benchmarks/k2u_sweep.measure), with its
     registers and shared memory (nvcc -Xptxas -v); K2 on the DEVICE
     route (K2d: whole segments, none of the PALLAS route's lane guards)
     bitwise against its plain lockstep loop, with its records against
     the schedule's model on the CPU, on a restart-free 136x128 gray stream
     and a gray gradient in two segments of 4100 MCUs, and damaged
     restart-free streams raising the plain version's classes; then on six
     3840x2160 inputs the PALLAS route refuses (the dense request without
     markers, bench.py's restart-free image, a photograph tiled to 4K
     without markers, a 12-bit restart-free stream, a stream of one
     non-interleaved scan a component, segments of three MCU rows), every
     plane bitwise the native host decoder's, each with its passes' times
     and pass 2's launches and steps beside the same image with a marker
     per MCU row on the PALLAS route; and K2's scan and dc passes as the
     wrapper picks them (the dc pass in chunks; the scan pass in chunks
     where a segment has more than one chunk of records), timed on the
     dense 4K request with a marker per MCU row and without markers, their
     planes bitwise the native host decoder's;
     K0 (EXACT IDCT) bitwise against its plain version on the 4K request's
     three planes, the 4K four-component frame's four, random +-2048
     coefficients x a table of 255, 8- and 12-bit, and ragged shapes,
     timed the card alone and with L2 flushed, with its F2F conversions a
     block from its SASS; K1 (FLOAT32 IDCT) within 1 on at most 1e-3 of the
     pixels, at the 4K luma shape and ragged shapes, 8- and 12-bit, with
     the error on extreme inputs reported, timed the card alone and with
     L2 flushed on the luma plane and over the request's three planes,
     beside the product alone as one cuBLAS call at both shapes, with its
     LDS and FFMA from its SASS; K3 (colour) bitwise against its plain
     version, per image and batched, timed the card alone; K03 (the EXACT pixel stage of a 3-component frame in one
     kernel) bitwise against its plain version and against K0 x 3 + K3, on
     the dense 4K request, the two photographs tiled to 4K, a 4:2:2 and a
     4:4:4 file of the corpus, random 12-bit planes at 4K and a batch of
     four, both quirks, with and without planes; its time beside K0 x 3 +
     K3 at 4K and for eight 4K images, and the sweep of its strip size G
     (benchmarks/pixel_sweep.py); K13 (the FLOAT32 pixel stage of a
     3-component frame in one kernel) on the same cases, bitwise against K1
     x 3 + K3, its planes within 1 of K03's and, against its plain version,
     within 1 on at most 1e-3 of the pixels with RGB the plain colour stage
     of its own planes; its time beside K1 x 3 + K3 and beside the product
     alone as one cuBLAS call, its sweep of G and the SASS mix of K13 and
     K1; the probes PK1-PK7 bitwise (all integer) on every one of
     their 21 variants (E1-E6, P1-P5, G1-G4b, H1-H5) at both chain
     lengths the probe path launches them at, in both table placements
     where the table fits shared memory, PK6 also from a random state;
     K3f (fancy upsample + colour) bitwise against its plain version on
     the dense 4K request's planes, flower_dri_blocks7_422.jpg, random
     4:1:1 and 4:2:1 planes at 4K, a batch of four and the 4K 4-component
     frame (YCCK EXACT, YCCK FLOAT32, CMYK), both quirks, timed the card
     alone (one image and the batch of four) and beside K3 on the same
     planes; K3c (nearest-neighbour 4-component colour) bitwise against its
     plain version on the 4K 4-component frame and, under YCCK EXACT, on a
     4096x4096 frame that walks R's whole (y, cr, k) domain against the
     float64 chain in NumPy, timed the card alone under each transform; K5
     (the scaled IDCT, one launch for all components) at k = 1, 2 and 4 on
     the 4K request's planes, within 1 on at most 1e-3 of the pixels and
     bitwise at k = 1 (on random 12-bit planes of their shapes reported),
     timed the card alone and with L2 flushed, beside the launch floor (an
     empty kernel at its grid) and the product alone as one torch.matmul;
     K4 (the encoder's device stage: colour, pad, box subsample, FDCT,
     quantize) bitwise its plain version on every coefficient of both 4K
     images and the small ones, the six chroma samplings, gray and a 2-D
     gray image at q = 10, 85 and 100, timed on the 4K photograph at 4:2:0
     and 4:4:4 the card alone and with L2 flushed and beside the product
     alone as one torch.matmul, with its registers and shared memory and
     its LDS and FFMA from its SASS; K6n (the nearest-neighbour pixel stage of
     streamed and striped decode: K03, K13 or K0/K1 + K3 launched with the
     stripe rule) bitwise its plain version (the JAX program stripe by
     stripe) on a 16384x2048 chunk of the gigapixel frame (below) and with 8
     stripes on the dense 4K request, a 4K gray frame, a 4K frame of 7/12
     vertical factors (refused by the guard: K0 + K3, the clamp live) and
     the 4-component photograph tiled to 4K (YCCK), and under FLOAT32 bitwise
     K1 x 3 + K3 with the rule; K6f (K0 + K3f under the striped fancy rule)
     bitwise its plain version on the dense 4K request in 8 stripes, where it
     differs from the whole-image fancy decode in row 2159 alone, and on a
     frame with a (2, 4)-ratio component; each timed one call and the card
     alone; K6h (K3f over one stripe of a mesh, its two halo rows a
     component given) stripe by stripe, each stripe's halo rows its
     neighbours' edge rows, bitwise K6f in one launch and its plain version
     (the JAX program's stripe) on the dense 4K request in 2 and 8 stripes
     and a (2, 4)-ratio frame, and bitwise K6f under FLOAT32 (K1), timed one
     call on a stripe and the card alone over both stripes beside K6f's K3f
     in turns;
  4. the main paths, each with every launch count set to 0 just before it
     and read just after, and the work of the IDCT and colour launches
     (_build.LAUNCH_UNITS: coefficient blocks, output pixels), from which
     the time K0, K1, K3, K3f, K3c, K4 and K5 lose on them is weighed in
     4K units (size_weighted):
     - JpegDecoder(PALLAS) and JpegDecoder(NATIVE), EXACT, answer four 4K
       requests, every RGB and pixel plane bitwise equal to the JAX-free
       EXACT reference (core.oracle over the native planes), one K03
       launch a request and no K0 or K3; then the gray one (K0 and K3),
       the two foreign files and the two 4K requests of photographs'
       blocks (K03), held the same way;
     - JpegDecoder(FLOAT32) for PALLAS and NATIVE on the four 4K
       requests: one K13 launch a request and no K1 or K3, pixel planes
       within 1 of the reference's, RGB bitwise equal to the colour stage
       of the returned planes; then the gray one (K1 and K3);
     - JpegDecoder(DEVICE), EXACT, on the six DEVICE inputs: RGB and pixel
       planes bitwise JpegDecoder(NATIVE)'s, one K2u and one K2d launch a
       scan; BatchDecoder(DEVICE).decode_batch of two restart-free 4K
       requests, each bitwise its single decode;
     - BatchDecoder for PALLAS and NATIVE, each with EXACT and FLOAT32:
       decode_batch of the eight 4K requests (one K2u and one K2 call, then
       one K03 launch under EXACT, or one K13 launch under FLOAT32),
       decode_stream with batches
       of 4, and decode_many over two 4K DRI requests, the restart-free
       one (which the PALLAS route hands to the native host decode) and
       the gray one; every RGB bitwise equal to the single-image decode
       with the same config, and to the reference under EXACT;
     - the configs of ROADMAP item 2, PALLAS and NATIVE: a 4K fancy request
       under EXACT (K0 x 3 + K3f, bitwise the host reference: the port's
       use_device=False pixel path) and FLOAT32 (K1 x 3 + K3f), the 4K
       4-component frame as YCCK (REFERENCE) and CMYK (CORRECT) (K0 x 4 +
       K3c, bitwise the host reference), 4K requests at scale 1, 2 and 4
       (K5 once + K3, against the plain version on CPU tensors), and
       BatchDecoder.decode_batch of the eight 4K requests with fancy
       upsampling (K0 x 3 + K3f once, bitwise the host reference and the
       single-image decodes);
     - the probe path through its entry point, benchmarks.gather_probe.main
       with all four rounds at the rounds' own chain lengths: 21 ns/step
       lines;
     - JpegEncoder on the card (one K4 launch an image, no plain version,
       no Python packer): the 4K photograph at 4:2:0, q85, a marker per MCU
       row, Annex K, byte for byte the port's CPU encode; with optimized
       tables, progressive and 4:4:4, the native host decode of the bytes
       giving K4's planes; encode_stream of four 4K images against four
       encode calls; the photograph's bytes through JpegDecoder(PALLAS,
       EXACT), bitwise the reference, with K4's planes;
     - checkpoint/resume (core/checkpoint.ScanDecoder) on the card: a
       320x240 progressive stream of the port's encoder decoded scan by
       scan, checkpointed after half its scans to a file, resumed by a new
       ScanDecoder and finished on the card (K03), bitwise the CPU finish
       and JpegDecoder's RGB; the dense 4K request's native host planes as
       a finished checkpoint, restored and finished at full size, EXACT
       (K03, bitwise the reference) and FLOAT32 (K13, bitwise
       JpegDecoder's FLOAT32 decode on the card);
     - the CLI, python -m jpeg_decoder_tpu_torch.cli in processes of its
       own on the card (not counted in this process's launches): decode of
       the 4K request to .npy and .ppm, --scale 1/2, --streamed,
       decode-batch --format npy of four 4K requests, encode of the 4K
       photograph from .npy and the decode of its bytes, info --json and
       bench, each output bitwise the library call on the card;
     - streamed and striped decode of a 16384x32768 4:2:0 frame of the first
       photograph's blocks with a marker per MCU row
       (benchmarks/inputs.gigapixel_jpeg, 0.537 GP): decode_streamed
       (NATIVE, 16 chunks, one K6n launch a chunk) under EXACT bitwise
       decode_striped (8 stripes, one K6n launch) and JpegDecoder's
       whole-image decode, and under FLOAT32 bitwise the whole-image FLOAT32
       decode; decode_striped of the dense 4K request with fancy upsampling
       (K6f) bitwise its plain version; wall time, MP/s and the card's peak
       allocation of each;
     - the mesh paths (parallel/mesh.py, multihost.py), each rank a process
       of its own on this card (benchmarks/mesh_ranks.py), its launch counts
       read in the rank: a one-rank NCCL group (BatchDecoder(mesh) of the
       eight 4K requests, PALLAS and NATIVE, EXACT and FLOAT32;
       decode_striped(mesh) of the dense 4K request, fancy EXACT and
       FLOAT32 and nearest-neighbour; dryrun_multichip(1)) and two gloo
       ranks on this card (the same batches over a data axis of 2; the 4K
       request over a stripe axis of 2, fancy through K6h with the halo rows
       exchanged and nearest-neighbour through K6n; dryrun_multichip(2);
       the gigapixel frame in 2 stripes, EXACT, nearest-neighbour), each
       bitwise the call without a mesh, with each rank's wall time and the
       host-clock time of its halo exchanges and all_gathers. NCCL across
       two or more cards is not run here: the machine has one card;
     - the bench and serving scripts, through their entry points: the
       headline bench (benchmarks/bench.main at its 3840x2160 workload,
       one host window: its JSON line, logged with the card, must hold
       every key, bit_exact not false (the B=1 EXACT RGB bitwise the CPU
       decode, every image of each B=16 call bitwise the B=1 call's) and
       device_kind this card; K03, K13 and K4), benchmarks/k2_batched.main
       (eight 4K images, K2u + K2 in one call, the planes bitwise the
       native host decoder's), examples/serving.main and
       progressive_serving (64 512x512 requests through
       BatchDecoder.decode_stream, each frame bitwise the port's CPU
       decode of its bytes; eight progressive ones through
       host_decode_batch; K03) and benchmarks/scaling.main with --sizes 1
       (one NCCL rank in a process of its own, its batch of 32 bitwise the
       CPU decode, its launches read from the rank's record; K03);
  5. stage times with CUDA events: per image (H2D, K2u, K2, K03 and K13,
     D2H), and per batch of eight (H2D, K2u, K2, K03 under EXACT or K13
     under FLOAT32, D2H), each with the host clock of the parse that
     remains on the host; and the pixel stage of item 2's routes on a 4K
     request (fancy, scale 4 and 1, YCCK, CMYK) beside K03, one call and
     the card alone, with the D2H and the warm PALLAS request latency; and
     a warm 4K encode (H2D, K4, D2H of the planes, native count and pack,
     assembly, latency, encode_stream of eight); the gigapixel frame's
     chunks (host entropy, H2D, K6n, D2H into fresh and into touched host
     pages), and decode_streamed and decode_striped each in a process of its
     own (benchmarks/gigapixel.py: time, the card's peak allocation, the
     host's resident set before and at its peak during the decode).
The last lines are the kernels' JSON record (twenty-two kernels: K0-K4, K03,
K13, K2u, K2d, K3f, K3c, K5, K6n, K6f, K6h and PK1-PK7, each with its launches on the main
paths, its time, its plain version's time and its bound; K0, K1, K3, K3f,
K3c, K4 and K5 also with their work in 4K units and the time lost), the
card's name and power limit, and
{"ok": true, "device": {...}}. The script imports the port alone, builds
the CUDA kernels and the native host runtime from the port's own sources,
and fails if anything loaded JAX or the JAX package jpeg_decoder_tpu.
"""

from __future__ import annotations

import functools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

W, H = 3840, 2160
RI = W // 16                     # one restart marker per MCU row
SEEDS = (20261016, 1, 2, 3)      # the four 4K requests
BATCH_SEEDS = SEEDS + (4, 5, 6, 7)  # the eight 4K requests of a batch
SMALL = (640, 352, 40)           # w, h, ri of the K2-vs-plain streams
SMALL_SEEDS = (12, 13, 14, 15)   # the batched K2-vs-plain streams
GRAY = (100, 37)                 # gray request, width not a multiple of 8
F420 = ((2, 2), (1, 1), (1, 1))
#: K1 against its plain version: |diff| <= 1 on at most this share of the
#: pixels (the two sum the 64 products of a pixel in other orders, so a
#: floor can flip; the JAX FLOAT32 contract is +-1 LSB).
K1_SHARE = 1e-3
#: Huffman-decoding one symbol, whatever the decoder's design, in int32
#: operations, for K2's bound: peek the code bits (a shift), look the code
#: up (a load), split the entry into length and size (a shift and a mask),
#: take the value bits (a shift and a mask), EXTEND (a compare, a select and
#: an add), drop the bits consumed (a shift and a subtract), step the
#: coefficient position by the run (an add), store the coefficient, and a
#: refill's compare, its load and merge being shared by several symbols.
K2_OPS_PER_SYMBOL = 14

# The card's published peaks, for each kernel's bound: the least time the
# card could take for the same work, the larger of its bytes over the memory
# rate and its operations over the peak rate of their type. NVIDIA's H100
# SXM data sheet: 3.35 TB/s; 67 TFLOP/s float32 outside the tensor cores
# (an FMA is two); float64 at half that; int32 instructions issue on half
# of an SM's float32 lanes, so a quarter of 67e12 a second.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "float64": 33.5e12, "int32": 16.75e12}


def bound(nbytes: float, ops: float, kind: str) -> dict:
    """bound_ms and bound_by of a call that must move `nbytes` (each input
    read once, each output written once) and do `ops` operations of `kind`."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return dict(bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations",
                bound_bytes=int(nbytes), bound_ops=int(ops), bound_ops_kind=kind)


def nbytes_of(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


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
# The reference
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def reference(data: bytes, quirks):
    """The JAX-free EXACT reference: native host planes, then core.oracle
    (the JAX package's use_device=False pixel path)."""
    from jpeg_decoder_tpu_torch import DecodeConfig
    from jpeg_decoder_tpu_torch.core import oracle
    from jpeg_decoder_tpu_torch.models import host

    frame, planes, qts = host.host_decode(data, DecodeConfig())
    pix = oracle.pixels_from_coeffs(frame, planes, qts)
    return planes, pix, oracle.color_convert(frame, pix, quirks)


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------


def cuda_ms(fn, reps: int, before=None) -> float:
    """Median milliseconds of fn() over `reps` runs, CUDA events; `before`
    runs ahead of each, outside the events."""
    import torch

    times = []
    for _ in range(reps):
        if before is not None:
            before()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _ints(t) -> np.ndarray:
    return (t.to("cpu").numpy() if hasattr(t, "to") else np.asarray(t)).astype(np.int64)


def _on_card(a, b) -> bool:
    """Both are tensors on one CUDA device: compare them there, not through
    int64 copies of every 4K output on the host."""
    return (getattr(a, "is_cuda", False) and getattr(b, "is_cuda", False)
            and a.device == b.device)


def max_abs_err(a, b) -> int:
    if _on_card(a, b):
        if a.shape != b.shape:
            fail(f"shape mismatch {tuple(a.shape)} vs {tuple(b.shape)}")
        import torch

        d = (a.to(torch.int64) - b.to(torch.int64)).abs()
        return int(d.max().item()) if d.numel() else 0
    a, b = _ints(a), _ints(b)
    if a.shape != b.shape:
        fail(f"shape mismatch {a.shape} vs {b.shape}")
    return int(np.abs(a - b).max()) if a.size else 0


def wrapped_err(a, b) -> int:
    """max_abs_err of uint8 samples counted modulo 256: the 12-bit store's
    rescale takes the low byte of trunc(v16 * 255 / 4096), so a step of 1
    in v16 where that is -1 or 0 shows as 255 against 0 (ops/idct.py
    _quantize_output_float); for 8-bit samples it is max_abs_err."""
    d = np.abs(_ints(a) - _ints(b))
    return int(np.minimum(d, 256 - d).max()) if d.size else 0


def share_differing(a, b) -> float:
    if _on_card(a, b):
        import torch

        d = a.to(torch.int64) != b.to(torch.int64)
        return float(d.double().mean().item()) if d.numel() else 0.0
    a, b = _ints(a), _ints(b)
    return float((a != b).mean()) if a.size else 0.0


def timed_phase(name: str, fn, *args):
    """fn(*args), with the seconds it took on a line of the log."""
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"phase {name}: {time.perf_counter() - t0:.1f} s")
    return out


def times_line(t: dict) -> str:
    """The times of pixel_sweep.timed, for a log line."""
    return f"the card alone {t['card_ms']:.4f} ms, L2 flushed {t['flushed_ms']:.4f} ms"


def run_path(name: str, fn):
    """Run one main path with every launch count set to 0 just before it;
    returns (fn's result, the counts read just after)."""
    from jpeg_decoder_tpu_torch import _build

    _build.LAUNCHES.clear()
    _build.LAUNCH_UNITS.clear()
    out = fn()
    launches = dict(_build.LAUNCHES)
    PATH_UNITS[name] = dict(_build.LAUNCH_UNITS)
    log(f"{name}: launches {launches}, units {PATH_UNITS[name]}")
    return out, launches


#: path -> entry point -> the work of its launches on that path
#: (_build.LAUNCH_UNITS: coefficient blocks for the IDCT kernels, output
#: pixels for the colour kernels), read by size_weighted.
PATH_UNITS: dict = {}
#: One 3840x2160 4:2:0 request, the unit of size_weighted: its three
#: planes' coefficient blocks, and its output pixels.
UNIT_BLOCKS = (W // 8) * (H // 8) + 2 * (W // 16) * (H // 16)
UNIT_PIXELS = W * H


# ---------------------------------------------------------------------------
# Phases: each kernel against its plain version
# ---------------------------------------------------------------------------


def zero_all(groups) -> None:
    for planes in groups:
        for p in planes:
            p.zero_()


def k2_passes(rec: dict) -> str:
    """A K2 call's subsequences, launches of pass 2 and pass times."""
    from jpeg_decoder_tpu_torch.ops.entropy_cuda import SUB_BYTES

    names = ("tables+pass1", "pass2", "scan", "write", "dc")
    return (f"{int(rec['sub_base'][-1])} subsequences of {SUB_BYTES} bytes,"
            f" {rec['rounds']} launches of pass 2 ({rec['steps']} steps in their blocks), passes "
            + ", ".join(f"{n} {t:.3f}" for n, t in zip(names, rec["pass_ms"])) + " ms")


def damaged_streams(data: bytes) -> dict:
    """name -> (a DRI stream damaged, the error it must raise): 64 one-bits
    that no code matches at byte 8 of the entropy data, the last restart
    segment cut in half, and both (the bad code is reported first)."""
    from jpeg_decoder_tpu_torch import JpegEntropyError, JpegTruncatedError
    from jpeg_decoder_tpu_torch.io.parser import parse

    span = parse(data).scans[0].span
    lo, hi = list(span.segment_bounds())[-1]
    bad = bytearray(data)
    bad[span.start + 8 : span.start + 24] = b"\xff\x00" * 8
    cut = lambda d: bytes(d[: lo + (hi - lo) // 2] + d[span.end:])
    return {"bad code": (bytes(bad), JpegEntropyError),
            "truncated segment": (cut(bytearray(data)), JpegTruncatedError),
            "bad code and truncated segment": (cut(bad), JpegEntropyError)}


def check_k2(dev, small: bytes, big: bytes, record: dict) -> None:
    """K2 against its plain version on the same inputs, bitwise: at the 4K
    shape the main path gives it and on a reduced stream. On the reduced
    stream the kernel's per-subsequence records are held against the
    schedule's model on the CPU, and damaged streams must raise the plain
    version's error classes. At 4K the kernel's planes are also held
    against the native host decoder's."""
    import torch
    from jpeg_decoder_tpu_torch import DecodeConfig, JpegError, convert
    from jpeg_decoder_tpu_torch.models import host
    from jpeg_decoder_tpu_torch.ops import entropy_cuda
    from jpeg_decoder_tpu_torch.io.parser import parse

    err = 0
    for data in (small, big):
        s = parse(data)
        packs = [entropy_cuda.prepare_scan(s, s.scans[0])]
        args, host_arrays = entropy_cuda.launch_args(packs, dev)
        n_segs = len(host_arrays.seg_bound) - 1
        got = convert.zero_planes(s.frame, dev)
        want = convert.zero_planes(s.frame, dev)
        box, rec = {}, {}
        plain_ms = cuda_ms(lambda: box.update(
            st=entropy_cuda._decode_segments_plain(*args, [want])), 1)
        st_k = entropy_cuda.decode_segments(*args, [got], records=rec, host=host_arrays)
        e = max(max_abs_err(st_k, box["st"]),
                *[max_abs_err(a, b) for a, b in zip(got, want)])
        err = max(err, e)
        entropy_cuda.check_status(st_k, args[1])
        ms = cuda_ms(lambda: entropy_cuda.decode_segments(*args, [got], host=host_arrays), 5,
                     before=lambda: zero_all([got]))
        e = max(e, *[max_abs_err(a, b) for a, b in zip(got, want)])
        err = max(err, e)
        shape = (f"{s.frame.width}x{s.frame.height} 4:2:0,"
                 f" {n_segs} segments")
        log(f"K2 entropy: kernel {ms:.3f} ms, plain {plain_ms:.1f} ms"
            f" ({shape}); max_abs_err {e}; {k2_passes(rec)}")
        if data is small:
            # the records of the fixed point, against the model on the CPU
            cpu_args, _ = entropy_cuda.launch_args(packs, "cpu")
            st_m, model = entropy_cuda._decode_segments_subseq_plain(
                *cpu_args, [convert.zero_planes(s.frame, "cpu")])
            rec_err = max(max_abs_err(st_k, st_m),
                          *[max_abs_err(rec[k], model[k]) for k in ("rec", "used", "first_du")])
            log(f"K2 entropy: records of {len(model['rec'])} subsequences (end states and"
                f" counts, start states, first data units) against the model on the CPU:"
                f" max_abs_err {rec_err}; the model needs {model['rounds']} rounds of pass 2"
                f" (records replaced per round {model['changed']}), the kernel"
                f" {rec['rounds']} launches with {rec['steps']} steps in their blocks")
            if rec_err != 0 or not 1 <= rec["rounds"] <= model["rounds"] + 1:
                fail("K2's records differ from the model's")
            for name, (bad, want_error) in damaged_streams(small).items():
                outcomes = []
                for device in (dev, "cpu"):
                    sb = parse(bad)
                    try:
                        entropy_cuda.decode_scan(sb, sb.scans[0],
                                                 convert.zero_planes(sb.frame, device))
                        outcomes.append(None)
                    except JpegError as ex:
                        outcomes.append(type(ex))
                if outcomes != [want_error, want_error]:
                    fail(f"K2 on a damaged stream ({name}): card and plain version gave"
                         f" {outcomes}, expected {want_error}")
            log("K2 entropy: damaged streams (bad code, truncated segment, both) raise"
                " the plain version's error classes on the card")
    # the last pass was the 4K one: its numbers go in the record
    _, native_planes, _ = host.host_decode(big, DecodeConfig())
    native_err = max(max_abs_err(a, b) for a, b in zip(got, native_planes.planes))
    if native_err != 0:
        fail(f"K2 planes differ from the native host decoder's at 4K"
             f" (max_abs_err {native_err})")
    log("K2 entropy: 4K planes bitwise equal to the native host decoder's")
    # Bound, from this request's data: the stream, offsets and tables read
    # once, the int16 planes written once; one Huffman symbol per nonzero AC
    # coefficient, one DC and at most one end-of-block per block, each
    # K2_OPS_PER_SYMBOL operations: what any decoder must do once, not what
    # this design's three to four decodes of every subsequence spend.
    n_blocks = sum(p.shape[0] * p.shape[1] for p in got)
    symbols = 2 * n_blocks + sum(int(torch.count_nonzero(p[..., 1:])) for p in got)
    record.update(max_abs_err=err, ms=ms, plain_ms=plain_ms, shape=shape, library_ms=None,
                  symbols=symbols, sub_bytes=entropy_cuda.SUB_BYTES,
                  subsequences=int(rec["sub_base"][-1]), pass2_launches=rec["rounds"],
                  pass2_steps=rec["steps"], pass_ms=rec["pass_ms"],
                  **bound(nbytes_of(*args[:4], args[6], args[7], *got),
                          K2_OPS_PER_SYMBOL * symbols, "int32"))


#: The DEVICE route's small streams, K2 against its plain lockstep loop
#: (w, h, factors, ri, seed, gradient): a restart-free gray scan of 17 x 16
#: MCUs of dense blocks, and a gray gradient in two restart segments of
#: 4100 MCUs (ri * P > 4096: past the PALLAS route's 512 MB lockstep bound;
#: each segment two chunks of the dc pass). The plain loop on a 4K
#: restart-free scan would be one lane of some 11 M symbols: never run.
DEVICE_SMALL = {
    "restart-free 136x128 gray": (136, 128, ((1, 1),), 0, 21, False),
    "800x656 gray gradient, two segments of 4100 MCUs": (800, 656, ((1, 1),), 4100, 22, True),
}
#: 4K 4:2:0 segments of three MCU rows: ri * P = 4320 > 4096, refused by
#: the PALLAS route's lockstep bound.
LONG_RI = 3 * RI


def device_inputs(no_dri: bytes, requests, tiled: dict) -> dict:
    """The DEVICE phase's 4K inputs, name -> (stream, the same image with a
    marker per MCU row for the PALLAS route, or None): the dense request
    without markers, bench.py's restart-free input, a photograph tiled to
    4K without markers, a 12-bit restart-free stream, a stream of one
    non-interleaved scan a component, and segments of three MCU rows."""
    from jpeg_decoder_tpu_torch.benchmarks import bench
    from jpeg_decoder_tpu_torch.benchmarks.inputs import (
        PHOTOS_420,
        make_jpeg,
        multiscan_jpeg,
        photo_jpeg,
    )

    photo = PHOTOS_420[0]
    return {
        "dense 4K, restart-free": (no_dri, requests[0]),
        "bench.make_input_nodri": (bench.make_input_nodri(), bench.make_input()),
        f"{photo.name} tiled to 4K, restart-free": (
            photo_jpeg(photo, W, H, 0), tiled[f"photograph {photo.name} tiled to {W}x{H}"]),
        "12-bit dense 4K, restart-free": (make_jpeg(W, H, F420, 0, SEEDS[0], precision=12),
                                          make_jpeg(W, H, F420, RI, SEEDS[0], precision=12)),
        "dense 4K, a scan a component": (multiscan_jpeg(W, H, F420, SEEDS[0]), None),
        f"dense 4K, ri {LONG_RI} (ri * P = {6 * LONG_RI})": (
            make_jpeg(W, H, F420, LONG_RI, SEEDS[0]), requests[0]),
    }


def tail_times(dev, data: bytes, guard, reps: int = 10) -> dict:
    """K2's scan and dc passes as the wrapper picks them (the dc pass in
    chunks; the scan pass a block per segment where every segment is one
    chunk of records, else in chunks), `reps` times on one stream: the
    median ms of each pass (CUDA events inside the call) and of the whole
    call (CUDA events around it, in a call of its own without the pass
    events), and the largest difference of the planes from the native host
    decoder's."""
    from jpeg_decoder_tpu_torch import DecodeConfig, convert
    from jpeg_decoder_tpu_torch.io.parser import parse
    from jpeg_decoder_tpu_torch.models import host
    from jpeg_decoder_tpu_torch.ops import entropy_cuda

    s = parse(data)
    args, host_arrays = entropy_cuda.launch_args(
        [entropy_cuda.prepare_scan(s, s.scans[0], guard)], dev)
    planes = convert.zero_planes(s.frame, dev)
    scan, dc, call = [], [], []
    for _ in range(reps):
        zero_all([planes])
        rec = {}
        entropy_cuda.decode_segments(*args, [planes], records=rec, host=host_arrays)
        scan.append(rec["pass_ms"][2])
        dc.append(rec["pass_ms"][4])
        call.append(cuda_ms(lambda: entropy_cuda.decode_segments(
            *args, [planes], host=host_arrays), 1, before=lambda: zero_all([planes])))
    _, native, _ = host.host_decode(data, DecodeConfig())
    err = max(max_abs_err(a, b) for a, b in zip(planes, native.planes))
    med = statistics.median
    return dict(scan_ms=med(scan), dc_ms=med(dc), call_ms=med(call), scan_all=scan,
                dc_all=dc, call_all=call, max_abs_err=err)


def check_k2d(dev, inputs: dict, dri: bytes, record: dict, card: str) -> None:
    """K2 on the DEVICE route (whole segments, no lane guard): against its
    plain lockstep loop, bitwise, on DEVICE_SMALL, with its records against
    the schedule's model on the CPU and damaged restart-free streams raising
    the plain version's classes; on the 4K inputs of device_inputs, every
    plane bitwise the native host decoder's, with its passes' times beside
    the same image with a marker per MCU row on the PALLAS route; the scan
    and dc passes as the wrapper picks them, timed on the dense 4K request
    with a marker per MCU row and restart-free, their planes bitwise the
    native host decoder's."""
    import torch
    from jpeg_decoder_tpu_torch import DecodeConfig, EntropyBackend, JpegError, convert
    from jpeg_decoder_tpu_torch.benchmarks.inputs import make_jpeg
    from jpeg_decoder_tpu_torch.io.parser import parse
    from jpeg_decoder_tpu_torch.models import host
    from jpeg_decoder_tpu_torch.ops import entropy_cuda, entropy_device

    device_guard = entropy_cuda.check_scan_device
    cfg = DecodeConfig(entropy_backend=EntropyBackend.DEVICE)
    err = 0
    for name, (w, h, factors, ri, seed, gradient) in DEVICE_SMALL.items():
        data = make_jpeg(w, h, factors, ri, seed, gradient=gradient)
        s = parse(data)
        pack = entropy_cuda.prepare_scan(s, s.scans[0], device_guard)
        args, host_arrays = entropy_cuda.launch_args([pack], dev)
        got = convert.zero_planes(s.frame, dev)
        want = convert.zero_planes(s.frame, dev)
        box, rec = {}, {}
        plain_ms = cuda_ms(lambda: box.update(
            st=entropy_cuda._decode_segments_plain(*args, [want])), 1)
        st_k = entropy_cuda.decode_segments(*args, [got], records=rec, host=host_arrays)
        e = max(max_abs_err(st_k, box["st"]), *[max_abs_err(a, b) for a, b in zip(got, want)])
        entropy_cuda.check_status(st_k, args[1])
        ms = cuda_ms(lambda: entropy_cuda.decode_segments(*args, [got], host=host_arrays), 5,
                     before=lambda: zero_all([got]))
        e = max(e, *[max_abs_err(a, b) for a, b in zip(got, want)])
        cpu_args, _ = entropy_cuda.launch_args([pack], "cpu")
        st_m, model = entropy_cuda._decode_segments_subseq_plain(
            *cpu_args, [convert.zero_planes(s.frame, "cpu")])
        e = max(e, max_abs_err(st_k, st_m),
                *[max_abs_err(rec[k], model[k]) for k in ("rec", "used", "first_du")])
        err = max(err, e)
        log(f"K2d (DEVICE route) {name}, {len(pack.bounds)} segment(s) of"
            f" {pack.ri * pack.units.shape[0]} data units: kernel {ms:.3f} ms, plain"
            f" {plain_ms:.1f} ms; max_abs_err {e} (status, planes, records against the"
            f" model, which needs {model['rounds']} rounds); {k2_passes(rec)} [{card}]")
        if e != 0 or not 1 <= rec["rounds"] <= model["rounds"] + 1:
            fail(f"K2d disagrees with its plain version or the model on {name}")
        if "plain_ms" not in record:
            record.update(plain_ms=plain_ms, small_ms=ms,
                          plain_shape=f"{name}: {w}x{h}, {len(pack.bounds)} segment(s)")
        record.setdefault("small", {})[name] = dict(ms=ms, plain_ms=plain_ms)
        if ri == 0:
            for what, (bad, want_error) in damaged_streams(data).items():
                outcomes = []
                for device in (dev, "cpu"):
                    sb = parse(bad)
                    try:
                        entropy_device.decode_scan_device(sb, sb.scans[0],
                                                          convert.zero_planes(sb.frame, device))
                        outcomes.append(None)
                    except JpegError as ex:
                        outcomes.append(type(ex))
                if outcomes != [want_error, want_error]:
                    fail(f"K2d on a damaged restart-free stream ({what}): card and plain"
                         f" version gave {outcomes}, expected {want_error}")
            log("K2d: damaged restart-free streams (bad code, truncated, both) raise the"
                " plain version's error classes on the card")

    # 4K: planes bitwise the native host decoder's; pass times beside PALLAS
    per_input = {}
    for name, (data, twin) in inputs.items():
        s = parse(data)
        recs = []
        planes = convert.zero_planes(s.frame, dev)
        for scan in s.scans:
            rec = {}
            entropy_device.decode_scan_device(s, scan, planes, records=rec)
            recs.append(rec)
        _, native, _ = host.host_decode(data, DecodeConfig())
        e = max(max_abs_err(a, b) for a, b in zip(planes, native.planes))
        err = max(err, e)
        if e != 0:
            fail(f"K2d planes differ from the native host decoder's on {name} (max_abs_err {e})")
        line = "; ".join(k2_passes(r) for r in recs)
        entry = dict(scans=len(recs), segments=[len(r["sub_base"]) - 1 for r in recs],
                     subsequences=[int(r["sub_base"][-1]) for r in recs],
                     pass2_launches=[r["rounds"] for r in recs],
                     pass2_steps=[r["steps"] for r in recs],
                     pass_ms=[r["pass_ms"] for r in recs])
        if twin is not None:
            st = parse(twin)
            args, host_arrays = entropy_cuda.launch_args(
                [entropy_cuda.prepare_scan(st, st.scans[0])], dev)
            rec = {}
            entropy_cuda.decode_segments(*args, [convert.zero_planes(st.frame, dev)],
                                         records=rec, host=host_arrays)
            entry["pallas_twin"] = dict(subsequences=int(rec["sub_base"][-1]),
                                        pass2_launches=rec["rounds"], pass2_steps=rec["steps"],
                                        pass_ms=rec["pass_ms"])
            line += f"; with a marker per MCU row on PALLAS: {k2_passes(rec)}"
        per_input[name] = entry
        log(f"K2d {name} ({len(data)} bytes, {len(recs)} scan(s)): planes bitwise the native"
            f" host decoder's; {line} [{card}]")

    # the scan and dc passes as the wrapper picks them
    tails = {"dense 4K, a marker per MCU row (PALLAS)": tail_times(dev, dri,
                                                                   entropy_cuda.check_scan),
             "dense 4K, restart-free (DEVICE)": tail_times(
                 dev, inputs["dense 4K, restart-free"][0], device_guard)}
    for name, t in tails.items():
        err = max(err, t["max_abs_err"])
        log(f"K2 scan and dc passes, {name}, as the wrapper picks them: scan"
            f" {t['scan_ms']:.4f} ms, dc {t['dc_ms']:.4f} ms, the call {t['call_ms']:.4f} ms"
            f" (medians of {len(t['scan_all'])}; scan"
            f" {min(t['scan_all']):.4f}-{max(t['scan_all']):.4f}); planes against the native"
            f" host decoder's max_abs_err {t['max_abs_err']} [{card}]")
        if t["max_abs_err"] != 0:
            fail(f"K2's planes differ from the native host decoder's on {name}")

    # the record: K2d at 4K on the dense restart-free request
    data = inputs["dense 4K, restart-free"][0]
    s = parse(data)
    args, host_arrays = entropy_cuda.launch_args(
        [entropy_cuda.prepare_scan(s, s.scans[0], device_guard)], dev)
    got = convert.zero_planes(s.frame, dev)
    ms = cuda_ms(lambda: entropy_cuda.decode_segments(*args, [got], host=host_arrays), 5,
                 before=lambda: zero_all([got]))
    n_blocks = sum(p.shape[0] * p.shape[1] for p in got)
    symbols = 2 * n_blocks + sum(int(torch.count_nonzero(p[..., 1:])) for p in got)
    first = per_input["dense 4K, restart-free"]
    record.update(max_abs_err=err, ms=ms, library_ms=None, symbols=symbols,
                  shape=f"{W}x{H} 4:2:0, restart-free (one segment)",
                  subsequences=first["subsequences"][0], pass2_launches=first["pass2_launches"][0],
                  pass2_steps=first["pass2_steps"][0], pass_ms=first["pass_ms"][0],
                  inputs=per_input, tail_times=tails,
                  **bound(nbytes_of(*args[:4], args[6], args[7], *got),
                          K2_OPS_PER_SYMBOL * symbols, "int32"))
    log(f"K2d at 4K restart-free: {ms:.3f} ms one call, bound {record['bound_ms']:.4f} ms by"
        f" {record['bound_by']} [{card}]")


def check_k2_batch(dev, batch: list, smalls: list, record: dict) -> None:
    """Batched K2, bitwise: the eight 4K requests in one launch against
    eight single-image launches and the native host planes; four 640x352
    streams in one launch against the batched plain version."""
    from jpeg_decoder_tpu_torch import DecodeConfig, convert
    from jpeg_decoder_tpu_torch.models import host
    from jpeg_decoder_tpu_torch.ops import entropy_cuda
    from jpeg_decoder_tpu_torch.io.parser import parse

    structures = [parse(d) for d in batch]
    args, host_arrays = entropy_cuda.launch_args(
        [entropy_cuda.prepare_scan(s, s.scans[0]) for s in structures], dev)
    got = [convert.zero_planes(s.frame, dev) for s in structures]
    rec = {}
    entropy_cuda.check_status(
        entropy_cuda.decode_segments(*args, got, records=rec, host=host_arrays), args[1])
    ms = cuda_ms(lambda: entropy_cuda.decode_segments(*args, got, host=host_arrays), 5,
                 before=lambda: zero_all(got))
    err, single_ms = 0, []
    for data, s, planes in zip(batch, structures, got):
        a1, h1 = entropy_cuda.launch_args([entropy_cuda.prepare_scan(s, s.scans[0])], dev)
        one = convert.zero_planes(s.frame, dev)
        single_ms.append(cuda_ms(lambda: entropy_cuda.check_status(
            entropy_cuda.decode_segments(*a1, [one], host=h1), a1[1]), 1))
        _, native, _ = host.host_decode(data, DecodeConfig())
        err = max(err, *[max_abs_err(a, b) for a, b in zip(planes, one)],
                  *[max_abs_err(a, b) for a, b in zip(planes, native.planes)])
    n_segs = len(host_arrays.seg_bound) - 1
    log(f"K2 batched: kernel {ms:.3f} ms for {len(batch)} x {W}x{H} 4:2:0 in one"
        f" launch ({n_segs} segments), {ms / len(batch):.3f} ms per image;"
        f" single-image launches {[round(t, 3) for t in single_ms]} ms;"
        f" max_abs_err {err} (against the single launches and the native planes);"
        f" {k2_passes(rec)}")

    structures = [parse(d) for d in smalls]
    sargs, shost = entropy_cuda.launch_args(
        [entropy_cuda.prepare_scan(s, s.scans[0]) for s in structures], dev)
    sseg = sargs[1]
    gk = [convert.zero_planes(s.frame, dev) for s in structures]
    gp = [convert.zero_planes(s.frame, dev) for s in structures]
    # without the host's copies: the wrapper reads its arguments back
    st_k = entropy_cuda.decode_segments(*sargs, gk)
    box = {}
    plain_ms = cuda_ms(lambda: box.update(
        st=entropy_cuda._decode_segments_plain(*sargs, gp)), 1)
    entropy_cuda.check_status(st_k, sseg)
    small_ms = cuda_ms(lambda: entropy_cuda.decode_segments(*sargs, gk, host=shost), 5,
                       before=lambda: zero_all(gk))
    e2 = max(max_abs_err(st_k, box["st"]),
             *[max_abs_err(a, b) for x, y in zip(gk, gp) for a, b in zip(x, y)])
    log(f"K2 batched: kernel {small_ms:.3f} ms, plain {plain_ms:.1f} ms"
        f" ({len(smalls)} x {SMALL[0]}x{SMALL[1]} 4:2:0, {sseg.numel() - 1}"
        f" segments); max_abs_err {e2}")
    err = max(err, e2)
    if err != 0:
        fail(f"batched K2 disagrees (max_abs_err {err}; tolerance 0)")
    record["max_abs_err"] = max(record["max_abs_err"], err)
    record.update(batch_ms=ms, batch_shape=f"{len(batch)} x {W}x{H} 4:2:0, {n_segs} segments",
                  batch_small_ms=small_ms, batch_small_plain_ms=plain_ms,
                  batch_subsequences=int(rec["sub_base"][-1]),
                  batch_pass2_launches=rec["rounds"], batch_pass2_steps=rec["steps"],
                  batch_pass_ms=rec["pass_ms"])


def size_weighted(kernels: dict) -> None:
    """The work of K0, K1, K3, K3f, K3c, K4 and K5 on the main paths in 4K
    units (UNIT_BLOCKS coefficient blocks or UNIT_PIXELS output pixels: one
    3840x2160 4:2:0 request), and the time each lost there: units x (the
    card-alone time of one unit - its bound). K1's unit time is the 4K
    request's three planes; K4's the 4K 4:2:0 photograph's encode, which
    also weighs its 4:4:4 launch (two units); K5's its time at the path's
    scale over the request's three planes; K3's the 4K 4:2:0
    nearest-neighbour one, which also weighs its gray and scaled launches,
    while its K3c launches count at K3c's times, per transform (the YCCK
    paths at YCCK EXACT's, the CMYK ones at CMYK's). Striped launches of
    K3/K3f count under K6n/K6f, not here."""
    units_of = {"jdtc_idct_exact": UNIT_BLOCKS, "jdtc_idct_float": UNIT_BLOCKS,
                "jdtc_color": UNIT_PIXELS, "jdtc_fancy": UNIT_PIXELS, "jdtc_fdct": UNIT_BLOCKS}
    for key, per in units_of.items():
        rec = kernels[key]
        by_path = {p: u[key] / per for p, u in PATH_UNITS.items() if key in u}
        unit_ms = rec.get("request_card_ms", rec["ms"])
        unit_bound = rec.get("request_bound_ms", rec["bound_ms"])
        rec["units_4k"] = sum(by_path.values())
        rec["units_4k_by_path"] = by_path
        rec["lost_ms"] = rec["units_4k"] * (unit_ms - unit_bound)
    k3c = kernels["K3c"]
    by_path = {p: u["jdtc_color"] / UNIT_PIXELS for p, u in PATH_UNITS.items()
               if "jdtc_color" in u and any(w in p for w in k3c["on_paths"])}
    k3c["units_4k"] = sum(by_path.values())
    k3c["units_4k_by_path"] = by_path
    k3c["lost_ms"] = sum(n * (k3c["ms_by_transform"]["CMYK" if "cmyk" in p else "YCCK EXACT"]
                              - k3c["bound_ms"]) for p, n in by_path.items())
    k3 = kernels["jdtc_color"]
    k3["lost_ms"] = (k3["units_4k"] - k3c["units_4k"]) * (k3["ms"] - k3["bound_ms"]) + k3c[
        "lost_ms"]
    k5 = kernels["jdtc_idct_scaled"]
    by_path = {p: u["jdtc_idct_scaled"] / UNIT_BLOCKS for p, u in PATH_UNITS.items()
               if "jdtc_idct_scaled" in u}
    k5["units_4k"] = sum(by_path.values())
    k5["units_4k_by_path"] = by_path
    k5["lost_ms"] = 0.0
    for p, n in by_path.items():
        at_k = k5["by_k"][int(p.rsplit("scale ", 1)[1].split()[0])]
        k5["lost_ms"] += n * (at_k["ms"] - at_k["bound_ms"])
    log("lost on the main paths, 4K units x (time - bound): " + ", ".join(
        f"{kernels[k]['name']} {kernels[k]['units_4k']:.2f} units, {kernels[k]['lost_ms']:.3f} ms"
        for k in (*units_of, "K3c", "jdtc_idct_scaled")))


def check_k2_photographs(dev, files: dict, tiled: dict, record: dict) -> None:
    """K2 on real blocks (an end-of-block code in nine of ten, where chains
    from wrong starts fall into step within a few blocks), planes bitwise
    against the native host decoder's, with the passes. `files`: streams as
    a foreign encoder wrote them; the one of short segments also against the
    plain version, status and planes (on the others its lockstep lanes would
    take ten seconds to a minute). `tiled`: photographs' coefficients at
    4K."""
    from jpeg_decoder_tpu_torch import DecodeConfig, convert
    from jpeg_decoder_tpu_torch.benchmarks import inputs
    from jpeg_decoder_tpu_torch.models import host
    from jpeg_decoder_tpu_torch.ops import entropy_cuda
    from jpeg_decoder_tpu_torch.io.parser import parse

    record["photographs"] = {}
    for name, data in {**files, **tiled}.items():
        s = parse(data)
        args, host_arrays = entropy_cuda.launch_args(
            [entropy_cuda.prepare_scan(s, s.scans[0])], dev)
        got = convert.zero_planes(s.frame, dev)
        rec = {}
        st_k = entropy_cuda.decode_segments(*args, [got], records=rec, host=host_arrays)
        entropy_cuda.check_status(st_k, args[1])
        ms = cuda_ms(lambda: entropy_cuda.decode_segments(*args, [got], host=host_arrays), 5,
                     before=lambda: zero_all([got]))
        _, native_planes, _ = host.host_decode(data, DecodeConfig())
        err = max(max_abs_err(a, b) for a, b in zip(got, native_planes.planes))
        against = "the native host decoder's planes"
        if name in files and s.scans[0].restart_interval < 8:
            want = convert.zero_planes(s.frame, dev)
            st_p = entropy_cuda._decode_segments_plain(*args, [want])
            err = max(err, max_abs_err(st_k, st_p),
                      *[max_abs_err(a, b) for a, b in zip(got, want)])
            against = "the plain version's status and planes and " + against
        stats = inputs.block_stats(data)
        log(f"K2 entropy, {name}: kernel {ms:.3f} ms ({s.frame.width}x{s.frame.height},"
            f" {len(host_arrays.seg_bound) - 1} segments, {stats['scan_bytes']} bytes,"
            f" {stats['nonzero_ac_per_block']} nonzero AC and {stats['bits_per_block']} bits"
            f" a block, an EOB in {stats['share_blocks_with_eob']:.4f} of the blocks);"
            f" max_abs_err {err} (against {against}); {k2_passes(rec)}")
        if err != 0:
            fail(f"K2 disagrees on {name} (max_abs_err {err}; tolerance 0)")
        record["max_abs_err"] = max(record["max_abs_err"], err)
        record["photographs"][name] = dict(
            ms=ms, subsequences=int(rec["sub_base"][-1]), pass2_launches=rec["rounds"],
            pass2_steps=rec["steps"], pass_ms=rec["pass_ms"], **stats)


def check_k2u(dev, small: bytes, big: bytes, no_dri: bytes, batch: list, record: dict,
              card: str) -> None:
    """K2u (the single pass and its sub_base kernel) against its plain
    version on the card and against the host's per-segment unstuffing
    (pack_scan), bitwise, stream, offsets and K2's layout: a 640x352
    stream, the 4K request and the eight 4K requests of a batch in one
    call. Each also timed by benchmarks/k2u_sweep.measure: the card alone,
    a device-to-device copy of the raw bytes, raw[keep] as one PyTorch
    call and one call of the wrapper between events. Then K2u without
    bounds, as a DEVICE request launches it (check_k2u_find), on the 4K
    request restart-free and with a marker per MCU row; then the kernels'
    registers and shared memory (nvcc -Xptxas -v)."""
    from jpeg_decoder_tpu_torch.benchmarks import k2u_sweep
    from jpeg_decoder_tpu_torch.ops import entropy_cuda
    from jpeg_decoder_tpu_torch.io.parser import parse

    err = 0
    for datas in ([small], [big], batch):
        structures = [parse(d) for d in datas]
        packs = [entropy_cuda.prepare_scan(s, s.scans[0]) for s in structures]
        raw, lo, hi, *_ = entropy_cuda.to_device(entropy_cuda.host_args(packs), dev)
        got = entropy_cuda.unstuff_segments(raw, lo, hi)
        box = {}
        plain_ms = cuda_ms(lambda: box.update(p=entropy_cuda._unstuff_plain(raw, lo, hi)), 3)
        # the host's: every image's segments unstuffed one by one
        t0 = time.perf_counter()
        host = [entropy_cuda.pack_scan(s, s.scans[0], p.total_mcus, p.units.shape[0])
                for s, p in zip(structures, packs)]
        host_ms = (time.perf_counter() - t0) * 1e3
        stream = np.concatenate([st[: so[-1]] for _ri, st, so in host]
                                + [np.zeros(8, dtype=np.uint8)])
        ends = np.cumsum([0] + [int(so[-1]) for _ri, _st, so in host])
        seg_off = np.concatenate([[0]] + [so[1:] + e for (_ri, _st, so), e in zip(host, ends)])
        end = len(stream)   # the bytes defined: the segments and the tail
        want = box["p"]
        e = max(max_abs_err(got.stream[:end], want.stream[:end]),
                max_abs_err(got.seg_off, want.seg_off), max_abs_err(got.sub_base, want.sub_base),
                max_abs_err(got.stream[:end], stream), max_abs_err(got.seg_off, seg_off),
                max_abs_err(got.sub_base, entropy_cuda.sub_layout(seg_off)))
        err = max(err, e)
        shape = f"{len(datas)} x {structures[0].frame.width}x{structures[0].frame.height}"
        m = k2u_sweep.measure(shape, raw, lo, hi, 7, card)
        bnd = bound(m["bound_bytes"], 3 * raw.numel(), "int32")
        log(f"K2u unstuff ({shape}: {raw.numel()} raw bytes, {lo.numel()} segments,"
            f" {raw.numel() - end + 8} bytes dropped): the card alone {m['card_ms']:.4f} ms;"
            f" a D2D copy of the raw bytes {m['copy_card_ms']:.4f} ms, raw[keep]"
            f" {m['compaction_ms']:.4f} ms (one call, it synchronises); one call between"
            f" events {m['wrapper_ms']:.4f} ms; plain {plain_ms:.3f} ms, the host's"
            f" per-segment unstuffing {host_ms:.1f} ms; bound {bnd['bound_ms']:.4f} ms;"
            f" max_abs_err {e} [{card}]")
        if datas[0] is big and len(datas) == 1:
            # Bound: the raw bytes and bounds read once, the stream and its
            # offsets written once; per raw byte a compare with 0x00, one
            # with 0xFF and the add of the prefix sum.
            record.update(ms=m["card_ms"], copy_ms=m["copy_card_ms"],
                          compaction_ms=m["compaction_ms"], call_ms=m["wrapper_ms"],
                          plain_ms=plain_ms, library_ms=None,
                          shape=f"{raw.numel()} raw bytes, {lo.numel()} segments", **bnd)
        elif len(datas) > 1:
            record.update(batch_ms=m["card_ms"], batch_copy_ms=m["copy_card_ms"],
                          batch_compaction_ms=m["compaction_ms"], batch_plain_ms=plain_ms,
                          batch_bound_ms=bnd["bound_ms"],
                          batch_shape=f"{raw.numel()} raw bytes, {lo.numel()} segments")
    for key, data in (("find", no_dri), ("find_dri", big)):
        err = max(err, check_k2u_find(dev, key, data, record, card))
    record["max_abs_err"] = err
    record["ptxas"] = k2u_sweep.ptxas_report()
    log(f"K2u registers and shared memory (nvcc -Xptxas -v): {record['ptxas']}")


def check_k2u_find(dev, key: str, data: bytes, record: dict, card: str) -> int:
    """K2u without bounds (find_segments, unstuff_kernel<true>) on a 4K
    request's bytes from its first entropy byte to the end of the file,
    bitwise against its plain version (_find_plain): every entry of `ends`
    the kernel defines (the offsets of the segments found, the end of the
    kept bytes, the count found, where the scan ended), the stream up to
    its tail and sub_base; the count found must be the header's and the
    end the full parse's (its scan span's). Timed the card alone; its bound is its bytes. Recorded
    under `key`; returns the largest difference (fails on any)."""
    import torch
    from jpeg_decoder_tpu_torch.benchmarks.pixel_sweep import card_ms
    from jpeg_decoder_tpu_torch.io.parser import parse
    from jpeg_decoder_tpu_torch.ops import entropy_cuda

    span = parse(data).scans[0].span
    n = span.num_segments
    raw = torch.frombuffer(bytearray(data[span.start:]), dtype=torch.uint8).to(dev)
    got, ends = entropy_cuda.find_segments(raw, n)
    want, want_ends = entropy_cuda._find_plain(raw, n)
    ends, want_ends = ends.cpu().numpy(), want_ends.cpu().numpy()
    found, final = int(want_ends[n + 1]), int(want_ends[n]) + 8
    defined = [*range(min(found, n)), n, n + 1, n + 2]
    e = max(max_abs_err(ends[defined], want_ends[defined]),
            max_abs_err(got.stream[:final], want.stream[:final]),
            max_abs_err(got.sub_base, want.sub_base))
    if e or found != n or int(ends[n + 2]) != span.end - span.start:
        fail(f"K2u without bounds ({key}): {found} of {n} segments, the end at"
             f" {int(ends[n + 2])} (the parse's at {span.end - span.start}), max_abs_err {e}")
    ms = card_ms(lambda: entropy_cuda.find_segments(raw, n), 7)
    # Bound: the raw bytes read once, the stream, its offsets, the counts
    # and K2's layout written once; per raw byte the compares with 0x00,
    # 0xFF and D0-D7 and the add of the prefix sum.
    bnd = bound(raw.numel() + final + 8 * (2 * n + 4), 4 * raw.numel(), "int32")
    record.update({f"{key}_ms": ms, f"{key}_bound_ms": bnd["bound_ms"],
                   f"{key}_shape": f"{raw.numel()} raw bytes to the end of the file, {n} segments"})
    log(f"K2u without bounds ({key}: {raw.numel()} bytes to the end of the file, {n} segments"
        f" found, {raw.numel() - final + 8} bytes dropped): the card alone {ms:.4f} ms; bound"
        f" {bnd['bound_ms']:.4f} ms; max_abs_err {e} [{card}]")
    return e


def check_k0(dev, big: bytes, cmyk: bytes, record: dict, card: str) -> None:
    """K0 bitwise against its plain version: the 4K request's three planes,
    random +-2048 coefficients x a table of 255 at the luma shape, 8- and
    12-bit, the 4K 4:4:4 four-component frame's four planes, and ragged
    shapes (one block wide, an odd width, a block count that is not a
    multiple of the CTA's 128, a stacked batch, 12-bit). Its time is the
    request's (three launches), the card alone and with L2 flushed
    (pixel_sweep.k0_turns); the F2F conversions a block in its SASS."""
    import torch
    from jpeg_decoder_tpu_torch import DecodeConfig, convert
    from jpeg_decoder_tpu_torch.benchmarks import pixel_sweep
    from jpeg_decoder_tpu_torch.models import host
    from jpeg_decoder_tpu_torch.ops import idct

    frame, planes, qts = host.host_decode(big, DecodeConfig())
    coeffs = [torch.from_numpy(p).to(dev) for p in planes.planes]
    tables = [convert.quant_table_to_device(qts[c.qtid], dev) for c in frame.components]
    cframe, cplanes, cqts = host.host_decode(cmyk, DecodeConfig())
    cases = {f"the {W}x{H} 4:2:0 request's plane {k}": (c, q, False)
             for k, (c, q) in enumerate(zip(coeffs, tables))}
    for k, (c, comp) in enumerate(zip(cplanes.planes, cframe.components)):
        cases[f"the {W}x{H} 4:4:4 four-component frame's plane {k}"] = (
            torch.from_numpy(c).to(dev), convert.quant_table_to_device(cqts[comp.qtid], dev),
            False)
    rng = np.random.default_rng(7)
    wild = torch.from_numpy(rng.integers(-2048, 2049, coeffs[0].shape, dtype=np.int16)).to(dev)
    q255 = convert.quant_table_to_device(np.full(64, 255), dev)
    cases["+-2048 x 255 at the luma shape, 8-bit"] = (wild, q255, False)
    cases["+-2048 x 255 at the luma shape, 12-bit"] = (wild, q255, True)
    qr = convert.quant_table_to_device(rng.integers(1, 256, 64), dev)
    for name, dims in (("one block wide", (37, 1)), ("an odd width", (19, 33)),
                       ("350 blocks", (7, 50)), ("a stacked batch of three", (3, 17, 12))):
        c = torch.from_numpy(rng.integers(-2048, 2049, (*dims, 64), dtype=np.int16)).to(dev)
        cases[f"{name} {dims}, 8-bit"] = (c, qr, False)
        cases[f"{name} {dims}, 12-bit"] = (c, qr, True)
    err = 0
    for name, (c, q, bits12) in cases.items():
        got = idct.idct_plane(c, q, bits12)
        e = max_abs_err(got, pixel_sweep.k0_plain(c, q, bits12))
        if e:
            log(f"K0 idct_exact, {name}: max_abs_err {e} against its plain version")
        err = max(err, e)
    log(f"K0 idct_exact: max_abs_err {err} against its plain version on {len(cases)} planes"
        f" ({', '.join(cases)})")
    turns = pixel_sweep.k0_turns(coeffs, tables, 7)
    ms = cuda_ms(lambda: [idct.idct_plane(c, q) for c, q in zip(coeffs, tables)], 10)
    plain_ms = cuda_ms(lambda: [pixel_sweep.k0_plain(c, q) for c, q in zip(coeffs, tables)], 3)
    blocks = turns["blocks"]
    mix = pixel_sweep.sass_mix()
    f2f = mix.get("idct_exact_kernel", {}).get("F2F")
    regs = mix.get("resources", {}).get("idct_exact_kernel")
    # Bound: int16 coefficients and the tables in, uint8 pixels out; 511
    # float64 operations a block (the chain's products and sums: 31 in each
    # of 16 passes and 15 in the pre-scale, csrc/idct_exact.cuh).
    bnd = bound(nbytes_of(*coeffs, *tables) + blocks * 64, 511 * blocks, "float64")
    record.update(max_abs_err=err, ms=turns["card_ms"], ms_one_call=ms,
                  plain_ms=plain_ms, library_ms=None, **turns, f2f_a_block=f2f, resources=regs,
                  shape=f"3 planes of the {W}x{H} 4:2:0 request, {blocks} blocks", **bnd)
    log(f"K0 idct_exact ({record['shape']}): {times_line(turns)}; one call {ms:.3f} ms; plain"
        f" {plain_ms:.3f} ms; bound {bnd['bound_ms']:.4f} ms by {bnd['bound_by']}; F2F a block"
        f" {f2f}; resources {regs} [{card}]")


def _random_blocks(rng, shape, lo=-1024, hi=1024):
    """The JAX tests' _random_blocks: uniform coefficients with a random
    zero suffix per block."""
    blocks = rng.integers(lo, hi, (*shape, 64))
    cut = rng.integers(1, 64, shape)
    return np.where(np.arange(64) < cut[..., None], blocks, 0).astype(np.int16)


def sass_of(mix: dict, kernels) -> dict:
    """LDS and FFMA of each kernel in pixel_sweep.sass_mix's counts (the
    instructions of its code as written)."""
    return {k: {op: mix.get(k, {}).get(op) for op in ("LDS", "FFMA")} for k in kernels}


def check_k1(dev, big: bytes, record: dict, card: str) -> None:
    """K1 against its plain version at the 4K luma shape (270x480 blocks)
    and on ragged shapes (one block wide, an odd width, a block count that
    is not a multiple of the 64-block tile, a stacked batch), 8- and
    12-bit: within 1 on at most K1_SHARE of the pixels. Also the request's
    own luma plane against EXACT (K0), and the error on extreme inputs,
    which is reported and not gated. Its time on the luma plane and over
    the request's three planes (the fancy FLOAT32 route's launches), the
    card alone and with L2 flushed (pixel_sweep.k1_turns), beside the
    product alone as one cuBLAS call at the same shapes; LDS and FFMA in
    its SASS."""
    import torch
    from jpeg_decoder_tpu_torch import DecodeConfig, IdctPrecision, convert
    from jpeg_decoder_tpu_torch.benchmarks import pixel_sweep
    from jpeg_decoder_tpu_torch.models import host
    from jpeg_decoder_tpu_torch.ops import idct
    from jpeg_decoder_tpu_torch.core import types

    f32 = IdctPrecision.FLOAT32
    _, planes, _ = host.host_decode(big, DecodeConfig())
    by, bx, _ = planes.planes[0].shape
    qt = convert.quant_table_to_device(types.standard_luminance_qtable(), dev)
    rng = np.random.default_rng(85)
    blocks = torch.from_numpy(_random_blocks(rng, (by, bx))).to(dev)

    err, share = 0, 0.0
    for bits12 in (False, True):
        got = idct.idct_plane(blocks, qt, bits12, f32)
        want = pixel_sweep.k1_plain(blocks, qt, bits12)
        e, sh = max_abs_err(got, want), share_differing(got, want)
        exact = idct.idct_plane(blocks, qt, bits12)
        log(f"K1 idct_float: {'12' if bits12 else '8'}-bit random blocks: against"
            f" plain max_abs_err {e}, share differing {sh:.3e}; against EXACT (K0)"
            f" max_abs_err {max_abs_err(got, exact)}, share {share_differing(got, exact):.3e}")
        err, share = max(err, e), max(share, sh)
    luma = torch.from_numpy(planes.planes[0]).to(dev)
    got = idct.idct_plane(luma, qt, False, f32)
    e_exact = max_abs_err(got, idct.idct_plane(luma, qt))
    log(f"K1 idct_float: 4K request luma plane against EXACT (K0): max_abs_err"
        f" {e_exact}, share {share_differing(got, idct.idct_plane(luma, qt)):.3e};"
        f" against plain max_abs_err {max_abs_err(got, pixel_sweep.k1_plain(luma, qt, False))}")
    if e_exact > 1:
        fail(f"K1 is more than 1 from EXACT on a 4K request ({e_exact})")
    # extremes, reported: +-2048 x qt 255; 12-bit pixels near the int16 wrap
    q255 = convert.quant_table_to_device(np.full(64, 255), dev)
    wild = torch.from_numpy(rng.integers(-2048, 2049, (by, bx, 64)).astype(np.int16)).to(dev)
    near = rng.integers(-20, 21, (by, bx, 64))
    # a DC-only block's pixels are dc * qt / 8, so dc * 255 / 8 + 2048
    # straddles the wrap at 32768 for dc in [930, 1000)
    near[..., 0] = rng.integers(930, 1000, (by, bx))
    near = torch.from_numpy(near.astype(np.int16)).to(dev)
    for label, c, bits12 in (("+-2048 x qt 255, 8-bit", wild, False),
                             ("near the int16 wrap, 12-bit", near, True)):
        got = idct.idct_plane(c, q255, bits12, f32)
        log(f"K1 idct_float extremes ({label}): against plain max_abs_err"
            f" {max_abs_err(got, pixel_sweep.k1_plain(c, q255, bits12))}, share"
            f" {share_differing(got, pixel_sweep.k1_plain(c, q255, bits12)):.3e}; against EXACT"
            f" max_abs_err {max_abs_err(got, idct.idct_plane(c, q255, bits12))} (not gated)")
    qr = convert.quant_table_to_device(rng.integers(1, 256, 64), dev)
    for dims in ((37, 1), (19, 33), (7, 50), (3, 17, 12)):
        c = torch.from_numpy(_random_blocks(rng, dims)).to(dev)
        for bits12 in (False, True):
            got = idct.idct_plane(c, qr, bits12, f32)
            want = pixel_sweep.k1_plain(c, qr, bits12)
            err = max(err, max_abs_err(got, want))
            share = max(share, share_differing(got, want))

    frame, _, qts = host.host_decode(big, DecodeConfig())
    request = [(torch.from_numpy(p).to(dev), convert.quant_table_to_device(qts[c.qtid], dev))
               for p, c in zip(planes.planes, frame.components)]
    turns = pixel_sweep.k1_turns([luma], [qt], 7)
    req_turns = pixel_sweep.k1_turns([c for c, _ in request], [q for _, q in request], 7)
    ms = cuda_ms(lambda: idct.idct_plane(blocks, qt, False, f32), 10)
    plain_ms = cuda_ms(lambda: pixel_sweep.k1_plain(blocks, qt, False), 3)
    exact_ms = cuda_ms(lambda: idct.idct_plane(blocks, qt), 10)
    # the product alone at K1's own shapes, [N, 64] x [64, 64], as one
    # cuBLAS call (TF32 off), the card alone: the luma plane, and the
    # request's three planes' blocks stacked
    matmul_ms = pixel_sweep.product_ms([luma], [qt], 7)
    request_matmul_ms = pixel_sweep.product_ms([c for c, _ in request],
                                               [q for _, q in request], 7)
    sass = sass_of(pixel_sweep.sass_mix(), ("idct_float_kernel",))
    # Bound: int16 coefficients and the table in, uint8 pixels out; the
    # [64] x [64, 64] product is 4096 FMAs a block, two float32 operations
    # each. No one PyTorch call computes dequant, product, floor, level
    # shift, clamp and block scatter.
    n_req = sum(c[..., 0].numel() for c, _ in request)
    req_bound = bound(nbytes_of(*[c for c, _ in request]) + 64 * n_req, 2 * 4096 * n_req,
                      "float32")["bound_ms"]
    record.update(max_abs_err=err, share_differing=share,
                  ms=turns["card_ms"], ms_one_call=ms, plain_ms=plain_ms,
                  **turns, request_card_ms=req_turns["card_ms"],
                  request_turns=req_turns, request_bound_ms=req_bound, library_ms=None,
                  matmul_ms=matmul_ms, request_matmul_ms=request_matmul_ms, sass=sass,
                  shape=f"luma plane {by}x{bx} blocks",
                  **bound(nbytes_of(luma, qt) + by * bx * 64, 2 * 4096 * by * bx, "float32"))
    log(f"K1 idct_float (luma plane, {by * bx} blocks): {times_line(turns)}; the product alone"
        f" (torch.matmul [{by * bx}, 64] x [64, 64], TF32 off; the card alone) {matmul_ms:.4f}"
        f" ms; bound {record['bound_ms']:.4f} ms [{card}]")
    log(f"K1 idct_float (the 4K request's three planes, {n_req} blocks): {times_line(req_turns)};"
        f" the product alone {request_matmul_ms:.4f} ms; bound {req_bound:.4f} ms [{card}]")
    log(f"K1 idct_float: one call {ms:.3f} ms, plain {plain_ms:.3f} ms, K0 on the same blocks"
        f" {exact_ms:.3f} ms ({record['shape']}); max_abs_err {err}, share differing"
        f" {share:.3e} (8-bit, 12-bit, ragged shapes); LDS and FFMA in the SASS {sass}")
    if err > 1 or share > K1_SHARE:
        fail(f"K1 disagrees with its plain version (max_abs_err {err}, share"
             f" {share:.3e}; tolerance 1 on at most {K1_SHARE})")


def check_k3(dev, big: bytes, gray: bytes, record: dict, card: str) -> None:
    """K3 bitwise against its plain version on the 4K request's planes and
    the gray one, both quirks, single and a batch of four; its time the
    card alone and with L2 flushed on the 4K 4:2:0 planes
    (pixel_sweep.colour_turns)."""
    import torch
    from jpeg_decoder_tpu_torch import Quirks
    from jpeg_decoder_tpu_torch.benchmarks import pixel_sweep
    from jpeg_decoder_tpu_torch.ops import color

    err = 0
    for data, w, h, factors in ((big, W, H, F420), (gray, GRAY[0], GRAY[1], ((1, 1),))):
        _, pix, _ = reference(data, Quirks.REFERENCE)
        planes = [torch.from_numpy(p).to(dev) for p in pix]
        # a batch of four: the image and three rolled copies
        stacked = [torch.stack([p, *(torch.roll(p, 17 * k, 1) for k in (1, 2, 3))])
                   for p in planes]
        for q in (Quirks.REFERENCE, Quirks.CORRECT):
            for ps in (planes, stacked):
                got = color.planes_to_rgb(ps, h, w, factors, q)
                err = max(err, max_abs_err(got, color._planes_to_rgb_plain(ps, h, w, factors, q)))
        if data is big:
            args = (planes, h, w, factors, Quirks.REFERENCE)
            ms = cuda_ms(lambda: color.planes_to_rgb(*args), 10)
            plain_ms = cuda_ms(lambda: color._planes_to_rgb_plain(*args), 3)
            turns = pixel_sweep.colour_turns(planes, h, w, factors, 7)
            # Bound: the three planes in, 3 bytes a pixel out; two index
            # products and ten float32 operations a pixel.
            bnd = bound(nbytes_of(*planes) + 3 * h * w, 14 * h * w, "float32")
    record.update(max_abs_err=err, ms=turns["card_ms"], ms_one_call=ms,
                  plain_ms=plain_ms, library_ms=None, shape=f"{W}x{H} 4:2:0 planes", **turns,
                  **bnd)
    log(f"K3 color: max_abs_err {err} against its plain version (both quirks, gray shear,"
        f" single and batched)")
    log(f"K3 color ({record['shape']}): {times_line(turns)}; one call {ms:.3f} ms, plain"
        f" {plain_ms:.3f} ms; bound {bnd['bound_ms']:.4f} ms by {bnd['bound_by']} [{card}]")


def k03_cases(dev, requests, tiled: dict, photos: dict) -> dict:
    """K03's inputs: name -> (frame, coefficient planes, tables) on the card,
    as the native host decoder reads each stream, and random 12-bit planes
    at the 4K shape; "batch of four" stacks four requests' planes."""
    import dataclasses

    import torch
    from jpeg_decoder_tpu_torch import convert
    from jpeg_decoder_tpu_torch.benchmarks import pixel_sweep

    cases = {f"dense {W}x{H} 4:2:0 request": pixel_sweep.decoded(requests[:1], dev)}
    for name, data in {**tiled, **photos}.items():
        cases[name] = pixel_sweep.decoded([data], dev)
    frame, planes, _ = cases[f"dense {W}x{H} 4:2:0 request"]
    rng = np.random.default_rng(12)
    wide = []
    for p in planes:
        blocks = rng.integers(-8192, 8192, p.shape)
        cut = rng.integers(1, 65, p.shape[:-1])
        wide.append(torch.from_numpy(
            np.where(np.arange(64) < cut[..., None], blocks, 0).astype(np.int16)).to(dev))
    cases[f"random 12-bit planes at {W}x{H} 4:2:0"] = (
        dataclasses.replace(frame, precision=12), wide,
        [convert.quant_table_to_device(rng.integers(1, 256, 64), dev) for _ in range(3)])
    cases[f"batch of four {W}x{H} 4:2:0 requests"] = pixel_sweep.decoded(requests[:4], dev)
    return cases


def check_k03(dev, cases: dict, batch: list, record: dict, card: str) -> None:
    """K03 bitwise against its plain version and against K0 x 3 + K3 on
    every case, both quirks, with and without planes; then its time beside
    theirs (in turns: K0 x 3 + K3, K03, K03, K0 x 3 + K3) on the dense 4K
    request with planes (JpegDecoder's call) and on eight 4K requests
    without (BatchDecoder's), one call between CUDA events and, the card
    alone, eight calls queued behind a spin kernel (pixel_sweep.card_ms);
    then the sweep of G."""
    from jpeg_decoder_tpu_torch import Quirks
    from jpeg_decoder_tpu_torch.benchmarks import pixel_sweep
    from jpeg_decoder_tpu_torch.ops import pixel

    err = 0
    for name, (frame, planes, qts) in cases.items():
        e = 0
        for quirks in (Quirks.REFERENCE, Quirks.CORRECT):
            plain = pixel._pixel_exact_plain(planes, qts, frame, quirks)
            old = pixel_sweep.k0_k3(planes, qts, frame, quirks)
            for want in (True, False):
                rgb, pix = pixel.pixel_exact(planes, qts, frame, quirks, want)
                e = max(e, max_abs_err(rgb, plain[0]), max_abs_err(rgb, old[0]))
                if want:
                    e = max(e, *[max_abs_err(a, b) for a, b in zip(pix, plain[1])],
                            *[max_abs_err(a, b) for a, b in zip(pix, old[1])])
                elif pix is not None:
                    fail("K03 returned planes it was not asked for")
        factors = tuple((c.hsf, c.vsf) for c in frame.components)
        log(f"K03 pixel_exact, {name} ({frame.width}x{frame.height}, sampling {factors},"
            f" {frame.precision}-bit, planes {tuple(planes[0].shape[:-1])}): max_abs_err {e}"
            f" against its plain version and against K0 x 3 + K3 (both quirks, with and"
            f" without planes)")
        err = max(err, e)
    record["max_abs_err"] = err
    if err != 0:
        fail(f"K03 disagrees (max_abs_err {err}; tolerance 0)")

    q = Quirks.REFERENCE
    eight = (*pixel_sweep.decoded(batch, dev), False)
    timed = {"request": (*cases[f"dense {W}x{H} 4:2:0 request"], True), "eight": eight}
    for key, (frame, planes, qts, want) in timed.items():
        k03 = lambda: pixel.pixel_exact(planes, qts, frame, q, want)  # noqa: E731
        old = lambda: pixel_sweep.k0_k3(planes, qts, frame, q, want)  # noqa: E731
        old_ms = [cuda_ms(old, 10)]
        ms = [cuda_ms(k03, 10), cuda_ms(k03, 10)]
        old_ms.append(cuda_ms(old, 10))
        card_old = [pixel_sweep.card_ms(old, 7)]
        card_ms = [pixel_sweep.card_ms(k03, 7), pixel_sweep.card_ms(k03, 7)]
        card_old.append(pixel_sweep.card_ms(old, 7))
        plain_ms = cuda_ms(lambda: pixel._pixel_exact_plain(planes, qts, frame, q, want), 1)
        rgb, pix = k03()
        blocks = sum(p[..., 0].numel() for p in planes)
        # Bound: the int16 coefficients and the tables read once, RGB (and
        # the planes when asked) written once; about 700 float64 operations
        # a block, the IDCT's (csrc/idct_exact.cu), the colour stage's few
        # float32 ones a pixel being far below.
        bnd = bound(nbytes_of(*planes, *qts, rgb, *(pix or [])), 700 * blocks, "float64")
        shape = (f"{planes[0].shape[0] if planes[0].dim() == 4 else 1} x {W}x{H} 4:2:0,"
                 f" {blocks} blocks, {'with' if want else 'without'} planes")
        log(f"K03 pixel_exact ({shape}): kernel {ms[0]:.3f} and {ms[1]:.3f} ms, K0 x 3 + K3"
            f" {old_ms[0]:.3f} and {old_ms[1]:.3f} ms (one call between events); the card"
            f" alone {card_ms[0]:.4f} and {card_ms[1]:.4f} ms, K0 x 3 + K3 {card_old[0]:.4f}"
            f" and {card_old[1]:.4f} ms; plain {plain_ms:.3f} ms; bound {bnd['bound_ms']:.4f}"
            f" ms by {bnd['bound_by']} [{card}]")
        if key == "request":
            record.update(ms=statistics.median(ms), plain_ms=plain_ms, library_ms=None,
                          shape=shape, ms_runs=ms, k0_k3_ms=old_ms, card_ms=card_ms,
                          k0_k3_card_ms=card_old, **bnd)
        else:
            record.update(batch_shape=shape, batch_ms=ms, batch_plain_ms=plain_ms,
                          batch_k0_k3_ms=old_ms, batch_card_ms=card_ms,
                          batch_k0_k3_card_ms=card_old, batch_bound_ms=bnd["bound_ms"])
    sweep_cases = {"dense 4K request, planes": timed["request"],
                   "8 x dense 4K, RGB only": eight}
    record["strip_sweep"] = pixel_sweep.sweep(sweep_cases, (2, 4, 8, 16, 32), 5)
    record["sass"] = {k: v for k, v in pixel_sweep.sass_mix().items()
                      if k in ("pixel_exact_kernel", "idct_exact_kernel")}
    log(f"K03 and K0 instruction mix (SASS of their code): {record['sass']}")
    for r in record["strip_sweep"]:
        log(f"K03 strip sweep, {r['case']}: G {r['strip']}{' (default)' if r['default'] else ''},"
            f" {r['blocks']} coefficient blocks a block of threads: the card alone"
            f" {r['ms']:.4f} ms (K0 x 3 + K3 {r['old_ms']:.4f} ms) [{card}]")


def check_k13(dev, cases: dict, batch: list, record: dict, card: str) -> None:
    """K13 on every K03 case, both quirks, with and without planes: bitwise
    equal to K1 x 3 + K3 on the same planes; its planes within 1 of K03's
    (EXACT; for 12-bit samples counted modulo 256, wrapped_err); against
    its plain version K1's rule (planes within 1 on at most K1_SHARE of the
    pixels) and RGB bitwise equal to the plain colour stage of its own
    planes. Then its time beside K1 x 3 + K3 and beside the product alone
    as one cuBLAS call (torch.matmul of the dequantized [N, 64] blocks by K,
    TF32 off), on the dense 4K request with planes and on eight 4K requests
    without, the card alone (in turns, as K03's); then the sweep of G."""
    from jpeg_decoder_tpu_torch import IdctPrecision, Quirks
    from jpeg_decoder_tpu_torch.benchmarks import pixel_sweep
    from jpeg_decoder_tpu_torch.ops import color, pixel

    err, exact_err, share = 0, 0, 0.0
    for name, (frame, planes, qts) in cases.items():
        e, ex, raw, sh = 0, 0, 0, 0.0
        factors = tuple((c.hsf, c.vsf) for c in frame.components)
        for quirks in (Quirks.REFERENCE, Quirks.CORRECT):
            old = pixel_sweep.k1_k3(planes, qts, frame, quirks)
            plain = pixel._pixel_float_plain(planes, qts, frame, quirks)
            exact = pixel.pixel_exact(planes, qts, frame, quirks)
            for want in (True, False):
                rgb, pix = pixel.pixel_float(planes, qts, frame, quirks, want)
                e = max(e, max_abs_err(rgb, old[0]))
                if not want:
                    if pix is not None:
                        fail("K13 returned planes it was not asked for")
                    continue
                e = max(e, *[max_abs_err(a, b) for a, b in zip(pix, old[1])])
                ex = max(ex, *[wrapped_err(a, b) for a, b in zip(pix, exact[1])])
                raw = max(raw, *[max_abs_err(a, b) for a, b in zip(pix, exact[1])])
                sh = max(sh, *[share_differing(a, b) for a, b in zip(pix, plain[1])])
                pe = max(max_abs_err(a, b) for a, b in zip(pix, plain[1]))
                own = color._planes_to_rgb_plain(pix, frame.height, frame.width, factors, quirks)
                if pe > 1 or max_abs_err(rgb, own) != 0:
                    fail(f"K13 on {name}: planes {pe} from the plain version's, or RGB not"
                         f" the plain colour stage of its own planes")
        log(f"K13 pixel_float, {name} ({frame.width}x{frame.height}, sampling {factors},"
            f" {frame.precision}-bit, planes {tuple(planes[0].shape[:-1])}): max_abs_err {e}"
            f" against K1 x 3 + K3 (both quirks, with and without planes); planes against"
            f" K03 (EXACT) max_abs_err {raw}, modulo 256 {ex}; against the plain version"
            f" share differing {sh:.3e}, RGB the plain colour stage of its planes")
        err, exact_err, share = max(err, e), max(exact_err, ex), max(share, sh)
    record.update(max_abs_err=err, max_abs_err_vs_exact=exact_err, share_differing=share)
    if err != 0:
        fail(f"K13 differs from K1 x 3 + K3 (max_abs_err {err}; tolerance 0)")
    if exact_err > 1 or share > K1_SHARE:
        fail(f"K13's planes: {exact_err} from EXACT (tolerance 1), share {share:.3e} differing"
             f" from the plain version (tolerance {K1_SHARE})")

    q = Quirks.REFERENCE
    eight = (*pixel_sweep.decoded(batch, dev), False)
    timed = {"request": (*cases[f"dense {W}x{H} 4:2:0 request"], True), "eight": eight}
    for key, (frame, planes, qts, want) in timed.items():
        k13 = lambda: pixel.pixel_float(planes, qts, frame, q, want)  # noqa: E731
        old = lambda: pixel_sweep.k1_k3(planes, qts, frame, q, want)  # noqa: E731
        old_ms = [cuda_ms(old, 10)]
        ms = [cuda_ms(k13, 10), cuda_ms(k13, 10)]
        old_ms.append(cuda_ms(old, 10))
        card_old = [pixel_sweep.card_ms(old, 7)]
        card_ms = [pixel_sweep.card_ms(k13, 7), pixel_sweep.card_ms(k13, 7)]
        card_old.append(pixel_sweep.card_ms(old, 7))
        matmul_ms = pixel_sweep.product_ms(planes, qts, 7)
        plain_ms = cuda_ms(lambda: pixel._pixel_float_plain(planes, qts, frame, q, want), 1)
        rgb, pix = k13()
        blocks = sum(p[..., 0].numel() for p in planes)
        # Bound: the int16 coefficients, the tables and K read once, RGB
        # (and the planes when asked) written once; the [64] x [64, 64]
        # product is 4096 FMAs a block, two float32 operations each (the
        # dequant, store and colour stage's few a pixel being far below).
        bnd = bound(nbytes_of(*planes, *qts, rgb, *(pix or [])) + 64 * 64 * 4,
                    2 * 4096 * blocks, "float32")
        shape = (f"{planes[0].shape[0] if planes[0].dim() == 4 else 1} x {W}x{H} 4:2:0,"
                 f" {blocks} blocks, {'with' if want else 'without'} planes")
        log(f"K13 pixel_float ({shape}): kernel {ms[0]:.3f} and {ms[1]:.3f} ms, K1 x 3 + K3"
            f" {old_ms[0]:.3f} and {old_ms[1]:.3f} ms (one call between events); the card"
            f" alone {card_ms[0]:.4f} and {card_ms[1]:.4f} ms, K1 x 3 + K3 {card_old[0]:.4f}"
            f" and {card_old[1]:.4f} ms, the product alone (torch.matmul [N, 64] x K, TF32"
            f" off) {matmul_ms:.4f} ms; plain {plain_ms:.3f} ms; bound {bnd['bound_ms']:.4f}"
            f" ms by {bnd['bound_by']} [{card}]")
        if key == "request":
            # library_ms stays null: no single call does the store, the
            # scatter and the colour step; the product alone is matmul_ms
            record.update(ms=statistics.median(card_ms), plain_ms=plain_ms, library_ms=None,
                          shape=shape, ms_runs=ms, card_ms=card_ms, k1_k3_ms=old_ms,
                          k1_k3_card_ms=card_old, matmul_ms=matmul_ms, **bnd)
        else:
            record.update(batch_shape=shape, batch_ms=ms, batch_plain_ms=plain_ms,
                          batch_card_ms=card_ms, batch_k1_k3_ms=old_ms,
                          batch_k1_k3_card_ms=card_old, batch_matmul_ms=matmul_ms,
                          batch_bound_ms=bnd["bound_ms"])
    sweep_cases = {"dense 4K request, planes": timed["request"],
                   "8 x dense 4K, RGB only": eight}
    record["strip_sweep"] = pixel_sweep.sweep(sweep_cases, (2, 4, 8, 16, 32), 5,
                                              IdctPrecision.FLOAT32)
    mix = pixel_sweep.sass_mix()
    record["sass"] = {k: v for k, v in mix.items() if k in ("pixel_float_kernel",
                                                           "idct_float_kernel")}
    record["resources"] = mix.get("resources", {})
    log(f"K13 and K1 instruction mix (SASS of their code): {record['sass']};"
        f" resources {record['resources']}")
    for r in record["strip_sweep"]:
        log(f"K13 strip sweep, {r['case']}: G {r['strip']}{' (default)' if r['default'] else ''},"
            f" {r['blocks']} coefficient blocks a strip: the card alone {r['ms']:.4f} ms"
            f" (K1 x 3 + K3 {r['old_ms']:.4f} ms) [{card}]")


#: Per probe kernel: its record's name, the Pallas call sites it replaces,
#: the variant whose times stand for it in the record, and the int32
#: operations of one step of one lane (read off the chain in
#: csrc/probes.cu: loads, adds, shifts, compares, selects).
PROBE_KERNELS = {
    "jdtc_probe_gather_chain": (
        "PK1 gather_chain", "P1", 4,
        "benchmarks/pallas_gather_probe.py:66,99; pallas_gather_probe2.py:68,98,126;"
        " pallas_gather_probe3.py:69; pallas_gather_probe4.py:67"),
    "jdtc_probe_onehot_lookup_chain": (
        "PK2 onehot_lookup_chain", "E3", 8, "benchmarks/pallas_gather_probe.py:139,179"),
    "jdtc_probe_row_scatter_chain": (
        "PK3 row_scatter_chain", "E5", 6, "benchmarks/pallas_gather_probe.py:212"),
    "jdtc_probe_vshift_chain": (
        "PK4 vshift_chain", "G4a", 5,
        "benchmarks/pallas_gather_probe.py:235; pallas_gather_probe2.py:150;"
        " pallas_gather_probe3.py:106"),
    "jdtc_probe_combined_step_chain": (
        "PK5 combined_step_chain", "P5", 16, "benchmarks/pallas_gather_probe2.py:203"),
    "jdtc_probe_symbol_step_chain": (
        "PK6 symbol_step_chain", "H4", 60, "benchmarks/pallas_gather_probe4.py:140"),
    "jdtc_probe_dma_wave_chain": (
        "PK7 dma_wave_chain", "H5", 4, "benchmarks/pallas_gather_probe4.py:197"),
}


def combined_step_bytes(tab: np.ndarray, words: np.ndarray, steps: int) -> int:
    """Bytes of its inputs that a combined-step chain (PK5) of `steps` steps
    needs: the distinct table entries its lanes peek at and the words they
    refill from, found by replaying the chain's bit buffer."""
    row0 = tab[0].astype(np.int64)
    w = words.view(np.uint32).astype(np.int64)
    cols = np.arange(w.shape[1])
    bitbuf = np.full(w.shape[1], 0x9E3779B9, np.int64)
    bitcnt = np.full(w.shape[1], 32, np.int64)
    wordpos = np.zeros(w.shape[1], np.int64)
    peeked = np.zeros(row0.shape[0], bool)
    for _ in range(steps):
        peek = (bitbuf >> 20) & 0xFFF
        peeked[peek] = True
        ln = row0[peek] & 31
        bitbuf = (bitbuf << ln) & 0xFFFFFFFF
        bitcnt -= ln
        need = bitcnt < 16
        bitbuf |= np.where(need, w[wordpos % w.shape[0], cols] >> 16, 0)
        bitcnt += 16 * need
        wordpos += need
    return 4 * int(peeked.sum()) + 4 * int(wordpos.sum())


def check_probes(dev, kernels: dict, card: str) -> None:
    """PK1-PK7 against their plain versions on the card, bitwise, on every
    variant of the four scripts at both chain lengths that the probe path
    launches it at; at the short one also against the plain version on the
    CPU, with the table in global memory where both placements exist, and
    PK6 from a random state. Fills each kernel's record from its standing
    variant: times of kernel and plain version at the short length, and the
    bound of that call."""
    import torch
    from jpeg_decoder_tpu_torch.benchmarks import gather_probe
    from jpeg_decoder_tpu_torch.ops import probes

    for variant in probes.VARIANTS:
        name, standing, step_ops, _ = PROBE_KERNELS[variant.kernel]
        rec = kernels[variant.kernel]
        steps, long_steps = gather_probe.ROUND_STEPS[variant.round]
        t = probes.tensors_for(variant, dev)
        cpu = probes.tensors_for(variant, "cpu")
        got = variant.run(t, steps)
        box = {}
        plain_ms = cuda_ms(lambda: box.update(want=variant.run(t, steps, plain=True)), 1)
        err = max_abs_err(got, box["want"])
        err = max(err, max_abs_err(variant.run(t, long_steps),
                                   variant.run(t, long_steps, plain=True)))
        # the plain version on the CPU, the one the CPU tests hold to the
        # JAX kernels: the card's plain version and kernel agree with it
        err = max(err, max_abs_err(got, variant.run(cpu, steps)))
        checked = ["default placement"]
        if probes.placement_of(variant, t) == "table in shared memory":
            err = max(err, max_abs_err(variant.run(t, steps, placement="global"), got))
            checked.append("table in global memory")
        if variant.key == "H4":
            rng = np.random.default_rng(4)
            state = tuple(
                torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a).to(dev)
                for a in (rng.integers(0, 2**32, (8, 128), dtype=np.uint32),
                          rng.integers(16, 33, (8, 128), dtype=np.int32),
                          rng.integers(-2**31, 2**31, (8, 128), dtype=np.int64).astype(np.int32)))
            rnd = variant.run(t, steps, state=state)
            err = max(err, max_abs_err(rnd, variant.run(t, steps, state=state, plain=True)))
            if len(torch.unique(rnd)) < 512:
                fail("PK6: lanes from a random state did not go their own ways")
            checked.append("random state")
        # the card alone: launches queued behind a spin kernel (time_ms)
        ms = gather_probe.time_ms(lambda: variant.run(t, steps), 7, dev)
        log(f"{name} [{variant.label}]: kernel {ms:.4f} ms, plain {plain_ms:.1f} ms"
            f" ({steps} steps); max_abs_err {err} at {steps} and {long_steps} steps"
            f" ({', '.join(checked)}) [{card}]")
        if err != 0:
            fail(f"{name} [{variant.label}] disagrees with its plain version"
                 f" (max_abs_err {err}; tolerance 0)")
        rec["max_abs_err"] = max(rec.get("max_abs_err", 0), err)
        rec.setdefault("variants", {})[variant.key] = dict(
            label=variant.label, check_steps=[steps, long_steps], ms=ms, plain_ms=plain_ms, max_abs_err=err)
        if variant.key == standing:
            # Bound of this call: every input read once, the result written
            # once; where a chain of this length cannot reach all of an
            # input, what it does read (PK7: the rows its copies fetch, 2 KB
            # each; PK5: the table entries and words its lanes come to);
            # step_ops int32 operations a step and lane. What holds a chain
            # in practice is the latency of its dependent step, which
            # gather_probe's ns/step below measures.
            lanes = got.numel() if variant.key != "E5" else 128
            if variant.key == "H5":
                moved = 2048 * probes.dma_waves(steps) * 128 + nbytes_of(t["idx0"])
            elif variant.key == "P5":
                moved = combined_step_bytes(cpu["tab"].numpy(), cpu["words"].numpy(), steps)
            else:
                moved = nbytes_of(*t.values())
            rec.update(ms=ms, plain_ms=plain_ms, library_ms=None,
                       shape=f"{variant.label}, {steps} steps",
                       **bound(moved + nbytes_of(got), step_ops * lanes * steps, "int32"))


def probe_path(kernels: dict) -> dict:
    """The probe path through its entry point: all four rounds at the
    rounds' own chain lengths. Returns path -> launch counts."""
    from jpeg_decoder_tpu_torch.benchmarks import gather_probe

    records, launches = run_path(
        "main path gather_probe", lambda: gather_probe.main(["--round", "all"]))
    if len(records) != 21:
        fail(f"gather_probe printed {len(records)} variants, expected 21")
    for r in records:
        slopes = [r["ns_per_step"]] + ([r["global"]["ns_per_step"]] if "global" in r else [])
        # a dependent step costs time: a slope of zero or less is a broken
        # measurement
        if not all(np.isfinite(x) and x > 0 for x in slopes):
            fail(f"gather_probe: [{r['label']}] gave the slope {slopes} ns/step")
        v = kernels[r["kernel"]]["variants"][r["key"]]
        v.update(ns_per_step=r["ns_per_step"], steps=list(r["steps"]), chain_ms=list(r["ms"]),
                 placement=r["placement"])
        if "global" in r:
            v["ns_per_step_global"] = r["global"]["ns_per_step"]
    return {"gather_probe": launches}


# ---------------------------------------------------------------------------
# Phases: K3f, K3c and K5 against their plain versions
# ---------------------------------------------------------------------------


def pixel_planes_on(dev, data: bytes):
    """(frame, the EXACT reference's uint8 pixel planes on the card)."""
    import torch
    from jpeg_decoder_tpu_torch import Quirks
    from jpeg_decoder_tpu_torch.io.parser import parse

    _, pix, _ = reference(data, Quirks.REFERENCE)
    return parse(data).frame, [torch.from_numpy(p).to(dev) for p in pix]


def random_planes(dev, w: int, h: int, factors, seed: int):
    """Random uint8 pixel planes of a w x h frame of `factors` at MCU
    padding, with an all-255 corner (the fancy passes' 256) and an all-0
    one."""
    import torch

    rng = np.random.default_rng(seed)
    mh, mv = max(f[0] for f in factors), max(f[1] for f in factors)
    mx, my = -(-w // (8 * mh)), -(-h // (8 * mv))
    planes = []
    for fh, fv in factors:
        p = rng.integers(0, 256, (my * fv * 8, mx * fh * 8), dtype=np.uint8)
        p[:9, :9] = 255
        p[-9:, -9:] = 0
        planes.append(torch.from_numpy(p).to(dev))
    return planes


#: 4-component transforms: name -> (exact, raw_cmyk)
TRANSFORMS = {"YCCK EXACT": (True, False), "YCCK FLOAT32": (False, False),
              "CMYK": (True, True)}


def check_k3f(dev, requests, files: dict, cmyk: bytes, record: dict, card: str) -> None:
    """K3f bitwise against its plain version (fancy_upsample + colour, torch
    ops on the card), both quirks: the dense 4K 4:2:0 request's planes,
    flower_dri_blocks7_422.jpg, random 4:1:1 and 4:2:1 planes at 4K, a
    batch of four, and the 4K 4-component frame under YCCK EXACT, YCCK
    FLOAT32 and CMYK. Then its time the card alone on the 4K request
    beside K3's (nearest-neighbour) on the same planes."""
    import torch
    from jpeg_decoder_tpu_torch import Quirks
    from jpeg_decoder_tpu_torch.benchmarks import pixel_sweep
    from jpeg_decoder_tpu_torch.ops import color

    frame, dense = pixel_planes_on(dev, requests[0])
    flower = next(d for n, d in files.items() if "flower" in n)
    fframe, fplanes = pixel_planes_on(dev, flower)
    f411 = ((4, 1), (1, 1), (1, 1))
    f421 = ((4, 2), (1, 1), (1, 1))
    cframe, cplanes = pixel_planes_on(dev, cmyk)
    stacked = [torch.stack([p, *(torch.roll(p, 17 * k, 1) for k in (1, 2, 3))]) for p in dense]
    cases = {
        f"dense {W}x{H} 4:2:0 request": (dense, H, W, F420, [(True, False)]),
        "file flower_dri_blocks7_422.jpg (4:2:2)": (
            fplanes, fframe.height, fframe.width, tuple((c.hsf, c.vsf) for c in fframe.components),
            [(True, False)]),
        f"random 4:1:1 planes at {W}x{H}": (random_planes(dev, W, H, f411, 41), H, W, f411,
                                            [(True, False)]),
        f"random 4:2:1 planes at {W}x{H}": (random_planes(dev, W, H, f421, 42), H, W, f421,
                                            [(True, False)]),
        f"batch of four {W}x{H} 4:2:0": (stacked, H, W, F420, [(True, False)]),
        f"4-component {W}x{H} 4:4:4 (hopper_cmyk_adobe.jpg tiled)": (
            cplanes, H, W, ((1, 1),) * 4, list(TRANSFORMS.values())),
    }
    err = 0
    for name, (planes, h, w, factors, transforms) in cases.items():
        e = 0
        for quirks in (Quirks.REFERENCE, Quirks.CORRECT):
            for exact, raw in transforms:
                args = (planes, h, w, factors, quirks, "fancy", exact, raw)
                got = color.planes_to_rgb(*args)
                e = max(e, max_abs_err(got, color._planes_to_rgb_plain(*args)))
        log(f"K3f fancy, {name}: max_abs_err {e} against its plain version (both quirks"
            f"{', YCCK EXACT, YCCK FLOAT32 and CMYK' if len(transforms) > 1 else ''})")
        err = max(err, e)
    record["max_abs_err"] = err
    if err != 0:
        fail(f"K3f disagrees with its plain version (max_abs_err {err}; tolerance 0)")
    q = Quirks.REFERENCE
    nn = lambda: color.planes_to_rgb(dense, H, W, F420, q)  # noqa: E731
    k3 = pixel_sweep.card_ms(nn, 7)
    turns = pixel_sweep.colour_turns(dense, H, W, F420, 7, "fancy")
    batch = pixel_sweep.colour_turns(stacked, H, W, F420, 7, "fancy")
    plain_ms = cuda_ms(lambda: color._planes_to_rgb_plain(dense, H, W, F420, q, "fancy"), 3)
    # Bound: the three planes in, 3 bytes a pixel out; 8 int32 operations
    # a pixel for each chroma component (its share of a horizontal sum 3x +
    # n + b, which two output rows use, and the vertical 3A + A' + 4b and
    # shift), the colour step's ten float32 ones coming to less.
    bnd = bound(nbytes_of(*dense) + 3 * H * W, 16 * H * W, "int32")
    record.update(ms=turns["card_ms"], plain_ms=plain_ms, library_ms=None,
                  k3_card_ms=k3, shape=f"{W}x{H} 4:2:0 planes", **turns,
                  batch_of_four=batch, **bnd)
    log(f"K3f fancy ({W}x{H} 4:2:0 planes): {times_line(turns)}; K3 (nearest-neighbour) on"
        f" the same planes {k3:.4f} ms; plain {plain_ms:.3f} ms; bound {bnd['bound_ms']:.4f} ms"
        f" by {bnd['bound_by']} [{card}]")
    log(f"K3f fancy (a batch of four {W}x{H} 4:2:0, one launch): {times_line(batch)} [{card}]")


def check_k3c(dev, cmyk: bytes, record: dict, card: str) -> None:
    """K3c (K3's kernel, jdtc_color, on four planes) bitwise against its
    plain version (nearest-neighbour upsample +
    YCCK or CMYK, torch ops on the card) on the 4K 4-component frame, both
    quirks, YCCK EXACT, YCCK FLOAT32 and CMYK; then under YCCK EXACT on a
    4096x4096 4:4:4 frame that walks R's whole (y, cr, k) domain against
    the float64 chain in NumPy (core/numerics.ycck_channels_to_rgb). Its
    time the card alone under each transform."""
    import torch
    from jpeg_decoder_tpu_torch import Quirks
    from jpeg_decoder_tpu_torch.benchmarks import pixel_sweep
    from jpeg_decoder_tpu_torch.core import numerics
    from jpeg_decoder_tpu_torch.ops import color

    f4 = ((1, 1),) * 4
    _, planes = pixel_planes_on(dev, cmyk)
    err = 0
    for quirks in (Quirks.REFERENCE, Quirks.CORRECT):
        for exact, raw in TRANSFORMS.values():
            args = (planes, H, W, f4, quirks, "nn", exact, raw)
            got = color.planes_to_rgb(*args)
            err = max(err, max_abs_err(got, color._planes_to_rgb_plain(*args)))
    log(f"K3c (K3 on four planes), 4-component {W}x{H} 4:4:4 (hopper_cmyk_adobe.jpg tiled): max_abs_err"
        f" {err} against its plain version (both quirks; YCCK EXACT, YCCK FLOAT32, CMYK)")
    y, cr, k = np.meshgrid(*[np.arange(256, dtype=np.uint8)] * 3, indexing="ij")
    walk = [a.reshape(4096, 4096) for a in (y, np.full_like(y, 77), cr, k)]
    on_card = [torch.from_numpy(a).to(dev) for a in walk]
    dom = 0
    for quirks in (Quirks.REFERENCE, Quirks.CORRECT):
        got = color.planes_to_rgb(on_card, 4096, 4096, f4, quirks, "nn", True, False)
        dom = max(dom, max_abs_err(got, numerics.ycck_channels_to_rgb(*walk, quirks)))
    log(f"K3c (K3 on four planes), YCCK EXACT over R's whole (y, cr, k) domain (4096x4096 4:4:4): max_abs_err"
        f" {dom} against the float64 chain in NumPy (both quirks)")
    record["max_abs_err"] = max(err, dom)
    if record["max_abs_err"] != 0:
        fail(f"K3c disagrees (max_abs_err {record['max_abs_err']}; tolerance 0)")
    times, turns = {}, {}
    for name, (exact, raw) in TRANSFORMS.items():
        turns[name] = pixel_sweep.colour_turns(planes, H, W, f4, 7, "nn", exact, raw)
        times[name] = turns[name]["card_ms"]
        log(f"K3c (K3 on four planes, {W}x{H} 4:4:4), {name}: {times_line(turns[name])}"
            f" [{card}]")
    plain_ms = cuda_ms(lambda: color._planes_to_rgb_plain(planes, H, W, f4, Quirks.REFERENCE), 3)
    # Bound: the four planes in, 3 bytes a pixel out; YCCK EXACT's two
    # dozen float64 operations a pixel come to less.
    bnd = bound(nbytes_of(*planes) + 3 * H * W, 24 * H * W, "float64")
    record.update(ms=times["YCCK EXACT"], plain_ms=plain_ms, library_ms=None,
                  ms_by_transform=times, turns_by_transform=turns,
                  **turns["YCCK EXACT"], shape=f"{W}x{H} 4:4:4, four planes", **bnd)
    log(f"K3c (K3 on four planes, {W}x{H} 4:4:4, four planes): the card alone "
        + ", ".join(f"{n} {t:.4f} ms" for n, t in times.items())
        + f"; plain (YCCK EXACT) {plain_ms:.3f} ms; bound {bnd['bound_ms']:.4f} ms by"
        f" {bnd['bound_by']} [{card}]")


def check_k5(dev, big: bytes, record: dict, card: str) -> None:
    """K5 (one launch for all components) against its plain version
    (idct_matmul_scaled and blocks_to_plane, torch ops on the card) on the
    4K request's three coefficient planes at k = 1, 2 and 4: within 1 on
    at most K1_SHARE of the pixels, bitwise at k = 1; on random 12-bit
    planes of their shapes the error is reported, not gated (the card
    tests hold K5 bitwise the CPU model of its walk at 12-bit). Its time
    the card alone and with L2
    flushed (pixel_sweep.k5_turns, with the launch floor: an empty kernel
    at its grid), beside the product alone as one library call
    (torch.matmul of the float32 coefficients by the folded [64, k*k]
    matrix, TF32 off, three calls)."""
    import torch
    from jpeg_decoder_tpu_torch import DecodeConfig, convert
    from jpeg_decoder_tpu_torch.benchmarks import pixel_sweep
    from jpeg_decoder_tpu_torch.core.types import ZIGZAG
    from jpeg_decoder_tpu_torch.models import host
    from jpeg_decoder_tpu_torch.ops import idct

    frame, planes, qts = host.host_decode(big, DecodeConfig())
    coeffs = [torch.from_numpy(p).to(dev) for p in planes.planes]
    tables = [convert.quant_table_to_device(qts[c.qtid], dev) for c in frame.components]
    host_tables = [np.asarray(qts[c.qtid]) for c in frame.components]
    zz = torch.as_tensor(ZIGZAG, dtype=torch.long, device=dev)
    rng = np.random.default_rng(12)
    coeffs12 = [torch.from_numpy(rng.integers(-2048, 2048, c.shape, dtype=np.int16)).to(dev)
                for c in coeffs]

    def plain(c, q, k, bits12=False):
        by, bx, _ = c.shape
        return idct.blocks_to_plane(idct.idct_matmul_scaled(c.reshape(-1, 64), q, k, bits12),
                                    by, bx, k)

    err, share, by_k = 0, 0.0, {}
    blocks = sum(c.shape[0] * c.shape[1] for c in coeffs)
    for k in (1, 2, 4):
        e, sh = 0, 0.0
        got = idct.idct_planes_scaled(coeffs, host_tables, k)
        for g, c, q in zip(got, coeffs, tables):
            want = plain(c, q, k)
            e, sh = max(e, max_abs_err(g, want)), max(sh, share_differing(g, want))
        got12 = idct.idct_planes_scaled(coeffs12, host_tables, k, True)
        e12 = max(max_abs_err(g, plain(c, q, k, True)) for g, c, q in zip(got12, coeffs12, tables))
        sh12 = max(share_differing(g, plain(c, q, k, True))
                   for g, c, q in zip(got12, coeffs12, tables))
        if k == 1 and e != 0:
            fail(f"K5 at k = 1 differs from its plain version (max_abs_err {e}; tolerance 0)")
        err, share = max(err, e), max(share, sh)
        turns = pixel_sweep.k5_turns(coeffs, tables, k, 7)
        ms = turns["card_ms"]
        xs = [c.reshape(-1, 64).to(torch.float32) for c in coeffs]
        ms_ = [idct.idct_matrix_scaled_on(dev, k) * q[zz].to(torch.float32)[:, None]
               for q in tables]
        outs = [torch.empty((x.shape[0], k * k), dtype=torch.float32, device=dev) for x in xs]
        with idct._true_float32_matmul():
            product = pixel_sweep.card_ms(
                lambda: [torch.matmul(x, m, out=o) for x, m, o in zip(xs, ms_, outs)], 7)
        plain_ms = cuda_ms(lambda: [plain(c, q, k) for c, q in zip(coeffs, tables)], 3)
        # Bound: of each block's int16 coefficients only the band (zigzag
        # rows of M_k that are not zero: z <= 0, 4, 24 at k = 1, 2, 4),
        # rounded up to the 32-byte sectors memory moves, read once; the
        # tables and M_k read once; k*k bytes a block written; 2 k^4
        # float32 operations a block.
        band = int(np.flatnonzero(np.abs(idct.idct_matrix_zz_scaled(k)).sum(1))[-1]) + 1
        read = -(-2 * band // 32) * 32
        bnd = bound(read * blocks + nbytes_of(*tables) + 64 * k * k * 4 + blocks * k * k,
                    2 * k ** 4 * blocks, "float32")
        by_k[k] = dict(ms=ms, plain_ms=plain_ms, library_ms=product, max_abs_err=e,
                       share_differing=sh, band_bytes_read=read, turns=turns, **bnd)
        log(f"K5 idct_scaled, k = {k} (the 4K request's three planes, {blocks} blocks, one"
            f" launch of {turns['ctas']} blocks of threads): {times_line(turns)}; the launch"
            f" floor (an empty kernel at its grid) {turns['empty_one_grid_ms']:.4f} ms; the"
            f" product alone (torch.matmul, TF32 off)"
            f" {product:.4f} ms; plain {plain_ms:.3f} ms; bound {bnd['bound_ms']:.4f} ms by"
            f" {bnd['bound_by']} ({read} B read a block, the band of {band} coefficients in"
            f" 32-byte sectors; {ms / bnd['bound_ms']:.1f}x the bound, half of it"
            f" {'reached' if ms <= 2 * bnd['bound_ms'] else 'missed'}); against plain"
            f" max_abs_err {e}, share differing {sh:.3e}; 12-bit random planes against plain"
            f" max_abs_err {e12}, share differing {sh12:.3e} (not gated) [{card}]")
    record.update(max_abs_err=err, share_differing=share, by_k=by_k,
                  shape=f"the {W}x{H} 4:2:0 request's three planes at k = 4 (by_k: 1, 2, 4)",
                  **{key: by_k[4][key] for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                                                  "bound_by", "bound_bytes", "bound_ops",
                                                  "bound_ops_kind")})
    if err > 1 or share > K1_SHARE:
        fail(f"K5 disagrees with its plain version (max_abs_err {err}, share {share:.3e};"
             f" tolerance 1 on at most {K1_SHARE})")


# ---------------------------------------------------------------------------
# Phases: the main paths
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# Streamed and striped decode (parallel/stripes.py): K6n, K6f
# ---------------------------------------------------------------------------

#: The gigapixel frame's chunk that K6n is held on against its plain version.
GIGA_CHUNK = 7
#: Stripes of decode_striped on the 4K and the gigapixel frames.
N_STRIPES = 8


def striped_case(dev, data: bytes, cfg, n: int = N_STRIPES):
    """decode_striped's StripeStage and its padded planes on the card."""
    from jpeg_decoder_tpu_torch.io.parser import parse
    from jpeg_decoder_tpu_torch.parallel import stripes

    return stripes._striped_planes(parse(data, cfg), cfg, n, dev)


def synthetic_stripe_case(dev, h: int, w: int, factors, seed: int, upsample: str = "nn",
                          quirks=None, n: int = N_STRIPES):
    """A StripeStage of an h x w frame of `factors` with random tables, and
    random padded coefficient planes on the card."""
    import torch
    from jpeg_decoder_tpu_torch import IdctPrecision, Quirks
    from jpeg_decoder_tpu_torch.core import types
    from jpeg_decoder_tpu_torch.io.markers import Encoding
    from jpeg_decoder_tpu_torch.parallel import stripes

    mh, mv = max(f[0] for f in factors), max(f[1] for f in factors)
    frame = types.FrameHeader(
        Encoding.BASELINE_DCT, 8, w, h,
        tuple(types.Component(i + 1, fh, fv, min(i, 1), -(-w * fh // mh), -(-h * fv // mv))
              for i, (fh, fv) in enumerate(factors)))
    rng = np.random.default_rng(seed)
    qts = tuple(rng.integers(1, 64, 64).astype(np.uint16).tobytes() for _ in factors)
    stage = stripes.StripeStage((frame, qts, IdctPrecision.EXACT, quirks or Quirks.REFERENCE,
                                 upsample, 8), n, dev)
    planes = [torch.from_numpy(rng.integers(-300, 300, (n * lby, c.blocks_x, 64))
                               .astype(np.int16)).to(dev)
              for lby, c in zip(stage.lby, frame.components)]
    return stage, planes


def gigapixel_chunk(dev, giga: bytes, k: int, precision):
    """(ChunkStage, chunk k's planes on the card) of decode_streamed on the
    gigapixel frame, the chunk's entropy decoded as decode_streamed does."""
    import torch
    from jpeg_decoder_tpu_torch import DecodeConfig
    from jpeg_decoder_tpu_torch.io.parser import parse
    from jpeg_decoder_tpu_torch.parallel import stripes

    cfg = DecodeConfig(idct_precision=precision)
    structure = parse(giga, cfg)
    frame = structure.frame
    n = -(-frame.height * frame.width // stripes.CHUNK_PIXELS)
    plan = stripes._striped_entropy_plan(structure, cfg, n)
    if plan is None:
        fail("the gigapixel frame's restart rows do not align with its chunks")
    decode_stripe, lby, qts = plan
    bufs = [np.zeros((rows, c.blocks_x, 64), np.int16) for rows, c in zip(lby, frame.components)]
    decode_stripe(k, bufs)
    stage = stripes.make_chunk_stage(stripes._stage_for(frame, qts, cfg), n, dev)
    return stage, [torch.from_numpy(b).to(dev) for b in bufs]


def k6_bound(planes, qts, rgb) -> dict:
    """K6n's and K6f's bound: the int16 coefficients and the tables read
    once, RGB written once; about 700 float64 operations a block, the EXACT
    IDCT's (csrc/idct_exact.cuh), the colour and upsampling steps' few
    integer and float32 ones a pixel being far below."""
    blocks = sum(p[..., 0].numel() for p in planes)
    return bound(nbytes_of(*planes, *qts, rgb), 700 * blocks, "float64")


def check_k6n(dev, giga: bytes, requests, cmyk: bytes, record: dict, card: str) -> None:
    """K6n (the nearest-neighbour pixel stage of a chunk or of every stripe
    with the stripe rule) bitwise against its plain version (the JAX
    program stripe by stripe, torch ops on the card): on chunk GIGA_CHUNK
    of the gigapixel frame (K03 with the chunk's origin), and with 8
    stripes on the dense 4K request (K03), a 4K gray frame (K0 + K3), a 4K
    frame of 7/12 vertical factors (not tile-local: K0 + K3, the clamp
    live) and the 4-component photograph tiled to 4K (YCCK, K0 x 4 + K3c).
    Under FLOAT32, K13 with the stripe rule bitwise K1 x 3 + K3 with it, on
    the same chunk and the 4K request. Then its time on the chunk, one call
    and the card alone, beside K03 on the whole 4K request."""
    from jpeg_decoder_tpu_torch import DecodeConfig, IdctPrecision, Quirks
    from jpeg_decoder_tpu_torch.benchmarks import pixel_sweep
    from jpeg_decoder_tpu_torch.ops import color, idct, pixel

    exact, f32 = IdctPrecision.EXACT, IdctPrecision.FLOAT32
    chunk, planes = gigapixel_chunk(dev, giga, GIGA_CHUNK, exact)
    cases = {
        f"gigapixel chunk {GIGA_CHUNK} ({chunk.frame.width}x{chunk.hs} of"
        f" {chunk.frame.width}x{chunk.frame.height}, K03)": (
            chunk, lambda: chunk(GIGA_CHUNK, *planes),
            lambda: chunk(GIGA_CHUNK, *planes, plain=True)),
    }
    for name, case in {
        f"dense {W}x{H} 4:2:0 request, 8 stripes (K03)": striped_case(dev, requests[0],
                                                                     DecodeConfig()),
        f"{W}x{H} gray, 8 stripes (K0 + K3)": synthetic_stripe_case(dev, H, W, ((1, 1),), 61),
        f"{W}x{H} 7/12 vertical factors, 8 stripes (K0 x 3 + K3, not tile-local)":
            synthetic_stripe_case(dev, H, W, ((1, 12), (1, 7), (1, 7)), 62),
        f"hopper_cmyk_adobe.jpg tiled to {W}x{H}, YCCK, 8 stripes (K0 x 4 + K3c)":
            striped_case(dev, cmyk, DecodeConfig()),
    }.items():
        stage, p = case
        cases[name] = (stage, lambda s=stage, p=p: s(*p), lambda s=stage, p=p: s(*p, plain=True))
    err = 0
    for name, (stage, kernel, plain) in cases.items():
        e = max_abs_err(kernel(), plain())
        log(f"K6n stripes, {name}: max_abs_err {e} against its plain version"
            f" (fused: {stage.fused})")
        err = max(err, e)
    record["max_abs_err"] = err
    if err != 0:
        fail(f"K6n disagrees with its plain version (max_abs_err {err}; tolerance 0)")
    f32_cases = {f"gigapixel chunk {GIGA_CHUNK}": gigapixel_chunk(dev, giga, GIGA_CHUNK, f32),
                 f"dense {W}x{H} 4:2:0 request, 8 stripes": striped_case(
                     dev, requests[0], DecodeConfig(idct_precision=f32))}
    for name, (stage, p) in f32_cases.items():
        chunk_k = GIGA_CHUNK if name.startswith("gigapixel") else None
        got = stage(chunk_k, *p) if chunk_k is not None else stage(*p)
        rows = stage.hs if chunk_k is not None else stage.pad_h
        stripes = color.Stripes(chunk_k * stage.hs if chunk_k is not None else 0, stage.hs)
        pix = [idct.idct_plane(x, q, False, f32) for x, q in zip(p, stage._qts())]
        split = stage._colour(pix, rows, "nn", stripes)
        plain = stage(chunk_k, *p, plain=True) if chunk_k is not None else stage(*p, plain=True)
        e = max_abs_err(got, split)
        e_plain, sh_plain = max_abs_err(got, plain), share_differing(got, plain)
        log(f"K6n stripes FLOAT32 (K13), {name}: max_abs_err {e} against K1 x 3 + K3 with the"
            f" stripe rule; against the plain version (another order of the products)"
            f" {sh_plain:.2e} of the RGB samples differ, max_abs_err {e_plain}"
            f" (tolerance 3 and 1e-3)")
        if e != 0:
            fail(f"K6n FLOAT32 on {name}: max_abs_err {e} against K1 x 3 + K3")
        if e_plain > 3 or sh_plain > 1e-3:
            fail(f"K6n FLOAT32 on {name}: max_abs_err {e_plain}, share {sh_plain:.3e} against"
                 f" its plain version (tolerance 3 and 1e-3)")
        del got, split, plain, pix

    kernel = lambda: chunk(GIGA_CHUNK, *planes)  # noqa: E731
    ms = [cuda_ms(kernel, 10), cuda_ms(kernel, 10)]
    card_ms = pixel_sweep.card_ms(kernel, 7)
    plain_ms = cuda_ms(lambda: chunk(GIGA_CHUNK, *planes, plain=True), 1)
    bnd = k6_bound(planes, chunk._qts(), kernel())
    shape = (f"gigapixel chunk {GIGA_CHUNK}: {chunk.frame.width}x{chunk.hs} 4:2:0,"
             f" {sum(p[..., 0].numel() for p in planes)} blocks, no planes")
    stage4k, p4k = striped_case(dev, requests[0], DecodeConfig())
    frame4k = stage4k.frame
    whole = [x[: c.blocks_y] for x, c in zip(p4k, frame4k.components)]
    stripes4k = pixel_sweep.card_ms(lambda: stage4k(*p4k), 7)
    k03_4k = pixel_sweep.card_ms(lambda: pixel.pixel_exact(whole, stage4k._qts(), frame4k,
                                                           Quirks.REFERENCE, False), 7)
    log(f"K6n stripes ({shape}): one call {ms[0]:.3f} and {ms[1]:.3f} ms, the card alone"
        f" {card_ms:.4f} ms; plain {plain_ms:.3f} ms; bound {bnd['bound_ms']:.4f} ms by"
        f" {bnd['bound_by']}; the dense 4K request in 8 stripes the card alone"
        f" {stripes4k:.4f} ms, K03 on its unpadded planes {k03_4k:.4f} ms [{card}]")
    record.update(ms=statistics.median(ms), ms_runs=ms, card_ms=card_ms, plain_ms=plain_ms,
                  library_ms=None, shape=shape, stripes_4k_card_ms=stripes4k,
                  k03_4k_card_ms=k03_4k, **bnd)


def check_k6f(dev, requests, record: dict, card: str) -> None:
    """K6f (K0 over the padded planes, then K3f under the striped rule, all
    stripes in one launch each) bitwise against its plain version (the JAX
    program's halo exchange over a list of stripe planes, torch ops on the
    card): the dense 4K 4:2:0 request in 8 stripes (135 MCU rows padded to
    136), under CORRECT, where it must differ from the whole-image fancy
    decode in row 2159 alone; and a random 4K frame with a (2, 4)-ratio
    component, which takes the nearest-neighbour rule. Then its time."""
    from jpeg_decoder_tpu_torch import DecodeConfig, JpegDecoder, Quirks
    from jpeg_decoder_tpu_torch.benchmarks import pixel_sweep

    cfg = DecodeConfig(upsample="fancy", quirks=Quirks.CORRECT)
    stage, planes = striped_case(dev, requests[0], cfg)
    got = stage(*planes)
    e = max_abs_err(got, stage(*planes, plain=True))
    whole = JpegDecoder(cfg, device=dev).decode_rgb(requests[0])
    rows = np.flatnonzero((got[:H].cpu().numpy() != whole).any(axis=(1, 2))).tolist()
    log(f"K6f stripes, dense {W}x{H} 4:2:0 request, 8 stripes: max_abs_err {e} against its"
        f" plain version; rows differing from the whole-image fancy decode: {rows}")
    if rows != [H - 1]:
        fail(f"K6f: rows {rows} differ from the whole-image decode, expected [{H - 1}]")
    s24, p24 = synthetic_stripe_case(dev, H, W, ((2, 4), (1, 1), (1, 1)), 63, "fancy",
                                     Quirks.CORRECT)
    e24 = max_abs_err(s24(*p24), s24(*p24, plain=True))
    log(f"K6f stripes, random {W}x{H} planes with a (2, 4)-ratio component, 8 stripes:"
        f" max_abs_err {e24} against its plain version")
    record["max_abs_err"] = max(e, e24)
    if record["max_abs_err"] != 0:
        fail(f"K6f disagrees with its plain version (max_abs_err {record['max_abs_err']})")
    kernel = lambda: stage(*planes)  # noqa: E731
    ms = [cuda_ms(kernel, 10), cuda_ms(kernel, 10)]
    card_ms = pixel_sweep.card_ms(kernel, 7)
    plain_ms = cuda_ms(lambda: stage(*planes, plain=True), 1)
    bnd = k6_bound(planes, stage._qts(), got)
    shape = f"{W}x{H} 4:2:0 in 8 stripes, padded to {stage.pad_h} rows"
    log(f"K6f stripes ({shape}): one call {ms[0]:.3f} and {ms[1]:.3f} ms, the card alone"
        f" {card_ms:.4f} ms; plain {plain_ms:.3f} ms; bound {bnd['bound_ms']:.4f} ms by"
        f" {bnd['bound_by']} [{card}]")
    record.update(ms=statistics.median(ms), ms_runs=ms, card_ms=card_ms, plain_ms=plain_ms,
                  library_ms=None, shape=shape, **bnd)


def gigapixel_path(dev, giga: bytes, requests, card: str) -> dict:
    """decode_streamed of the gigapixel frame under EXACT (chunk-local
    native entropy, one K6n launch a chunk) bitwise decode_striped with 8
    stripes (one K6n launch) and JpegDecoder(NATIVE, EXACT).decode_rgb of
    the same bytes (K03); under FLOAT32, decode_streamed bitwise the
    whole-image FLOAT32 decode (K13 either way, the same sums). Then
    decode_striped of the dense 4K request with fancy upsampling in 8
    stripes (K6f) bitwise its plain version. Wall times (host clock) and
    the card's peak allocated memory of each."""
    import torch
    from jpeg_decoder_tpu_torch import DecodeConfig, IdctPrecision, JpegDecoder, Quirks
    from jpeg_decoder_tpu_torch.io.parser import parse
    from jpeg_decoder_tpu_torch.parallel import stripes

    frame = parse(giga).frame
    n_chunks = -(-frame.width * frame.height // stripes.CHUNK_PIXELS)
    runs = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out, runs[name] = run_path(name, fn)
        s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**20
        mp = out.shape[0] * out.shape[1] / 1e6
        log(f"{name} ({out.shape[1]}x{out.shape[0]}, {mp:.1f} MP): {s:.3f} s,"
            f" {mp / s:.1f} MP/s; peak allocated on the card {peak:.0f} MiB [{card}]")
        return out

    for precision in (IdctPrecision.EXACT, IdctPrecision.FLOAT32):
        cfg = DecodeConfig(idct_precision=precision)
        p = precision.value
        streamed = timed(f"decode_streamed {p}",
                         lambda: stripes.decode_streamed(giga, cfg, device=dev))
        if runs[f"decode_streamed {p}"].get("K6n") != n_chunks:
            fail(f"decode_streamed {p} launched {runs[f'decode_streamed {p}']},"
                 f" not K6n once a chunk ({n_chunks})")
        whole = timed(f"JpegDecoder gigapixel {p}",
                      lambda: JpegDecoder(cfg, device=dev).decode_rgb(giga))
        if not np.array_equal(streamed, whole):
            fail(f"decode_streamed {p} differs from JpegDecoder's whole-image decode")
        del whole
        if precision == IdctPrecision.EXACT:
            striped = timed(f"decode_striped {p}", lambda: stripes.decode_striped(
                giga, cfg, n_stripes=N_STRIPES, device=dev))
            if not np.array_equal(streamed, striped):
                fail("decode_striped differs from decode_streamed")
            del striped
        log(f"main path gigapixel {p}: decode_streamed bitwise JpegDecoder's whole-image"
            f" decode{' and decode_striped (8 stripes)' if p == 'exact' else ''}")
        del streamed
    cfg = DecodeConfig(upsample="fancy", quirks=Quirks.CORRECT)
    got = timed("decode_striped fancy 4K", lambda: stripes.decode_striped(
        requests[0], cfg, n_stripes=N_STRIPES, device=dev))
    stage, planes = striped_case(dev, requests[0], cfg)
    if not np.array_equal(got, stage(*planes, plain=True)[:H].cpu().numpy()):
        fail("decode_striped fancy differs from K6f's plain version")
    log("main path decode_striped fancy 4K: bitwise the plain version of the striped rule")
    return runs


def resident_exchanges(stage, stripe_planes):
    """Stand-ins for a mesh's halo exchange with every stripe on this card:
    stripe k's `exchange(first, last)` for StripeStage.stripe gives its
    neighbours' edge rows (StripeStage.edge_rows of their K0/K1 planes), its
    own at the two ends."""
    from jpeg_decoder_tpu_torch.ops import idct

    edges = [stage.edge_rows([idct.idct_plane(p, q, stage.bits12, stage.precision)
                              for p, q in zip(planes, stage._qts())])
             for planes in stripe_planes]
    n = len(edges)
    return [lambda first, last, k=k: (edges[k - 1][2] if k else first,
                                      edges[k + 1][1] if k < n - 1 else last)
            for k in range(n)]


def stripe_by_stripe(stage, planes, plain: bool = False):
    """The padded frame decoded as a mesh's stripe axis decodes it, each
    stripe alone on this card (StripeStage.stripe: K0/K1, then K6h under
    fancy upsampling, its halo rows from resident_exchanges), concatenated."""
    import torch

    parts = stage._stripes(planes)
    exchanges = resident_exchanges(stage, parts)
    return torch.cat([stage.stripe(k, p, exchanges[k], plain=plain) for k, p in enumerate(parts)])


#: Stripes of the mesh phase's striped decodes, one a rank.
MESH_STRIPES = 2


def check_k6h(dev, requests, record: dict, card: str) -> None:
    """K6h (K3f over ONE stripe, its two halo rows a component given: the
    fancy colour stage of a rank of a mesh's stripe axis) bitwise against
    the one-launch K6f over the padded frame and against its plain version
    (StripeStage._fancy_stripe_plain, the JAX program's stripe): the dense
    4K request under CORRECT in 2 and 8 stripes, each stripe decoded alone
    (K0, then K6h with its neighbours' edge rows); under FLOAT32 (K1) in 2
    stripes against K6f; a random 4K frame with a (2, 4)-ratio component
    (the rule, so no halo on it) in 2 stripes. Then its time on the 4K
    request in 2 stripes: one call on one stripe, and the card alone over
    both stripes (two launches) beside K6f's K3f over the padded frame (one
    launch) in turns; the whole pixel stage, K0 x 3 + K6h a stripe beside K0
    x 3 + K3f, the card alone."""
    from jpeg_decoder_tpu_torch import DecodeConfig, IdctPrecision, Quirks
    from jpeg_decoder_tpu_torch.benchmarks import pixel_sweep
    from jpeg_decoder_tpu_torch.ops import color, idct

    cfg = DecodeConfig(upsample="fancy", quirks=Quirks.CORRECT)
    cases = {f"dense {W}x{H} 4:2:0 request, {n} stripes": (
        striped_case(dev, requests[0], cfg, n), True) for n in (MESH_STRIPES, N_STRIPES)}
    cases[f"dense {W}x{H} 4:2:0 request, FLOAT32, {MESH_STRIPES} stripes"] = (
        striped_case(dev, requests[0], cfg.replace(idct_precision=IdctPrecision.FLOAT32),
                     MESH_STRIPES), False)
    cases[f"random {W}x{H} planes, a (2, 4)-ratio component, {MESH_STRIPES} stripes"] = (
        synthetic_stripe_case(dev, H, W, ((2, 4), (1, 1), (1, 1)), 64, "fancy", Quirks.CORRECT,
                              n=MESH_STRIPES), True)
    err = 0
    for name, ((stage, planes), exact) in cases.items():
        got = stripe_by_stripe(stage, planes)
        e_f = max_abs_err(got, stage(*planes))
        e_p = max_abs_err(got, stripe_by_stripe(stage, planes, plain=True)) if exact else 0
        log(f"K6h, {name}: stripe by stripe max_abs_err {e_f} against K6f in one launch,"
            f" {e_p if exact else 'not compared (FLOAT32)'} against the plain version")
        err = max(err, e_f, e_p)
        del got
    record["max_abs_err"] = err
    if err != 0:
        fail(f"K6h disagrees with K6f or its plain version (max_abs_err {err}; tolerance 0)")
    (stage, planes), _ = cases[f"dense {W}x{H} 4:2:0 request, {MESH_STRIPES} stripes"]
    qts = stage._qts()
    parts = stage._stripes(planes)
    exchanges = resident_exchanges(stage, parts)
    pixel = [[idct.idct_plane(p, q, False, stage.precision) for p, q in zip(ps, qts)]
             for ps in parts]
    halos = [stage._halos(px, exchanges[k]) for k, px in enumerate(pixel)]
    whole = [idct.idct_plane(p, q, False, stage.precision) for p, q in zip(planes, qts)]

    def k6h(k):
        return stage._colour(pixel[k], stage.hs, "fancy", color.Stripes(k * stage.hs, stage.hs),
                             halos[k])

    def k6f():
        return stage._colour(whole, stage.pad_h, "fancy", color.Stripes(0, stage.hs))

    ms = [cuda_ms(lambda: k6h(0), 10), cuda_ms(lambda: k6h(0), 10)]
    turns = pixel_sweep.in_turns(lambda: [k6h(k) for k in range(MESH_STRIPES)], k6f, 7, "k6f")
    stage_k6h = pixel_sweep.card_ms(lambda: [stage.stripe(k, p, exchanges[k])
                                             for k, p in enumerate(parts)], 7)
    stage_k6f = pixel_sweep.card_ms(lambda: stage(*planes), 7)
    plain_ms = cuda_ms(lambda: stage._fancy_stripe_plain(0, pixel[0], halos[0]), 1)
    rows = [r for pair in halos[0] if pair is not None for r in pair]
    out = k6h(0)
    bnd = bound(nbytes_of(*pixel[0], *rows, out), 16 * out.shape[0] * out.shape[1], "int32")
    shape = (f"{W}x{stage.hs}, stripe 0 of {W}x{H} 4:2:0 in {MESH_STRIPES} stripes (padded to"
             f" {stage.pad_h} rows), {len(rows)} halo rows")
    log(f"K6h ({shape}): one call {ms[0]:.3f} and {ms[1]:.3f} ms; both stripes (two launches)"
        f" the card alone {turns['card_ms'][0]:.4f} and {turns['card_ms'][1]:.4f} ms, K6f (K3f"
        f" over the padded frame) {turns['k6f_card_ms'][0]:.4f} and"
        f" {turns['k6f_card_ms'][1]:.4f} ms (in turns); L2 flushed"
        f" {turns['flushed_ms'][0]:.4f} and {turns['flushed_ms'][1]:.4f} ms, K6f"
        f" {turns['k6f_flushed_ms'][0]:.4f} and {turns['k6f_flushed_ms'][1]:.4f} ms;"
        f" plain {plain_ms:.3f} ms; bound {bnd['bound_ms']:.4f} ms by {bnd['bound_by']}; the"
        f" pixel stage a stripe at a time (K0 x 3 + K6h, both stripes) the card alone"
        f" {stage_k6h:.4f} ms, K6f (K0 x 3 + K3f, one launch each) {stage_k6f:.4f} ms [{card}]")
    record.update(ms=statistics.median(ms), ms_runs=ms, card_ms=turns["card_ms"],
                  k6f_card_ms=turns["k6f_card_ms"], flushed_ms=turns["flushed_ms"],
                  k6f_flushed_ms=turns["k6f_flushed_ms"], stage_card_ms=stage_k6h,
                  k6f_stage_card_ms=stage_k6f, plain_ms=plain_ms, library_ms=None, shape=shape,
                  **bnd)


def run_ranks(tmp, world: int, backend: str, cases, timeout: float = 600.0) -> list:
    """benchmarks/mesh_ranks.py in `world` processes of one process group
    (`backend`, a file store in `tmp`), all on this card; each rank's JSON
    record. The first rank to fail (or the deadline) ends the others and the
    script."""
    from jpeg_decoder_tpu_torch.benchmarks import mesh_ranks

    try:
        return mesh_ranks.run_ranks("jpeg_decoder_tpu_torch.benchmarks.mesh_ranks",
                                    [str(tmp), "--backend", backend, "--cases", *cases],
                                    world, tmp, timeout)
    except RuntimeError as e:
        fail(f"mesh ({backend}): {e}")


def mesh_path(dev, batch, giga: bytes, card: str) -> dict:
    """The mesh paths (parallel/mesh.py, multihost.py), each rank a process
    of its own on this card (benchmarks/mesh_ranks.py), every launch count
    set to 0 in each rank just before its path and read just after:
    - one rank under NCCL: BatchDecoder(mesh).decode_batch of the eight 4K
      requests (PALLAS and NATIVE, EXACT and FLOAT32), decode_striped(mesh)
      of the dense 4K request (fancy EXACT and FLOAT32, nearest-neighbour)
      and dryrun_multichip(1);
    - two ranks under gloo, both on this card: the same batches over a data
      axis of 2, the 4K request over a stripe axis of 2 (fancy through K6h,
      the halo rows exchanged; nearest-neighbour through K6n),
      dryrun_multichip(2), and the gigapixel frame in 2 stripes (EXACT,
      nearest-neighbour);
    each bitwise the same call without a mesh on this card, every rank's
    result the same. NCCL across two or more cards is not run: the machine
    has one card."""
    import shutil

    tmp = scratch_dir()
    runs = {}
    try:
        for i, d in enumerate(batch):
            (tmp / f"batch{i}.jpg").write_bytes(d)
        (tmp / "gigapixel.jpg").write_bytes(giga)
        for world, backend, cases in ((1, "nccl", ("batches", "stripes", "dryrun")),
                                      (MESH_STRIPES, "gloo",
                                       ("batches", "stripes", "dryrun", "gigapixel"))):
            t0 = time.perf_counter()
            recs = run_ranks(tmp, world, backend, cases)
            log(f"mesh, {world} rank(s) under {backend}: {time.perf_counter() - t0:.1f} s with"
                f" the processes' start; {[r['process_info'] for r in recs]}")
            for case in recs[0]:
                if not isinstance(recs[0][case], dict) or "launches" not in recs[0][case]:
                    continue
                digests = {r[case]["sha256"] for r in recs}
                if len(digests) != 1:
                    fail(f"mesh {backend} x{world} {case}: the ranks' results differ")
                if any(r[case]["bitwise"] is False for r in recs) or all(
                        r[case]["bitwise"] is None for r in recs):
                    fail(f"mesh {backend} x{world} {case}: differs from the call without a"
                         f" mesh (or was compared on no rank)")
                for r in recs:
                    rec = r[case]
                    path = f"mesh {backend} x{world} rank{r['rank']}: {case}"
                    runs[path] = rec["launches"]
                    PATH_UNITS[path] = rec["units"]
                    log(f"{path}: launches {rec['launches']}; wall {rec['wall_s'] * 1e3:.1f} ms,"
                        f" halo exchange {rec['halo_s'] * 1e3:.3f} ms in {rec['halo_calls']}"
                        f" calls, all_gather {rec['gather_s'] * 1e3:.3f} ms in"
                        f" {rec['gather_calls']} calls (host clock); output {rec['shape']};"
                        f" bitwise the call without a mesh: {rec['bitwise']} [{card}]")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return runs


def printed_by(fn, *args):
    """fn(*args) with its standard output kept: (its result, that output)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue()


def bench_path(dev, card: str) -> dict:
    """The port of the JAX side's bench and serving scripts, each through
    its entry point in run_path (so its launches count): the headline
    bench at its full 4K workload with one host window, k2_batched at its
    own (eight 4K images), serving's main and progressive_serving, and
    scaling with --sizes 1 (one NCCL rank, a process of its own: its
    launches are read from its record)."""
    import shutil

    import torch

    from jpeg_decoder_tpu_torch import DecodeConfig
    from jpeg_decoder_tpu_torch.benchmarks import bench, k2_batched, scaling
    from jpeg_decoder_tpu_torch.examples import serving
    from jpeg_decoder_tpu_torch.models.decoder import decode

    runs = {}
    tmp = scratch_dir()
    try:
        t0 = time.perf_counter()
        (rc, _), runs["bench"] = run_path("bench", lambda: printed_by(
            bench.main, ["--max-attempts", "1", "--out", str(tmp / "bench.json")]))
        if rc != 0:
            fail(f"the bench exited {rc}")
        line = json.loads((tmp / "bench.json").read_text())
        log(f"bench in {time.perf_counter() - t0:.1f} s [{card}]: {json.dumps(line)}")
        if bench.LINE_KEYS - line.keys():
            fail(f"the bench's line lacks {sorted(bench.LINE_KEYS - line.keys())}")
        if line.get("bit_exact") is False:
            fail("the bench's EXACT RGB differs from the port's CPU decode, or a B=16 call's"
                 " images from its B=1 call's")
        if line["device_kind"] != torch.cuda.get_device_name(0):
            fail(f"the bench ran on {line['device_kind']!r}")

        t0 = time.perf_counter()
        (rc, out), runs["k2_batched"] = run_path("k2_batched", lambda: printed_by(
            k2_batched.main, []))
        if rc != 0:
            fail(f"k2_batched exited {rc} (its planes differ from the native host decoder's)")
        log(f"k2_batched in {time.perf_counter() - t0:.1f} s [{card}]: {out.strip()}")

        t0 = time.perf_counter()
        (datas, frames), runs["serving"] = run_path("serving", lambda: (
            serving.main(dev), serving.progressive_serving(dev))[0])
        if frames.shape != (len(datas), 512, 512, 3):
            fail(f"serving gave frames {frames.shape}")
        cpu = DecodeConfig().replace(use_device=False)
        for i, d in enumerate(datas):
            if not np.array_equal(frames[i], decode(d, cpu, device="cpu").rgb):
                fail(f"serving's frame {i} differs from the port's CPU decode of its bytes")
        log(f"serving in {time.perf_counter() - t0:.1f} s, its {len(datas)} frames bitwise"
            f" the port's CPU decode [{card}]")

        t0 = time.perf_counter()
        rc, out = printed_by(scaling.main, ["--sizes", "1", "--out", str(tmp / "scaling.json")])
        if rc != 0:
            fail(f"scaling exited {rc} (a rank failed, or its batch differs from the port's"
                 f" CPU decode)")
        rec = json.loads((tmp / "scaling.json").read_text())["shared_core_raw"]["sizes"][0]
        path = "scaling nccl x1 rank0"
        runs[path] = rec["launches"][0]
        PATH_UNITS[path] = rec["units"][0]
        log(f"scaling in {time.perf_counter() - t0:.1f} s with the rank's start [{card}]:"
            f" {out.strip()}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return runs


def gigapixel_stage_times(dev, giga: bytes, card: str) -> None:
    """decode_streamed's chunks one by one with their steps timed: host
    entropy (host clock), H2D of the chunk's int16 planes, K6n one call and
    the D2H of the chunk's real rows into the zeroed host output (first
    touch of its pages) and again into the same rows (CUDA events); then
    the host's peak resident set and the card's peak allocated memory of
    decode_streamed and of decode_striped (8 stripes), each in a process of
    its own (benchmarks/gigapixel.py: VmRSS sampled during the decode)."""
    import torch
    from jpeg_decoder_tpu_torch import DecodeConfig, _build
    from jpeg_decoder_tpu_torch.benchmarks import gigapixel
    from jpeg_decoder_tpu_torch.io.parser import parse
    from jpeg_decoder_tpu_torch.parallel import stripes

    cfg = DecodeConfig()
    structure = parse(giga, cfg)
    frame = structure.frame
    n = -(-frame.height * frame.width // stripes.CHUNK_PIXELS)
    decode_stripe, lby, qts = stripes._striped_entropy_plan(structure, cfg, n)
    stage = stripes.make_chunk_stage(stripes._stage_for(frame, qts, cfg), n, dev)
    flat, bufs, flat_dev, chunk_dev = stripes._chunk_buffers(frame, lby, dev)
    out = np.zeros((frame.height, frame.width, 3), np.uint8)
    steps = {"host entropy": [], "H2D": [], "K6n": [], "D2H first touch": [], "D2H again": []}
    box = {}
    for k in range(n):
        t0 = time.perf_counter()
        flat.fill(0)
        decode_stripe(k, bufs)
        steps["host entropy"].append((time.perf_counter() - t0) * 1e3)
        steps["H2D"].append(cuda_ms(lambda: flat_dev.copy_(torch.from_numpy(flat)), 1))
        steps["K6n"].append(cuda_ms(lambda: box.update(rgb=stage(k, *chunk_dev)), 1))
        r0 = k * stage.hs
        take = min(stage.hs, frame.height - r0)
        for key in ("D2H first touch", "D2H again"):
            steps[key].append(cuda_ms(lambda: torch.from_numpy(out[r0:r0 + take]).copy_(
                box["rgb"][:take]), 1))
    coef_mb = flat.nbytes / 1e6
    rgb_mb = stage.hs * frame.width * 3 / 1e6
    for key, ts in steps.items():
        log(f"gigapixel stage times, {key}: {sum(ts):.1f} ms over {n} chunks, per chunk"
            f" {[round(t, 3) for t in ts]} ms ({coef_mb:.1f} MB of coefficients,"
            f" {rgb_mb:.1f} MB of RGB a chunk) [{card}]")
    del out
    path = _build.BUILD_DIR / "gigapixel_input.jpg"
    path.write_bytes(giga)
    try:
        for engine, stripes_n in (("streamed", None), ("striped", N_STRIPES)):
            r = gigapixel.measure(path, engine, n_stripes=stripes_n)
            log(f"gigapixel memory, decode_{engine} exact (a process of its own):"
                f" {r['decode_s']:.3f} s, {r['mp_per_s']:.1f} MP/s, peak allocated on the card"
                f" {r['max_memory_allocated_mb']:.0f} MiB, host peak resident set (VmRSS"
                f" sampled every 2 ms) {r['peak_rss_mb']:.0f} MiB; before the decode"
                f" {r['rss_before_mb']:.0f} MiB, of which {r['rss_after_imports_mb']:.0f}"
                f" after importing the package and torch, the rest the warm-up's (the card's"
                f" context, the kernels, a 2048x2048 decode); VmHWM {r['vm_hwm_mb']}"
                f" MiB, ru_maxrss {r['ru_maxrss_mb']:.0f} MiB (this script's at the fork"
                f" included) [{r['card']}]")
    finally:
        path.unlink(missing_ok=True)


def pixel_launches_ok(launches: dict, n: int, fused: bool) -> bool:
    """The pixel stage of n EXACT requests (or batches) launched K03 once
    each and neither K0 nor K3 (`fused`), or K0 for each component and K3
    once each and no K03 (gray)."""
    if fused:
        return (launches.get("jdtc_pixel_exact") == n and "jdtc_idct_exact" not in launches
                and "jdtc_color" not in launches)
    return ("jdtc_pixel_exact" not in launches and launches.get("jdtc_color") == n
            and launches.get("jdtc_idct_exact") == n)


def main_path(dev, requests, card: str, label: str = "", fused: bool = True) -> dict:
    """Both EXACT configs through the public entry points, against the
    reference. Returns path -> launch counts of its run; `label` tells a
    second set of requests from the first. `fused`: three-component
    requests, one K03 launch each; else gray ones, K0 and K3."""
    from jpeg_decoder_tpu_torch import (
        DecodeConfig,
        EntropyBackend,
        JpegDecoder,
        Quirks,
    )

    runs = {}
    for cfg in (DecodeConfig(entropy_backend=EntropyBackend.PALLAS),
                DecodeConfig()):
        name = cfg.entropy_backend.value + label
        dec = JpegDecoder(cfg, device=dev)
        e2e = []

        def serve():
            outs = []
            for data in requests:
                t0 = time.perf_counter()
                outs.append(dec.decode(data))
                e2e.append((time.perf_counter() - t0) * 1e3)
            return outs

        outs, runs[f"JpegDecoder {name} exact"] = run_path(
            f"main path JpegDecoder {name} exact", serve)
        if not pixel_launches_ok(runs[f"JpegDecoder {name} exact"], len(requests), fused):
            fail(f"{name}: the pixel stage launched {runs[f'JpegDecoder {name} exact']}")
        for data, img in zip(requests, outs):
            _, pix, rgb = reference(data, Quirks.REFERENCE)
            if not np.array_equal(img.rgb, rgb):
                fail(f"{name}: RGB differs from the reference")
            if not all(np.array_equal(a, b) for a, b in zip(img.planes, pix)):
                fail(f"{name}: pixel planes differ from the reference")
        log(f"main path {name}: {len(requests)} requests bitwise equal to the"
            f" reference")
        log(f"main path {name}: end-to-end ms per request (host clock)"
            f" {[round(t, 3) for t in e2e]} [{card}]")
    return runs


def float32_path(dev, requests, gray: bytes, card: str) -> dict:
    """JpegDecoder(FLOAT32) for PALLAS and NATIVE: one K13 launch a 4K
    request and no K1 or K3, pixel planes within 1 of the EXACT reference's,
    RGB bitwise equal to the colour stage of the returned planes; then the
    gray request, K1 and K3."""
    import torch
    from jpeg_decoder_tpu_torch import (
        DecodeConfig,
        EntropyBackend,
        IdctPrecision,
        JpegDecoder,
        Quirks,
    )
    from jpeg_decoder_tpu_torch.ops import color

    runs = {}
    for backend in (EntropyBackend.PALLAS, EntropyBackend.NATIVE):
        cfg = DecodeConfig(entropy_backend=backend, idct_precision=IdctPrecision.FLOAT32)
        dec = JpegDecoder(cfg, device=dev)
        e2e = []

        def serve():
            outs = []
            for data in requests:
                t0 = time.perf_counter()
                outs.append(dec.decode(data))
                e2e.append((time.perf_counter() - t0) * 1e3)
            return outs

        name = f"JpegDecoder {backend.value} float32"
        outs, runs[name] = run_path(f"main path {name}", serve)
        pixel_launches = {k: v for k, v in runs[name].items()
                          if k not in ("jdtc_entropy_decode", "jdtc_unstuff")}
        if pixel_launches != {"jdtc_pixel_float": len(requests)}:
            fail(f"{name}: the pixel stage launched {runs[name]}")
        errs, shares = [], []
        for data, img in zip(requests, outs):
            _, pix, _ = reference(data, Quirks.REFERENCE)
            errs.append(max(max_abs_err(a, b) for a, b in zip(img.planes, pix)))
            shares.append(max(share_differing(a, b) for a, b in zip(img.planes, pix)))
            f = img.frame
            colour = color._planes_to_rgb_plain(
                [torch.from_numpy(p).to(dev) for p in img.planes], f.height, f.width,
                F420, Quirks.REFERENCE).cpu().numpy()
            if not np.array_equal(img.rgb, colour):
                fail(f"{name}: RGB is not the colour stage of its planes")
        log(f"main path {name}: pixel planes against the EXACT reference:"
            f" max_abs_err {errs}, share differing {[f'{x:.3e}' for x in shares]};"
            f" RGB bitwise the colour stage of the planes")
        log(f"main path {name}: end-to-end ms per request (host clock)"
            f" {[round(t, 3) for t in e2e]} [{card}]")
        if max(errs) > 1:
            fail(f"{name}: pixel planes more than 1 from EXACT")
        # a gray frame keeps K1 and K3
        gname = f"JpegDecoder {backend.value} (gray) float32"
        img, runs[gname] = run_path(f"main path {gname}", lambda: dec.decode(gray))
        glaunch = {k: v for k, v in runs[gname].items()
                   if k not in ("jdtc_entropy_decode", "jdtc_unstuff")}
        if glaunch != {"jdtc_idct_float": 1, "jdtc_color": 1}:
            fail(f"{gname}: the pixel stage launched {runs[gname]}")
        _, pix, _ = reference(gray, Quirks.REFERENCE)
        gerr = max_abs_err(img.planes[0], pix[0])
        log(f"main path {gname}: pixel plane against the EXACT reference max_abs_err {gerr}")
        if gerr > 1:
            fail(f"{gname}: pixel plane more than 1 from EXACT")
    return runs


def batch_path(dev, batch, many, card: str) -> dict:
    """BatchDecoder for PALLAS and NATIVE, EXACT and FLOAT32: decode_batch,
    decode_stream(batch_size=4) and decode_many, every RGB bitwise equal to
    the single-image decode with the same config (NATIVE for a member the
    PALLAS route hands to the native host decode), and to the reference
    under EXACT."""
    from jpeg_decoder_tpu_torch import (
        BatchDecoder,
        DecodeConfig,
        EntropyBackend,
        IdctPrecision,
        JpegDecoder,
        Quirks,
    )
    from jpeg_decoder_tpu_torch.ops import entropy_cuda
    from jpeg_decoder_tpu_torch.io.parser import parse

    runs = {}
    for backend in (EntropyBackend.PALLAS, EntropyBackend.NATIVE):
        for precision in IdctPrecision:
            cfg = DecodeConfig(entropy_backend=backend, idct_precision=precision)
            name = f"BatchDecoder {backend.value} {precision.value}"
            dec = BatchDecoder(cfg, device=dev)
            t = {}

            def timed(key, fn):
                t0 = time.perf_counter()
                out = fn()
                t[key] = (time.perf_counter() - t0) * 1e3
                return out

            rgb, launches = run_path(
                f"main path {name} decode_batch",
                lambda: timed("batch", lambda: dec.decode_batch(batch)))
            runs[f"{name} decode_batch"] = launches
            exact = precision == IdctPrecision.EXACT
            fused = "jdtc_pixel_exact" if exact else "jdtc_pixel_float"
            idct = "jdtc_idct_exact" if exact else "jdtc_idct_float"
            want = {fused: 1}
            if backend == EntropyBackend.PALLAS:
                want["jdtc_entropy_decode"] = want["jdtc_unstuff"] = 1
            if launches != want:
                fail(f"{name}: decode_batch launched {launches}, expected {want}")
            stream, runs[f"{name} decode_stream"] = run_path(
                f"main path {name} decode_stream",
                lambda: timed("stream", lambda: list(dec.decode_stream(batch, batch_size=4))))
            out_many, runs[f"{name} decode_many"] = run_path(
                f"main path {name} decode_many",
                lambda: timed("many", lambda: dec.decode_many(many)))
            # a K03 (EXACT) or K13 (FLOAT32) launch a batch of 3-component
            # images (two batches of four; decode_many's two 4K groups), K0
            # or K1 and K3 only for the gray member of decode_many
            stream_launches = runs[f"{name} decode_stream"]
            many_launches = runs[f"{name} decode_many"]
            if not (stream_launches.get(fused) == 2 and idct not in stream_launches
                    and "jdtc_color" not in stream_launches
                    and many_launches.get(fused) == 2 and many_launches.get(idct) == 1
                    and many_launches.get("jdtc_color") == 1):
                fail(f"{name}: decode_stream launched {runs[f'{name} decode_stream']},"
                     f" decode_many {runs[f'{name} decode_many']}")
            # the single-image decode with the same config; a member the
            # PALLAS route hands to the native host decode, with NATIVE
            single = JpegDecoder(cfg, device=dev)
            host_single = JpegDecoder(
                DecodeConfig(idct_precision=precision), device=dev)
            got = list(rgb) + list(np.concatenate(stream)) + out_many
            datas = list(batch) + list(batch) + list(many)
            for g, d in zip(got, datas):
                one = single if entropy_cuda.batchable(parse(d)) else host_single
                if not np.array_equal(g, one.decode_rgb(d)):
                    fail(f"{name}: a batched RGB differs from its single-image decode")
                if exact:
                    # the restart-free request holds request 0's coefficients
                    ref = REFERENCE_OF.get(d, d)
                    if not np.array_equal(g, reference(ref, Quirks.REFERENCE)[2]):
                        fail(f"{name}: a batched RGB differs from the reference")
            log(f"main path {name}: {len(got)} RGB outputs bitwise equal to the"
                f" single-image decode{' and the reference' if exact else ''};"
                f" host clock: decode_batch of {len(batch)} {t['batch']:.3f} ms,"
                f" decode_stream {t['stream']:.3f} ms, decode_many of {len(many)}"
                f" {t['many']:.3f} ms [{card}]")
    return runs


def device_path(dev, inputs: dict, card: str) -> dict:
    """JpegDecoder(DEVICE) on each 4K input of device_inputs, EXACT, its RGB
    and pixel planes bitwise JpegDecoder(NATIVE)'s on the card, one K2u and
    one K2d launch a scan and no PALLAS K2; and BatchDecoder(DEVICE).
    decode_batch of two restart-free 4K images, each bitwise its single
    decode."""
    from jpeg_decoder_tpu_torch import BatchDecoder, DecodeConfig, EntropyBackend, JpegDecoder
    from jpeg_decoder_tpu_torch.io.parser import parse

    dec = JpegDecoder(DecodeConfig(entropy_backend=EntropyBackend.DEVICE), device=dev)
    native = JpegDecoder(DecodeConfig(), device=dev)
    runs = {}
    for name, (data, _twin) in inputs.items():
        path = f"JpegDecoder DEVICE exact ({name})"
        t0 = time.perf_counter()
        got, launches = run_path(path, lambda: dec.decode(data))
        wall = (time.perf_counter() - t0) * 1e3
        runs[path] = launches
        want = native.decode(data)
        n_scans = len(parse(data).scans)
        if launches.get("K2d") != n_scans or launches.get("jdtc_unstuff") != n_scans \
                or "jdtc_entropy_decode" in launches:
            fail(f"{path} launched {launches}")
        e = max(max_abs_err(got.rgb, want.rgb),
                *[max_abs_err(a, b) for a, b in zip(got.planes, want.planes)])
        if e != 0:
            fail(f"{path}: RGB or planes differ from JpegDecoder(NATIVE) (max_abs_err {e})")
        log(f"main path {path}: RGB and planes bitwise JpegDecoder(NATIVE)'s; host clock"
            f" {wall:.1f} ms with the launch counts' bookkeeping [{card}]")
    pair = [inputs["dense 4K, restart-free"][0], inputs["bench.make_input_nodri"][0]]
    bdec = BatchDecoder(DecodeConfig(entropy_backend=EntropyBackend.DEVICE), device=dev)
    path = "BatchDecoder DEVICE exact decode_batch"
    rgb, runs[path] = run_path(path, lambda: bdec.decode_batch(pair[:1] * 2))
    if runs[path].get("K2d") != 2:
        fail(f"{path} launched {runs[path]}")
    for g in rgb:
        if not np.array_equal(g, dec.decode_rgb(pair[0])):
            fail(f"{path}: a batched RGB differs from its single-image decode")
    log(f"main path {path}: two restart-free 4K members, each bitwise its single decode")
    return runs


@functools.lru_cache(maxsize=None)
def host_reference(data: bytes, quirks, upsample: str):
    """The JAX-free reference of a full-size EXACT decode: the port's
    use_device=False host pixel path (models/decoder._host_pixel_stage: the
    NumPy oracle's EXACT IDCT, then its colour conversion or, for fancy
    upsampling, the NumPy triangular passes) on the native host planes,
    with `reference`'s pixel planes. Returns (pixel planes, RGB)."""
    from jpeg_decoder_tpu_torch.core import oracle
    from jpeg_decoder_tpu_torch.io.parser import parse
    from jpeg_decoder_tpu_torch.models import decoder

    frame = parse(data).frame
    _, pix, rgb = reference(data, quirks)
    if upsample == "fancy" and frame.ncs in (3, 4):
        rgb = decoder._host_fancy_convert(frame, pix, quirks)
    else:
        rgb = oracle.color_convert(frame, pix, quirks)
    return pix, rgb


def new_paths(dev, requests, batch, cmyk: bytes, card: str) -> dict:
    """The configs of ROADMAP item 2 through JpegDecoder and BatchDecoder,
    PALLAS and NATIVE, each on the route of PixelStage:
    - a 4K fancy request, EXACT (K0 x 3 + K3f: RGB and planes bitwise the
      host reference) and FLOAT32 (K1 x 3 + K3f: planes within 1 of it,
      RGB bitwise the colour stage of the returned planes);
    - the 4K 4-component frame under REFERENCE (YCCK) and CORRECT (its
      APP14 transform 0: CMYK) quirks (K0 x 4 + K3c), bitwise the host
      reference;
    - 4K requests at scale 1, 2 and 4 (K5 once + K3): against the plain
      version on CPU tensors (NATIVE entropy), planes by K1's rule and
      bitwise at scale 1, RGB within 3 and bitwise the colour stage of the
      returned planes;
    - BatchDecoder: decode_batch of the eight 4K requests with fancy
      upsampling (K0 x 3 + K3f once), each RGB bitwise the host reference
      and the single-image decode.
    Returns path -> launch counts of its run."""
    import torch
    from jpeg_decoder_tpu_torch import (
        BatchDecoder,
        DecodeConfig,
        EntropyBackend,
        IdctPrecision,
        JpegDecoder,
        Quirks,
    )
    from jpeg_decoder_tpu_torch import decode as port_decode
    from jpeg_decoder_tpu_torch.ops import color

    FLOAT32 = IdctPrecision.FLOAT32
    runs = {}

    def pixel_part(launches):
        return {k: v for k, v in launches.items()
                if k not in ("jdtc_entropy_decode", "jdtc_unstuff")}

    for backend in (EntropyBackend.PALLAS, EntropyBackend.NATIVE):
        b = backend.value
        requests_of = {
            f"JpegDecoder {b} fancy exact": (requests[0], DecodeConfig(upsample="fancy"),
                                             {"jdtc_idct_exact": 3, "jdtc_fancy": 1}),
            f"JpegDecoder {b} fancy float32": (
                requests[0], DecodeConfig(upsample="fancy", idct_precision=FLOAT32),
                {"jdtc_idct_float": 3, "jdtc_fancy": 1}),
            f"JpegDecoder {b} ycck exact": (cmyk, DecodeConfig(),
                                            {"jdtc_idct_exact": 4, "jdtc_color": 1}),
            f"JpegDecoder {b} cmyk exact": (cmyk, DecodeConfig(quirks=Quirks.CORRECT),
                                            {"jdtc_idct_exact": 4, "jdtc_color": 1}),
            **{f"JpegDecoder {b} scale {k}": (requests[0], DecodeConfig(scale=k),
                                              {"jdtc_idct_scaled": 1, "jdtc_color": 1})
               for k in (1, 2, 4)},
        }
        for name, (data, cfg, route) in requests_of.items():
            cfg = cfg.replace(entropy_backend=backend)
            dec = JpegDecoder(cfg, device=dev)
            t0 = time.perf_counter()
            img, runs[name] = run_path(f"main path {name}", lambda: dec.decode(data))
            e2e = (time.perf_counter() - t0) * 1e3
            if pixel_part(runs[name]) != route:
                fail(f"{name}: the pixel stage launched {runs[name]}, expected {route}")
            f = img.frame
            if cfg.scale == 8:
                pix, rgb = host_reference(data, cfg.quirks, cfg.upsample)
                if cfg.idct_precision == IdctPrecision.EXACT:
                    if not (np.array_equal(img.rgb, rgb)
                            and all(np.array_equal(x, y) for x, y in zip(img.planes, pix))):
                        fail(f"{name}: RGB or planes differ from the host reference")
                    note = "RGB and planes bitwise the host reference"
                else:
                    e = max(max_abs_err(x, y) for x, y in zip(img.planes, pix))
                    own = color._planes_to_rgb_plain(
                        [torch.from_numpy(p).to(dev) for p in img.planes], f.height, f.width,
                        F420, cfg.quirks, cfg.upsample, False).cpu().numpy()
                    if e > 1 or not np.array_equal(img.rgb, own):
                        fail(f"{name}: planes {e} from the host reference's, or RGB not the"
                             f" colour stage of its planes")
                    note = (f"planes max_abs_err {e} against the host reference, RGB bitwise"
                            f" the colour stage of the planes")
            else:
                want = port_decode(data, cfg.replace(entropy_backend=EntropyBackend.NATIVE),
                                   device="cpu")
                e = max(max_abs_err(x, y) for x, y in zip(img.planes, want.planes))
                sh = max(share_differing(x, y) for x, y in zip(img.planes, want.planes))
                h, w = img.rgb.shape[:2]
                own = color._planes_to_rgb_plain(
                    [torch.from_numpy(p).to(dev) for p in img.planes], h, w, F420,
                    cfg.quirks).cpu().numpy()
                rgb_e = max_abs_err(img.rgb, want.rgb)
                if (e > 1 or sh > K1_SHARE or (cfg.scale == 1 and e != 0) or rgb_e > 3
                        or not np.array_equal(img.rgb, own)):
                    fail(f"{name}: planes {e} (share {sh:.3e}) or RGB {rgb_e} from the plain"
                         f" version on CPU tensors, or RGB not the colour stage of its planes")
                note = (f"{w}x{h}; planes against the plain version on CPU tensors max_abs_err"
                        f" {e}, share {sh:.3e}; RGB max_abs_err {rgb_e}, bitwise the colour"
                        f" stage of the planes")
            log(f"main path {name}: {note}; end-to-end {e2e:.3f} ms (host clock) [{card}]")

        name = f"BatchDecoder {b} fancy exact decode_batch"
        cfg = DecodeConfig(entropy_backend=backend, upsample="fancy")
        dec = BatchDecoder(cfg, device=dev)
        t0 = time.perf_counter()
        rgb, runs[name] = run_path(f"main path {name}", lambda: dec.decode_batch(batch))
        e2e = (time.perf_counter() - t0) * 1e3
        want = {"jdtc_idct_exact": 3, "jdtc_fancy": 1}
        if pixel_part(runs[name]) != want:
            fail(f"{name}: launched {runs[name]}, expected {want} for the pixel stage")
        one = JpegDecoder(cfg, device=dev)
        for g, d in zip(rgb, batch):
            if not np.array_equal(g, host_reference(d, Quirks.REFERENCE, "fancy")[1]):
                fail(f"{name}: a batched RGB differs from the host reference")
            if not np.array_equal(g, one.decode_rgb(d)):
                fail(f"{name}: a batched RGB differs from its single-image decode")
        log(f"main path {name}: {len(batch)} RGB outputs bitwise the host reference and the"
            f" single-image decode; decode_batch {e2e:.3f} ms (host clock) [{card}]")
    return runs


#: request -> the request whose reference it shares (same coefficients)
REFERENCE_OF: dict = {}


def scratch_dir():
    """A fresh directory under the ignored build directory for this run's
    files (checkpoints, the CLI's inputs and outputs); the caller removes
    it."""
    import shutil

    from jpeg_decoder_tpu_torch import _build

    d = _build.BUILD_DIR / "smoke_files"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    return d


#: The progressive stream of the checkpoint phase: a random image of this
#: size, encoded progressive by the port's encoder (its CPU path), decoded
#: scan by scan (the Python scan loop: a 4K stream would take minutes)
CHECKPOINT_SHAPE = (240, 320)


def checkpoint_path(dev, big: bytes, card: str) -> dict:
    """ScanDecoder (core/checkpoint.py) on the card:
    - a progressive stream decoded scan by scan, checkpointed after half its
      scans, resumed by a new ScanDecoder over a fresh parse and finished on
      the card: bitwise the port's CPU finish of the same checkpoint and
      JpegDecoder's decode on the card (K03 once);
    - the 4K dense request's planes from the native host decode, written as
      a finished checkpoint, restored and finished on the card at full
      size: EXACT through K03, bitwise the JAX-free reference; FLOAT32
      through K13, bitwise JpegDecoder(FLOAT32) on the card and within 1 of
      the CPU finish on at most K1_SHARE of the pixels.
    Returns path -> launch counts; prints the steps' host-clock times."""
    import shutil

    import torch
    from jpeg_decoder_tpu_torch import (
        DecodeConfig,
        EncodeConfig,
        IdctPrecision,
        JpegDecoder,
        Quirks,
    )
    from jpeg_decoder_tpu_torch import encode as port_encode
    from jpeg_decoder_tpu_torch.core import checkpoint
    from jpeg_decoder_tpu_torch.io.parser import parse
    from jpeg_decoder_tpu_torch.models import host

    runs = {}
    tmp = scratch_dir()
    try:
        rng = np.random.default_rng(ENCODE_SEED + 1)
        img = rng.integers(0, 256, (*CHECKPOINT_SHAPE, 3), dtype=np.uint8)
        data = port_encode(img, EncodeConfig(progressive=True), device="cpu")
        cfg = DecodeConfig()
        ck = tmp / "progressive.npz"
        t0 = time.perf_counter()
        d = checkpoint.ScanDecoder(parse(data), cfg, device=dev)
        half = d.total_scans // 2
        while d.scans_done < half:
            d.step()
        d.checkpoint(ck)
        first_s = time.perf_counter() - t0

        def resume(device):
            r = checkpoint.ScanDecoder.restore(ck, parse(data), cfg, device=device)
            while not r.finished:
                r.step()
            return r

        t0 = time.perf_counter()
        r = resume(dev)
        steps_s = time.perf_counter() - t0
        name = "ScanDecoder progressive exact"
        t0 = time.perf_counter()
        got, runs[name] = run_path(f"main path {name}", r.finish)
        finish_ms = (time.perf_counter() - t0) * 1e3
        if runs[name] != {"jdtc_pixel_exact": 1}:
            fail(f"{name}: finish launched {runs[name]}, expected K03 once")
        cpu = resume("cpu").finish()
        one = JpegDecoder(cfg, device=dev).decode(data)
        if not (np.array_equal(got.rgb, cpu.rgb) and np.array_equal(got.rgb, one.rgb)
                and all(np.array_equal(a, b) for a, b in zip(got.planes, cpu.planes))):
            fail(f"{name}: finish on the card differs from the CPU finish or JpegDecoder's")
        log(f"main path {name}: {CHECKPOINT_SHAPE[1]}x{CHECKPOINT_SHAPE[0]} 4:2:0, {d.total_scans}"
            f" scans, checkpointed after {half} and resumed; RGB and planes bitwise the CPU"
            f" finish and JpegDecoder's RGB; scans before the checkpoint and the file"
            f" {first_s:.2f} s, restore and the remaining scans {steps_s:.2f} s (the Python"
            f" scan loop), finish on the card {finish_ms:.3f} ms (host clock) [{card}]")

        frame, planes, qts = host.host_decode(big, DecodeConfig())
        structure = parse(big)
        ck = tmp / "request_4k.npz"
        t0 = time.perf_counter()
        checkpoint.save_checkpoint(ck, frame, planes, len(structure.scans), qts)
        save_s = time.perf_counter() - t0
        _, pix, rgb = reference(big, Quirks.REFERENCE)
        for precision, entry in ((IdctPrecision.EXACT, "jdtc_pixel_exact"),
                                 (IdctPrecision.FLOAT32, "jdtc_pixel_float")):
            c = DecodeConfig(idct_precision=precision)
            t0 = time.perf_counter()
            r = checkpoint.ScanDecoder.restore(ck, structure, c, device=dev)
            restore_s = time.perf_counter() - t0
            if not r.finished:
                fail("the 4K checkpoint did not restore as finished")
            name = f"ScanDecoder 4K {precision.value} finish"
            r.finish()  # warm: the stage's first call
            t0 = time.perf_counter()
            got, runs[name] = run_path(f"main path {name}", r.finish)
            finish_ms = (time.perf_counter() - t0) * 1e3
            if runs[name] != {entry: 1}:
                fail(f"{name}: finish launched {runs[name]}, expected {entry} once")
            if precision == IdctPrecision.EXACT:
                if not (np.array_equal(got.rgb, rgb)
                        and all(np.array_equal(a, b) for a, b in zip(got.planes, pix))):
                    fail(f"{name}: RGB or planes differ from the reference")
                note = "RGB and planes bitwise the JAX-free reference"
            else:
                one = JpegDecoder(c, device=dev).decode(big)
                cpu = checkpoint.ScanDecoder.restore(ck, structure, c, device="cpu").finish()
                e = max(max_abs_err(a, b) for a, b in zip(got.planes, cpu.planes))
                sh = max(share_differing(a, b) for a, b in zip(got.planes, cpu.planes))
                if (not np.array_equal(got.rgb, one.rgb)
                        or not all(np.array_equal(a, b) for a, b in zip(got.planes, one.planes))
                        or e > 1 or sh > K1_SHARE):
                    fail(f"{name}: differs from JpegDecoder(FLOAT32) on the card, or planes"
                         f" {e} (share {sh:.3e}) from the CPU finish")
                note = (f"RGB and planes bitwise JpegDecoder(FLOAT32) on the card; planes"
                        f" against the CPU finish max_abs_err {e}, share {sh:.3e}")
            log(f"main path {name}: the {W}x{H} request's planes as a finished checkpoint"
                f" ({ck.stat().st_size} bytes, written in {save_s:.2f} s, restored in"
                f" {restore_s:.2f} s); {note}; finish (warm, RGB and planes to the host)"
                f" {finish_ms:.3f} ms (host clock) [{card}]")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return runs


def run_cli(*args, timeout: int = 600) -> subprocess.CompletedProcess:
    """`python -m jpeg_decoder_tpu_torch.cli *args` in a process of its own
    (from the repository root: the port's checkout), on the card by the
    CLI's default; fails on a nonzero exit."""
    r = subprocess.run([sys.executable, "-m", "jpeg_decoder_tpu_torch.cli", *map(str, args)],
                       capture_output=True, text=True, timeout=timeout,
                       cwd=str(Path(__file__).resolve().parent))
    if r.returncode != 0:
        fail(f"the CLI {' '.join(map(str, args))} exited {r.returncode}: {r.stderr[-3000:]}")
    return r


def cli_phase(dev, big: bytes, batch: list, image, card: str) -> None:
    """The CLI (python -m jpeg_decoder_tpu_torch.cli) on the card, each
    command in a process of its own and each output against the library
    call on the card in this process: decode of the 4K request to .npy and
    .ppm, --scale 1/2, --streamed, decode-batch --format npy of four 4K
    requests, encode of a 4K photograph from .npy (the bytes of
    jtt.encode on the card) and the decode of those bytes, info --json (the
    structure_summary), and bench, all at once."""
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    from jpeg_decoder_tpu_torch import DecodeConfig, EncodeConfig, JpegDecoder
    from jpeg_decoder_tpu_torch import decode as port_decode
    from jpeg_decoder_tpu_torch import encode as port_encode
    from jpeg_decoder_tpu_torch.io.parser import parse
    from jpeg_decoder_tpu_torch.parallel import stripes
    from jpeg_decoder_tpu_torch.utils.debug import structure_summary

    tmp = scratch_dir()
    try:
        src = tmp / "request.jpg"
        src.write_bytes(big)
        inputs = []
        for i, d in enumerate(batch[:4]):
            inputs.append(tmp / f"batch{i}.jpg")
            inputs[-1].write_bytes(d)
        np.save(tmp / "photo.npy", image)
        # the library's bytes, which the CLI's encode must equal: the CLI
        # decodes them back in the same step
        jpg = port_encode(image, EncodeConfig(restart_interval=W // 16), device=dev)
        (tmp / "photo_lib.jpg").write_bytes(jpg)
        commands = {
            "decode npy": ("decode", src, tmp / "out.npy"),
            "decode ppm": ("decode", src, tmp / "out.ppm"),
            "decode --scale 1/2": ("decode", src, tmp / "half.npy", "--scale", "1/2"),
            "decode --streamed": ("decode", src, tmp / "streamed.npy", "--streamed"),
            "decode-batch": ("decode-batch", *inputs, "--out-dir", tmp / "batch", "--format",
                             "npy"),
            "encode": ("encode", tmp / "photo.npy", tmp / "photo.jpg", "--restart-interval",
                       W // 16),
            "info --json": ("info", src, "--json"),
            "decode of the encode": ("decode", tmp / "photo_lib.jpg", tmp / "photo_back.npy"),
            "bench": ("bench", src, "--repeat", 5),
        }
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(commands)) as ex:
            done = dict(zip(commands, ex.map(lambda a: run_cli(*a), commands.values())))
        wall_s = time.perf_counter() - t0
        dec = JpegDecoder(DecodeConfig(), device=dev)
        rgb = dec.decode_rgb(big)
        checks = {
            "decode npy": np.array_equal(np.load(tmp / "out.npy"), rgb),
            "decode ppm": (tmp / "out.ppm").read_bytes()
            == b"P6\n%d %d\n255\n" % (W, H) + rgb.tobytes(),
            "decode --scale 1/2": np.array_equal(
                np.load(tmp / "half.npy"), port_decode(big, DecodeConfig(scale=4), dev).rgb),
            "decode --streamed": np.array_equal(
                np.load(tmp / "streamed.npy"), stripes.decode_streamed(big, DecodeConfig(),
                                                                      device=dev)),
            "decode-batch": all(np.array_equal(np.load(tmp / "batch" / f"batch{i}.npy"),
                                               dec.decode_rgb(d))
                                for i, d in enumerate(batch[:4])),
            "encode": (tmp / "photo.jpg").read_bytes() == jpg,
            "info --json": json.loads(done["info --json"].stdout)
            == json.loads(json.dumps(structure_summary(parse(big)))),
            "decode of the encode": np.array_equal(np.load(tmp / "photo_back.npy"),
                                                   dec.decode_rgb(jpg)),
        }
        rec = json.loads(done["bench"].stdout)
        checks["bench"] = rec["metric"] == "cli_decode_throughput" and rec["value"] > 0
        bad = [k for k, ok in checks.items() if not ok]
        if bad:
            fail(f"the CLI's output differs from the library call on the card: {bad}")
        log(f"CLI on the card: {', '.join(checks)} bitwise the library calls on the card;"
            f" {len(commands)} commands together {wall_s:.1f} s (each process imports torch"
            f" and loads the built kernels; bench beside the others); decode stderr"
            f" {done['decode npy'].stderr.strip()!r}; bench {rec} [{card}]")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# Stage times
# ---------------------------------------------------------------------------


def stage_times(dev, requests, card: str, label: str = "image") -> None:
    """Per-image CUDA-event times of the PALLAS path's device stages (the
    pixel stage under EXACT, K03, and FLOAT32, K13)."""
    from jpeg_decoder_tpu_torch import DecodeConfig, EntropyBackend, IdctPrecision, convert
    from jpeg_decoder_tpu_torch.models import decoder
    from jpeg_decoder_tpu_torch.ops import entropy_cuda
    from jpeg_decoder_tpu_torch.io.parser import parse

    cfg = DecodeConfig(entropy_backend=EntropyBackend.PALLAS)
    for i, data in enumerate(requests):
        t0 = time.perf_counter()
        s = parse(data)
        host = entropy_cuda.host_args([entropy_cuda.prepare_scan(s, s.scans[0])])
        host_ms = (time.perf_counter() - t0) * 1e3
        planes = convert.zero_planes(s.frame, dev)
        box = {}
        h2d = cuda_ms(lambda: box.update(dev=entropy_cuda.to_device(host, dev)), 1)
        raw, lo, hi, *rest = box["dev"]
        k2u = cuda_ms(lambda: box.update(un=entropy_cuda.unstuff_segments(raw, lo, hi)), 1)
        stream, seg_off, sub_base = box["un"]
        on_host = entropy_cuda.HostArrays(entropy_cuda.raw_bound(host[1], host[2]), host[3],
                                          host[6], host[7], sub_base)
        k2 = cuda_ms(lambda: box.update(status=entropy_cuda.decode_segments(
            stream, seg_off, *rest, [planes], host=on_host)), 1)
        entropy_cuda.check_status(box["status"], seg_off)
        stage = decoder.device_stage_for(
            s.frame, {t: q.values for t, q in s.scans[0].quant_tables.items()}, cfg, dev)
        stage32 = decoder.device_stage_for(
            s.frame, {t: q.values for t, q in s.scans[0].quant_tables.items()},
            cfg.replace(idct_precision=IdctPrecision.FLOAT32), dev)
        if not stage.fused or not stage32.fused:
            fail(f"stage times: the {label} request does not take K03 and K13")
        # JpegDecoder's call: RGB and the pixel planes
        k13 = cuda_ms(lambda: stage32(*planes, want_planes=True), 1)
        k03 = cuda_ms(lambda: box.update(rgb=stage(*planes, want_planes=True)[0]), 1)
        d2h = cuda_ms(lambda: box["rgb"].cpu(), 1)
        log(f"stage times {label} {i}: host parse {host_ms:.3f} ms,"
            f" H2D {h2d:.3f} ms ({sum(r.nbytes for r in host[0])} B), K2u {k2u:.3f} ms, K2 {k2:.3f} ms,"
            f" K03 {k03:.3f} ms (FLOAT32: K13 {k13:.3f} ms), D2H rgb {d2h:.3f} ms [{card}]")


def new_stage_times(dev, big: bytes, cmyk: bytes, card: str) -> None:
    """The pixel stage of item 2's routes on a 4K request, JpegDecoder's
    call (RGB and planes): CUDA events around one call and the card alone
    (pixel_sweep.card_ms), and the warm request latency through
    JpegDecoder (PALLAS, the median of three; host clock), beside the
    nearest-neighbour EXACT route (K03) on the same request."""
    import torch
    from jpeg_decoder_tpu_torch import (
        DecodeConfig,
        EntropyBackend,
        IdctPrecision,
        JpegDecoder,
        Quirks,
        convert,
    )
    from jpeg_decoder_tpu_torch.benchmarks import pixel_sweep
    from jpeg_decoder_tpu_torch.models import decoder, host

    configs = {
        "4:2:0 nn exact (K03)": (big, DecodeConfig()),
        "4:2:0 fancy exact (K0 x 3 + K3f)": (big, DecodeConfig(upsample="fancy")),
        "4:2:0 fancy float32 (K1 x 3 + K3f)": (
            big, DecodeConfig(upsample="fancy", idct_precision=IdctPrecision.FLOAT32)),
        "4:2:0 scale 4 (K5 + K3)": (big, DecodeConfig(scale=4)),
        "4:2:0 scale 1 (K5 + K3)": (big, DecodeConfig(scale=1)),
        "4:4:4 YCCK exact (K0 x 4 + K3c)": (cmyk, DecodeConfig()),
        "4:4:4 CMYK exact (K0 x 4 + K3c)": (cmyk, DecodeConfig(quirks=Quirks.CORRECT)),
    }
    for name, (data, cfg) in configs.items():
        frame, planes, qts = host.host_decode(data, DecodeConfig())
        coeffs = convert.planes_to_device(planes, dev)
        stage = decoder.device_stage_for(frame, qts, cfg, dev)
        run = lambda: stage(*coeffs, want_planes=True)  # noqa: E731
        one = cuda_ms(run, 3)
        alone = pixel_sweep.card_ms(run, 3)
        box = {}
        cuda_ms(lambda: box.update(out=run()), 1)
        d2h = cuda_ms(lambda: [box["out"][0].cpu(), *(p.cpu() for p in box["out"][1])], 1)
        dec = JpegDecoder(cfg.replace(entropy_backend=EntropyBackend.PALLAS), device=dev)
        dec.decode(data)
        e2e = []
        for _ in range(3):
            t0 = time.perf_counter()
            dec.decode(data)
            e2e.append((time.perf_counter() - t0) * 1e3)
        log(f"stage times {name}: pixel stage {one:.3f} ms one call, {alone:.4f} ms the card"
            f" alone; D2H RGB and planes {d2h:.3f} ms; PALLAS request (warm, host clock)"
            f" {statistics.median(e2e):.3f} ms [{card}]")


def batch_stage_times(dev, batch, card: str) -> None:
    """CUDA-event times of one PALLAS batch's device stages, EXACT and
    FLOAT32, with the host clock of its parse (the segments' raw bounds;
    unstuffing is K2u's)."""
    import torch
    from jpeg_decoder_tpu_torch import DecodeConfig, EntropyBackend, IdctPrecision
    from jpeg_decoder_tpu_torch.models import decoder
    from jpeg_decoder_tpu_torch.ops import entropy_cuda
    from jpeg_decoder_tpu_torch.io.parser import parse

    for precision in IdctPrecision:
        cfg = DecodeConfig(entropy_backend=EntropyBackend.PALLAS, idct_precision=precision)
        t0 = time.perf_counter()
        structures = [parse(d) for d in batch]
        host = entropy_cuda.host_args(
            [entropy_cuda.prepare_scan(s, s.scans[0]) for s in structures])
        host_ms = (time.perf_counter() - t0) * 1e3
        frame = structures[0].frame
        stacks = [torch.zeros((len(batch), c.blocks_y, c.blocks_x, 64),
                              dtype=torch.int16, device=dev) for c in frame.components]
        box = {}
        h2d = cuda_ms(lambda: box.update(dev=entropy_cuda.to_device(host, dev)), 1)
        raw, lo, hi, *rest = box["dev"]
        k2u = cuda_ms(lambda: box.update(un=entropy_cuda.unstuff_segments(raw, lo, hi)), 1)
        stream, seg_off, sub_base = box["un"]
        on_host = entropy_cuda.HostArrays(entropy_cuda.raw_bound(host[1], host[2]), host[3],
                                          host[6], host[7], sub_base)
        k2 = cuda_ms(lambda: box.update(status=entropy_cuda.decode_segments(
            stream, seg_off, *rest,
            [[st[i] for st in stacks] for i in range(len(batch))], host=on_host)), 1)
        entropy_cuda.check_status(box["status"], seg_off)
        stage = decoder.device_stage_for(
            frame, {t: q.values for t, q in structures[0].scans[0].quant_tables.items()},
            cfg, dev)
        if precision == IdctPrecision.EXACT:
            if not stage.fused:
                fail("batch stage times: the batch does not take K03")
            # BatchDecoder's call: RGB alone
            k03 = cuda_ms(lambda: box.update(rgb=stage(*stacks, want_planes=False)[0]), 1)
            pixel = f"K03 {k03:.3f} ms"
        else:
            if not stage.fused:
                fail("batch stage times: the FLOAT32 batch does not take K13")
            k13 = cuda_ms(lambda: box.update(rgb=stage(*stacks, want_planes=False)[0]), 1)
            pixel = f"K13 {k13:.3f} ms"
        d2h = cuda_ms(lambda: box["rgb"].cpu(), 1)
        nbytes = sum(r.nbytes for r in host[0])
        log(f"batch stage times ({len(batch)} x {W}x{H}, {precision.value}):"
            f" host parse {host_ms:.3f} ms, H2D {h2d:.3f} ms ({nbytes} B),"
            f" K2u {k2u:.3f} ms, K2 {k2:.3f} ms, {pixel}, D2H rgb {d2h:.3f} ms"
            f" ({box['rgb'].numel()} B) [{card}]")


# ---------------------------------------------------------------------------
# The encoder (ROADMAP item 4): K4 and the encode path
# ---------------------------------------------------------------------------

ENCODE_SEED = 20261017           # the uniform random 4K image and the small ones
K4_QUALITIES = (10, 85, 100)
#: the encode path's config: 4:2:0, q85, a restart marker per MCU row, Annex K
ENCODE_CFG = dict(quality=85, subsampling="420", restart_interval=W // 16)


def encode_images(photo_data: bytes) -> dict:
    """The encoder's inputs: a 3840x2160 photograph (the JAX-free EXACT
    decode of a photograph's tile, benchmarks.inputs.photo_jpeg), a uniform
    random 3840x2160 image from a seed (the packer's worst case), a 33x47
    and an 8x8 RGB image (planes of one block) and a 41x57 gray one."""
    from jpeg_decoder_tpu_torch import Quirks

    rng = np.random.default_rng(ENCODE_SEED)
    return {f"photograph {W}x{H}": np.ascontiguousarray(reference(photo_data, Quirks.REFERENCE)[2]),
            f"random {W}x{H}": rng.integers(0, 256, (H, W, 3), dtype=np.uint8),
            "random 33x47": rng.integers(0, 256, (33, 47, 3), dtype=np.uint8),
            "random 8x8": rng.integers(0, 256, (8, 8, 3), dtype=np.uint8),
            "random 41x57 gray": rng.integers(0, 256, (41, 57), dtype=np.uint8)}


def k4_cases(img) -> dict:
    """K4's cases on one image: name -> (its factors, the image it takes):
    the six chroma samplings and gray (luma) of an RGB image, and a 2-D gray
    image (an RGB image's green channel)."""
    from jpeg_decoder_tpu_torch.models import encoder

    if img.ndim == 2:
        return {"gray 2-D": (((1, 1),), img)}
    cases = {s: (f, img) for s, f in encoder._SAMPLING.items()}
    cases["gray"] = (((1, 1),), img)
    cases["gray 2-D"] = (((1, 1),), np.ascontiguousarray(img[..., 1]))
    return cases


def check_k4(dev, images: dict, record: dict, card: str) -> None:
    """K4 against its plain version on the card, every coefficient bitwise:
    both 4K images and the two small ones, every sampling and gray, at q =
    10, 85 and 100. Then its time on the 4K photograph at 4:2:0 and 4:4:4,
    q85, the card alone and with L2 flushed (pixel_sweep.k4_turns), and one
    call, beside the product alone as one torch.matmul ([N, 64] x [64, 64],
    TF32 off); its registers and shared memory, and LDS and FFMA in its
    SASS."""
    import torch
    from jpeg_decoder_tpu_torch.benchmarks import k2u_sweep, pixel_sweep
    from jpeg_decoder_tpu_torch.models import encoder
    from jpeg_decoder_tpu_torch.ops import fdct, idct

    differing, compared, err = 0, 0, 0
    for name, img in images.items():
        for case, (factors, x) in k4_cases(img).items():
            src = torch.from_numpy(x).to(dev)
            for q in K4_QUALITIES:
                kq = fdct.fdct_tables(encoder.quality_qtables(q)[: 1 if len(factors) == 1 else 2],
                                      dev)
                got = fdct.encode_planes(src, factors, kq)
                want = fdct._planes_plain(src, factors, kq)
                for a, b in zip(got, want, strict=True):
                    d = (a.to(torch.int32) - b.to(torch.int32)).abs()
                    differing += int((d != 0).sum().item())
                    err = max(err, int(d.max().item()))
                    compared += d.numel()
        log(f"K4 fdct, {name}: {len(k4_cases(img))} samplings x q {K4_QUALITIES} against"
            f" the plain version on the card")
    log(f"K4 fdct: {differing} of {compared} coefficients differ from the plain version"
        f" (max_abs_err {err}; tolerance 0)")
    record.update(max_abs_err=err, differing=differing, coefficients_compared=compared)
    if differing:
        fail(f"K4 differs from its plain version on {differing} coefficients")

    photo = torch.from_numpy(images[f"photograph {W}x{H}"]).to(dev)
    for sub in ("420", "444"):
        factors = encoder._SAMPLING[sub]
        kq = fdct.fdct_tables(encoder.quality_qtables(85), dev)
        _, _, comps = fdct.plane_layout(H, W, factors)
        blocks = sum(by * bx for by, bx, _, _ in comps)
        out = torch.empty(blocks * 64, dtype=torch.int16, device=dev)
        run = lambda: fdct.encode_planes(photo, factors, kq, out)  # noqa: E731
        turns = pixel_sweep.k4_turns(photo, factors, kq, 7)
        one = [cuda_ms(run, 10), cuda_ms(run, 10)]
        plain_ms = cuda_ms(lambda: fdct._planes_plain(photo, factors, kq), 1)
        x = torch.randn(blocks, 64, device=dev)
        prod = torch.empty_like(x)
        with idct._true_float32_matmul():
            matmul_ms = pixel_sweep.card_ms(lambda: torch.matmul(x, kq[0], out=prod), 7)
        # Bound: the RGB read once, the int16 coefficients and Kq written and
        # read once; the chain is 4096 FMAs a block, two float32 operations
        # each (the colour and box steps' few a sample far below).
        bnd = bound(nbytes_of(photo, out, kq), 2 * 4096 * blocks, "float32")
        shape = f"{W}x{H} {sub}, {blocks} blocks, run {fdct.run_mcus(factors)} MCUs"
        log(f"K4 fdct ({shape}): {times_line(turns)}; one call {one[0]:.3f} and {one[1]:.3f}"
            f" ms; the product alone (torch.matmul [{blocks}, 64] x [64, 64], TF32 off; the"
            f" card alone) {matmul_ms:.4f} ms; plain {plain_ms:.3f} ms; bound"
            f" {bnd['bound_ms']:.4f} ms by {bnd['bound_by']} [{card}]")
        if sub == "420":
            record.update(ms=turns["card_ms"], plain_ms=plain_ms,
                          library_ms=None, shape=shape, **turns, one_call_ms=one,
                          matmul_ms=matmul_ms, **bnd)
        else:
            record.update(shape_444=shape, turns_444=turns, one_call_ms_444=one,
                          plain_ms_444=plain_ms, matmul_ms_444=matmul_ms,
                          bound_ms_444=bnd["bound_ms"])
    record["ptxas"] = k2u_sweep.ptxas_report("fdct.cu")
    record["sass"] = sass_of(pixel_sweep.sass_mix(), ("fdct_kernel",))
    log(f"K4 registers and shared memory (nvcc -Xptxas -v): {record['ptxas']}; LDS and FFMA"
        f" in the SASS {record['sass']}")


def k4_planes(dev, img, cfg) -> list:
    """The coefficient planes K4 makes of `img` under `cfg`, on the host."""
    import torch
    from jpeg_decoder_tpu_torch.models import encoder

    qts = encoder.quality_qtables(cfg.quality)
    stage = encoder._build_encode_stage(
        img.shape[0], img.shape[1], cfg.subsampling, (qts[0].tobytes(), qts[1].tobytes()),
        cfg.subsampling == "gray" or img.ndim == 2, dev)
    return [p.cpu().numpy() for p in stage(torch.from_numpy(img).to(dev))[1]]


def encode_path(dev, images: dict, card: str) -> dict:
    """JpegEncoder on the card: the 4K photograph at 4:2:0, q85, a restart
    marker per MCU row, Annex K tables, byte for byte the port's CPU
    encode; then once each with optimized tables, progressive and 4:4:4,
    whose native host decode gives K4's planes; encode_stream of four 4K
    images against four encode calls. Each run: one K4 launch an image and
    nothing else, no plain version, no Python packer. Then the photograph's
    bytes through JpegDecoder(PALLAS, EXACT): RGB bitwise the JAX-free
    reference, its host planes K4's. Returns path -> launch counts."""
    from jpeg_decoder_tpu_torch import (
        DecodeConfig,
        EncodeConfig,
        EntropyBackend,
        JpegDecoder,
        JpegEncoder,
        Quirks,
        encode,
    )
    from jpeg_decoder_tpu_torch.models import encoder, host
    from jpeg_decoder_tpu_torch.ops import fdct

    photo = images[f"photograph {W}x{H}"]
    rand = images[f"random {W}x{H}"]
    runs = {}

    def on_card(path, cfg, imgs, stream=False):
        enc = JpegEncoder(cfg, device=dev)
        fdct.PLAIN_CALLS.clear()
        encoder.FALLBACKS.clear()
        t0 = time.perf_counter()
        out, launches = run_path(
            f"main path {path}",
            lambda: list(enc.encode_stream(imgs)) if stream else [enc.encode(i) for i in imgs])
        ms = (time.perf_counter() - t0) * 1e3
        if launches != {"jdtc_fdct": len(imgs)} or fdct.PLAIN_CALLS or encoder.FALLBACKS:
            fail(f"{path}: launches {launches}, plain calls {dict(fdct.PLAIN_CALLS)}, Python"
                 f" packer {dict(encoder.FALLBACKS)}; want one K4 launch an image alone")
        runs[path] = launches
        log(f"main path {path}: {len(imgs)} images, {[len(b) for b in out]} bytes,"
            f" {ms:.1f} ms (host clock, first call) [{card}]")
        return out

    base = EncodeConfig(**ENCODE_CFG)
    (card_bytes,) = on_card("JpegEncoder 4:2:0 q85 annex_k", base, [photo])
    t0 = time.perf_counter()
    cpu_bytes = encode(photo, base, device="cpu")
    log(f"encode path: the card's bytes {'equal' if card_bytes == cpu_bytes else 'DIFFER FROM'}"
        f" the CPU encode's ({len(cpu_bytes)} bytes; the CPU encode took"
        f" {time.perf_counter() - t0:.1f} s)")
    if card_bytes != cpu_bytes:
        fail("the card's encode differs from the CPU encode (plain versions)")
    for label, cfg in (("optimized", base.replace(huffman="optimized")),
                       ("progressive", base.replace(progressive=True)),
                       ("4:4:4", base.replace(subsampling="444"))):
        (data,) = on_card(f"JpegEncoder {label}", cfg, [photo])
        _, planes, _ = host.host_decode(data, DecodeConfig())
        want = k4_planes(dev, photo, cfg)
        if len(planes.planes) != len(want) or not all(
                np.array_equal(a, b) for a, b in zip(planes.planes, want)):
            fail(f"encode {label}: the host decode of its bytes is not K4's planes")
        log(f"encode path {label}: the native host decode of its {len(data)} bytes gives K4's"
            f" planes")
    four = [photo, rand, np.ascontiguousarray(photo[::-1]), np.ascontiguousarray(rand[:, ::-1])]
    streamed = on_card("JpegEncoder encode_stream", base, four, stream=True)
    enc = JpegEncoder(base, device=dev)
    if streamed != [enc.encode(i) for i in four]:
        fail("encode_stream differs from per-image encode calls")
    log("encode path: encode_stream of four 4K images equals four encode calls")

    dec = JpegDecoder(DecodeConfig(entropy_backend=EntropyBackend.PALLAS), device=dev)
    img, runs["JpegDecoder pallas exact (encoded photograph)"] = run_path(
        "main path JpegDecoder pallas exact (encoded photograph)", lambda: dec.decode(card_bytes))
    planes, _, rgb = reference(card_bytes, Quirks.REFERENCE)
    if not np.array_equal(img.rgb, rgb):
        fail("PALLAS EXACT's decode of the encoded photograph differs from the reference")
    if not all(np.array_equal(a, b) for a, b in
               zip(planes.planes, k4_planes(dev, photo, base), strict=True)):
        fail("the host planes of the encoded photograph are not K4's")
    log("encode path: PALLAS EXACT decodes the encoded 4K photograph bitwise to the"
        " reference, and its host planes are K4's")
    return runs


def encode_stage_times(dev, images: dict, card: str) -> None:
    """A warm 4K 4:2:0 encode of the photograph, stage by stage: H2D of the
    RGB, K4, D2H of the planes into a pinned buffer (CUDA events); the
    native symbol count (optimized tables), the native pack and the whole
    assembly (tables, pack, markers; host clock, median of three); the
    encode latency (median of three) and the time an image of a warm
    encode_stream of eight; the host's steps of each (dispatch, wait,
    assembly; the encoder's metrics timers)."""
    import torch
    from jpeg_decoder_tpu_torch import EncodeConfig, JpegEncoder
    from jpeg_decoder_tpu_torch.core import huffman
    from jpeg_decoder_tpu_torch.models import encoder
    from jpeg_decoder_tpu_torch.utils.metrics import GLOBAL_METRICS as metrics

    photo = images[f"photograph {W}x{H}"]
    cfg = EncodeConfig(**ENCODE_CFG)
    enc = JpegEncoder(cfg, device=dev)
    enc.encode(photo)
    qts, qt_bytes = enc._qts()
    stage = encoder._build_encode_stage(H, W, cfg.subsampling, qt_bytes, False, dev)
    box = {}
    h2d = cuda_ms(lambda: box.update(src=torch.from_numpy(photo).to(dev)), 3)
    k4 = cuda_ms(lambda: box.update(flat=stage(box["src"])[0]), 10)
    pinned = torch.empty(box["flat"].shape, dtype=torch.int16, pin_memory=True)
    d2h = cuda_ms(lambda: pinned.copy_(box["flat"], non_blocking=True), 5)
    coeffs = stage.split(pinned.numpy())
    mx, my, factors = stage.mcus_x, stage.mcus_y, stage.factors

    def steps_ms() -> dict:
        return {k.removeprefix("encode_"): round(v["mean_s"] * 1e3, 3)
                for k, v in metrics.summary().items() if k.startswith("encode_")}

    def host_ms(fn) -> float:
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    count = host_ms(lambda: enc._count(coeffs, factors, mx, my, 2,
                                       cfg.replace(huffman="optimized")))
    dc_specs, ac_specs = enc._huffman_specs(cfg, coeffs, factors, mx, my, False)
    dc = [huffman.build_encode_table(s) for s in dc_specs]
    ac = [huffman.build_encode_table(s) for s in ac_specs]
    pack = host_ms(lambda: enc._pack(coeffs, factors, mx, my, dc, ac, 2, cfg))
    assemble = host_ms(lambda: enc._assemble_baseline(cfg, H, W, False, coeffs, factors, mx,
                                                      my, qts))
    metrics.stages.clear()
    latency = host_ms(lambda: enc.encode(photo))
    single = steps_ms()
    eight = [photo if k % 2 == 0 else np.ascontiguousarray(photo[::-1]) for k in range(8)]
    list(enc.encode_stream(eight))  # warm: the stream's second pinned buffer
    metrics.stages.clear()
    t0 = time.perf_counter()
    list(enc.encode_stream(eight))
    per_image = (time.perf_counter() - t0) * 1e3 / len(eight)
    streamed = steps_ms()
    log(f"encode stage times ({W}x{H} 4:2:0 photograph, q85, ri {cfg.restart_interval}):"
        f" H2D rgb {h2d:.3f} ms ({photo.nbytes} B), K4 {k4:.3f} ms, D2H planes {d2h:.3f} ms"
        f" ({box['flat'].numel() * 2} B, pinned); native count (optimized) {count:.3f} ms,"
        f" native pack {pack:.3f} ms, assembly (tables, pack, markers) {assemble:.3f} ms;"
        f" encode latency (warm, median of three) {latency:.3f} ms; encode_stream of eight"
        f" {per_image:.3f} ms an image [{card}]")
    log(f"encode steps, ms an image (host clock: the upload, K4 and the copy queued; the wait"
        f" for the planes; tables, pack and markers): encode {single}; encode_stream {streamed}")


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    try:
        from jpeg_decoder_tpu_torch import _build
        from jpeg_decoder_tpu_torch.benchmarks.inputs import (
            CMYK_FILE,
            DRI_FILES,
            GIGAPIXEL,
            PHOTOS,
            PHOTOS_420,
            gigapixel_jpeg,
            make_jpeg,
            photo_jpeg,
        )
        from jpeg_decoder_tpu_torch.native import build as native_build
        from jpeg_decoder_tpu_torch.utils import jax_free
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
    native = native_build.build()
    if native is None or native.parent != _build.BUILD_DIR:
        fail(f"the native host runtime did not build into {_build.BUILD_DIR}")
    log(f"native host runtime built in {time.perf_counter() - t0:.1f} s: {native.name}")

    t0 = time.perf_counter()
    batch = [make_jpeg(W, H, F420, RI, seed) for seed in BATCH_SEEDS]
    requests = batch[: len(SEEDS)]
    no_dri = make_jpeg(W, H, F420, 0, SEEDS[0])
    REFERENCE_OF[no_dri] = requests[0]
    gray = make_jpeg(GRAY[0], GRAY[1], ((1, 1),), 0, 11)
    smalls = [make_jpeg(SMALL[0], SMALL[1], F420, SMALL[2], seed) for seed in SMALL_SEEDS]
    many = [requests[0], requests[1], no_dri, gray]
    files = {f"file {p.name}": p.read_bytes() for p in DRI_FILES}
    tiled = {f"photograph {p.name} tiled to {W}x{H}": photo_jpeg(p, W, H, RI)
             for p in PHOTOS_420}
    # 4:4:4, a marker per MCU row; APP14 transform 0: YCCK under REFERENCE
    # quirks, raw CMYK under CORRECT
    cmyk = photo_jpeg(CMYK_FILE, W, H, W // 8)
    log(f"inputs: {len(batch)} x {W}x{H} 4:2:0, ri {RI},"
        f" {[len(r) for r in batch]} bytes; the same frame restart-free"
        f" ({len(no_dri)} bytes); {len(files)} foreign files with restart markers"
        f" ({[len(r) for r in files.values()]} bytes); {len(tiled)} photographs tiled to"
        f" {W}x{H} ({[len(r) for r in tiled.values()]} bytes); {CMYK_FILE.name} tiled to"
        f" {W}x{H} ({len(cmyk)} bytes, 4 components); made in"
        f" {time.perf_counter() - t0:.1f} s")

    kernels = {
        "jdtc_entropy_decode": dict(
            name="K2 entropy_decode", route="cuda",
            source="jpeg_decoder_tpu_torch/csrc/entropy_decode.cu",
            replaces="jpeg_decoder_tpu/ops/entropy_pallas.py:607"),
        # K2 on the DEVICE route: the same entry point, its launches counted
        # under their own name (ops/entropy_device.COUNT_AS)
        "K2d": dict(
            name="K2d entropy_decode on the DEVICE route (whole segments)", route="cuda",
            source="jpeg_decoder_tpu_torch/csrc/entropy_decode.cu",
            replaces="jpeg_decoder_tpu/ops/entropy_device.py:61"),
        "jdtc_unstuff": dict(
            name="K2u unstuff (bounds given: PALLAS, batches; find_*: without bounds,"
                 " a DEVICE request's)", route="cuda",
            source="jpeg_decoder_tpu_torch/csrc/unstuff.cu",
            replaces="jpeg_decoder_tpu/ops/entropy_pallas.py:636"),
        "jdtc_idct_exact": dict(
            name="K0 idct_exact", route="cuda",
            source="jpeg_decoder_tpu_torch/csrc/idct_exact.cu",
            replaces="jpeg_decoder_tpu/ops/idct.py:189"),
        "jdtc_idct_float": dict(
            name="K1 idct_float", route="cuda",
            source="jpeg_decoder_tpu_torch/csrc/idct_float.cu",
            replaces="jpeg_decoder_tpu/ops/pallas_kernels.py:103"),
        "jdtc_color": dict(
            name="K3 color", route="cuda",
            source="jpeg_decoder_tpu_torch/csrc/color.cu",
            replaces="jpeg_decoder_tpu/ops/color.py:138"),
        "jdtc_pixel_exact": dict(
            name="K03 pixel_exact", route="cuda",
            source="jpeg_decoder_tpu_torch/csrc/pixel_exact.cu",
            replaces="jpeg_decoder_tpu/models/decoder.py:72"),
        "jdtc_pixel_float": dict(
            name="K13 pixel_float", route="cuda",
            source="jpeg_decoder_tpu_torch/csrc/pixel_float.cu",
            replaces="jpeg_decoder_tpu/ops/pallas_kernels.py:103"),
        "jdtc_fancy": dict(
            name="K3f fancy", route="cuda",
            source="jpeg_decoder_tpu_torch/csrc/color.cu",
            replaces="jpeg_decoder_tpu/ops/color.py:73"),
        # K3's kernel on four planes: its launches are jdtc_color's on the
        # 4-component paths (which K3's count includes)
        "K3c": dict(
            name="K3c color (K3 on four planes)", route="cuda",
            source="jpeg_decoder_tpu_torch/csrc/color.cu",
            replaces="jpeg_decoder_tpu/ops/color.py:181", entry="jdtc_color",
            on_paths=("ycck", "cmyk")),
        "jdtc_idct_scaled": dict(
            name="K5 idct_scaled", route="cuda",
            source="jpeg_decoder_tpu_torch/csrc/idct_scaled.cu",
            replaces="jpeg_decoder_tpu/ops/idct.py:261"),
        "jdtc_fdct": dict(
            name="K4 fdct", route="cuda",
            source="jpeg_decoder_tpu_torch/csrc/fdct.cu",
            replaces="jpeg_decoder_tpu/models/encoder.py:68"),
        # striped and streamed decode: K03/K13, or K0/K1 + K3/K3c, launched
        # with the stripe rule (colour::nn_row). The colour kernel's launch
        # counts here; a K0/K1 launch before it counts under its own name.
        # `ms` times the whole stage (K03 alone on the gigapixel chunk).
        "K6n": dict(
            name="K6n stripes, nearest-neighbour", route="cuda",
            source="jpeg_decoder_tpu_torch/csrc/pixel_exact.cu",
            sources=["jpeg_decoder_tpu_torch/csrc/pixel_exact.cu",
                     "jpeg_decoder_tpu_torch/csrc/pixel_float.cu",
                     "jpeg_decoder_tpu_torch/csrc/color.cu"],
            launches_count="the colour kernel (K03, K13, K3 or K3c) once a stage call",
            replaces="jpeg_decoder_tpu/parallel/stripes.py:322"),
        # K0/K1 over the padded planes, then K3f under the striped rule:
        # K3f's launch counts here, `ms` times K0 x 3 + K3f
        "K6f": dict(
            name="K6f stripes, fancy", route="cuda",
            source="jpeg_decoder_tpu_torch/csrc/color.cu",
            sources=["jpeg_decoder_tpu_torch/csrc/idct_exact.cu",
                     "jpeg_decoder_tpu_torch/csrc/color.cu"],
            launches_count="K3f once a stage call; K0's launches count as jdtc_idct_exact",
            replaces="jpeg_decoder_tpu/parallel/stripes.py:86"),
        # one stripe of a mesh's stripe axis, its halo rows given: K3f's
        # kernel with two halo rows a component (jdtc_fancy_halo); its
        # launches are the mesh phase's ranks'
        "K6h": dict(
            name="K6h stripe of a mesh, fancy", route="cuda",
            source="jpeg_decoder_tpu_torch/csrc/color.cu",
            launches_count="jdtc_fancy_halo once a stripe a rank; K0/K1's launches count"
                           " under their own names",
            replaces="jpeg_decoder_tpu/parallel/stripes.py:86"),
    }
    for key, (name, _standing, _ops, replaces) in PROBE_KERNELS.items():
        kernels[key] = dict(name=name, route="cuda",
                            source="jpeg_decoder_tpu_torch/csrc/probes.cu",
                            replaces=replaces)
    timed_phase("K2 against plain", check_k2, dev, smalls[0], requests[0],
                kernels["jdtc_entropy_decode"])
    timed_phase("K2 batched", check_k2_batch, dev, batch, smalls,
                kernels["jdtc_entropy_decode"])
    timed_phase("K2 on photographs", check_k2_photographs, dev, files, tiled,
                kernels["jdtc_entropy_decode"])
    timed_phase("K2u", check_k2u, dev, smalls[0], requests[0], no_dri, batch,
                kernels["jdtc_unstuff"], card)
    t0 = time.perf_counter()
    dev_inputs = device_inputs(no_dri, requests, tiled)
    log(f"inputs of the DEVICE route: {[(n, len(d)) for n, (d, _t) in dev_inputs.items()]}"
        f" bytes, made in {time.perf_counter() - t0:.1f} s")
    timed_phase("K2d, the DEVICE route", check_k2d, dev, dev_inputs, requests[0],
                kernels["K2d"], card)
    timed_phase("K0", check_k0, dev, requests[0], cmyk, kernels["jdtc_idct_exact"], card)
    timed_phase("K1", check_k1, dev, requests[0], kernels["jdtc_idct_float"], card)
    timed_phase("K3", check_k3, dev, requests[0], gray, kernels["jdtc_color"], card)
    photos = {f"file {DRI_FILES[1].name} (4:2:2)": DRI_FILES[1].read_bytes(),
              f"file {PHOTOS[0].name} (4:4:4)": PHOTOS[0].read_bytes()}
    cases = k03_cases(dev, requests, tiled, photos)
    timed_phase("K03", check_k03, dev, cases, batch, kernels["jdtc_pixel_exact"], card)
    timed_phase("K13", check_k13, dev, cases, batch, kernels["jdtc_pixel_float"], card)
    del cases
    timed_phase("K3f", check_k3f, dev, requests, files, cmyk, kernels["jdtc_fancy"], card)
    timed_phase("K3c", check_k3c, dev, cmyk, kernels["K3c"], card)
    timed_phase("K5", check_k5, dev, requests[0], kernels["jdtc_idct_scaled"], card)
    timed_phase("probes against plain", check_probes, dev, kernels, card)
    images = encode_images(tiled[f"photograph {PHOTOS_420[0].name} tiled to {W}x{H}"])
    timed_phase("K4", check_k4, dev, images, kernels["jdtc_fdct"], card)
    t0 = time.perf_counter()
    giga = gigapixel_jpeg()
    log(f"inputs: {PHOTOS_420[0].name} tiled to {GIGAPIXEL[0]}x{GIGAPIXEL[1]} 4:2:0 with a"
        f" marker per MCU row ({len(giga)} bytes) in {time.perf_counter() - t0:.1f} s")
    timed_phase("K6n", check_k6n, dev, giga, requests, cmyk, kernels["K6n"], card)
    timed_phase("K6f", check_k6f, dev, requests, kernels["K6f"], card)
    timed_phase("K6h", check_k6h, dev, requests, kernels["K6h"], card)
    for key, rec in kernels.items():
        if (key not in ("jdtc_idct_float", "jdtc_pixel_float", "jdtc_idct_scaled")
                and rec["max_abs_err"] != 0):
            fail(f"{rec['name']} disagrees with its plain version"
                 f" (max_abs_err {rec['max_abs_err']}; tolerance 0)")

    runs = timed_phase("main paths, single requests", main_path, dev, requests, card)
    runs.update(main_path(dev, [gray], card, " (gray)", fused=False))
    runs.update(main_path(dev, list(files.values()) + list(tiled.values()), card,
                          " (foreign files, photographs at 4K)"))
    runs.update(float32_path(dev, requests, gray, card))
    runs.update(timed_phase("main paths, batches", batch_path, dev, batch, many, card))
    runs.update(timed_phase("main paths, DEVICE entropy", device_path, dev, dev_inputs, card))
    runs.update(timed_phase("main paths, fancy, 4 components, scaled", new_paths, dev,
                            requests, batch, cmyk, card))
    runs.update(timed_phase("main path, probes", probe_path, kernels))
    runs.update(timed_phase("main path, encode", encode_path, dev, images, card))
    runs.update(timed_phase("main paths, checkpoint/resume", checkpoint_path, dev, requests[0],
                            card))
    timed_phase("CLI", cli_phase, dev, requests[0], batch, images[f"photograph {W}x{H}"], card)
    runs.update(timed_phase("main paths, streamed and striped", gigapixel_path, dev, giga,
                            requests, card))
    runs.update(timed_phase("main paths, mesh", mesh_path, dev, batch, giga, card))
    runs.update(timed_phase("main paths, bench and serving", bench_path, dev, card))
    for key, rec in kernels.items():
        entry = rec.get("entry", key)
        paths = {p: r for p, r in runs.items()
                 if any(w in p for w in rec.get("on_paths", ("",)))}
        rec["launches"] = sum(r.get(entry, 0) for r in paths.values())
        rec["launches_by_path"] = {p: r[entry] for p, r in paths.items() if entry in r}
        if rec["launches"] == 0:
            fail(f"{rec['name']} was not launched by a main path")
    size_weighted(kernels)
    for path, key in (("JpegDecoder pallas exact", "jdtc_entropy_decode"),
                      ("JpegDecoder pallas exact", "jdtc_unstuff"),
                      ("JpegDecoder pallas exact", "jdtc_pixel_exact"),
                      ("JpegDecoder native exact", "jdtc_pixel_exact"),
                      ("JpegDecoder pallas float32", "jdtc_pixel_float"),
                      ("JpegDecoder native float32", "jdtc_pixel_float"),
                      ("BatchDecoder pallas float32 decode_batch", "jdtc_pixel_float"),
                      ("JpegDecoder pallas (gray) float32", "jdtc_idct_float"),
                      ("JpegDecoder native (gray) exact", "jdtc_idct_exact"),
                      *[(f"JpegDecoder {b} {c}", k) for b in ("pallas", "native")
                        for c, k in (("fancy exact", "jdtc_fancy"),
                                     ("fancy float32", "jdtc_fancy"),
                                     ("ycck exact", "jdtc_color"),
                                     ("cmyk exact", "jdtc_color"),
                                     ("scale 1", "jdtc_idct_scaled"),
                                     ("scale 2", "jdtc_idct_scaled"),
                                     ("scale 4", "jdtc_idct_scaled"))],
                      ("BatchDecoder pallas fancy exact decode_batch", "jdtc_fancy"),
                      ("BatchDecoder native fancy exact decode_batch", "jdtc_fancy"),
                      ("JpegEncoder 4:2:0 q85 annex_k", "jdtc_fdct"),
                      ("JpegEncoder encode_stream", "jdtc_fdct"),
                      ("JpegDecoder pallas exact (encoded photograph)", "jdtc_pixel_exact"),
                      ("ScanDecoder progressive exact", "jdtc_pixel_exact"),
                      ("ScanDecoder 4K exact finish", "jdtc_pixel_exact"),
                      ("ScanDecoder 4K float32 finish", "jdtc_pixel_float"),
                      ("decode_streamed exact", "K6n"), ("decode_streamed float32", "K6n"),
                      ("decode_striped exact", "K6n"), ("decode_striped fancy 4K", "K6f"),
                      *[(f"mesh {m}: {case}", key) for m in ("nccl x1 rank0", "gloo x2 rank0",
                                                              "gloo x2 rank1")
                        for case, key in (
                            ("BatchDecoder mesh pallas exact decode_batch", "jdtc_pixel_exact"),
                            ("BatchDecoder mesh native float32 decode_batch",
                             "jdtc_pixel_float"),
                            ("decode_striped mesh fancy exact", "K6h"),
                            ("decode_striped mesh fancy pallas float32", "K6h"),
                            ("decode_striped mesh nn exact", "K6n"))],
                      ("mesh nccl x1 rank0: dryrun_multichip(1)", "K6h"),
                      ("mesh gloo x2 rank0: dryrun_multichip(2)", "K6h"),
                      ("mesh gloo x2 rank1: dryrun_multichip(2)", "jdtc_fdct"),
                      ("mesh gloo x2 rank0: decode_striped mesh gigapixel exact", "K6n"),
                      ("mesh gloo x2 rank1: decode_striped mesh gigapixel exact", "K6n"),
                      ("bench", "jdtc_pixel_exact"), ("bench", "jdtc_pixel_float"),
                      ("bench", "jdtc_fdct"), ("k2_batched", "jdtc_entropy_decode"),
                      ("k2_batched", "jdtc_unstuff"), ("serving", "jdtc_pixel_exact"),
                      *[(f"JpegDecoder DEVICE exact ({n})", "K2d") for n in dev_inputs],
                      ("BatchDecoder DEVICE exact decode_batch", "K2d"),
                      ("scaling nccl x1 rank0", "jdtc_pixel_exact")):
        if runs[path].get(key, 0) == 0:
            fail(f"{path} did not launch {key}")
    timed_phase("stage times", stage_times, dev, requests, card)
    stage_times(dev, list(tiled.values()), card, "photograph at 4K")
    timed_phase("batch stage times", batch_stage_times, dev, batch, card)
    timed_phase("stage times, fancy, 4 components, scaled", new_stage_times, dev, requests[0],
                cmyk, card)
    timed_phase("encode stage times", encode_stage_times, dev, images, card)
    timed_phase("gigapixel stage times", gigapixel_stage_times, dev, giga, card)
    if not jax_free():
        fail("JAX or the JAX package jpeg_decoder_tpu was loaded")
    required = {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
                "plain_ms", "bound_ms", "bound_by", "library_ms"}
    for rec in kernels.values():
        if required - rec.keys():
            fail(f"{rec['name']}: the record lacks {sorted(required - rec.keys())}")

    log(json.dumps({"kernels": list(kernels.values())}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
