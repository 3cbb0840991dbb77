"""Build the port's CUDA kernels (nvcc -> libjdtc.so) at first use, cached.

The counterpart of jpeg_decoder_tpu/native/build.py for the card: every
`csrc/*.cu` file is compiled for Hopper (sm_90a) by its own nvcc process,
all started together, and the objects are linked into one shared library
with a plain C interface, cached under `build/` by a hash of the sources
(the `csrc/*.cuh` headers they share included) and flags, and loaded with
ctypes. No PyTorch header is included, so a build
takes seconds, not minutes.

Each C entry point launches its kernel (K2 and K2u: the kernels of their
passes) on the stream it is given and returns `cudaGetLastError()`; `launch`
raises on a nonzero status and counts the launch, one per call. The counts
let a caller show which kernels a run went through.

CLI: python -m jpeg_decoder_tpu_torch._build [--force]
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ("entropy_decode.cu", "unstuff.cu", "idct_exact.cu", "idct_float.cu",
           "idct_scaled.cu", "color.cu", "pixel_exact.cu", "pixel_float.cu", "probes.cu",
           "fdct.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I32 = ctypes.c_int
_I64 = ctypes.c_int64
_F32 = ctypes.c_float
#: C entry point -> argtypes. Pointers (and the CUDA stream) are c_void_p:
#: a bare Python int would be passed as a 32-bit int and cut the address.
SIGNATURES = {
    # stream, seg_off, seg_img, seg_idx, n_segs, ri, total_mcus, units,
    # n_units, tables, n_specs, plane_ptrs, status, sub_base, du_base_img,
    # max_subs, rec, used, first_du, dcdiff, lut, flag, chain, chain_words,
    # rounds (host int*), pass_ms (host float[5]* or null), cuda_stream
    "jdtc_entropy_decode": [
        _P, _P, _P, _P, _I64, _I64, _P, _P, _I32, _P, _I32, _P, _P,
        _P, _P, _I64, _P, _P, _P, _P, _P, _P, _P, _I64, _P, _P, _P,
    ],
    # the subsequence size K2 was built with (no launch)
    "jdtc_entropy_sub_bytes": [],
    # the records of a scan-pass block (0) and the data units of a dc-pass
    # block (1) K2 was built with (no launch)
    "jdtc_entropy_chunk": [_I32],
    # raw, n_raw, lo, hi, n_segs, scratch, out, seg_off, sub_base,
    # sub_bytes, cuda_stream
    "jdtc_unstuff": [_P, _I64, _P, _P, _I64, _P, _P, _P, _P, _I32, _P],
    # the bytes of a K2u tile (no launch)
    "jdtc_unstuff_tile_bytes": [],
    # coeffs, qt, n_blocks, blocks_x, bits12, out, cuda_stream
    "jdtc_idct_exact": [_P, _P, _I64, _I32, _I32, _P, _P],
    # coeffs, qt, k_matrix, n_blocks, blocks_x, bits12, out, cuda_stream
    "jdtc_idct_float": [_P, _P, _P, _I64, _I32, _I32, _P, _P],
    # K5, every component of a call in one launch: desc (host int64 [n][6]),
    # folded tables (host float [t][k^4]), n_comps, n_tables, k, bits12,
    # cuda_stream
    "jdtc_idct_scaled": [_P, _P, _I32, _I32, _I32, _I32, _P],
    # an empty kernel of n_ctas blocks of K5's threads (the launch floor),
    # for measurement: n_ctas, cuda_stream
    "jdtc_idct_scaled_empty": [_I64, _P],
    # coeff0..2, qt0..2, n_images, h, w, hsf0..2, vsf0..2, hratio0..2,
    # vratio0..2, mcus_x, mcus_y, strip, bits12, correct, row0, stripe_h
    # (striped decode; 0, 0 for whole frames), rgb, plane0..2 (null: not
    # stored), cuda_stream
    "jdtc_pixel_exact": [*[_P] * 6, *[_I32] * 9, *[_F32] * 6, *[_I32] * 7, *[_P] * 5],
    # jdtc_pixel_exact's arguments with k_matrix after qt2
    "jdtc_pixel_float": [*[_P] * 7, *[_I32] * 9, *[_F32] * 6, *[_I32] * 7, *[_P] * 5],
    # K3 (nearest-neighbour) and K3f (fancy): plane0..3, n_images, n_comps,
    # h, w, geometry (host int64 [4][5]), ratios (host float [4][2]), row0,
    # stripe_h, mode, correct, out, cuda_stream
    "jdtc_color": [*[_P] * 4, *[_I32] * 4, _P, _P, *[_I32] * 4, _P, _P],
    "jdtc_fancy": [*[_P] * 4, *[_I32] * 4, _P, _P, *[_I32] * 4, _P, _P],
    # K6h (K3f over one stripe of a mesh): jdtc_fancy's arguments with
    # halos (host int64 [4][2]: each component's top and bottom halo rows'
    # device addresses, 0 for none) before out
    "jdtc_fancy_halo": [*[_P] * 4, *[_I32] * 4, _P, _P, *[_I32] * 4, _P, _P, _P],
    # K4 (the encoder's device stage): img, h, w, channels, n_comps, comps
    # (host int64 [3][9]), kq, consts (host float [5]), cuda_stream
    "jdtc_fdct": [_P, _I32, _I32, _I32, _I32, _P, _P, _P, _P],
    # The probes (csrc/probes.cu), each: its tensors, its sizes, steps, ...,
    # cuda_stream.
    # tab, idx0, out, n_lanes, lane_cols, row_stride, col_stride, idx_stride,
    # tab_elems, size, add_idx, mod, steps, in_shared
    "jdtc_probe_gather_chain": [_P, _P, _P, *[_I32] * 11, _P],
    # tab, idx0, out, n_lanes, n, bits, mask, steps, in_shared
    "jdtc_probe_onehot_lookup_chain": [_P, _P, _P, *[_I32] * 6, _P],
    # idx0, out, n_rows, width, steps
    "jdtc_probe_row_scatter_chain": [_P, _P, _I32, _I32, _I32, _P],
    # x0, sh, out, n_lanes, n_ops, steps
    "jdtc_probe_vshift_chain": [_P, _P, _P, _I32, _I32, _I32, _P],
    # tab, words, out, n_lanes, tab_cols, n_words, steps
    "jdtc_probe_combined_step_chain": [_P, _P, _P, _I32, _I32, _I32, _I32, _P],
    # thr, sym, bitbuf0, bitcnt0, acc0, out, steps
    "jdtc_probe_symbol_step_chain": [_P, _P, _P, _P, _P, _P, _I32, _P],
    # stream, off0, out, n_rows, waves
    "jdtc_probe_dma_wave_chain": [_P, _P, _P, _I32, _I32, _P],
}

#: The most images one launch takes: K03 and K3 put the image on a grid
#: dimension, whose limit this is; the wrappers split a larger batch
#: (image_chunks).
MAX_IMAGES = 65535

#: Kernel launches per C entry point since the process started (or since a
#: caller last cleared it). Only `launch` adds to it. Launches of striped
#: and streamed decode are counted under their stage's name instead (K6n,
#: K6f, K6h: parallel/stripes.py), so that each record counts its own.
LAUNCHES: collections.Counter = collections.Counter()
#: The work of those launches, counted beside them where the wrapper gives
#: it: coefficient blocks for the IDCT kernels (K0, K1, K5) and K4, output pixels
#: (all images) for the colour kernels (K3, K3f; K6n and K6f when they
#: launch K3 or K3f), so that a batch launch weighs what it does.
LAUNCH_UNITS: collections.Counter = collections.Counter()

_lib = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    if not home:
        from torch.utils.cpp_extension import CUDA_HOME

        home = CUDA_HOME
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME); the port's CUDA kernels are"
            " built from csrc/ at first use"
        )
    return found


def _source_hash() -> str:
    """Every csrc/*.cu and *.cuh file, so that an edit to a shared header
    builds anew."""
    h = hashlib.sha256()
    for path in sorted([*SRC_DIR.glob("*.cu"), *SRC_DIR.glob("*.cuh")]):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def lib_path() -> Path:
    return BUILD_DIR / f"libjdtc-{_source_hash()}.so"


def build(force: bool = False) -> Path:
    """Compile if needed; returns the library path or raises RuntimeError
    with nvcc's output."""
    out = lib_path()
    if out.exists() and not force:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    # Objects and library get process-unique names and the library is
    # renamed atomically, so a concurrent process never loads a
    # half-written one.
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{Path(s).stem}.{tag}.o" for s in SOURCES]
    tmp = BUILD_DIR / f"{tag}.so.tmp"
    procs: list[subprocess.Popen] = []
    try:
        for s, o in zip(SOURCES, objs):
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(SRC_DIR / s), "-o", str(o)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        failed = []
        for s, proc in zip(SOURCES, procs):
            log, _ = proc.communicate(timeout=600)
            if proc.returncode != 0:
                failed.append(f"{s} ({proc.returncode}):\n{log[-4000:]}")
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        r = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o", str(tmp)],
            capture_output=True, text=True, timeout=600)
        if r.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({r.returncode}):\n{r.stdout[-4000:]}{r.stderr[-4000:]}")
        os.replace(tmp, out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)
    return out


def load(path) -> ctypes.CDLL:
    """The kernel library at `path`, its entry points typed (SIGNATURES)."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.jdtc_error_string.argtypes = [ctypes.c_int]
    lib.jdtc_error_string.restype = ctypes.c_char_p
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = load(build())
        return _lib


def launch(name: str, *args) -> None:
    """Call C entry point `name` (which launches its kernel) and raise if
    the launch was refused; count it otherwise."""
    launch_as(name, name, *args)


def launch_as(count_as: str, name: str, *args) -> None:
    """launch, the launch counted under `count_as` (K6n, K6f, K6h)."""
    lib = library()
    rc = getattr(lib, name)(*args)
    if rc != 0:
        msg = lib.jdtc_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")
    LAUNCHES[count_as] += 1


def add_units(count_as: str, units: int) -> None:
    """Count `units` of work for the launch just made under `count_as`."""
    LAUNCH_UNITS[count_as] += units


def ptr(t) -> ctypes.c_void_p:
    """Device address of a tensor (None -> null)."""
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def image_chunks(n_images: int, *tensors):
    """Split a launch over `n_images` images into launches of at most
    MAX_IMAGES: a list of (first image, count, [the device address of each
    tensor at the chunk's first image]). Each tensor holds the n_images
    images back to back, one equal share each (a leading batch dimension,
    or none for a single image); None stays a null pointer."""
    chunks = []
    for first in range(0, n_images, MAX_IMAGES):
        ptrs = [ptr(None) if t is None else ctypes.c_void_p(
            t.data_ptr() + first * (t.numel() // n_images) * t.element_size())
            for t in tensors]
        chunks.append((first, min(MAX_IMAGES, n_images - first), ptrs))
    return chunks


def stream_of(t) -> ctypes.c_void_p:
    """The current PyTorch CUDA stream of tensor t's device."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


if __name__ == "__main__":
    print(build(force="--force" in sys.argv))
