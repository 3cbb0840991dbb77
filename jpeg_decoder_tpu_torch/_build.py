"""Build the port's CUDA kernels (nvcc -> libjdtc.so) at first use, cached.

The counterpart of jpeg_decoder_tpu/native/build.py for the card: every
`csrc/*.cu` file is compiled in one nvcc call for Hopper (sm_90a) into a
shared library with a plain C interface, cached under `build/` by a hash of
the sources and flags, and loaded with ctypes. No PyTorch header is
included, so a build takes seconds, not minutes.

Each C entry point launches one kernel on the stream it is given and
returns `cudaGetLastError()`; `launch` raises on a nonzero status and counts
the launch. The counts let a caller show which kernels a run went through.

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
SOURCES = ("entropy_decode.cu", "idct_exact.cu", "color.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I32 = ctypes.c_int
_I64 = ctypes.c_int64
_F32 = ctypes.c_float
#: C entry point -> argtypes. Pointers (and the CUDA stream) are c_void_p:
#: a bare Python int would be passed as a 32-bit int and cut the address.
SIGNATURES = {
    # stream, seg_off, n_segs, ri, total_mcus, units, n_units, tables,
    # n_specs, plane0..3, status, cuda_stream
    "jdtc_entropy_decode": [
        _P, _P, _I64, _I64, _I64, _P, _I32, _P, _I32,
        _P, _P, _P, _P, _P, _P,
    ],
    # coeffs, qt, n_blocks, blocks_x, bits12, out, cuda_stream
    "jdtc_idct_exact": [_P, _P, _I64, _I32, _I32, _P, _P],
    # plane0..2, n_comps, h, w, stride0..2, hratio0..2, vratio0..2,
    # correct, out, cuda_stream
    "jdtc_color": [
        _P, _P, _P, _I32, _I32, _I32, _I32, _I32, _I32,
        _F32, _F32, _F32, _F32, _F32, _F32, _I32, _P, _P,
    ],
}

#: Kernel launches per C entry point since the process started (or since a
#: caller last cleared it). Only `launch` adds to it.
LAUNCHES: collections.Counter = collections.Counter()

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
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((SRC_DIR / name).read_bytes())
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
    # Compile to a process-unique name and rename atomically, so that a
    # concurrent process never loads a half-written library.
    tmp = out.with_suffix(f".tmp.{os.getpid()}")
    cmd = [_nvcc(), *NVCC_FLAGS, *[str(SRC_DIR / s) for s in SOURCES],
           "-o", str(tmp)]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({r.returncode}):\n{r.stdout[-4000:]}{r.stderr[-4000:]}"
        )
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.jdtc_error_string.argtypes = [ctypes.c_int]
            lib.jdtc_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def launch(name: str, *args) -> None:
    """Call C entry point `name` (which launches its kernel) and raise if
    the launch was refused; count it otherwise."""
    lib = library()
    rc = getattr(lib, name)(*args)
    if rc != 0:
        msg = lib.jdtc_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")
    LAUNCHES[name] += 1


def ptr(t) -> ctypes.c_void_p:
    """Device address of a tensor (None -> null)."""
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    """The current PyTorch CUDA stream of tensor t's device."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


if __name__ == "__main__":
    print(build(force="--force" in sys.argv))
