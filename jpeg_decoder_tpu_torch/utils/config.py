"""Engine configuration.

The reference has no config system: its only inputs are `argv[1]` and a
compile-time `DEBUG` define (`reference/src/debug.h:2`,
`jpeg_decoder.c:31-34`). Here every behavioral switch is an explicit,
runtime-checkable dataclass field, including the "quirk" switches that decide
whether to replicate the reference's non-spec behaviors bit-for-bit (needed for
conformance parity) or to use the corrected behavior.
"""

from __future__ import annotations

import dataclasses
import enum
import os
from typing import Any

from .errors import JpegConfigError


class Quirks(enum.Enum):
    """Whether to replicate the reference decoder's quirks.

    REFERENCE replicates, bit-for-bit, the behaviors catalogued in SURVEY.md's
    quirk ledger:
      * clamp-to-256 wrap in color conversion: an RGB value strictly greater
        than 256.0 is stored as (uint8)256 == 0 (`colour_conversion.c:77-79`);
      * truncating (not rounding) float->int casts in the IDCT output
        (`dct.c:189-203`) and color conversion;
      * nearest-neighbor chroma upsampling with float ratio-index truncation
        (`colour_conversion.c:62-69`);
      * grayscale output indexed at image width rather than the MCU-padded
        plane stride (`colour_conversion.c:20`), which shears non-multiple-of-8
        grayscale images;
      * component dimensions computed as ceil(X * float32(h/hmax))
        (`frame_header.c:52-55`), which over-counts by one in rare
        ratio-1/3-style cases versus integer ceil division.

    CORRECT fixes all of the above (spec-conformant clamp to 255, proper
    stride, integer ceil division). NN upsampling remains the default
    upsampler in both modes since it is the conformance target.
    """

    REFERENCE = "reference"
    CORRECT = "correct"


class IdctPrecision(enum.Enum):
    """Numeric contract of the device IDCT.

    EXACT   — emulate the reference's float32-storage/float64-compute
              arithmetic with double-float (two-float) products so device
              output matches the C decoder bit-for-bit (verified empirically
              on the conformance corpus).
    FLOAT32 — same dataflow in plain float32; ±1 LSB of the reference on a
              tiny fraction of pixels, ~2x cheaper.
    """

    EXACT = "exact"
    FLOAT32 = "float32"


class EntropyBackend(enum.Enum):
    """Who runs the serial entropy (Huffman) stage.

    NATIVE — the C++ runtime (restart-segment-parallel, LUT-based). Default.
    NUMPY  — vectorized NumPy decoder (no native build required).
    ORACLE — the bit-serial NumPy oracle (slow; for conformance testing).
    DEVICE — the JAX package's XLA while_loop testbed (not ported: raises).
    PALLAS — on-device lockstep kernel (ops/entropy_cuda.py, kernel K2):
             one restart segment per thread; the compressed bytes go to
             the card and the coefficient planes are born there. The name
             is the JAX package's, kept so configs read the same.
    """

    NATIVE = "native"
    NUMPY = "numpy"
    ORACLE = "oracle"
    DEVICE = "device"
    PALLAS = "pallas"


@dataclasses.dataclass(frozen=True)
class DecodeConfig:
    """Configuration for the decode pipeline."""

    quirks: Quirks = Quirks.REFERENCE
    idct_precision: IdctPrecision = IdctPrecision.EXACT
    entropy_backend: EntropyBackend = EntropyBackend.NATIVE
    # Run dequant+IDCT+color on the device (False = all-host decode).
    use_device: bool = True
    # Number of host threads for the native entropy stage (0 = all cores).
    num_threads: int = 0
    # Upsampling: "nn" is the reference rule; "fancy" is libjpeg-style
    # triangular interpolation (needs a 1-row halo in stripe mode).
    upsample: str = "nn"
    # Fractional scaled decode (libjpeg's scale_num/8): output dimensions are
    # ceil(dim * scale / 8), scale in {1, 2, 4, 8}. scale < 8 decodes each
    # 8x8 block with a truncated k-point IDCT (k = scale) straight from the
    # coefficient planes — an 8x cheaper thumbnail path that never computes
    # the full-resolution pixels (ops/idct.idct_matrix_zz_scaled). 8 = full
    # size (the only scale with a bit-exactness contract vs the reference;
    # the reference has no scaled decode at all).
    scale: int = 8
    # Emit per-stage timing metrics.
    collect_metrics: bool = False

    def __post_init__(self) -> None:
        if self.upsample not in ("nn", "fancy"):
            raise JpegConfigError(f"unknown upsample mode {self.upsample!r}")
        if self.num_threads < 0:
            raise JpegConfigError("num_threads must be >= 0")
        if self.scale not in (1, 2, 4, 8):
            raise JpegConfigError(
                f"scale must be one of 1, 2, 4, 8 (got {self.scale})"
            )

    def replace(self, **kw: Any) -> "DecodeConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class EncodeConfig:
    """Configuration for the encode pipeline (reference intent at
    `reference/src/encode.c:12-74`, built properly here)."""

    quality: int = 85
    # "444", "422", "420" chroma subsampling, "gray", or the exotic-but-
    # legal factor sets "411", "440", "mixed" (see models/encoder._SAMPLING).
    subsampling: str = "420"
    # Restart interval in MCUs (0 = none). Restart markers are this engine's
    # parallelism seam, so the encoder emits them by default.
    restart_interval: int = 0
    # Huffman tables: "annex_k" = spec Tables K.3-K.6; "optimized" = two-pass
    # per-image optimal code lengths.
    huffman: str = "annex_k"
    # Progressive (SOF2) output with a spectral-selection scan script:
    # one interleaved DC scan, then one full-band AC scan per component.
    # Always uses optimized tables (EOBn symbols are absent from Annex K).
    progressive: bool = False

    def __post_init__(self) -> None:
        if not (1 <= self.quality <= 100):
            raise JpegConfigError("quality must be in [1, 100]")
        if self.subsampling not in (
            "444", "422", "420", "gray", "411", "440", "mixed"
        ):
            raise JpegConfigError(f"unknown subsampling {self.subsampling!r}")
        if self.huffman not in ("annex_k", "optimized"):
            raise JpegConfigError(f"unknown huffman mode {self.huffman!r}")
        if not (0 <= self.restart_interval <= 65535):
            raise JpegConfigError("restart_interval must fit in uint16")

    def replace(self, **kw: Any) -> "EncodeConfig":
        return dataclasses.replace(self, **kw)


def env_flag(name: str, default: bool = False) -> bool:
    """Read a boolean flag from the environment (JPEGTPU_* namespace)."""
    val = os.environ.get(name)
    if val is None:
        return default
    return val.strip().lower() in ("1", "true", "yes", "on")
