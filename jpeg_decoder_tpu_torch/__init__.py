"""jpeg_decoder_tpu_torch — the JPEG engine on PyTorch and CUDA.

A port of jpeg_decoder_tpu (JAX on a TPU) to one NVIDIA Hopper card. It
imports nothing of that package and runs with it absent: the host layers
(io/, core/, native/, utils/: NumPy, ctypes and the C++ runtime, built from
native/src/ into build/) are the port's own copies, and the device half is
new: the pixel stage is a torch.nn.Module whose hot ops are CUDA
kernels written for sm_90a (csrc/, built with nvcc at first use) -- the
EXACT and FLOAT32 IDCT contracts each have one -- and the PALLAS entropy
backend decodes restart segments on the card, a batch's in one launch.

Every entry point takes `device=` (default "cuda"). Without CUDA a "cuda"
device raises; pass device="cpu" to run the plain PyTorch versions of the
kernels, which is what the tests hold against the JAX package.

Public API:
    decode(data, cfg, device)      -> DecodedImage
    decode_rgb(data, cfg, device)  -> [H, W, 3] uint8
    decode_file(path, cfg, device) -> DecodedImage
    JpegDecoder(cfg, device)       -> reusable handle
    BatchDecoder(cfg, device)      -> same-geometry batches: decode_batch,
                                      decode_stream, decode_many
    decode_batch(datas, cfg, device) -> [B, H, W, 3] uint8
    python -m jpeg_decoder_tpu_torch.benchmarks.gather_probe: the cost of
        one dependent step (lookup, shift, ladder, refill) on the card
"""

from .utils.config import (  # noqa: F401
    DecodeConfig,
    EntropyBackend,
    IdctPrecision,
    Quirks,
)
from .utils.errors import (  # noqa: F401
    JpegEntropyError,
    JpegError,
    JpegFormatError,
    JpegTruncatedError,
    JpegUnsupportedError,
)
from .core.types import DecodedImage  # noqa: F401

from .models.decoder import JpegDecoder, decode, decode_file, decode_rgb  # noqa: F401
from .parallel.batch import BatchDecoder, decode_batch  # noqa: F401
