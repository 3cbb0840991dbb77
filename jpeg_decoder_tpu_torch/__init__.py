"""jpeg_decoder_tpu_torch — the JPEG engine on PyTorch and CUDA.

A port of jpeg_decoder_tpu (JAX on a TPU) to one NVIDIA Hopper card. It
shares that package's host layers (io/, core/, native/, utils/: NumPy,
ctypes and the C++ runtime, none of which loads JAX) and replaces its
device half: the pixel stage is a torch.nn.Module whose hot ops are CUDA
kernels written for sm_90a (csrc/, built with nvcc at first use), and the
PALLAS entropy backend decodes restart segments on the card.

Every entry point takes `device=` (default "cuda"). Without CUDA a "cuda"
device raises; pass device="cpu" to run the plain PyTorch versions of the
kernels, which is what the tests hold against the JAX package.

Public API:
    decode(data, cfg, device)      -> DecodedImage
    decode_rgb(data, cfg, device)  -> [H, W, 3] uint8
    decode_file(path, cfg, device) -> DecodedImage
    JpegDecoder(cfg, device)       -> reusable handle
"""

from jpeg_decoder_tpu.utils.config import (  # noqa: F401
    DecodeConfig,
    EntropyBackend,
    IdctPrecision,
    Quirks,
)
from jpeg_decoder_tpu.utils.errors import (  # noqa: F401
    JpegEntropyError,
    JpegError,
    JpegFormatError,
    JpegTruncatedError,
    JpegUnsupportedError,
)
from jpeg_decoder_tpu.core.types import DecodedImage  # noqa: F401

from .models.decoder import JpegDecoder, decode, decode_file, decode_rgb  # noqa: F401
