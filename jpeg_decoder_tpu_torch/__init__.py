"""jpeg_decoder_tpu_torch — the JPEG engine on PyTorch and CUDA.

A port of jpeg_decoder_tpu (JAX on a TPU) to one NVIDIA Hopper card. It
imports nothing of that package and runs with it absent: the host layers
(io/, core/, native/, utils/: NumPy, ctypes and the C++ runtime, built from
native/src/ into build/) are the port's own copies, and the device half is
new: the pixel stage is a torch.nn.Module whose hot ops are CUDA
kernels written for sm_90a (csrc/, built with nvcc at first use) -- the
EXACT and FLOAT32 IDCT contracts each have one -- the PALLAS entropy
backend decodes restart segments on the card, a batch's in one launch, and
the encoder's device stage (colour, subsample, FDCT, quantize) is one
kernel, bitwise the JAX package's CPU output.

Every entry point takes `device=` (default "cuda"). Without CUDA a "cuda"
device raises; pass device="cpu" to run the plain PyTorch versions of the
kernels, which is what the tests hold against the JAX package.

Public API:
    decode(data, cfg, device)      -> DecodedImage
    decode_rgb(data, cfg, device)  -> [H, W, 3] uint8 (no sample planes made;
                                      from a CUDA device, in pinned memory
                                      up to a budget held at once)
    decode_file(path, cfg, device) -> DecodedImage
    JpegDecoder(cfg, device)       -> reusable handle
    BatchDecoder(cfg, device, mesh) -> same-geometry batches: decode_batch,
                                      decode_stream, decode_many; with a
                                      mesh, sharded over its "data" ranks
    decode_batch(datas, cfg, device, mesh) -> [B, H, W, 3] uint8
    parallel.stripes.decode_streamed(data, cfg, n_chunks, sink, device),
    parallel.stripes.decode_striped(data, cfg, n_stripes, device, mesh)
                                   -> one large image in chunks or stripes;
                                      with a mesh, a stripe a "stripe" rank
    parallel.multihost.initialize(coordinator_address, num_processes,
        process_id, local_device_ids, backend), is_distributed(),
        process_info()             -> torch.distributed, one rank a device
    parallel.mesh.make_mesh(n_data, n_stripe, devices) -> ("data", "stripe")
                                      DeviceMesh over ranks; batch_sharding,
                                      stripe_sharding, replicated
    entry.entry(device), entry.dryrun_multichip(n_devices, device)
    decode_oracle(data)            -> DecodedImage (bit-serial conformance oracle)
    parse(data)                    -> JpegStructure (marker walk only)
    host_decode_batch(datas, cfg, pool, max_workers) -> (frame, planes, qts) per image
    encode(rgb, cfg, device)       -> JPEG bytes (device stage: kernel K4)
    JpegEncoder(cfg, device)       -> reusable handle: encode, encode_stream
    python -m jpeg_decoder_tpu_torch.benchmarks.gather_probe: the cost of
        one dependent step (lookup, shift, ladder, refill) on the card
"""

from .utils.config import (  # noqa: F401
    DecodeConfig,
    EncodeConfig,
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
from .core.types import CoefficientPlanes, DecodedImage, FrameHeader, JpegStructure  # noqa: F401
from .io.parser import parse  # noqa: F401
from .core.oracle import decode as decode_oracle  # noqa: F401

from .models.decoder import JpegDecoder, decode, decode_file, decode_rgb  # noqa: F401
from .parallel.batch import BatchDecoder, decode_batch  # noqa: F401
from .models.encoder import JpegEncoder, encode  # noqa: F401

__version__ = "0.6.0"


def host_decode_batch(datas, cfg=None, pool=None, max_workers=0):
    """Concurrent host stage (parse + entropy -> coefficient planes) across
    images; yields (frame, planes, qts) in input order. See
    models/host.host_decode_batch."""
    from .models.host import host_decode_batch as _b

    return _b(datas, cfg, pool, max_workers)

