"""The host layers the port shares with jpeg_decoder_tpu, under the port's name.

The port does not copy jpeg_decoder_tpu's io/, core/, native/ and utils/:
they are NumPy, ctypes and the C++ runtime, and none of them loads JAX.
Code that drives the port (chip_smoke.py, tests/test_torch_cuda.py) reaches
them through this module only, so that it imports nothing of the JAX
package directly. `jax_free()` checks that nothing has loaded JAX, or the
JAX package's device layers (models/, ops/, parallel/), which do.
"""

from __future__ import annotations

import sys

from jpeg_decoder_tpu.core import huffman, oracle, types  # noqa: F401
from jpeg_decoder_tpu.io import parser, writer  # noqa: F401
from jpeg_decoder_tpu.io.parser import parse  # noqa: F401
from jpeg_decoder_tpu.native import runtime  # noqa: F401

_DEVICE_LAYERS = ("jax", "jpeg_decoder_tpu.models", "jpeg_decoder_tpu.ops",
                  "jpeg_decoder_tpu.parallel")


def jax_free() -> bool:
    """True while neither JAX nor a JAX-importing layer of jpeg_decoder_tpu
    has been imported in this process."""
    return not any(name in sys.modules for name in _DEVICE_LAYERS)
