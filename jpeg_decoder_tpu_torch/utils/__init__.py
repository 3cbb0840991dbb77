"""Host utilities of the port: config, errors, logging, metrics."""

from __future__ import annotations

import sys


def jax_free() -> bool:
    """True while this process has imported neither JAX nor the JAX package
    jpeg_decoder_tpu (any module of it): the port runs without both."""
    return not any(
        name == "jax" or name.startswith("jax.")
        or name == "jpeg_decoder_tpu" or name.startswith("jpeg_decoder_tpu.")
        for name in sys.modules
    )
