"""Structured error hierarchy for the JPEG engine.

Design note: the reference's failure handling is `return -1` bubbling plus two
silent `exit(1)` calls in the progressive path (`reference/src/decode.c:861,868`).
This engine never exits or swallows errors: every failure raises a typed exception
carrying byte offsets and decoder state so corrupt streams are diagnosable.
"""

from __future__ import annotations


class JpegError(Exception):
    """Base class for all engine errors."""


class JpegFormatError(JpegError):
    """The byte stream violates ITU-T T.81 syntax (bad marker, bad length...)."""

    def __init__(self, message: str, offset: int | None = None):
        self.offset = offset
        if offset is not None:
            message = f"{message} (at byte offset {offset})"
        super().__init__(message)


class JpegTruncatedError(JpegFormatError):
    """The stream ended before a structurally required element.

    The reference has no bounds checking at all (`bitstream.c:10` grows `size`
    instead of tracking a limit); this engine bounds-checks every read.
    """


class JpegUnsupportedError(JpegError):
    """A valid JPEG process this engine does not implement (e.g. arithmetic
    coding, lossless, hierarchical)."""


class JpegEntropyError(JpegError):
    """Entropy-coded segment is inconsistent (bad Huffman code, coefficient
    index out of range, missing restart marker...)."""

    def __init__(self, message: str, mcu: int | None = None, offset: int | None = None):
        self.mcu = mcu
        self.offset = offset
        extra = []
        if mcu is not None:
            extra.append(f"mcu={mcu}")
        if offset is not None:
            extra.append(f"byte_offset={offset}")
        if extra:
            message = f"{message} ({', '.join(extra)})"
        super().__init__(message)


class JpegConfigError(JpegError):
    """Invalid engine configuration (bad flag value, incompatible options)."""


class JpegNativeError(JpegError):
    """The native (C++) runtime reported a failure."""
