"""Structured logging.

The reference's observability is a compile-time `DEBUG` define gating
`debug_print` to stderr (`reference/src/debug.h:2-8`) — rebuilding to
toggle. Here: standard `logging` with a runtime-settable level, a JPEGTPU_LOG
environment override, and per-module child loggers.
"""

from __future__ import annotations

import logging
import os
import sys

_ROOT_NAME = "jpegtpu"


def get_logger(name: str | None = None) -> logging.Logger:
    """Return the engine root logger or a child of it."""
    logger = logging.getLogger(_ROOT_NAME)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(
            logging.Formatter(
                "%(asctime)s %(levelname)s %(name)s: %(message)s", "%H:%M:%S"
            )
        )
        logger.addHandler(handler)
        level = os.environ.get("JPEGTPU_LOG", "WARNING").upper()
        logger.setLevel(getattr(logging, level, logging.WARNING))
        logger.propagate = False
    if name:
        return logger.getChild(name)
    return logger


def set_level(level: str) -> None:
    get_logger().setLevel(getattr(logging, level.upper()))
