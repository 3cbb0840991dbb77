"""JPEG marker-segment emission (the serialization the reference lacks).

Emits a baseline/extended interchange-format stream: SOI, JFIF APP0, DQT,
SOF0, DHT, [DRI], SOS + entropy bytes, EOI (spec B.2). The reference's
serializers exist but are dead and bit-buggy (huff_table.c:69-163,
quant_table.c:36-89 — see SURVEY.md quirk ledger); these are written from
spec and validated by round-tripping through both our decoder and Pillow.
"""

from __future__ import annotations

import struct

import numpy as np

from ..core.types import HuffTableSpec, ZIGZAG


def soi() -> bytes:
    return b"\xff\xd8"


def eoi() -> bytes:
    return b"\xff\xd9"


def app0_jfif(density: tuple[int, int] = (1, 1)) -> bytes:
    payload = b"JFIF\x00" + bytes((1, 1, 0)) + struct.pack(
        ">HH", density[0], density[1]
    ) + bytes((0, 0))
    return b"\xff\xe0" + struct.pack(">H", 2 + len(payload)) + payload


def dqt(table_id: int, values_natural: np.ndarray) -> bytes:
    """One DQT segment. 8-bit precision when all values fit, else 16-bit."""
    zz = np.asarray(values_natural)[ZIGZAG]
    precision = 1 if int(zz.max()) > 255 else 0
    if precision:
        body = b"".join(struct.pack(">H", int(v)) for v in zz)
    else:
        body = bytes(int(v) for v in zz)
    payload = bytes(((precision << 4) | table_id,)) + body
    return b"\xff\xdb" + struct.pack(">H", 2 + len(payload)) + payload


def sof(
    width: int,
    height: int,
    components: list[tuple[int, int, int, int]],
    precision: int = 8,
    marker: int = 0xC0,
) -> bytes:
    """SOFn. components: (id, hsf, vsf, qtid)."""
    payload = bytearray()
    payload.append(precision)
    payload += struct.pack(">HH", height, width)
    payload.append(len(components))
    for cid, h, v, qtid in components:
        payload += bytes((cid, (h << 4) | v, qtid))
    return bytes((0xFF, marker)) + struct.pack(">H", 2 + len(payload)) + bytes(
        payload
    )


def dht(spec: HuffTableSpec) -> bytes:
    payload = (
        bytes(((spec.table_class << 4) | spec.table_id,))
        + bytes(int(c) for c in spec.counts)
        + bytes(int(s) for s in spec.symbols)
    )
    return b"\xff\xc4" + struct.pack(">H", 2 + len(payload)) + payload


def dri(interval: int) -> bytes:
    return b"\xff\xdd" + struct.pack(">HH", 4, interval)


def sos(components: list[tuple[int, int, int]], ss: int = 0, se: int = 63,
        ah: int = 0, al: int = 0) -> bytes:
    """SOS header. components: (component_id, dc_table, ac_table)."""
    payload = bytearray((len(components),))
    for cid, dc, ac in components:
        payload += bytes((cid, (dc << 4) | ac))
    payload += bytes((ss, se, (ah << 4) | al))
    return b"\xff\xda" + struct.pack(">H", 2 + len(payload)) + bytes(payload)


def com(text: bytes) -> bytes:
    return b"\xff\xfe" + struct.pack(">H", 2 + len(text)) + text
