"""Helpers for the tests that hold the port (jpeg_decoder_tpu_torch) against
the JAX package (jpeg_decoder_tpu): the two packages' configs, enums, error
classes and parsed structures are equal in content and distinct in identity,
so they are compared by field names, enum member names and class names.
Also the hand-packed inputs that the CPU tests and the card tests of the
entropy path share. This module imports neither package's JAX side."""

import dataclasses
import enum

import numpy as np

from jpeg_decoder_tpu_torch.core.types import HuffTableSpec
from jpeg_decoder_tpu_torch.io import bitstream, writer


def assert_same_fields(got, want, path="value"):
    """`got` and `want` agree field for field: dataclasses by their field
    names (their classes by __name__), enum members by name and value,
    arrays bitwise with equal dtype, containers element by element."""
    if dataclasses.is_dataclass(want) and not isinstance(want, type):
        assert type(got).__name__ == type(want).__name__, path
        names = [f.name for f in dataclasses.fields(want)]
        assert [f.name for f in dataclasses.fields(got)] == names, path
        for n in names:
            assert_same_fields(getattr(got, n), getattr(want, n), f"{path}.{n}")
    elif isinstance(want, enum.Enum):
        assert isinstance(got, enum.Enum), path
        assert (type(got).__name__, got.name, got.value) == \
            (type(want).__name__, want.name, want.value), path
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    elif isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            assert_same_fields(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same_fields(g, w, f"{path}[{i}]")
    else:
        assert type(got) is type(want) and got == want, path


def class_chain(cls):
    """The names of `cls` and its base classes, in method-resolution order."""
    return [c.__name__ for c in cls.__mro__]


def assert_same_error_class(got, want):
    """Two error classes of the two packages are counterparts: the same
    name and the same chain of base-class names."""
    assert class_chain(got) == class_chain(want)


# ---------------------------------------------------------------------------
# Hand-packed entropy inputs (the port's writer; no JAX)
# ---------------------------------------------------------------------------

#: DC table with all 16 categories (15 codes of 4 bits, category 15 in 5)
#: and an AC table whose only code is EOB ('0').
_DC16 = HuffTableSpec(table_class=0, table_id=0,
                      counts=np.array([0, 0, 0, 15, 1] + [0] * 11, dtype=np.uint8),
                      symbols=np.arange(16, dtype=np.uint8))
_EOB_ONLY = HuffTableSpec(table_class=1, table_id=0,
                          counts=np.array([1] + [0] * 15, dtype=np.uint8),
                          symbols=np.array([0], dtype=np.uint8))


def dc_only_stream(diffs, nb_x, restart_interval=0):
    """A gray stream of DC-only blocks whose DC differences are `diffs`
    (|d| <= 32767), hand-packed: DC code, value bits, EOB. Segments are cut
    every `restart_interval` blocks (0: none)."""
    def seg_bytes(ds):
        bits = ""
        for d in ds:
            size = int(abs(d)).bit_length()
            bits += "11110" if size == 15 else format(size, "04b")
            if size:
                bits += format(d if d > 0 else d + (1 << size) - 1, f"0{size}b")
            bits += "0"
        bits += "1" * (-len(bits) % 8)
        raw = int(bits, 2).to_bytes(len(bits) // 8, "big")
        return raw.replace(b"\xff", b"\xff\x00")

    ri = restart_interval or len(diffs)
    segs = [seg_bytes(diffs[i : i + ri]) for i in range(0, len(diffs), ri)]
    entropy = b"".join(s + (bytes((0xFF, 0xD0 + i % 8)) if i + 1 < len(segs) else b"")
                       for i, s in enumerate(segs))
    nb_y = -(-len(diffs) // nb_x)
    parts = [writer.soi(), writer.dqt(0, np.ones(64, dtype=np.uint16)),
             writer.sof(nb_x * 8, nb_y * 8, [(1, 1, 1, 0)]),
             writer.dht(_DC16), writer.dht(_EOB_ONLY)]
    if restart_interval:
        parts.append(writer.dri(restart_interval))
    parts += [writer.sos([(1, 0, 0)]), entropy, writer.eoi()]
    return b"".join(parts)


def block_boundary_case():
    """(raw, lo, hi, stream, seg_off): 3 segments over 3 blocks of 4096
    bytes, FF 00 pairs across bytes 15|16, 4095|4096 and 8191|8192, a
    segment that starts with 00 right after a marker and one that begins
    and ends with a pair; the expectation comes from io.bitstream.unstuff."""
    rng = np.random.default_rng(4096)
    raw = rng.integers(1, 255, 9000, dtype=np.uint8)   # no 00, no FF
    for at in (15, 4095, 8191, 100, 102, 8995):
        raw[at : at + 2] = (0xFF, 0x00)
    raw[5000:5002] = (0xFF, 0xD0)
    raw[5002] = 0x00                                    # kept: starts its segment
    raw[8190] = 0xFF
    raw[8189:8191] = (0xFF, 0xD1)
    lo = np.array([0, 5002, 8191], dtype=np.int64)
    hi = np.array([5000, 8189, 8997], dtype=np.int64)
    segs = [bitstream.unstuff(raw, int(a), int(b))[0] for a, b in zip(lo, hi)]
    stream = np.concatenate(segs + [np.zeros(8, np.uint8)])
    seg_off = np.concatenate([[0], np.cumsum([len(x) for x in segs])]).astype(np.int64)
    return raw, lo, hi, stream, seg_off


def plain_bytes(rng, n):
    """Random bytes with no 0x00 and no 0xFF."""
    return rng.integers(1, 255, n, dtype=np.uint8)


def scan_bytes(datas):
    """raw, lo, hi of the streams' scans laid back to back, as host_args
    lays out a group (any streams: unstuffing takes no group key)."""
    from jpeg_decoder_tpu_torch.io.parser import parse

    raws, bounds, at = [], [], 0
    for data in datas:
        span = parse(data).scans[0].span
        raws.append(np.frombuffer(data[span.start : span.end], dtype=np.uint8))
        bounds.append(span.segment_bounds_flat().reshape(-1, 2) - span.start + at)
        at += raws[-1].shape[0]
    b = np.concatenate(bounds)
    return np.concatenate(raws), b[:, 0].copy(), b[:, 1].copy()


def pairs_across_edges(step):
    """(raw, lo, hi): a stuffed pair across every edge of `step` bytes
    (0xFF the last byte before it, 0x00 the first after), in two segments
    with a marker between, a 0x00 that starts the second segment right
    after the marker, and a 0xFF 0x00 0x00 run (only the first 0x00 is
    stuffed)."""
    rng = np.random.default_rng(step)
    n = 9 * step + 11
    raw = plain_bytes(rng, n)
    for edge in range(step, n, step):
        raw[edge - 1 : edge + 1] = (0xFF, 0x00)
    mid = 4 * step + 5
    raw[mid : mid + 2] = (0xFF, 0xD3)
    raw[mid + 2] = 0x00
    raw[mid + 9 : mid + 12] = (0xFF, 0x00, 0x00)
    return raw, np.array([0, mid + 2], dtype=np.int64), np.array([mid, n - 1], dtype=np.int64)


def bound_at(tile, p, seed=0):
    """(raw, lo, hi): segments that start and end at position p of a tile
    of `tile` bytes, a marker between them, a stuffed pair on each side of
    every bound."""
    raw = plain_bytes(np.random.default_rng(seed + 1000 * tile + p), 6 * tile)
    n = raw.shape[0]
    lo = np.array([0, tile + p, 3 * tile + p], dtype=np.int64)
    hi = np.array([tile + p - 2, 3 * tile + p - 2, n - (p % 3)], dtype=np.int64)
    for b in (tile + p - 2, 3 * tile + p - 2):
        raw[b : b + 2] = (0xFF, 0xD0 + p % 8)        # the marker
        raw[b - 2 : b] = (0xFF, 0x00)                 # a pair that ends a segment
        raw[b + 2 : b + 4] = (0xFF, 0x00)             # and one that starts the next
    return raw, lo, hi


def empty_segments(tile):
    """[(raw, lo, hi)]: empty segments inside a tile of `tile` bytes and on
    a tile edge, two segments that start at one byte, and an empty last
    segment at the end of the bytes; no segment at all; one segment that
    starts on a tile edge and spans several tiles."""
    raw = plain_bytes(np.random.default_rng(7), 5 * tile)
    n = raw.shape[0]
    raw[tile - 1 : tile + 1] = (0xFF, 0x00)
    none = np.zeros(0, np.int64)
    return [(raw, np.array([0, 3, 3, tile, tile, 2 * tile + 1, n], dtype=np.int64),
             np.array([1, 3, tile - 2, tile, 2 * tile, n - 2, n], dtype=np.int64)),
            (raw, none, none),
            (raw, np.array([tile], np.int64), np.array([4 * tile], np.int64))]


def unstuffed_by_the_host(raw, lo, hi):
    """The host's unstuffing of raw[lo[s]:hi[s]], segment by segment:
    (stream with its 8 zero bytes of tail, seg_off)."""
    segs = [bitstream.unstuff(raw, int(a), int(b))[0] for a, b in zip(lo, hi)]
    seg_off = np.concatenate([[0], np.cumsum([len(x) for x in segs])]).astype(np.int64)
    return np.concatenate(segs + [np.zeros(8, np.uint8)]), seg_off


def scan_to_end(data):
    """(raw, n_segs) as K2u without bounds takes a stream: the bytes from
    its first scan's first entropy byte to the end of the file, and the
    segment count the scan's header implies."""
    from jpeg_decoder_tpu_torch.io.parser import parse

    scan = parse(data).scans[0]
    return np.frombuffer(data[scan.span.start:], dtype=np.uint8), scan.span.num_segments


def _marked(body, at, second):
    """`body` with 0xFF, `second` written at `at` (a marker, a stuffed pair,
    a fill byte)."""
    out = body.copy()
    out[at : at + 2] = (0xFF, second)
    return out


def find_cases(tile):
    """name -> (raw, n_segs): bytes from a scan's first entropy byte to the
    end of its file, cut where tiles of `tile` bytes cut them, and the
    segment count a header would give: a restart marker and a stuffed pair
    across a tile edge (and across a 32- and a 1024-byte edge inside
    one); fill bytes before a marker (FF FF D3) and before EOI; a scan
    ended by DNL and by a second SOS; no end at all; a 0xFF as the last
    byte; more and fewer markers than the header's count; markers after
    the end; the end at the tile's last byte, at its first, right after a
    marker; an empty scan; empty first and last segments."""
    rng = np.random.default_rng(tile)
    eoi = np.array([0xFF, 0xD9], np.uint8)
    cat = lambda *parts: np.concatenate([np.asarray(p, np.uint8) for p in parts])  # noqa: E731
    body = plain_bytes(rng, 3 * tile + 40)
    cases = {}
    split = _marked(_marked(body, tile - 1, 0xD3), 2 * tile - 1, 0x00)
    for edge in (32, 1024):
        if edge < tile:
            split = _marked(_marked(split, edge - 1, 0x00), tile + edge - 1, 0x00)
    cases["split_pairs"] = (cat(split, eoi), 2)
    fill = body.copy()
    fill[tile - 2 : tile + 1] = (0xFF, 0xFF, 0xD3)
    cases["fill_before_marker_and_eoi"] = (cat(fill, [0xFF, 0xFF], eoi), 2)
    tail = plain_bytes(rng, tile + 9)
    cases["ended_by_dnl"] = (cat(_marked(body, tile + 3, 0xD0), [0xFF, 0xDC, 0, 4, 0, 16],
                                 tail, eoi), 2)
    sos = [0xFF, 0xDA, 0, 8, 1, 1, 0, 0, 63, 0]
    cases["ended_by_a_second_sos"] = (cat(_marked(body, 5, 0x00), sos,
                                          _marked(_marked(tail, 3, 0xD0), 9, 0x00), eoi), 1)
    cases["no_end"] = (_marked(body, tile + 1, 0xD5), 2)
    cases["ff_last_byte"] = (cat(_marked(body, 7, 0x00), [0xFF]), 1)
    three = _marked(_marked(_marked(body, 10, 0xD0), tile, 0xD1), 2 * tile + 7, 0xD2)
    cases["more_markers_than_the_header"] = (cat(three, eoi), 2)
    cases["fewer_markers_than_the_header"] = (cat(three, eoi), 6)
    cases["markers_after_the_end"] = (cat(_marked(body, 4, 0xD0), eoi, [0xFF, 0xD0],
                                          _marked(tail, 2, 0xD1), eoi), 2)
    cases["end_at_the_tiles_last_byte"] = (cat(body[: tile - 1], eoi, tail), 1)
    cases["end_at_the_tiles_first_byte"] = (cat(body[:tile], eoi, tail), 1)
    cases["end_right_after_a_marker"] = (cat(_marked(body[: tile + 2], tile, 0xD7), eoi), 2)
    cases["empty_scan"] = (cat(eoi, tail), 1)
    cases["empty_first_and_last_segments"] = (cat([0xFF, 0xD0], body[:tile], [0xFF, 0xD1],
                                                  eoi), 3)
    return cases
