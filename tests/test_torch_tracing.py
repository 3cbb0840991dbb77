"""The port's spans and counters (utils/metrics.span, count) on the CPU: the
ranges each entry path opens when `collect_metrics` is on, how they nest
and on which thread; none when it is off, while the host timers still
record; and the benchmark's readers of them (perfbench/attribution.py and
the metric files that use it) on hand-built traces.

    python -m pytest tests/test_torch_tracing.py -q
"""

from __future__ import annotations

import dataclasses
import importlib.util
from collections import Counter
from pathlib import Path

import pytest
import torch
import torch.profiler as tp
from torch._C._profiler import _ExperimentalConfig

from jpeg_decoder_tpu_torch import BatchDecoder, DecodeConfig, JpegDecoder
from jpeg_decoder_tpu_torch.benchmarks.inputs import make_jpeg
from jpeg_decoder_tpu_torch.utils.config import EntropyBackend
from jpeg_decoder_tpu_torch.utils.metrics import GLOBAL_METRICS
from perfbench import attribution, trace

ROOT = Path(__file__).resolve().parents[1]
SAMPLING = [(2, 2), (1, 1), (1, 1)]

#: The spans of a DEVICE request, each with the span it lies in (None: the
#: request's top level).
REQUEST_SPANS = {
    "parse": None,
    "entropy_device": None,
    "entropy_prepare": "entropy_device",
    "entropy_upload": "entropy_device",
    "entropy_launch": "entropy_device",
    "entropy_check": "entropy_device",
    "stage_lookup": None,
    "device_stage": None,
    "copy_out": "device_stage",
}
#: The spans of a PALLAS decode_stream by thread: the prefetch thread's
#: host stage, and the consumer's.
PREFETCH_SPANS = {
    "batch_parse": None,
    "entropy_pallas_batch": None,
    "entropy_prepare": "entropy_pallas_batch",
    "entropy_upload": "entropy_pallas_batch",
    "entropy_launch": "entropy_pallas_batch",
    "entropy_check": "entropy_pallas_batch",
    "entropy_batch_fallback": None,
    "fallback_copy": None,
}
CONSUMER_SPANS = {
    "batch_wait": None,
    "stage_lookup": None,
    "device_batch": None,
    "copy_out": None,
}


def _request():
    """A 4:2:0 frame, restart-free, decoded on the DEVICE route."""
    return make_jpeg(64, 48, SAMPLING, 0, 3, gradient=True)


def _loader_batch():
    """Three 272x256 4:2:0 streams: two with a marker per MCU row, which
    K2 takes in one call, and one restart-free over 256 MCUs, which PALLAS
    refuses and the native host decode takes."""
    return [make_jpeg(272, 256, SAMPLING, 17, s, gradient=True) for s in (1, 2)] + [
        make_jpeg(272, 256, SAMPLING, 0, 3, gradient=True)]


def _run_request(on: bool):
    dec = JpegDecoder(DecodeConfig(entropy_backend=EntropyBackend.DEVICE,
                                   collect_metrics=on), device="cpu")
    return dec.decode_rgb(_request())


def _run_loader(on: bool):
    bd = BatchDecoder(DecodeConfig(entropy_backend=EntropyBackend.PALLAS, upsample="fancy",
                                   num_threads=2, collect_metrics=on), device="cpu")
    return list(bd.decode_stream(_loader_batch() * 2, batch_size=3))


def _ranges(fn, all_threads: bool = False):
    """The "jpegtpu." ranges a call opens: [(name, start, end, thread)]."""
    kw = {"experimental_config": _ExperimentalConfig(profile_all_threads=True)} \
        if all_threads else {}
    with tp.profile(activities=[tp.ProfilerActivity.CPU], **kw) as prof:
        fn()
    return [(e.name.removeprefix("jpegtpu."), e.time_range.start, e.time_range.end, e.thread)
            for e in prof.events() if e.name.startswith("jpegtpu.")]


def _parent(r, ranges):
    """The innermost range on r's thread that holds r, or None."""
    name, s, t, th = r
    holders = [q for q in ranges if q is not r and q[3] == th and q[1] <= s and t <= q[2]]
    return min(holders, key=lambda q: q[2] - q[1])[0] if holders else None


def _assert_nesting(ranges, expected: dict):
    assert {r[0] for r in ranges} == set(expected)
    for r in ranges:
        assert _parent(r, ranges) == expected[r[0]], r


def test_request_spans_nest_as_documented():
    """A DEVICE request with collect_metrics on opens every request span,
    each inside the span the docs give it, all on the caller's thread."""
    ranges = _ranges(lambda: _run_request(True))
    _assert_nesting(ranges, REQUEST_SPANS)
    assert len({r[3] for r in ranges}) == 1
    top = sorted((r for r in ranges if REQUEST_SPANS[r[0]] is None), key=lambda r: r[1])
    assert [r[0] for r in top] == ["parse", "entropy_device", "stage_lookup", "device_stage"]


@pytest.mark.parametrize("entry", ["decode_rgb", "decode"])
def test_traced_request_opens_copy_out_once(entry):
    """A traced request opens `copy_out` once, inside `device_stage`,
    whether it reads back the RGB alone (decode_rgb) or the planes too
    (decode), and counts readback_mb and readback_pinned_pct once."""
    dec = JpegDecoder(DecodeConfig(entropy_backend=EntropyBackend.DEVICE,
                                   collect_metrics=True), device="cpu")
    before = {k: GLOBAL_METRICS.stages[k].calls for k in ("readback_mb", "readback_pinned_pct")
              if k in GLOBAL_METRICS.stages}
    ranges = _ranges(lambda: getattr(dec, entry)(_request()))
    copies = [r for r in ranges if r[0] == "copy_out"]
    assert len(copies) == 1 and _parent(copies[0], ranges) == "device_stage"
    for k in ("readback_mb", "readback_pinned_pct"):
        assert GLOBAL_METRICS.stages[k].calls == before.get(k, 0) + 1


def test_loader_spans_nest_as_documented():
    """A PALLAS decode_stream with collect_metrics on, every thread
    recorded: each loader span, nested as documented, the host stage's on
    the prefetch thread and the rest on the consumer's."""
    ranges = _ranges(lambda: _run_loader(True), all_threads=True)
    threads = {}
    for r in ranges:
        threads.setdefault(r[3], []).append(r)
    consumer = {r[3] for r in ranges if r[0] == "batch_wait"}.pop()
    prefetch = [r for r in ranges if r[3] != consumer]
    _assert_nesting(threads[consumer], CONSUMER_SPANS)
    _assert_nesting(prefetch, PREFETCH_SPANS)
    # two batches: each span of the consumer once a batch
    assert Counter(r[0] for r in threads[consumer]) == {k: 2 for k in CONSUMER_SPANS}


def test_batch_parse_is_on_another_thread_than_batch_wait():
    """Under profile_all_threads the prefetch thread's parse lies on a
    thread other than the consumer's wait for it; without the flag the
    profiler records the consumer's ranges alone."""
    ranges = _ranges(lambda: _run_loader(True), all_threads=True)
    parse = {r[3] for r in ranges if r[0] == "batch_parse"}
    wait = {r[3] for r in ranges if r[0] == "batch_wait"}
    assert parse and wait and not parse & wait
    alone = {r[0] for r in _ranges(lambda: _run_loader(True))}
    assert alone == set(CONSUMER_SPANS)


SPANS_OF = {"request": (_run_request, REQUEST_SPANS),
            "loader": (_run_loader, {**PREFETCH_SPANS, **CONSUMER_SPANS})}


@pytest.mark.parametrize("path", sorted(SPANS_OF))
def test_off_enters_no_range_and_the_timers_still_record(path, monkeypatch):
    """collect_metrics off: no record_function is built (the profiler's
    class is replaced by one that fails), no range is in a trace, and each
    span's host timer still counts its calls."""
    run, spans = SPANS_OF[path]
    before = {k: v.calls for k, v in GLOBAL_METRICS.stages.items()}

    def refuse(*a, **k):
        raise AssertionError("record_function entered with collect_metrics off")

    with monkeypatch.context() as m:
        m.setattr(tp, "record_function", refuse)
        m.setattr(torch.autograd.profiler, "record_function", refuse)
        run(False)
    after = {k: v.calls for k, v in GLOBAL_METRICS.stages.items()}
    assert all(after.get(k, 0) > before.get(k, 0) for k in spans), \
        {k: (before.get(k), after.get(k)) for k in spans}
    assert _ranges(lambda: run(False), all_threads=True) == []
    on = _ranges(lambda: run(True), all_threads=True)
    assert {r[0] for r in on} == set(spans)


# ---------------------------------------------------------------------------
# The benchmark's readers on hand-built traces
# ---------------------------------------------------------------------------


def _trace(window, device, host):
    ev = trace.Event
    return trace.Trace(ev("perfbench.window", *window),
                       sorted((ev(n, s, t) for n, s, t in device), key=lambda e: e.start),
                       [ev(n, s, t, th) for n, s, t, th in host])


def _reader(name: str):
    spec = importlib.util.spec_from_file_location(
        "m_" + name.replace(".", "_"), ROOT / "perfbench" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class _Run:
    trace: object = None
    stages: dict = dataclasses.field(default_factory=dict)


#: A window of 1000 ns; the card busy over [100, 200) and [150, 300)
#: (overlapping: busy 200) and [600, 700): idle [0, 100), [300, 600),
#: [700, 1000), 700 ns.
WINDOW, DEVICE = (0, 1000), [("pass2_kernel", 100, 200), ("Memcpy DtoH", 150, 300),
                             ("idct_exact_kernel", 600, 700)]
#: Thread 1: a request's parse [0, 80), then entropy_device [80, 450) with
#: entropy_launch nested in it [120, 400) (counted once); thread 2: a
#: prefetch thread's batch_parse [420, 650), which overlaps thread 1's and
#: the busy stretch; an aten operator and the harness's own range, which
#: name no program layer; a range that runs past the window's end.
HOST = [("jpegtpu.parse", 0, 80, 1), ("jpegtpu.entropy_device", 80, 450, 1),
        ("jpegtpu.entropy_launch", 120, 400, 1), ("jpegtpu.batch_parse", 420, 650, 2),
        ("aten::copy_", 700, 800, 1), ("perfbench.request", 0, 1000, 1),
        ("jpegtpu.copy_out", 950, 1200, 1)]


def test_idle_intervals_and_interval_arithmetic():
    tr = _trace(WINDOW, DEVICE, HOST)
    assert attribution.idle_intervals(tr) == [[0, 100], [300, 600], [700, 1000]]
    assert attribution.union([(5, 9), (0, 2), (1, 3), (9, 9), (8, 12)]) == [[0, 3], [5, 12]]
    assert attribution.intersection([[0, 3], [5, 12]], [[2, 6], [7, 8], [11, 20]]) == [
        [2, 3], [5, 6], [7, 8], [11, 12]]
    assert attribution.length([[0, 3], [5, 12]]) == 10


@pytest.mark.parametrize("name", ["idle_unattributed_pct.request",
                                  "idle_unattributed_pct.loader"])
def test_idle_unattributed_exact(name):
    """Idle 700 ns; covered by a program range: [0, 100) (parse, then
    entropy_device), [300, 450) (entropy_device, its nested launch once),
    [450, 600) (thread 2's batch_parse), [950, 1000) (copy_out, clipped to
    the window): 450 ns. Unattributed 250 of 700."""
    read = _reader(name).read
    assert read(_Run(_trace(WINDOW, DEVICE, HOST))) == pytest.approx(100.0 * 250 / 700)
    # no program range at all (the parent of the spans): all of it
    bare = [h for h in HOST if not h[0].startswith("jpegtpu.")]
    assert read(_Run(_trace(WINDOW, DEVICE, bare))) == pytest.approx(100.0)
    # a card never idle, or no trace: nothing to read
    assert read(_Run(_trace(WINDOW, [("k", 0, 1000)], HOST))) is None
    assert read(_Run()) is None


@pytest.mark.parametrize("name,stage,want", [
    ("parse_ms.loader", "batch_parse", 1e3 * 0.512 / 256),
    ("host_wait_ms.loader", "batch_wait", 1e3 * 0.512 / 256),
    ("k2_pass2_steps.request", "k2_pass2_steps", 256 / 2),
    ("k2_pass2_steps.loader", "k2_pass2_steps", 256 / 2),
    ("colour_vector_pct.loader", "colour_vector_pct", 256 / 2),
    ("readback_mb.request", "readback_mb", 256 / 2),
    ("readback_pinned_pct.request", "readback_pinned_pct", 256 / 2),
])
def test_span_and_counter_readers(name, stage, want):
    """(calls, seconds, items) as the harness snapshots GLOBAL_METRICS: the
    span readers give ms an item, the counter's steps a call; a run without
    the span or counter (the parent of the change) gives None."""
    read = _reader(name).read
    assert read(_Run(stages={stage: (2, 0.512, 256.0)})) == pytest.approx(want)
    assert read(_Run(stages={"parse": (2, 0.5, 0.0)})) is None
