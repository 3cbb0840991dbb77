"""BENCHMARK.json against the benchmark's contract, and the harness's parts
that need no card: the generator, the packer, the roofline arithmetic, the
reference against the program's CPU decode, and the import guard.

    python -m pytest perfbench/tests -q
"""

from __future__ import annotations

import ast
import importlib.util
import json
import re
import statistics
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import gen, harness, packer, reference, roofline
from perfbench.tests import queued

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TRAFFIC = sorted({w["traffic"] for w in BENCH["workloads"]})
#: BENCHMARK.json's cells and the queued ones it does not hold yet
WORKLOADS = queued.workloads(BENCH)


def _line_ok(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def _metric_module(name: str):
    spec = importlib.util.spec_from_file_location("m", HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= len(BENCH["command"]) <= 32 and all(_line_ok(w) for w in BENCH["command"])
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word
        if "/" in word or word.endswith(".py"):
            assert word.startswith("perfbench/")
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    # a full check with 24 cells fits its time
    cells = 24
    assert ((2 + 14 * cells) * (BENCH["run_seconds"] + 60) + cells * 2 * 90 + 1200) <= 43200
    names = [x["name"] for sec in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[sec]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n


def test_configs_and_cells():
    cfgs = {c["name"]: c for c in BENCH["configs"]}
    assert 1 <= len(cfgs) <= 24
    for c in cfgs.values():
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line_ok(c["source"]) and _line_ok(c["why"])
        assert c["file"].startswith("perfbench/configs/")
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["name"] == c["name"] and body["source"] == c["source"]
        assert body["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k) and k in body
    assert len({c["file"] for c in cfgs.values()}) == len(cfgs)
    pairs = set()
    used = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and _line_ok(w["why"])
        assert w["config"] in cfgs and NAME.match(w["traffic"])
        assert (HERE / "traffic" / f"{w['traffic']}.json").exists()
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        used.add(w["config"])
    assert used == set(cfgs)


def test_metrics_declared_and_found():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = [w["name"] for w in BENCH["workloads"]]
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert (HERE / "end_to_end" / f"{m['name']}.py").exists()
    for cell in cells:
        reported = [m for m in BENCH["end_to_end"] if cell in m.get("workloads", cells)]
        assert "setup_s" in [m["name"] for m in reported] and len(reported) >= 2
        assert any(cell in m.get("workloads", cells) for m in BENCH["per_layer"])
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") and _line_ok(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        # the metric's end-to-end metric is reported in each of its cells
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", cells), (m["name"], cell)
        mod = _metric_module(m["name"])
        assert (mod.LAYER, mod.UNIT, mod.MOVES) == (m["layer"], m["unit"], m["moves"])
        layers.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    # metrics of one layer give it letter for letter
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("traffic", TRAFFIC)
def test_generator_deterministic(traffic):
    t = json.loads((HERE / "traffic" / f"{traffic}.json").read_text())
    a = gen.make_pool(t, 2**31 + 11, rehearse=True)
    b = gen.make_pool(t, 2**31 + 11, rehearse=True)
    c = gen.make_pool(t, 7, rehearse=True)
    assert [i.data for i in a.images] == [i.data for i in b.images]
    assert [i.data for i in a.images] != [i.data for i in c.images]
    assert len({i.data for i in a.images}) == len(a.images)
    assert (a.width, a.height, len(a.images)) == (c.width, c.height, len(c.images))


@pytest.mark.parametrize("w,h,ri", [(128, 64, 0), (128, 64, 8), (40, 24, 1), (272, 256, 0)])
def test_packer_round_trip(w, h, ri):
    """The packer writes what it is given: the reference's Huffman decoder
    reads every coefficient back."""
    pool = gen.make_pool({"width": w, "height": h, "restart_interval": ri,
                          "layout": "halves", "pool": 2}, 3)
    for im in pool.images:
        info, planes = reference.decode_coefficients(im.data)
        assert (info["width"], info["height"], info["ri"]) == (w, h, ri)
        for got, want in zip(planes, im.coeffs):
            np.testing.assert_array_equal(got, want)
        assert im.scan_bytes == len(im.data) - len(packer.header(w, h, im.qts, ri)) - 2


def test_packer_symbols_and_escapes():
    """Long zero runs (ZRL), a block ending on a nonzero, the largest
    values, and the symbol count."""
    y = np.zeros((2, 2, 64), np.int16)
    y[0, 0, 0], y[0, 0, 40] = -1023, 5          # a run of 38 zeros: two ZRLs
    y[0, 1, 63] = -1                            # 62 zeros (three ZRLs), no EOB
    y[1, 0, 1:64] = np.arange(1, 64) % 7 - 3    # dense
    y[1, 1, 0] = 1023
    cb = np.zeros((1, 1, 64), np.int16)
    cr = np.zeros((1, 1, 64), np.int16)
    cr[0, 0, 17] = 1023                         # 16 zeros: one ZRL
    (data,), (symbols,) = packer.pack_420([(y, cb, cr)], 16, 16, np.ones((2, 64), np.int32), 0)
    _, planes = reference.decode_coefficients(data)
    for got, want in zip(planes, (y, cb, cr)):
        np.testing.assert_array_equal(got, want)
    dense = 1 + int(np.count_nonzero(y[1, 0, 1:])) + (1 if y[1, 0, 63] == 0 else 0)
    # DC + ZRL x2 + symbol + EOB; DC + ZRL x3 + symbol; dense; DC + EOB; Cb: DC + EOB;
    # Cr: DC + ZRL + symbol + EOB
    assert symbols == 5 + 5 + dense + 2 + 2 + 4


def test_roofline_hand_worked():
    """A 32x16 4:2:0 frame: 2 MCUs, 12 blocks, 512 pixels."""
    blocks, pixels = 12, 512
    # entropy: 1,000 coded bytes + 12 * 128 written = 2,536 bytes -> 757.0 ps;
    # 300 symbols * 14 = 4,200 int32 operations -> 250.7 ps
    assert roofline.entropy_bound_s(1000, blocks, 300) == pytest.approx(2536 / 3.35e12)
    assert roofline.entropy_bound_s(10, blocks, 3000) == pytest.approx(42000 / 16.75e12)
    # pixel stage: 12 * 128 + 512 * 3 (+ 12 * 64 planes) bytes; 12 * 831 + 512 * 10
    # (+ 512 * 12 fancy) float64 operations
    assert roofline.IDCT_OPS_PER_BLOCK == 831
    assert roofline.pixel_bound_s(blocks, pixels, True, False) == pytest.approx(
        max((1536 + 1536 + 768) / 3.35e12, (9972 + 5120) / 33.5e12))
    assert roofline.pixel_bound_s(blocks, pixels, False, True) == pytest.approx(
        max((1536 + 1536) / 3.35e12, (9972 + 5120 + 6144) / 33.5e12))


class _Ev:
    """A profiler event as `trace.from_profile` reads it."""

    def __init__(self, name, start, end, kind, cuda=True):
        self._n, self._s, self._e, self._k, self._c = name, start, end, kind, cuda

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def start_thread_id(self):
        return 1

    def activity_type(self):
        return self._k

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._c else torch.autograd.DeviceType.CPU

    def is_user_annotation(self):
        return self._k == "user_annotation"


def _profile(events):
    class Results:
        def events(self):
            return events

    class Prof:
        pass

    prof = Prof()
    prof.profiler = Prof()
    prof.profiler.kineto_results = Results()
    return prof


def test_trace_busy_and_kernel_time():
    """Busy time counts overlaps once and clips to the window; kernel time
    leaves copies and memsets out; a profile of the card alone, with no
    host range, takes the span of its device events as its window."""
    from perfbench import readers, trace

    dev = [_Ev("pass2_kernel(Call)", 100, 400, "kernel"),
           _Ev("idct_exact_kernel<2>", 300, 500, "kernel"),
           _Ev("Memcpy DtoH (Device -> Pageable)", 450, 1450, "gpu_memcpy"),
           _Ev("Memset (Device)", 1500, 1600, "gpu_memset")]
    tr = trace.from_profile(_profile(dev + [_Ev("perfbench.window", 0, 1550, "user_annotation",
                                                 cuda=False)]))
    assert tr.window_s == pytest.approx(1550e-9)
    assert tr.busy_s == pytest.approx(1400e-9)  # 100-1450, 1500-1550
    assert tr.kernel_busy_s == pytest.approx(400e-9)  # 100-500
    with pytest.raises(RuntimeError):
        trace.from_profile(_profile(dev))
    alone = trace.from_profile(_profile(dev), device_only=True)
    assert (alone.window.start, alone.window.end) == (100, 1600)
    assert alone.busy_s == pytest.approx(1450e-9)

    class R:
        images = 4
        attempted = 1

    class Run:
        result = R()

    Run.trace = alone
    assert readers.kernel_us(Run, "image") == pytest.approx(400e-9 * 1e6 / 4)


def _upsamplings(traffic: str) -> list:
    """The upsampling of each cell's configuration that decodes `traffic`."""
    return sorted({queued.config(BENCH, w)["decode_config"].get("upsample", "nn")
                   for w in WORKLOADS if w["traffic"] == traffic})


@pytest.mark.parametrize("traffic", sorted({w["traffic"] for w in WORKLOADS}))
@pytest.mark.parametrize("size", [(128, 64), (500, 375), (36, 20)])
def test_reference_matches_program_cpu_decode(traffic, size):
    """The reference's RGB equals the program's host decode (use_device=False,
    the EXACT arithmetic) on small frames of each traffic mix, each image at
    its own size and tables, under the upsampling of each cell's
    configuration that decodes the mix."""
    from jpeg_decoder_tpu_torch import DecodeConfig
    from jpeg_decoder_tpu_torch.models import decoder

    t = queued.traffic(traffic)
    over = ({"sizes": [list(size)], "size_weights": [1]} if "sizes" in t
            else {"width": size[0], "height": size[1]})
    t = {**t, **over, "pool": 2,
         "restart_interval": t["restart_interval"] and -(-size[0] // 16)}
    pool = gen.make_pool(t, 2**31 + 5)
    for upsample in _upsamplings(traffic):
        cfg = DecodeConfig(use_device=False, upsample=upsample)
        for im in pool.images:
            assert (im.width, im.height) == size
            want = decoder.decode_rgb(im.data, cfg, device="cpu")
            got = reference.decode_rgb(im.width, im.height, gen.COMPS_420,
                                       [torch.from_numpy(c) for c in im.coeffs],
                                       [im.qts[0], im.qts[1], im.qts[1]], upsample)
            np.testing.assert_array_equal(got.numpy(), want)


def test_reservoir_is_seeded_and_uniform():
    def draw(seed):
        r = harness.Reservoir(4, seed)
        for _ in range(50):
            for j, slot in r.offer(8):
                r.put(slot, (r.seen - 8 + j))
        return list(r.items)

    assert draw(5) == draw(5) and draw(5) != draw(6)
    counts = np.zeros(400)
    for s in range(500):
        counts[draw(s)] += 1
    assert len(draw(1)) == 4 and counts.sum() == 2000
    # each of the 400 outputs kept 5 times on average; no region favoured
    assert abs(statistics.mean(counts[:200]) - statistics.mean(counts[200:])) < 1.5


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module)
    return out


def test_import_guard_sources():
    """Nothing under perfbench/ imports JAX or the JAX package, or reads the
    JAX-era benchmarks/ or jpeg_decoder_tpu/; the yardstick (reference,
    packer, generator, photos, roofline) imports nothing of the program."""
    for path in HERE.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "jpeg_decoder_tpu"}, path
        text = path.read_text()
        if path.parent.name == "tests":
            continue
        assert not re.search(r"(?<![\w/])(jpeg_decoder_tpu|benchmarks)/", text), path
        assert "jpeg_decoder_tpu_torch.benchmarks" not in text, path
    for name in ("reference", "packer", "gen", "photos", "roofline", "trace"):
        tops = {m.split(".")[0] for m in _imports(HERE / f"{name}.py")}
        assert "jpeg_decoder_tpu_torch" not in tops, name


def test_forbidden_modules_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "jpeg_decoder_tpu_torch_x", sys)
    assert harness.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "jpeg_decoder_tpu.ops", sys)
    assert harness.forbidden_loaded() == ["jax", "jpeg_decoder_tpu"]


def test_no_result_when_jax_is_loaded(monkeypatch, capsys):
    monkeypatch.setattr(harness, "run", lambda *a, **k: {"correct": True})
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert harness.main(["--workload", "uhd_camera", "--seed", "1", "--seconds", "1"]) == 2
    out, err = capsys.readouterr()
    assert out == "" and "jax" in err


def test_no_result_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert harness.main(["--workload", "uhd_camera", "--seed", "1", "--seconds", "1"]) == 2
    out, err = capsys.readouterr()
    assert out == "" and "CUDA" in err
