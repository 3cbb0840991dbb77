"""Whole runs of the harness without a card (`--rehearse`: the cells' small
sizes on the CPU, the program's plain paths), the control, the faults the
check has to catch (in BENCHMARK.json's cells and the queued ones of
`tests/queued.py`, chosen by the entry their configuration names), and a
cell added by new files alone.

    python -m pytest perfbench/tests -q
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from perfbench import harness
from perfbench.tests import queued

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
#: BENCHMARK.json's cells and the queued ones it does not hold yet
WORKLOADS = {w["name"]: w for w in queued.workloads(BENCH)}
KEYS = {"correct", "attempted", "failed", "metrics", "device", "breakdown", "checks"}
SEED = 2**31 + 101


def _cli(cwd: Path, *args: str, env=None) -> tuple[int, str, str]:
    r = subprocess.run([sys.executable, "-m", "perfbench", *args], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=600)
    return r.returncode, r.stdout, r.stderr


def _env(root: Path) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(root)
    return env


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_rehearsal_line(cell, trace):
    """Each cell's rehearsal ends its output with the contract's line, its
    checks last, correct, no device metric; and the import guard held (it
    exits 2 with no line where JAX or the JAX package was loaded)."""
    rc, out, err = _cli(ROOT, "--workload", cell, "--seed", str(SEED), "--seconds", "1",
                        "--trace", str(trace), "--rehearse")
    assert rc == 0, err[-3000:]
    line = json.loads(out.strip().splitlines()[-1])
    assert set(line) <= KEYS and list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert line["device"]["platform"] == "cpu"
    # a rehearsal has no card: no metric read from the device's trace
    want = {m["name"] for m in BENCH["per_layer" if trace else "end_to_end"]
            if cell in m.get("workloads", [cell]) and m["source"] != "device_trace"}
    assert set(line["metrics"]) <= want
    if not trace:
        assert set(line["metrics"]) == want
    for name, c in line["checks"].items():
        assert f"check {name} {c['value']}" in err
    assert err.strip().splitlines()[-1].startswith("check ")


def test_new_traffic_and_metric_found_by_name(tmp_path):
    """A traffic file and a metric file added to a copy, with their entries
    in BENCHMARK.json, run with no edit to any file the copy had."""
    shutil.copytree(HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "build", "tests"))
    before = {p: p.read_bytes() for p in (tmp_path / "perfbench").rglob("*") if p.is_file()}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    t = json.loads((HERE / "traffic" / "loader_nodri_photo_b256.json").read_text())
    t.update(name="loader_nodri_photo_b64", batch=64,
             rehearse={"pool": 5, "batch": 2, "warmup_batches": 1, "sample": 3})
    (tmp_path / "perfbench" / "traffic" / "loader_nodri_photo_b64.json").write_text(json.dumps(t))
    (tmp_path / "perfbench" / "metrics" / "launches_per_image.loader.py").write_text(
        '"""launches_per_image.loader: the program\'s kernel launches a yielded image."""\n\n'
        'LAYER = "device"\nUNIT = "launches"\nMOVES = "kernel_us_per_image"\n\n\n'
        "def read(run):\n"
        "    n = run.result.images\n"
        "    return sum(run.launches.values()) / n if n else None\n")
    bench["workloads"].append({"name": "loader_camera_b64", "config": "imagenet_loader_pallas",
                               "traffic": "loader_nodri_photo_b64", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "launches_per_image.loader", "unit": "launches",
                               "better": "lower", "source": "program_counter", "layer": "device",
                               "moves": "kernel_us_per_image", "workloads": ["loader_camera_b64"]})
    for m in bench["end_to_end"]:
        if "workloads" in m and m["name"] == "kernel_us_per_image":
            m["workloads"].append("loader_camera_b64")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "jpeg_decoder_tpu_torch").symlink_to(ROOT / "jpeg_decoder_tpu_torch")
    rc, out, err = _cli(tmp_path, "--workload", "loader_camera_b64", "--seed", str(SEED),
                        "--seconds", "1", "--trace", "1", "--rehearse", env=_env(tmp_path))
    assert rc == 0, err[-3000:]
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is True and "launches_per_image.loader" in line["metrics"]
    assert {p: p.read_bytes() for p in before} == before


def test_no_result_without_the_program(tmp_path):
    """A directory that holds only BENCHMARK.json and perfbench/: no line."""
    shutil.copytree(HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "build"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    env = dict(os.environ, PYTHONPATH=str(tmp_path), PYTHONNOUSERSITE="1")
    rc, out, _ = _cli(tmp_path, "--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                      "--rehearse", env=env)
    assert rc != 0 and out.strip() == ""


#: Sizes at which the control (FLOAT32) departs from EXACT on the CPU: a
#: frame must hold a pixel where the two contracts round apart (at the
#: cells' own sizes every frame does); the request cells' windows hold both
#: frames of the pool, of which the second departs, and compare every output.
CONTROL_SIZES = {"uhd_camera": {"width": 128, "height": 128, "sample": 16},
                 "uhd_dri": {"width": 128, "height": 128, "sample": 16},
                 "loader_dri_b256": {"width": 500, "height": 375, "restart_interval": 32}}
CONTROL_SECONDS = {"uhd_camera": 6.0, "uhd_dri": 3.0}
#: A seed whose first uhd frame at these sizes already departs, so that the
#: control fails on the window's first request however slow the CPU is.
CONTROL_SEED = SEED + 1
#: Sizes at which a batch cell's rehearsal makes calls that hold different
#: images one after another (a stale call is then seen), small enough for
#: many calls in the window.
FAULT_SIZES = {"loader_mixed_b256": {"sizes": [[48, 32], [32, 48], [48, 24]], "pool": 3,
                                     "batch": 2}}
#: Images a batch cell's rehearsal draws for the check, as its full size
#: does: a fault that breaks one image of a batch in four then goes unseen
#: with a chance of about (3/4)**32 however many batches the window holds
#: (with 8 drawn from 11 batches of 4, about one run in ten).
FAULT_SAMPLE = 32


def _entry(cell: str) -> str:
    return queued.config(BENCH, WORKLOADS[cell])["entry"]


def _cells(*entries: str) -> list:
    """The cells whose configuration drives one of `entries`."""
    return [c for c in WORKLOADS if _entry(c) in entries]


def _traffic(cell: str, **over) -> dict:
    t = queued.traffic(WORKLOADS[cell]["traffic"])
    t["rehearse"] = {**t["rehearse"], **CONTROL_SIZES.get(cell, {}), **over}
    return t


def _run(cell: str, monkeypatch, seconds: float = 0.5, seed: int = SEED, tmp_path=None,
         **kw) -> dict:
    """A rehearsal of the cell; a queued cell's configuration file goes to
    `tmp_path`."""
    monkeypatch.setattr(harness, "CACHES", {})
    bench = queued.bench_for(BENCH, WORKLOADS[cell], tmp_path)
    return harness.run(cell, seed, seconds, False, 0.0, rehearse=True, bench=bench, **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell, monkeypatch):
    """The program's own lower-precision path (FLOAT32) in place of EXACT
    comes out not correct, by the RGB bytes it gets wrong."""
    seconds = CONTROL_SECONDS.get(cell, 0.5)
    good = _run(cell, monkeypatch, seconds, seed=CONTROL_SEED, traffic=_traffic(cell))
    assert good["correct"] is True
    line = _run(cell, monkeypatch, seconds, seed=CONTROL_SEED, control=True,
                traffic=_traffic(cell))
    assert line["correct"] is False
    assert line["checks"]["rgb_bytes_off"]["value"] > 0


def _patch_requests(monkeypatch, fault: str):
    from jpeg_decoder_tpu_torch.models.decoder import JpegDecoder

    real = JpegDecoder.decode_rgb
    state = {"last": None, "n": 0}

    def decode_rgb(self, data):
        rgb = real(self, data)
        state["n"] += 1
        if fault == "stale":  # the step returns its state unchanged
            out, state["last"] = (state["last"] if state["last"] is not None else rgb), rgb
            return out
        if fault == "altered":  # an answer altered where it is produced
            rgb = rgb.copy()
            rgb[-1, -1, 2] ^= 1
            return rgb
        if fault == "raises" and state["n"] % 3 == 0:
            raise RuntimeError("planted")
        return rgb

    monkeypatch.setattr(JpegDecoder, "decode_rgb", decode_rgb)


def _patch_batches(monkeypatch, fault: str, entry: str):
    """Break the entry the cell's configuration names underneath. Each batch
    that `decode_stream` yields, or each list of arrays that a
    `decode_many` call returns, comes out as the last one (stale), with its
    second half zeroed (half), with its first image's first byte altered
    (altered), or, once the window is open, as an exception (raises)."""
    from jpeg_decoder_tpu_torch.parallel.batch import BatchDecoder

    state = {"last": None, "open": False}
    real_open = harness.Window.open

    def open_window(self):
        real_open(self)
        state["open"] = True

    def broken(outs):
        if fault == "raises" and state["open"]:
            raise RuntimeError("planted")
        if fault == "stale":  # the step returns its state unchanged
            outs, state["last"] = (state["last"] if state["last"] is not None else outs), outs
        elif fault in ("half", "altered"):
            outs = outs.copy() if isinstance(outs, np.ndarray) else [o.copy() for o in outs]
            if fault == "half":  # half of the batch left out
                for o in outs[len(outs) // 2:]:
                    o[...] = 0
            else:  # an answer altered where it is produced
                outs[0][0, 0, 0] ^= 4
        return outs

    real_stream, real_many = BatchDecoder.decode_stream, BatchDecoder.decode_many

    def decode_stream(self, datas, batch_size=None):
        stream = real_stream(self, datas, batch_size)
        try:
            for out in stream:
                yield broken(out)
        finally:
            stream.close()

    def decode_many(self, datas):
        return broken(real_many(self, datas))

    patched = {"BatchDecoder.decode_stream": decode_stream,
               "BatchDecoder.decode_many": decode_many}
    monkeypatch.setattr(harness.Window, "open", open_window)
    monkeypatch.setattr(BatchDecoder, entry.split(".")[1], patched[entry])


@pytest.mark.parametrize("fault", ["stale", "altered", "raises"])
@pytest.mark.parametrize("cell", _cells("JpegDecoder.decode_rgb"))
def test_request_faults_caught(cell, fault, monkeypatch, tmp_path):
    _patch_requests(monkeypatch, fault)
    line = _run(cell, monkeypatch, tmp_path=tmp_path, traffic=_traffic(cell, sample=8))
    assert line["correct"] is False


@pytest.mark.parametrize("fault", ["stale", "half", "altered", "raises"])
@pytest.mark.parametrize("cell", _cells("BatchDecoder.decode_stream", "BatchDecoder.decode_many"))
def test_batch_faults_caught(cell, fault, monkeypatch, tmp_path):
    _patch_batches(monkeypatch, fault, _entry(cell))
    line = _run(cell, monkeypatch, tmp_path=tmp_path,
                traffic=_traffic(cell, **FAULT_SIZES.get(cell, {}), sample=FAULT_SAMPLE))
    assert line["correct"] is False


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell):
    """Each cell, a short window on the card: correct, its metrics there."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rc, out, err = _cli(ROOT, "--workload", cell, "--seed", str(SEED), "--seconds", "2")
    assert rc == 0, err[-3000:]
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
    assert np.isfinite([m["value"] for m in line["metrics"].values()]).all()
