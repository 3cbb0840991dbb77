"""The port's serving and scaling scripts on device="cpu" (the kernels'
plain versions), at small sizes, against the JAX package on the same bytes:

- jpeg_decoder_tpu_torch.benchmarks.scaling with --sizes 1,2 --backend gloo
  --device cpu (one and two rank processes of a gloo group): each size's
  decoded batch (its SHA-256, the same on every rank) is bitwise the JAX
  BatchDecoder(DecodeConfig(), make_mesh(n_data=n)).decode_batch over the
  8-device CPU mesh of tests/conftest.py, and the records carry the JAX
  script's keys; the images are the JAX encoder's bytes.
- jpeg_decoder_tpu_torch.examples.serving: main's frames are bitwise the
  JAX BatchDecoder(DecodeConfig(), make_mesh()).decode_stream(datas,
  batch_size=16), and progressive_serving's planes bitwise the JAX
  host_decode_batch, on the same bytes (the port's encoder's; its
  progressive bytes equal jpeg_decoder_tpu.encode's).
- Each of the four scripts, run as `python -m` without a card and without
  --device cpu, exits non-zero and prints no result.
- benchmarks/mesh_ranks.run_ranks, the launcher of scaling's ranks, raises
  with the log of a rank that fails.
"""

import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jpeg_decoder_tpu as jt
from jpeg_decoder_tpu.models import decoder as jdecoder
from jpeg_decoder_tpu.parallel import batch as jbatch
from jpeg_decoder_tpu.parallel import mesh as jmesh
from jpeg_decoder_tpu_torch.benchmarks import scaling
from jpeg_decoder_tpu_torch.examples import serving

REPO = Path(__file__).resolve().parent.parent
#: scaling.py's record keys
SCALING_KEYS = {"mesh_devices", "frames_per_s", "mp_per_s", "scaling_efficiency"}


def _sha(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def test_scaling_gloo_ranks_match_jax_mesh_decode(capsys, tmp_path):
    batch, hw = 4, 32
    out = tmp_path / "scaling.json"
    assert scaling.main(["--sizes", "1,2", "--batch", str(batch), "--hw", str(hw),
                         "--repeat", "1", "--backend", "gloo", "--device", "cpu",
                         "--out", str(out)]) == 0
    lines = [json.loads(s) for s in capsys.readouterr().out.strip().splitlines()]
    assert [r["mesh_devices"] for r in lines] == [1, 2]
    for r in lines:
        assert SCALING_KEYS <= r.keys()
    assert lines[0]["scaling_efficiency"] == 1.0
    artifact = json.loads(out.read_text())
    raw = artifact["shared_core_raw"]
    assert raw["sizes"] == lines and raw["backend"] == "gloo" and raw["platform"] == "cpu"
    assert raw["warning"] and "gather" in artifact["headline"]

    datas = scaling.make_inputs(batch, hw, "cpu")
    rng = np.random.default_rng(scaling.SEED)
    cfg = jt.EncodeConfig(quality=85, subsampling="420", restart_interval=2)
    assert datas == [jt.encode(rng.integers(0, 256, (hw, hw, 3), dtype=np.uint8), cfg)
                     for _ in range(batch)]
    for r in lines:
        n = r["mesh_devices"]
        want = jbatch.BatchDecoder(jt.DecodeConfig(), jmesh.make_mesh(n_data=n)
                                   ).decode_batch(datas)
        assert np.asarray(want).shape == (batch, hw, hw, 3)
        assert r["sha256"] == _sha(np.asarray(want))


def test_run_ranks_raises_on_a_failed_rank(tmp_path):
    """The rank launcher that scaling and chip_smoke.py share: a rank that
    exits non-zero ends the run with its log."""
    from jpeg_decoder_tpu_torch.benchmarks import mesh_ranks

    with pytest.raises(RuntimeError, match=r"rank [01] of 2 exited 2:.*--backend"):
        mesh_ranks.run_ranks("jpeg_decoder_tpu_torch.benchmarks.mesh_ranks",
                             [str(tmp_path), "--backend", "none"], 2, tmp_path, timeout=120)


def test_serving_frames_match_jax_decode_stream(capsys):
    datas, frames = serving.main("cpu", n_streams=8, side=64)
    assert "8 frames in" in capsys.readouterr().out
    want = np.concatenate(list(jbatch.BatchDecoder(jt.DecodeConfig(), jmesh.make_mesh())
                               .decode_stream(datas, batch_size=16)))
    assert frames.shape == (8, 64, 64, 3)
    np.testing.assert_array_equal(frames, want)


def test_progressive_serving_planes_match_jax_host_decode_batch(capsys):
    datas, planes = serving.progressive_serving("cpu", n_streams=2, side=64)
    assert "progressive serving: 2 images" in capsys.readouterr().out
    rng = np.random.default_rng(1)
    cfg = jt.EncodeConfig(quality=85, subsampling="420", progressive=True)
    assert datas == [jt.encode(rng.integers(0, 256, (64, 64, 3), dtype=np.uint8), cfg)
                     for _ in range(2)]
    want = list(jdecoder.host_decode_batch(datas, jt.DecodeConfig(num_threads=1),
                                           jdecoder.PlanePool()))
    assert len(want) == len(planes) == 2
    for got, (_frame, jplanes, _qts) in zip(planes, want):
        assert len(got) == 3
        for ci, p in enumerate(got):
            np.testing.assert_array_equal(p, jplanes.plane(ci))


@pytest.mark.parametrize("module", [
    "jpeg_decoder_tpu_torch.benchmarks.bench",
    "jpeg_decoder_tpu_torch.benchmarks.k2_batched",
    "jpeg_decoder_tpu_torch.benchmarks.scaling",
    "jpeg_decoder_tpu_torch.examples.serving",
])
def test_script_without_a_card_exits_nonzero(module):
    # no card visible, on any host
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-m", module], cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=240)
    assert r.returncode != 0
    assert r.stdout.strip() == "" or "{" not in r.stdout
    assert "torch.cuda.is_available() is False" in r.stderr
