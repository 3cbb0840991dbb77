"""The port's bench scripts on device="cpu" (the kernels' plain versions),
at small sizes, against the JAX package on the same inputs:

- jpeg_decoder_tpu_torch.benchmarks.bench: each input generator (bench.py's
  seeds and its in-repo fallback's configs) gives bytes equal to
  jpeg_decoder_tpu.encode of the same array; main prints one JSON line with
  every key of the port's line; a pixel stage that is off in one pixel
  makes the guard print value 0.0 and bit_exact false and exit 1, as does
  one image of the slope's B=16 call that differs from the B=1 call; the
  input cache is named after the encoder's sources and config; without
  a card (and without --device cpu), or without the native runtime, it
  exits non-zero.
- jpeg_decoder_tpu_torch.benchmarks.k2_batched: its images are the JAX
  encoder's bytes, and the batched decode's planes (the plain K2u and K2)
  are bitwise jpeg_decoder_tpu.ops.entropy_pallas.entropy_decode_batch's,
  which runs the lockstep kernel in interpret mode here, as the JAX tests
  run it; main prints its line.

Bitwise throughout: the encoder's bytes and the coefficient planes.
"""

import json

import numpy as np
import pytest

import jpeg_decoder_tpu as jt
from jpeg_decoder_tpu.io.parser import parse as jparse
from jpeg_decoder_tpu.ops import entropy_pallas
from jpeg_decoder_tpu_torch.benchmarks import bench, k2_batched
from jpeg_decoder_tpu_torch.io.parser import parse
from jpeg_decoder_tpu_torch.models import decoder as decoder_mod
from jpeg_decoder_tpu_torch.native import runtime as native_runtime

W, H = 64, 48
#: bench.py's seeds: the headline image, then the DRI and the progressive
#: serving streams (seed + i)
SEED, STREAM_SEED, PROG_STREAM_SEED = 20260816, 555, 777
#: the keys of the port's line (ref_same_host_mps and vs_ref_same_host
#: only where the reference decoder was measured; bit_exact only when false)
LINE_KEYS = {
    "metric", "unit", "host_ms", "host_p25_ms", "host_p75_ms", "nodri_host_ms",
    "progressive_host_ms", "progressive_stream_ms", "host_stream_ms", "host_steal_pct",
    "host_window_attempts", "encode_pack_ms", "encode_bytes", "encode_steal_pct",
    "device_exact_ms", "device_kind", "device_f32_mps", "encode_fdct_device_ms", "host_cpu",
    "host_ncpu", "encode_mps", "encode_note", "host_stage_used", "value", "vs_baseline",
    "encode_oneshot_ms", "encode_oneshot_mps", "device_power_limit",
}
SMALL_RUN = ["--device", "cpu", "--size", f"{W}x{H}", "--passes", "1", "--max-attempts", "1"]


@pytest.fixture(scope="module", autouse=True)
def cache_dir(tmp_path_factory):
    """The bench's input cache in a directory of this module's own."""
    with pytest.MonkeyPatch.context() as mp:
        d = tmp_path_factory.mktemp("bench_cache")
        mp.setattr(bench, "CACHE", d)
        yield d


def _noise(seed):
    return np.random.default_rng(seed).integers(0, 256, (H, W, 3), dtype=np.uint8)


def _jax_encode(seed, restart=True, progressive=False):
    return jt.encode(_noise(seed), jt.EncodeConfig(
        quality=85, subsampling="420", restart_interval=W // 16 if restart else 0,
        progressive=progressive))


GENERATORS = {
    "dri": (lambda: [bench.make_input(W, H, "cpu")], lambda: [_jax_encode(SEED)]),
    "nodri": (lambda: [bench.make_input_nodri(W, H, "cpu")],
              lambda: [_jax_encode(SEED, restart=False)]),
    "progressive": (lambda: [bench.make_input_progressive(W, H, "cpu")],
                    lambda: [_jax_encode(SEED, restart=False, progressive=True)]),
    "stream": (lambda: bench.make_stream_inputs(3, W, H, "cpu"),
               lambda: [_jax_encode(STREAM_SEED + i) for i in range(3)]),
    "progressive_stream": (lambda: bench.make_progressive_stream_inputs(2, W, H, "cpu"),
                           lambda: [_jax_encode(PROG_STREAM_SEED + i, restart=False,
                                                progressive=True) for i in range(2)]),
}


@pytest.mark.parametrize("kind", list(GENERATORS))
def test_generator_bytes_equal_jax_encode(kind, cache_dir):
    port, jax_side = GENERATORS[kind]
    got = port()
    assert got == jax_side()
    assert got == port()  # the second call reads the cache
    assert any(cache_dir.glob(f"torch_*_{W}x{H}_*.jpg"))


def test_cache_name_follows_the_encoder(monkeypatch):
    """A changed encoder source or encode config names another cache file,
    so that the bench never decodes bytes an older encoder made."""
    a = bench.cache_path("dri", W, H, {})
    assert a.name.startswith(f"torch_dri_{W}x{H}_") and a.parent == bench.CACHE
    assert bench.cache_path("dri", W, H, {"restart": False}) != a
    monkeypatch.setattr(bench, "_sources_digest", lambda: b"another encoder")
    assert bench.cache_path("dri", W, H, {}) != a


def _line(capsys):
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1, out
    return json.loads(out[0])


def test_bench_main_prints_every_key(capsys, tmp_path):
    out = tmp_path / "line.json"
    assert bench.main(SMALL_RUN + ["--out", str(out)]) == 0
    line = _line(capsys)
    assert LINE_KEYS <= line.keys(), sorted(LINE_KEYS - line.keys())
    assert bench.LINE_KEYS == LINE_KEYS
    assert "bit_exact" not in line and "ref_same_host_mps" not in line
    assert json.loads(out.read_text()) == line
    assert line["metric"] == "decode_4k420_q85_throughput" and line["device_kind"] == "cpu"
    assert line["host_window_attempts"] == 1
    assert line["host_stage_used"] in ("host_ms", "host_stream_ms")
    t_host = line[line["host_stage_used"]]
    assert t_host <= min(line["host_ms"], line["host_stream_ms"])
    # the pipeline compositions, in the bench's own operations (the times
    # themselves are the CPU's, and a loaded host may round them to 0)
    px = W * H
    assert line["value"] == round(px / max(t_host / 1e3, line["device_exact_ms"] / 1e3) / 1e6, 2)
    assert line["vs_baseline"] == round(line["value"] / bench.BASELINE_MPS, 2)
    t_enc = max(line["encode_pack_ms"], line["encode_fdct_device_ms"]) / 1e3
    assert line["encode_mps"] == round(px / t_enc / 1e6, 2)
    assert line["encode_bytes"] == len(_jax_encode(SEED))


def test_bench_guard_fails_on_one_pixel(capsys, monkeypatch):
    forward = decoder_mod.PixelStage.forward

    def off_by_one(self, *planes, want_planes=True):
        rgb, pix = forward(self, *planes, want_planes=want_planes)
        rgb = rgb.clone()
        rgb[..., 0, 0, 0] ^= 1
        return rgb, pix

    monkeypatch.setattr(decoder_mod.PixelStage, "forward", off_by_one)
    assert bench.main(SMALL_RUN) == 1
    line = _line(capsys)
    assert line["bit_exact"] is False
    assert line["value"] == 0.0 and line["vs_baseline"] == 0.0


def test_bench_guard_fails_on_one_image_of_the_batch(capsys, monkeypatch):
    """The slope's B=16 call must decode each of its images as the B=1
    call does."""
    forward = decoder_mod.PixelStage.forward

    def off_in_batch(self, *planes, want_planes=True):
        rgb, pix = forward(self, *planes, want_planes=want_planes)
        if rgb.shape[0] > 1:
            rgb = rgb.clone()
            rgb[1, 0, 0, 0] ^= 1
        return rgb, pix

    monkeypatch.setattr(decoder_mod.PixelStage, "forward", off_in_batch)
    assert bench.main(SMALL_RUN) == 1
    line = _line(capsys)
    assert line["bit_exact"] is False
    assert line["value"] == 0.0 and line["vs_baseline"] == 0.0


def test_bench_needs_a_card_or_the_cpu_flag(capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main(["--size", f"{W}x{H}", "--passes", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_bench_needs_the_native_runtime(capsys, monkeypatch):
    monkeypatch.setattr(native_runtime, "available", lambda: False)
    assert bench.main(SMALL_RUN) != 0
    assert capsys.readouterr().out == ""


def test_k2_batched_planes_match_jax_batched_decode():
    datas = k2_batched.make_inputs(2, W, H, "cpu")
    rng = np.random.default_rng(k2_batched.SEED)
    cfg = jt.EncodeConfig(quality=85, subsampling="420", restart_interval=W // 16)
    assert datas == [jt.encode(rng.integers(0, 256, (H, W, 3), dtype=np.uint8), cfg)
                     for _ in range(2)]
    got = k2_batched.decode_batch([parse(d) for d in datas], "cpu")
    want = entropy_pallas.entropy_decode_batch([jparse(d) for d in datas], jt.DecodeConfig())
    for planes, (jplanes, _qts) in zip(got, want):
        assert len(planes) == 3
        for ci, p in enumerate(planes):
            np.testing.assert_array_equal(p.numpy(), jplanes.plane(ci))


def test_k2_batched_main_prints_its_line(capsys):
    assert k2_batched.main(["--device", "cpu", "--images", "2", "--width", str(W),
                            "--height", str(H), "--repeat", "1"]) == 0
    line = _line(capsys)
    assert line["artifact"] == "k2_batched_entropy" and line["platform"] == "cpu"
    assert line["images"] == 2
    # a marker per MCU row: three rows of four 16x16 MCUs an image
    assert line["segments"] == 2 * 3
    assert line["subsequences"] >= line["segments"]
    assert line["batch_wall_s"] > 0 and "mp_per_s" in line
