"""Pools of mixed sizes with per-image quant tables, and the loop that drives
`BatchDecoder.decode_many` over them: the cells' own pools pinned byte for
byte, the readers' numbers on a uniform pool pinned, libjpeg's quality
scaling, a mixed pool against its draws, and whole rehearsals of a
`decode_many` cell that is in no BENCHMARK.json (its configuration in a
temporary directory; its faults are cases of `test_perfbench_runs.py`'s
`test_batch_faults_caught`).

    python -m pytest perfbench/tests -q
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest

from perfbench import gen, harness, readers, reference, trace
from perfbench.tests import queued

HERE = Path(__file__).resolve().parents[1]
SEED = 2**31 + 7


def _traffic(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def _digest(pool) -> str:
    h = hashlib.sha256()
    for im in pool.images:
        h.update(im.data)
        h.update(np.asarray(im.qts, dtype="<i4").tobytes())
        h.update(f"{im.symbols},{im.scan_bytes};".encode())
    return h.hexdigest()


#: sha256 over each image's stream, tables, symbols and scan bytes, as the
#: generator made them before it took mixed pools: (traffic, rehearse, seed).
PINNED = {
    ("loader_dri_photo_b256", True, 0):
        "bd5508ad928cff4955d16b386869e1d461726cfe3cc660c7cc41907616f4fd88",
    ("loader_dri_photo_b256", False, 0):
        "7ade7beeebe7c1bcd3433ec0adf916e3140f4f310c849a6f2df8fa62dca87cbe",
    ("loader_dri_photo_b256", True, 1):
        "d97feebb62f55d952655e1e621767d4aa7d364ae375d45672ef7913d1af11d34",
    ("loader_dri_photo_b256", False, 1):
        "aeb4a730c8a566f565051fb023c8b96d04cd9b63e3a9c57903160ce0a6c55e15",
    ("loader_nodri_photo_b256", True, 0):
        "59c19eabe56299fa212007843d8f699205d23e260c9eeb7fbb853d84174d2b90",
    ("loader_nodri_photo_b256", False, 0):
        "60d489c17918afdfd96e573a7e3ad6c9463250f74d0fe3f2f8727bbd0e7b5f25",
    ("loader_nodri_photo_b256", True, 1):
        "779a6b1655e21aa755d833371c0eda6827baabaee15f6d338482f781aa57165b",
    ("loader_nodri_photo_b256", False, 1):
        "60ad21191dae9cd39626f934140e06bd77dd2adf17671b7a2d156ea26aa58229",
    ("uhd_dri_photo", True, 0):
        "fc5068c575969876ed7d6a8934c6d587742095e9e08a6816262800524bc87628",
    ("uhd_dri_photo", True, 1):
        "4a3b1083361355cc6c8bcc65b96d6e9281e9a4fec423b9f502915057c51e332c",
    ("uhd_nodri_photo", True, 0):
        "3d9dfefaf299d5346e70c68f1cbd07d6d48923385a9676c9770259c30ad8a21e",
    ("uhd_nodri_photo", True, 1):
        "ea6412814015636464ddc0e082c91cae4a417cedbe3e3b82a3a68204bb6ea5c8",
}


@pytest.mark.parametrize("key", sorted(PINNED),
                         ids=lambda k: f"{k[0]}-{'rehearse' if k[1] else 'full'}-{k[2]}")
def test_existing_pools_unchanged(key):
    """A traffic file without the mixed keys gives the pool it gave before."""
    name, rehearse, seed = key
    pool = gen.make_pool(_traffic(name), seed, rehearse=rehearse)
    assert _digest(pool) == PINNED[key]
    assert all((im.width, im.height) == (pool.width, pool.height) for im in pool.images)


def _synthetic_trace():
    """Three calls of each layer's kernels in a 40 us window."""
    E = trace.Event
    dev = []
    for k in range(3):
        o = 10_000 * k
        dev += [E("pass1_kernel", 100 + o, 2_100 + o), E("pass2_kernel", 2_200 + o, 3_000 + o),
                E("idct_exact_kernel<1>", 3_100 + o, 4_900 + o),
                E("colour_run_kernel<true>", 5_000 + o, 5_700 + o)]
    return trace.Trace(E("perfbench.window", 0, 40_000), dev, [])


def _config(name: str) -> dict:
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


#: What the readers gave on these runs before they took mixed pools.
LOADER_BEFORE = {"mps": 0.0786432, "entropy": 7.821243781094527e-09,
                 "pixel": 1.4672238805970149e-08, "entropy_pct": 1.117320540156361,
                 "pixel_pct": 2.3475582089552236}
REQUEST_BEFORE = {"entropy": 7.919850746268656e-09, "pixel": 1.8340298507462686e-08,
                  "entropy_pct": 0.2828518123667378, "pixel_pct": 0.7336119402985075}


@pytest.mark.parametrize("cell", ["loader", "request"])
def test_readers_on_a_uniform_pool_unchanged(cell):
    """mps, the mean image's bound and the roofline shares read the same
    float on a uniform pool as before, where the loop sets images_per_call."""
    if cell == "loader":
        t = _traffic("loader_dri_photo_b256")
        config = _config("imagenet_loader_pallas")
        res = harness.LoopResult(attempted=12, images=12, elapsed_s=1.25, images_per_call=4,
                                 indices=[k % 6 for k in range(12)])
        want = LOADER_BEFORE
    else:
        t = _traffic("uhd_dri_photo")
        config = _config("uhd_still_device")
        res = harness.LoopResult(attempted=3, latencies_s=[0.01, 0.02, 0.03])
        want = REQUEST_BEFORE
    pool = gen.make_pool(t, 0, rehearse=True)
    run = harness.Run({"name": cell}, config, t, pool, res, 1.0, {}, {}, _synthetic_trace())
    if "mps" in want:
        assert readers.mps(run) == want["mps"]
    for layer in ("entropy", "pixel"):
        assert readers._per_image(run, layer) == want[layer]
        assert readers.roofline_pct(run, layer) == want[f"{layer}_pct"]


def test_readers_weigh_a_mixed_pool_image_by_image():
    """Where a call's launches follow its groups (images_per_call None), the
    roofline share is the summed bound of the images yielded, and the rate
    sums each image's own pixels; the entropy share reads nothing once the
    host's entropy decoder took images."""
    t = queued.mixed_traffic()
    pool = gen.make_pool(t, SEED, rehearse=True)
    assert pool.width is None and len({(im.width, im.height) for im in pool.images}) == 3
    idx = [0, 1, 2, 3, 4, 5, 0]
    res = harness.LoopResult(attempted=7, images=7, elapsed_s=0.5, images_per_call=None,
                             indices=idx)
    run = harness.Run({"name": "m"}, queued.mixed_config(), t, pool, res, 1.0, {}, {},
                      _synthetic_trace())
    assert readers.mps(run) == sum(pool.images[i].width * pool.images[i].height
                                   for i in idx) / 0.5 / 1e6
    tr = run.trace
    for layer in ("entropy", "pixel"):
        spent = tr.seconds(tr.kernels(layer))
        want = sum(readers._bound_s(run, pool.images[i], layer) for i in idx)
        assert readers.roofline_pct(run, layer) == pytest.approx(100 * want / spent, rel=1e-12)
    run.stages = {"entropy_batch_fallback": (1, 0.01, 3)}
    assert readers.roofline_pct(run, "entropy") is None
    assert readers.roofline_pct(run, "pixel") is not None


def test_jpeg_quality_scaling():
    """libjpeg's rule: quality 50 is Annex K itself, 100 all ones; 75 halves
    the tables (luma DC 16 -> 8)."""
    assert gen.jpeg_quality_scaling(50) == 100 and gen.jpeg_quality_scaling(10) == 500
    assert gen.jpeg_quality_scaling(75) == 50 and gen.jpeg_quality_scaling(100) == 0
    natural = gen.quality_tables(50)[:, reference.INV_ZIGZAG]
    np.testing.assert_array_equal(natural, gen.ANNEX_K_QT)
    assert natural[0, :8].tolist() == [16, 11, 10, 16, 24, 40, 51, 61]
    assert natural[1, :8].tolist() == [17, 18, 24, 47, 99, 99, 99, 99]
    assert (gen.quality_tables(100) == 1).all()
    assert gen.quality_tables(75)[0, 0] == 8
    assert gen.quality_tables(1).max() == 255
    # a second witness: the program's encoder writes the same tables
    from jpeg_decoder_tpu_torch.models.encoder import quality_qtables

    for q in range(1, 101):
        np.testing.assert_array_equal(np.stack(quality_qtables(q)).reshape(2, 64),
                                      gen.quality_tables(q)[:, reference.INV_ZIGZAG])


@pytest.mark.parametrize("rehearse", [True, False])
def test_mixed_pool_matches_its_draws(rehearse):
    """Each stream's SOF gives its image's drawn size and its DQT the tables
    of its drawn quality; the sizes follow their weights exactly, so every
    seed holds the same sizes."""
    t = queued.mixed_traffic()
    pool = gen.make_pool(t, SEED, rehearse=rehearse)
    tt = {**t, **(t["rehearse"] if rehearse else {})}
    quality = gen._qualities(tt, SEED)
    assert min(quality) >= 75 and max(quality) <= 95 and len(set(quality)) > 1
    sizes = [(im.width, im.height) for im in pool.images]
    assert sizes == gen._sizes(tt, SEED)
    weights = np.asarray(tt["size_weights"]) / sum(tt["size_weights"]) * tt["pool"]
    for (w, h), share in zip(tt["sizes"], weights):
        assert abs(sizes.count((w, h)) - share) < 1
    assert sorted(sizes) == sorted(gen._sizes(tt, SEED + 1)) and sizes != gen._sizes(tt, SEED + 1)
    for im, q in zip(pool.images, quality):
        info = reference.parse(im.data)
        assert (info["width"], info["height"]) == (im.width, im.height)
        np.testing.assert_array_equal(np.stack([info["qt"][0], info["qt"][1]]),
                                      gen.quality_tables(q))
        np.testing.assert_array_equal(im.qts, gen.quality_tables(q))
        assert im.blocks == sum(c.shape[0] * c.shape[1] for c in im.coeffs)
        assert im.blocks == 6 * -(-im.width // 16) * -(-im.height // 16)
        assert im.scan_bytes == len(im.data) - info["data_at"] - 2
    if rehearse:
        info, planes = reference.decode_coefficients(pool.images[0].data)
        for a, b in zip(planes, pool.images[0].coeffs):
            np.testing.assert_array_equal(a, b)


def _mixed_run(tmp_path, monkeypatch, control=False) -> dict:
    cell = queued.QUEUED[0]
    monkeypatch.setattr(harness, "CACHES", {})
    return harness.run(cell["name"], SEED, 0.1, False, 0.0, rehearse=True, control=control,
                       bench=queued.bench_for(queued.load_bench(), cell, tmp_path),
                       traffic=queued.mixed_traffic())


def test_mixed_decode_many_rehearsal_and_control(tmp_path, monkeypatch):
    """decode_many over three sizes in two orientations with per-image
    tables is bitwise the reference; its FLOAT32 control is not."""
    line = _mixed_run(tmp_path, monkeypatch)
    assert line["correct"] is True and line["failed"] == 0
    assert line["checks"]["compared"]["value"] >= 1
    control = _mixed_run(tmp_path, monkeypatch, control=True)
    assert control["correct"] is False
    assert control["checks"]["rgb_bytes_off"]["value"] > 0
