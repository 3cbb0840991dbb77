"""The port's mesh paths in real process groups: 2 and 4 OS processes join
one torch.distributed group (gloo, a file store in the test's directory),
build ("data", "stripe") meshes over their ranks and run BatchDecoder(mesh)
and decode_striped(mesh) on device="cpu" (the kernels' plain versions).
The counterparts of tests/test_multihost.py:

  * test_multiprocess_global_mesh[2/4-...] -- data parallelism over
    distinct images, a batch of 5 or 7 (not a multiple of the data axis):
    decode_batch, decode_stream and decode_many, NATIVE and PALLAS;
  * test_stripe_mesh[2/4-...] -- decode_striped over a stripe axis of 2
    (data=1 on 2 processes; data=2, stripe=2 on 4: the DP x SP shape),
    nearest-neighbour and fancy, EXACT and FLOAT32, NATIVE (each rank
    decodes its stripe's restart segments) and PALLAS (the whole image,
    sliced), with the halo rows exchanged between the ranks;
  * test_four_process_dp_sp_mesh and test_two_process_dryrun --
    dryrun_multichip(4) on (data=2, stripe=2) and dryrun_multichip(2);
  * make_mesh past the group's ranks raising the JAX ValueError, and
    process_info's four keys.

The children never import JAX (each checks jax_free() before it exits):
they write .npy files, and this process holds every rank's result
bitwise against the port's one-process call and against the JAX package
on the same bytes: jpeg_decoder_tpu.parallel.batch.decode_batch over a
JAX mesh of as many data devices, and stripes.decode_striped over
make_mesh(n_data=1, n_stripe=2, devices=jax.devices()[:2]) (EXACT
bitwise; FLOAT32 within 1, as in tests/test_torch_stripes.py). Every child
has a hard deadline, and the first to fail ends the others. Only a torch
without gloo skips.
"""

import functools
import json
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import jpeg_decoder_tpu as jt
from jpeg_decoder_tpu.parallel import batch as jbatch
from jpeg_decoder_tpu.parallel import mesh as jmesh
from jpeg_decoder_tpu.parallel import stripes as jstripes
import jpeg_decoder_tpu_torch as jtt
from jpeg_decoder_tpu_torch import DecodeConfig, EntropyBackend, IdctPrecision, Quirks
from jpeg_decoder_tpu_torch.benchmarks.inputs import make_jpeg
from jpeg_decoder_tpu_torch.native import build as native_build
from jpeg_decoder_tpu_torch.parallel import stripes as tstripes

from .test_torch_mesh import jax_fdct_of

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
F420 = ((2, 2), (1, 1), (1, 1))
DEADLINE_S = 240.0
BACKENDS = ("native", "pallas")

#: name -> bytes; the children read the same files.
INPUTS = {
    **{f"batch{i}": make_jpeg(64, 48, F420, 4, 300 + i) for i in range(7)},
    "other444": make_jpeg(40, 40, ((1, 1),) * 3, 5, 310),
    "gray": make_jpeg(30, 20, ((1, 1),), 0, 311),
    "tall": make_jpeg(48, 200, F420, 3, 312),   # 13 MCU rows: padded stripes
    "dense": make_jpeg(64, 96, F420, 0, 313),   # no restart markers
}
#: The striped cases: name -> (input, config).
FANCY = DecodeConfig(upsample="fancy", quirks=Quirks.CORRECT)
STRIPED = {
    "nn_exact": ("tall", DecodeConfig()),
    "fancy_exact": ("tall", FANCY),
    "fancy_float32": ("tall", FANCY.replace(idct_precision=IdctPrecision.FLOAT32)),
    "fancy_pallas": ("tall", FANCY.replace(entropy_backend=EntropyBackend.PALLAS)),
    "fancy_exact_no_restarts": ("dense", DecodeConfig(upsample="fancy")),
}


def _batch(nproc):
    """One fewer than two images a data rank: not a multiple of it."""
    return [f"batch{i}" for i in range(2 * nproc - 1)]


def _mixed(nproc):
    return ["batch0", "other444", *_batch(nproc)[1:3], "gray", "batch3"]


CHILD = textwrap.dedent('''
    import json, sys
    from pathlib import Path

    import numpy as np
    import torch

    out, rank, world = Path(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    from jpeg_decoder_tpu_torch.parallel import mesh as mesh_mod, multihost
    multihost.initialize(f"file://{out / 'store'}", num_processes=world, process_id=rank,
                         backend="gloo")
    multihost.initialize(f"file://{out / 'store'}", num_processes=world, process_id=rank)
    import jpeg_decoder_tpu_torch as jtt
    from jpeg_decoder_tpu_torch import DecodeConfig, EntropyBackend, IdctPrecision, Quirks
    from jpeg_decoder_tpu_torch.entry import dryrun_multichip
    from jpeg_decoder_tpu_torch.parallel import stripes
    from jpeg_decoder_tpu_torch.utils import jax_free

    CPU = torch.device("cpu")
    inputs = {p.stem: p.read_bytes() for p in (out / "inputs").glob("*.jpg")}
    spec = json.loads((out / "spec.json").read_text())

    def save(name, arr):
        np.save(out / f"{name}.r{rank}.npy", np.asarray(arr))

    def cfg_of(d):
        return DecodeConfig(quirks=Quirks[d["quirks"]],
                            idct_precision=IdctPrecision[d["precision"]],
                            entropy_backend=EntropyBackend[d["backend"]],
                            upsample=d["upsample"])

    info = {"process_info": multihost.process_info(),
            "distributed": multihost.is_distributed()}
    try:
        mesh_mod.make_mesh(world, 2)
    except ValueError as e:
        info["too_small"] = str(e)
    (out / f"info.r{rank}.json").write_text(json.dumps(info))

    m = mesh_mod.make_mesh(n_data=world)
    batch = [inputs[n] for n in spec["batch"]]
    mixed = [inputs[n] for n in spec["mixed"]]
    for b in ("NATIVE", "PALLAS"):
        bd = jtt.BatchDecoder(DecodeConfig(entropy_backend=EntropyBackend[b]), CPU, m)
        save(f"batch_{b}", bd.decode_batch(batch))
        stream = list(bd.decode_stream(batch))
        assert [len(s) for s in stream] == spec["stream_sizes"], [len(s) for s in stream]
        save(f"stream_{b}", np.concatenate(stream))
        for i, rgb in enumerate(bd.decode_many(mixed)):
            save(f"many_{b}_{i}", rgb)

    sm = mesh_mod.make_mesh(n_data=world // 2, n_stripe=2)
    for name, (src, d) in spec["striped"].items():
        save(f"striped_{name}", stripes.decode_striped(inputs[src], cfg_of(d), device=CPU,
                                                       mesh=sm))
    mixed_slices = [inputs["batch0"]] * world + [inputs["other444"]] * world
    try:
        jtt.BatchDecoder(DecodeConfig(), CPU, m).decode_batch(mixed_slices)
    except jtt.JpegError as e:
        info["mixed_slices"] = type(e).__name__
    (out / f"info.r{rank}.json").write_text(json.dumps(info))
    rgb, coeffs = dryrun_multichip(world, "cpu")
    save("dryrun_rgb", rgb)
    save("dryrun_coeffs", coeffs)
    assert jax_free()
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    print("OK process", rank)
''')


def _spec(nproc):
    return {
        "batch": _batch(nproc),
        "mixed": _mixed(nproc),
        "stream_sizes": [2 * nproc - 1],  # the default batch: two images a data rank
        "striped": {name: (src, {"quirks": c.quirks.name, "precision": c.idct_precision.name,
                                 "backend": c.entropy_backend.name, "upsample": c.upsample})
                    for name, (src, c) in STRIPED.items()},
    }


def _run_ranks(out: Path, nproc: int) -> None:
    """CHILD in nproc processes of one gloo group; every rank must exit 0
    within DEADLINE_S, and the first failure ends the others."""
    (out / "inputs").mkdir(parents=True)
    for name, data in INPUTS.items():
        (out / "inputs" / f"{name}.jpg").write_bytes(data)
    (out / "spec.json").write_text(json.dumps(_spec(nproc)))
    script = out / "child.py"
    script.write_text(CHILD)
    # the children load the host runtime the parent built, never build it
    # side by side
    native_build.build()
    env = {"PATH": "/usr/bin:/bin:/usr/local/bin", "PYTHONPATH": str(REPO), "HOME": str(out),
           "JAX_PLATFORMS": "cpu"}
    logs = [out / f"rank{r}.log" for r in range(nproc)]
    procs = []
    for r in range(nproc):
        with open(logs[r], "w") as f:
            procs.append(subprocess.Popen([sys.executable, str(script), str(out), str(r),
                                           str(nproc)], cwd=REPO, env=env, stdout=f,
                                          stderr=subprocess.STDOUT))
    deadline = time.monotonic() + DEADLINE_S
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break
            assert time.monotonic() < deadline, "a rank passed its deadline"
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{logs[r].read_text()[-4000:]}"
        assert "OK process" in logs[r].read_text()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """nproc -> the directory of a finished run of nproc ranks (each run
    once a module)."""
    if not torch.distributed.is_available() or not torch.distributed.is_gloo_available():
        pytest.skip("this torch has no gloo backend")
    done = {}

    def get(nproc):
        if nproc not in done:
            out = tmp_path_factory.mktemp(f"ranks{nproc}")
            _run_ranks(out, nproc)
            done[nproc] = out
        return done[nproc]

    return get


def _each_rank(out: Path, nproc: int, name: str):
    return [np.load(out / f"{name}.r{r}.npy") for r in range(nproc)]


def _jax_cfg(cfg: DecodeConfig):
    return jt.DecodeConfig(quirks=jt.Quirks[cfg.quirks.name],
                           idct_precision=jt.IdctPrecision[cfg.idct_precision.name],
                           entropy_backend=jt.EntropyBackend.NATIVE, upsample=cfg.upsample)


@functools.lru_cache(maxsize=None)
def _jax_mesh(n_data, n_stripe):
    return jmesh.make_mesh(n_data=n_data, n_stripe=n_stripe,
                           devices=jax.devices()[:n_data * n_stripe])


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("nproc", [2, 4])
def test_multiprocess_global_mesh(ranks, nproc, backend):
    """Data parallelism over distinct images: every rank's decode_batch and
    decode_stream bitwise the one-process decode_batch and the JAX
    decode_batch over a JAX mesh of nproc data devices."""
    out = ranks(nproc)
    datas = [INPUTS[n] for n in _batch(nproc)]
    cfg = DecodeConfig(entropy_backend=EntropyBackend[backend.upper()])
    want = jtt.BatchDecoder(cfg, CPU).decode_batch(datas)
    np.testing.assert_array_equal(want, jbatch.decode_batch(datas, _jax_cfg(cfg),
                                                            _jax_mesh(nproc, 1)))
    for name in (f"batch_{backend.upper()}", f"stream_{backend.upper()}"):
        for got in _each_rank(out, nproc, name):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("nproc", [2, 4])
def test_multiprocess_decode_many(ranks, nproc, backend):
    """decode_many of mixed geometries over the data axis, every rank bitwise
    the one-process decode_many."""
    out = ranks(nproc)
    cfg = DecodeConfig(entropy_backend=EntropyBackend[backend.upper()])
    want = jtt.BatchDecoder(cfg, CPU).decode_many([INPUTS[n] for n in _mixed(nproc)])
    for i, w in enumerate(want):
        for got in _each_rank(out, nproc, f"many_{backend.upper()}_{i}"):
            np.testing.assert_array_equal(got, w)


@pytest.mark.parametrize("name", sorted(STRIPED))
@pytest.mark.parametrize("nproc", [2, 4])
def test_stripe_mesh(ranks, nproc, name):
    """decode_striped over a stripe axis of 2 ranks (data=1 on 2 processes,
    data=2 x stripe=2 on 4), the halo rows exchanged between the ranks:
    every rank bitwise the one-process decode_striped(n_stripes=2), and the
    JAX decode_striped over its (1, 2) mesh (FLOAT32 within 1)."""
    out = ranks(nproc)
    src, cfg = STRIPED[name]
    want = tstripes.decode_striped(INPUTS[src], cfg, n_stripes=2, device=CPU)
    jax_rgb = jstripes.decode_striped(INPUTS[src], _jax_cfg(cfg), _jax_mesh(1, 2))
    if cfg.idct_precision == IdctPrecision.EXACT:
        np.testing.assert_array_equal(want, jax_rgb)
    else:
        assert np.abs(want.astype(np.int32) - jax_rgb.astype(np.int32)).max() <= 1
    for got in _each_rank(out, nproc, f"striped_{name}"):
        np.testing.assert_array_equal(got, want)


def _dryrun_checks(out, nproc):
    """Every rank's dryrun_multichip(nproc): the JAX shapes; RGB bitwise the
    one-process whole-frame decode of the tiny image and within 1 of the JAX
    dry run's step on the CPU mesh; the coefficients bitwise the JAX
    re-encode leg over the same pixels."""
    from jpeg_decoder_tpu_torch.entry import _tiny_coeffs

    from .test_torch_mesh import _jax_dryrun

    n_stripe = 2 if nproc % 2 == 0 else 1
    frame, planes, qts, cfg = _tiny_coeffs(h=16 * n_stripe, w=32)
    whole = tstripes.StripeStage(tstripes._stage_for(frame, qts, cfg.replace(upsample="fancy")),
                                 n_stripe, CPU)(*[torch.from_numpy(p) for p in planes.planes])
    jax_rgb = _jax_dryrun(nproc)
    for rgb, coeffs in zip(_each_rank(out, nproc, "dryrun_rgb"),
                           _each_rank(out, nproc, "dryrun_coeffs")):
        assert rgb.shape == (2 * nproc // n_stripe, 16 * n_stripe, 32, 3) == jax_rgb.shape
        assert coeffs.shape == (rgb.shape[0], 2 * n_stripe * 4, 64) and coeffs.dtype == np.int32
        for img in rgb:
            np.testing.assert_array_equal(img, whole.numpy())
        assert np.abs(rgb.astype(np.int32) - jax_rgb.astype(np.int32)).max() <= 1
        np.testing.assert_array_equal(coeffs, jax_fdct_of(rgb))


def test_four_process_dp_sp_mesh(ranks):
    """dryrun_multichip(4): (data=2, stripe=2), the fancy stripes' halo rows
    exchanged, then the re-encode leg."""
    _dryrun_checks(ranks(4), 4)


def test_two_process_dryrun(ranks):
    _dryrun_checks(ranks(2), 2)


@pytest.mark.parametrize("nproc", [2, 4])
def test_process_info_and_a_mesh_too_large(ranks, nproc):
    """process_info's four keys, counted in the group (one device a rank);
    make_mesh(nproc, 2) raises the JAX ValueError; a second initialize is
    ignored."""
    out = ranks(nproc)
    for r in range(nproc):
        info = json.loads((out / f"info.r{r}.json").read_text())
        assert info["process_info"] == {"process_index": r, "process_count": nproc,
                                        "local_devices": 1, "global_devices": nproc}
        assert info["distributed"] is True
        assert info["too_small"] == f"mesh {nproc}x2 needs {2 * nproc} devices, have {nproc}"
        assert "called twice" in (out / f"rank{r}.log").read_text()


@pytest.mark.parametrize("nproc", [2, 4])
def test_slices_of_two_geometries_raise_on_every_rank(ranks, nproc):
    """A batch whose data slices decode to two geometries raises
    JpegFormatError on every rank (each slice alone is uniform): the
    status rows exchanged before the gather, not a rank left waiting."""
    out = ranks(nproc)
    for r in range(nproc):
        assert json.loads((out / f"info.r{r}.json").read_text())["mixed_slices"] == \
            "JpegFormatError"


def _run_to_the_end(cmd, cwd, tmp_path):
    env = {"PATH": "/usr/bin:/bin:/usr/local/bin", "PYTHONPATH": str(REPO),
           "HOME": str(tmp_path)}
    r = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True, text=True,
                       timeout=DEADLINE_S)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    return r.stdout


def test_torchrun_dryrun(ranks, tmp_path):
    """`torchrun --standalone --nproc-per-node 2 -m jpeg_decoder_tpu_torch.entry
    --dryrun 2 --device cpu`: multihost.initialize() from torchrun's
    environment, then dryrun_multichip(2) on both ranks."""
    native_build.build()
    out = _run_to_the_end([sys.executable, "-m", "torch.distributed.run", "--standalone",
                           "--nproc-per-node", "2", "-m", "jpeg_decoder_tpu_torch.entry",
                           "--dryrun", "2", "--device", "cpu"], REPO, tmp_path)
    assert out.count("dryrun_multichip(2) ok: rgb (2, 32, 32, 3), coefficients (2, 16, 64)") == 2


def test_card_phase_ranks_on_the_cpu(ranks, tmp_path):
    """benchmarks/mesh_ranks.py, the ranks of chip_smoke.py's mesh phase, in
    two gloo processes on the CPU with small inputs: every case bitwise the
    call without a mesh (the gigapixel case compared on rank 0), the two
    ranks' results equal, the launch counts empty (no kernel on the CPU)."""
    native_build.build()
    for i in range(8):
        (tmp_path / f"batch{i}.jpg").write_bytes(make_jpeg(64, 48, F420, 4, 320 + i))
    (tmp_path / "gigapixel.jpg").write_bytes(make_jpeg(96, 200, F420, 6, 330))
    env = {"PATH": "/usr/bin:/bin:/usr/local/bin", "PYTHONPATH": str(REPO),
           "HOME": str(tmp_path)}
    procs = [subprocess.Popen([sys.executable, "-m", "jpeg_decoder_tpu_torch.benchmarks.mesh_ranks",
                               str(tmp_path), "--rank", str(r), "--world", "2", "--backend",
                               "gloo", "--device", "cpu"], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        logs = [p.communicate(timeout=DEADLINE_S)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    assert [p.returncode for p in procs] == [0, 0], logs
    recs = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(2)]
    cases = [k for k, v in recs[0].items() if isinstance(v, dict) and "bitwise" in v]
    assert len(cases) == 9
    for case in cases:
        assert recs[0][case]["sha256"] == recs[1][case]["sha256"], case
        assert recs[0][case]["bitwise"] is True, case
        assert recs[1][case]["bitwise"] in (True, None) and recs[0][case]["launches"] == {}
    assert recs[0]["decode_striped mesh fancy exact"]["halo_calls"] == 1
