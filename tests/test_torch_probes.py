"""The dependent-step probes of the port (jpeg_decoder_tpu_torch/ops/probes.py,
kernels PK1-PK7) against the Pallas kernels of benchmarks/pallas_gather_probe.py
and its rounds 2 to 4, on the CPU.

Each of the 21 variants: the port's maker reproduces the script's inputs
(held bitwise against the arrays the script itself builds), and the port's
plain PyTorch version gives bitwise the result of the script's `build_*`
function run in Pallas interpret mode (`jax.experimental.pallas.pallas_call`
wrapped to pass interpret=True; no file of the scripts changes). Tolerance
0: everything is integer arithmetic.

E5 adds into an output it never initialises; interpret mode fills an int32
output with -2^31 first, and the port defines the start as zero, so that
fill is subtracted (wrapping int32) from the JAX result.
"""

import functools
import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from jpeg_decoder_tpu_torch.benchmarks import gather_probe
from jpeg_decoder_tpu_torch.ops import probes

BENCHMARKS = Path(__file__).resolve().parent.parent / "benchmarks"
SCRIPTS = {1: "pallas_gather_probe.py", 2: "pallas_gather_probe2.py",
           3: "pallas_gather_probe3.py", 4: "pallas_gather_probe4.py"}
#: chain length per variant: H5 counts copies, 128 to a wave (two waves)
STEPS = {"H5": 256, "G2": 16, "G3": 8}
DEFAULT_STEPS = 48
#: what Pallas interpret mode fills an uninitialised int32 output with
INTERPRET_FILL = np.int32(-2**31)


@functools.lru_cache(maxsize=None)
def _script(round_):
    path = BENCHMARKS / SCRIPTS[round_]
    spec = importlib.util.spec_from_file_location(f"_probe_script_{round_}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def interpret(monkeypatch):
    """The scripts' pl.pallas_call, in interpret mode."""
    orig = pl.pallas_call
    monkeypatch.setattr(
        pl, "pallas_call", lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))


def _jax_result(variant, steps):
    """(the script's input arrays, its function's output) as numpy."""
    mod = _script(variant.round)
    build = getattr(mod, f"build_{variant.key.lower()}")
    if variant.round == 1:
        mod.STEPS = steps  # the round-1 kernels read the module's constant
        fn, args = build()
    else:
        fn, args = build(steps)
    return [np.asarray(a) for a in args], np.asarray(jax.device_get(fn(*args)))


def _bits(a: np.ndarray) -> np.ndarray:
    """uint32 arrays as the int32 bits the port carries them in."""
    a = np.ascontiguousarray(a)
    return a.view(np.int32) if a.dtype == np.uint32 else a


@pytest.mark.parametrize("key", [v.key for v in probes.VARIANTS])
def test_plain_matches_pallas_interpret(key, interpret):
    variant = probes.BY_KEY[key]
    steps = STEPS.get(key, DEFAULT_STEPS)
    jax_args, want = _jax_result(variant, steps)
    inputs = variant.inputs()
    # the makers reproduce the script's arrays (P5 and H4 also take a state
    # array that their kernels never read: the port has no such input)
    used = jax_args[:len(inputs)]
    assert len(used) == len(inputs)
    for mine, theirs in zip(inputs.values(), used):
        np.testing.assert_array_equal(mine.reshape(theirs.shape), _bits(theirs))
    got = variant.run(probes.tensors_for(variant, "cpu"), steps).numpy()
    if key == "E5":
        want = want - INTERPRET_FILL  # wrapping int32
    assert got.shape == want.shape and got.dtype == np.int32
    np.testing.assert_array_equal(got, _bits(want))
    assert got.any()  # not a chain that collapsed to zeros


def _symbol_step_numpy(thr, sym, bitbuf, bitcnt, acc, steps):
    """benchmarks/pallas_gather_probe4.py build_h4's body, lane by lane in
    Python integers (uint32 bitbuf; two's-complement int32 at the end)."""
    bitbuf, bitcnt, acc = (np.array(a, dtype=np.int64) for a in (bitbuf, bitcnt, acc))
    for _ in range(steps):
        code16 = bitbuf >> 16
        ln = np.minimum(1 + (code16[..., None] > thr.reshape(16)).sum(-1), 16)
        off = (code16 >> (16 - ln)) & 0x3FF
        lo, hi = off & 127, (off >> 7) & 7
        s = np.empty_like(off)
        for r in range(8):
            for c in range(128):
                h = hi[r, c]
                s[r, c] = sym[h, lo[h, c]]  # lane (r, c) reads lane (h, c)'s lo
        size = s & 0xF
        ext = (bitbuf >> (32 - ln - size)) & ((1 << size) - 1)
        half = np.where(size > 0, 1 << np.maximum(size - 1, 0), 0)
        val = np.where(ext < half, ext - 2 * half + 1, ext)
        bitbuf = (bitbuf << (ln + size)) & 0xFFFFFFFF
        bitcnt = bitcnt - (ln + size)
        need = bitcnt < 16
        bitbuf = bitbuf | np.where(need, 0x5A5A, 0)
        bitcnt = np.where(need, bitcnt + 16, bitcnt)
        acc = acc ^ val
    out = (acc + bitcnt + bitbuf) & 0xFFFFFFFF
    return out.astype(np.uint32).view(np.int32)


def test_symbol_step_from_a_random_state_matches_numpy():
    """With the script's constant state every lane stays equal, which would
    hide a wrong exchange between the lanes of a column; a random state does
    not."""
    variant = probes.BY_KEY["H4"]
    inputs = variant.inputs()
    rng = np.random.default_rng(4)
    bitbuf = rng.integers(0, 2**32, (8, 128), dtype=np.uint32)
    bitcnt = rng.integers(16, 33, (8, 128), dtype=np.int32)
    acc = rng.integers(-2**31, 2**31, (8, 128), dtype=np.int64).astype(np.int32)
    state = tuple(torch.from_numpy(a) for a in (bitbuf.view(np.int32), bitcnt, acc))
    got = variant.run(probes.tensors_for(variant, "cpu"), 40, state=state).numpy()
    want = _symbol_step_numpy(inputs["thr"], inputs["sym"], bitbuf, bitcnt, acc, 40)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) > 512  # the lanes went their own ways


def test_default_symbol_state_is_the_scripts():
    variant = probes.BY_KEY["H4"]
    t = probes.tensors_for(variant, "cpu")
    assert torch.equal(variant.run(t, 24),
                       variant.run(t, 24, state=probes.symbol_state("cpu")))
    bitbuf, bitcnt, acc = probes.symbol_state("cpu")
    assert int(bitbuf[0, 0]) & 0xFFFFFFFF == 0x9E3779B9
    assert int(bitcnt[3, 5]) == 32 and int(acc[7, 127]) == 0


def test_dma_waves_at_least_one():
    assert [probes.dma_waves(s) for s in (1, 127, 128, 255, 256, 32768)] == \
        [1, 1, 1, 1, 2, 256]
    variant = probes.BY_KEY["H5"]
    t = probes.tensors_for(variant, "cpu")
    assert torch.equal(variant.run(t, 8), variant.run(t, 128))
    assert not torch.equal(variant.run(t, 128), variant.run(t, 256))


@pytest.mark.parametrize(
    "call",
    [lambda t: probes.gather_chain(t["tab"], t["idx0"] + 4096, 4, 1),
     lambda t: probes.gather_chain(t["tab"], t["idx0"][:4], 4, 0),
     lambda t: probes.gather_chain(t["tab"], t["idx0"], 4, 1, mod=5000),
     lambda t: probes.gather_chain(t["tab"].to(torch.int64), t["idx0"], 4, 1),
     lambda t: probes.gather_chain(t["tab"], t["idx0"], 4, 1, placement="registers")],
    ids=["start_out_of_range", "shape", "mod", "dtype", "placement"])
def test_gather_chain_rejects_what_the_kernel_cannot_take(call):
    t = probes.tensors_for(probes.BY_KEY["P1"], "cpu")
    with pytest.raises(ValueError):
        call(t)


def test_vshift_chain_takes_the_scripts_two_op_counts_only():
    t = probes.tensors_for(probes.BY_KEY["G4a"], "cpu")
    with pytest.raises(ValueError, match="n_ops"):
        probes.vshift_chain(t["x"], t["sh"], 4, 3)


def test_placement_of_every_variant():
    both = [v.key for v in probes.VARIANTS
            if probes.placement_of(v, probes.tensors_for(v, "cpu")) == "table in shared memory"]
    assert both == ["E1", "E3", "P1", "G1", "H1", "H2", "H3"]
    in_global = [v.key for v in probes.VARIANTS
                 if probes.placement_of(v, probes.tensors_for(v, "cpu")) == "table in global memory"]
    assert in_global == ["E2", "E4", "P2", "P3", "G2", "G3"]


def test_placement_picks_shared_memory_when_the_table_fits():
    assert probes._placement("x", None, 128 * 1024) is True       # P1: 128 KB
    assert probes._placement("x", None, 512 * 128 * 4) is False   # G2: 256 KB
    assert probes._placement("x", "global", 4096) is False
    with pytest.raises(ValueError):
        probes._placement("x", "shared", 8 << 20)                 # P3: 8 MB


def test_gather_probe_main_prints_21_lines_on_the_cpu(capsys):
    records = gather_probe.main(
        ["--device", "cpu", "--round", "all", "--steps", "2", "6", "--reps", "1"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 21 and len(records) == 21
    labels = [v.label for v in probes.VARIANTS]
    assert labels[0] == "E1 take shared 4096" and labels[-1] == "H5 per-lane DMA"
    for line, label in zip(lines, labels):
        assert line.startswith(f"[{label}] ") and " ns/step" in line
        assert "cpu" in line and "not a device time" in line and "FAILED" not in line


def test_gather_probe_rounds_and_chain_lengths(capsys):
    assert gather_probe.ROUND_STEPS == {1: (256, 4096), 2: (256, 4096),
                                        3: (256, 4096), 4: (4096, 32768)}
    assert gather_probe.ROUND_REPS == {1: 7, 2: 7, 3: 7, 4: 5}
    recs = gather_probe.main(["--device", "cpu", "--round", "3", "--steps", "1", "3",
                              "--reps", "1"])
    assert [r["key"] for r in recs] == ["G1", "G2", "G3", "G4a", "G4b"]
    assert all(r["steps"] == (1, 3) for r in recs)
    capsys.readouterr()


def test_gather_probe_asks_for_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError):
        gather_probe.main(["--round", "1"])
    with pytest.raises(RuntimeError):
        gather_probe.main(["--device", "cuda", "--round", "4"])
