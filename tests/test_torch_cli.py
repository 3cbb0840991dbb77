"""The port's CLI (python -m jpeg_decoder_tpu_torch.cli) against the JAX
package's (python -m jpeg_decoder_tpu.cli) on the CPU: the cases of
tests/test_cli.py, each run through both `main`s on the same input file,
the port's with `--device cpu`, and every output file (PPM, PNG, NPY, JPEG)
byte-equal to the JAX CLI's; `info` prints the same text and JSON. The
JAX --striped cuts the image over every JAX device, 8 under
tests/conftest.py, so the port's runs pass --stripes 8. Also the two
reference defects the port keeps (ROADMAP.md §3), a run of
`python -m jpeg_decoder_tpu_torch.cli` in a process that refuses to import
jax and jpeg_decoder_tpu, and the port's entry() on the CPU.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from jpeg_decoder_tpu import cli as jcli
from jpeg_decoder_tpu.utils import errors as jerrors
from jpeg_decoder_tpu_torch import cli
from jpeg_decoder_tpu_torch.utils import errors

from . import corpus
from .torch_crossing import assert_same_error_class

REPO = Path(__file__).resolve().parent.parent
CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def sample_jpeg(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    p = d / "in.jpg"
    p.write_bytes(corpus.baseline_corpus()[5][1])  # rgb420_q90, 64x64
    return p


def _both(tmp_path, args, out_name=None, port_extra=()):
    """Run `args` through the JAX CLI and the port's (with --device cpu and
    `port_extra`), each writing `out_name` in a directory of its own when
    given: (port rc, JAX rc, port file, JAX file)."""
    files = []
    rcs = []
    for who, main, extra in (("port", cli.main, [*CPU, *port_extra]), ("jax", jcli.main, [])):
        d = tmp_path / who
        d.mkdir(exist_ok=True)
        argv = [a.replace("{out}", str(d / out_name)) if out_name else a for a in args]
        rcs.append(main([*argv, *extra]))
        files.append(d / out_name if out_name else None)
    return rcs[0], rcs[1], files[0], files[1]


def _same_file(a: Path, b: Path) -> None:
    assert a.read_bytes() == b.read_bytes(), (a, b)


@pytest.mark.parametrize("backend", ["numpy", "native", "pallas"])
def test_decode_to_ppm(sample_jpeg, tmp_path, backend):
    mine, theirs, a, b = _both(tmp_path, ["decode", str(sample_jpeg), "{out}", "--backend",
                                          backend], "out.ppm")
    assert mine == theirs == 0
    raw = a.read_bytes()
    assert raw.startswith(b"P6\n64 64\n255\n")
    assert len(raw) == len(b"P6\n64 64\n255\n") + 64 * 64 * 3
    _same_file(a, b)


def test_decode_to_png_matches_library(sample_jpeg, tmp_path):
    from PIL import Image

    import jpeg_decoder_tpu_torch as jtt

    mine, theirs, a, b = _both(tmp_path, ["decode", str(sample_jpeg), "{out}", "--backend",
                                          "numpy"], "out.png")
    assert mine == theirs == 0
    _same_file(a, b)
    want = jtt.decode(sample_jpeg.read_bytes(),
                      jtt.DecodeConfig(entropy_backend=jtt.EntropyBackend.NUMPY),
                      device="cpu").rgb
    np.testing.assert_array_equal(np.asarray(Image.open(a)), want)


def test_encode_roundtrip(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (40, 56, 3), dtype=np.uint8)
    src = tmp_path / "in.png"
    Image.fromarray(img, "RGB").save(src)
    mine, theirs, a, b = _both(tmp_path, ["encode", str(src), "{out}", "--quality", "90",
                                          "--subsampling", "444", "--optimize"], "out.jpg")
    assert mine == theirs == 0
    _same_file(a, b)
    assert np.asarray(Image.open(a).convert("RGB")).shape == (40, 56, 3)


@pytest.mark.parametrize("as_json", [True, False], ids=["json", "text"])
def test_info(sample_jpeg, capsys, as_json):
    flag = ["--json"] if as_json else []
    assert cli.main(["info", str(sample_jpeg), *flag]) == 0
    mine = capsys.readouterr().out
    assert jcli.main(["info", str(sample_jpeg), *flag]) == 0
    assert mine == capsys.readouterr().out
    if as_json:
        info = json.loads(mine)
        assert info["width"] == 64 and info["height"] == 64
        assert info["components"][0]["sampling"] == [2, 2]
        assert info["scans"][0]["tables"]["quant"] == [0, 1]
    else:
        assert "BASELINE" in mine and "64x64" in mine


_REFUSING = """
import runpy, sys

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "jpeg_decoder_tpu"):
            raise ImportError("refused: " + name)
        return None

sys.meta_path.insert(0, Refuse())
sys.argv = ["jpeg_decoder_tpu_torch.cli", *sys.argv[1:]]
runpy.run_module("jpeg_decoder_tpu_torch.cli", run_name="__main__", alter_sys=True)
"""


def test_cli_module_invocation_needs_neither_jax_nor_the_jax_package(sample_jpeg, tmp_path):
    """`python -m jpeg_decoder_tpu_torch.cli`, run as a module in a process
    that refuses to import jax and jpeg_decoder_tpu, writes the JAX CLI's
    bytes."""
    out = tmp_path / "m.ppm"
    r = subprocess.run(
        [sys.executable, "-c", _REFUSING, "decode", str(sample_jpeg), str(out), "--backend",
         "numpy", "--no-device", "--device", "cpu"],
        capture_output=True, text=True, cwd=REPO, timeout=600)
    assert r.returncode == 0, r.stderr
    want = tmp_path / "j.ppm"
    assert jcli.main(["decode", str(sample_jpeg), str(want), "--backend", "numpy",
                      "--no-device"]) == 0
    _same_file(out, want)


def test_decode_file_missing_path_is_typed(tmp_path):
    """A missing path raises the port's JpegFormatError through the CLI, as
    the JAX package's through its own."""
    with pytest.raises(errors.JpegFormatError):
        cli.main(["decode", str(tmp_path / "nope.jpg"), str(tmp_path / "x.npy"), *CPU])
    with pytest.raises(jerrors.JpegFormatError):
        jcli.main(["decode", str(tmp_path / "nope.jpg"), str(tmp_path / "x.npy")])


@pytest.mark.parametrize("precision", ["exact", "float32"])
@pytest.mark.parametrize("upsample", ["nn", "fancy"])
def test_decode_streamed_and_striped_match_plain(sample_jpeg, tmp_path, upsample, precision):
    """--streamed and --striped (the port's with --stripes 8) route through
    the gigapixel engines: the JAX CLI's files byte for byte, and under
    EXACT NN the plain decode's pixels. Under fancy upsampling --streamed
    falls back to striped decode in both packages: the JAX one over its
    8-device mesh, which at this padded height differs from the whole-image
    decode in the last row (ROADMAP.md §3, stripes divergence 1), the
    port's over the CUDA devices, one stripe on the CPU, which is the
    whole-image decode. There the two files agree above the last row, and
    each is its own package's plain or striped decode."""
    opts = ["--upsample", upsample, "--precision", precision]
    runs = {"plain": [], "streamed": ["--streamed", "--chunks", "2"], "striped": ["--striped"]}
    files = {}
    for name, flags in runs.items():
        mine, theirs, a, b = _both(tmp_path, ["decode", str(sample_jpeg), "{out}", *opts,
                                              *flags], f"{name}.npy",
                                   ["--stripes", "8"] if name == "striped" else [])
        assert mine == theirs == 0
        files[name] = (a, b)
        if not (upsample == "fancy" and name == "streamed"):
            _same_file(a, b)
    if upsample == "fancy":
        (mine, theirs), plain, striped = files["streamed"], files["plain"][0], files["striped"][1]
        _same_file(mine, plain)
        _same_file(theirs, striped)
        np.testing.assert_array_equal(np.load(mine)[:63], np.load(theirs)[:63])
    elif precision == "exact":
        for name in ("streamed", "striped"):
            np.testing.assert_array_equal(np.load(files[name][0]), np.load(files["plain"][0]))


@pytest.mark.parametrize("sub", ["411", "440", "mixed", "420", "gray"])
def test_encode_exotic_subsampling_flags(sub, tmp_path):
    """Every sampling flag gives the JAX CLI's JPEG bytes; the result
    decodes back through the port's CLI to the JAX CLI's pixels."""
    rng = np.random.default_rng(3)
    src = tmp_path / "in.npy"
    np.save(src, rng.integers(0, 256, (40, 48, 3), dtype=np.uint8))
    mine, theirs, a, b = _both(tmp_path, ["encode", str(src), "{out}", "--subsampling", sub,
                                          "--quality", "90"], "out.jpg")
    assert mine == theirs == 0 and a.stat().st_size > 0
    _same_file(a, b)
    mine, theirs, c, d = _both(tmp_path, ["decode", str(a), "{out}"], "back.npy")
    assert mine == theirs == 0
    _same_file(c, d)
    assert np.load(c).shape == (40, 48, 3)


def test_encode_progressive_restart_and_gray_input(tmp_path):
    rng = np.random.default_rng(6)
    for name, img, flags in (
            ("prog", rng.integers(0, 256, (33, 47, 3), dtype=np.uint8), ["--progressive"]),
            ("ri", rng.integers(0, 256, (48, 64, 3), dtype=np.uint8),
             ["--restart-interval", "2", "--quality", "50"]),
            ("gray", rng.integers(0, 256, (41, 57), dtype=np.uint8), [])):
        src = tmp_path / f"{name}.npy"
        np.save(src, img)
        mine, theirs, a, b = _both(tmp_path, ["encode", str(src), "{out}", *flags],
                                   f"{name}.jpg")
        assert mine == theirs == 0
        _same_file(a, b)


def test_info_reports_progressive(tmp_path, capsys):
    """`info` exposes the coding process and scan script of a progressive
    (SOF2) stream, as the JAX CLI's."""
    from jpeg_decoder_tpu_torch.models.encoder import encode
    from jpeg_decoder_tpu_torch.utils.config import EncodeConfig

    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
    p = tmp_path / "prog.jpg"
    p.write_bytes(encode(img, EncodeConfig(progressive=True), device="cpu"))
    assert cli.main(["info", str(p)]) == 0
    text = capsys.readouterr().out
    assert "PROGRESSIVE" in text
    assert text.count("scan") >= 4  # DC scan + one AC scan per component
    assert jcli.main(["info", str(p)]) == 0
    assert capsys.readouterr().out == text
    assert cli.main(["info", str(p), "--json"]) == 0
    js = capsys.readouterr().out
    assert "PROGRESSIVE" in json.loads(js)["process"]
    assert jcli.main(["info", str(p), "--json"]) == 0
    assert capsys.readouterr().out == js


@pytest.mark.parametrize("no_device", [True, False], ids=["host", "device_stage"])
def test_decode_batch_cli(tmp_path, no_device):
    """decode-batch writes one output per input (mixed sequential +
    progressive), each the JAX CLI's bytes and the single-file decode's
    pixels."""
    import jpeg_decoder_tpu_torch as jtt

    srcs = []
    for i, (name, data) in enumerate(corpus.baseline_corpus()[:2]):
        p = tmp_path / f"seq{i}.jpg"
        p.write_bytes(data)
        srcs.append(p)
    name, data = corpus.progressive_corpus()[0]
    p = tmp_path / "prog0.jpg"
    p.write_bytes(data)
    srcs.append(p)
    flags = ["--no-device"] if no_device else []
    rcs = (cli.main(["decode-batch", *map(str, srcs), "--out-dir", str(tmp_path / "port"),
                     "--format", "npy", "--jobs", "2", *flags, *CPU]),
           jcli.main(["decode-batch", *map(str, srcs), "--out-dir", str(tmp_path / "jax"),
                      "--format", "npy", "--jobs", "2", *flags]))
    assert rcs == (0, 0)
    cfg = jtt.DecodeConfig(use_device=not no_device)
    for p in srcs:
        _same_file(tmp_path / "port" / f"{p.stem}.npy", tmp_path / "jax" / f"{p.stem}.npy")
        np.testing.assert_array_equal(np.load(tmp_path / "port" / f"{p.stem}.npy"),
                                      jtt.decode(p.read_bytes(), cfg, device="cpu").rgb)


@pytest.mark.parametrize("fmt", ["ppm", "png"])
def test_decode_batch_formats(tmp_path, fmt):
    srcs = []
    for i, (name, data) in enumerate(corpus.baseline_corpus()[3:5]):
        p = tmp_path / f"in{i}.jpg"
        p.write_bytes(data)
        srcs.append(p)
    assert cli.main(["decode-batch", *map(str, srcs), "--out-dir", str(tmp_path / "port"),
                     "--format", fmt, *CPU]) == 0
    assert jcli.main(["decode-batch", *map(str, srcs), "--out-dir", str(tmp_path / "jax"),
                      "--format", fmt]) == 0
    for p in srcs:
        _same_file(tmp_path / "port" / f"{p.stem}.{fmt}", tmp_path / "jax" / f"{p.stem}.{fmt}")


@pytest.mark.parametrize("scale", ["1/8", "1/4", "1/2"])
def test_decode_scale_flag(sample_jpeg, tmp_path, scale):
    """--scale gives the scaled decoder's output at ceil(dim * scale),
    under FLOAT32 as the JAX test asks, and under EXACT (the same scaled
    product: the JAX package ignores EXACT there), the JAX CLI's bytes."""
    from PIL import Image

    import jpeg_decoder_tpu_torch as jtt

    for precision in ("float32", "exact"):
        mine, theirs, a, b = _both(tmp_path, ["decode", str(sample_jpeg), "{out}", "--backend",
                                              "numpy", "--precision", precision, "--scale",
                                              scale], f"{precision}.png")
        assert mine == theirs == 0
        _same_file(a, b)
    k = cli._SCALE_FLAGS[scale]
    png = np.asarray(Image.open(a))
    want = jtt.decode_rgb(sample_jpeg.read_bytes(), jtt.DecodeConfig(
        entropy_backend=jtt.EntropyBackend.NUMPY, scale=k), device="cpu")
    assert png.shape == (8 * k, 8 * k, 3)
    np.testing.assert_array_equal(png, want)


@pytest.mark.parametrize("route", ["--streamed", "--striped"])
def test_decode_scale_rejects_gigapixel_routes(sample_jpeg, tmp_path, route):
    for main, extra in ((cli.main, CPU), (jcli.main, [])):
        assert main(["decode", str(sample_jpeg), str(tmp_path / "x.png"), "--scale", "1/4",
                     route, *extra]) == 2


def test_no_device_scale_raises_as_the_reference(sample_jpeg, tmp_path):
    """Reference defect (jpeg_decoder_tpu/cli.py:78, kept): --no-device
    --scale ends in the pixel stage's JpegConfigError, the port's own
    class, rather than a usage error."""
    args = ["decode", str(sample_jpeg), str(tmp_path / "x.npy"), "--no-device", "--scale",
            "1/2"]
    with pytest.raises(errors.JpegConfigError) as mine:
        cli.main([*args, *CPU])
    with pytest.raises(jerrors.JpegConfigError) as theirs:
        jcli.main(args)
    assert_same_error_class(type(mine.value), type(theirs.value))
    assert str(mine.value) == str(theirs.value)


@pytest.mark.parametrize("scale", ["1", "1/2"])
def test_bench_counts_the_source_megapixels(sample_jpeg, capsys, scale):
    """bench prints the JAX CLI's record; its megapixels are the source
    frame's, also under --scale (reference defect, jpeg_decoder_tpu/cli.py
    :203, kept): value is 64 x 64 pixels over the median time in both, as
    far as both printed numbers' rounding to two decimals lets it be."""
    recs = []
    for main, extra in ((cli.main, CPU), (jcli.main, [])):
        assert main(["bench", str(sample_jpeg), "--repeat", "2", "--backend", "numpy",
                     "--scale", scale, *extra]) == 0
        recs.append(json.loads(capsys.readouterr().out))
    for rec in recs:
        assert sorted(rec) == ["median_ms", "metric", "unit", "value"]
        assert rec["metric"] == "cli_decode_throughput" and rec["unit"] == "MP/s"
        fastest, slowest = (rec["median_ms"] - 0.005) / 1e3, (rec["median_ms"] + 0.005) / 1e3
        assert round(64 * 64 / 1e6 / slowest, 2) <= rec["value"] <= round(
            64 * 64 / 1e6 / fastest, 2)


def test_device_backend_is_not_ported(sample_jpeg, tmp_path):
    """--backend device decodes (the DEVICE entropy backend, on the CPU its
    plain lockstep loop), the file byte for byte the JAX CLI's with its
    DEVICE backend. The name is the one the test had while it raised."""
    rc, jrc, got, want = _both(tmp_path, ["decode", str(sample_jpeg), "{out}", "--backend",
                                          "device"], "x.npy")
    assert rc == jrc == 0
    _same_file(got, want)


def test_default_device_is_the_card(sample_jpeg, tmp_path):
    """Without --device the CLI runs on the card; without one it raises
    rather than dropping to the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["decode", str(sample_jpeg), str(tmp_path / "x.npy")])


def test_entry_runs_on_the_cpu():
    """entry(): the pixel stage of the port's own tiny encode, on the CPU;
    its RGB is the port's decode of the same image."""
    import torch

    from jpeg_decoder_tpu_torch import entry as tentry
    from jpeg_decoder_tpu_torch.models import decoder

    fn, args = tentry.entry("cpu")
    assert all(isinstance(a, torch.Tensor) and a.device.type == "cpu" for a in args)
    rgb = fn(*args)
    assert tuple(rgb.shape) == (32, 32, 3) and rgb.dtype == torch.uint8
    frame, planes, qts, cfg = tentry._tiny_coeffs()
    want = decoder._pixel_stage(frame, planes, qts, cfg, "cpu").rgb
    np.testing.assert_array_equal(rgb.numpy(), want)
