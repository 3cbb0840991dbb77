"""The port's own host layers (jpeg_decoder_tpu_torch/{utils,io,core,native})
against the JAX package's, and the port's independence of that package.

(a) No module of the port, nor chip_smoke.py, imports `jax` or
    `jpeg_decoder_tpu` (an `ast` walk over the sources).
(b) In a process that refuses both imports, the port imports, builds its own
    native runtime and decodes a DRI stream on the CPU, PALLAS and NATIVE.
(c) On the repository's small test streams the port's parser, native scan
    decode, NumPy entropy decode and oracle give the JAX package's results:
    structures field for field, planes and pixels bitwise. The two native
    libraries are two files, the port's under jpeg_decoder_tpu_torch/build/.

The two packages' objects are equal in content and distinct in identity, so
each side gets its own package's config and parses the bytes itself.
"""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jpeg_decoder_tpu as jt
import jpeg_decoder_tpu_torch as jtt
from jpeg_decoder_tpu.core import entropy_encode as j_entropy_encode
from jpeg_decoder_tpu.core import entropy_np as j_entropy_np
from jpeg_decoder_tpu.core import huffman as j_huffman
from jpeg_decoder_tpu.core import oracle as j_oracle
from jpeg_decoder_tpu.io.parser import parse as jparse
from jpeg_decoder_tpu.native import build as j_build
from jpeg_decoder_tpu.native import runtime as j_runtime
from jpeg_decoder_tpu.utils import errors as j_errors
from jpeg_decoder_tpu_torch import convert
from jpeg_decoder_tpu_torch.core import entropy_encode, entropy_np, huffman, oracle
from jpeg_decoder_tpu_torch.io.parser import parse
from jpeg_decoder_tpu_torch.native import build as t_build
from jpeg_decoder_tpu_torch.native import runtime
from jpeg_decoder_tpu_torch.utils import errors, jax_free

from . import corpus
from .torch_crossing import assert_same_error_class, assert_same_fields

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "jpeg_decoder_tpu_torch"
WILD = REPO / "tests" / "wild_files"


# ---------------------------------------------------------------------------
# (a) static: no import of jax or of the JAX package
# ---------------------------------------------------------------------------

PORT_SOURCES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_roots(path: Path) -> set[str]:
    """Top-level names of every absolute import in a source file (at any
    depth: function bodies too)."""
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_neither_jax_nor_the_jax_package(path):
    assert not _imported_roots(path) & {"jax", "jaxlib", "jpeg_decoder_tpu"}


def test_the_port_has_its_own_host_modules_and_no_shared_module():
    assert len(PORT_SOURCES) > 30
    assert not (PORT / "shared.py").exists()
    for rel in ("utils/errors.py", "utils/config.py", "utils/logging.py", "utils/metrics.py",
                "io/markers.py", "io/bitstream.py", "io/parser.py", "io/writer.py",
                "core/types.py", "core/huffman.py", "core/numerics.py", "core/driver.py",
                "core/oracle.py", "core/entropy_np.py", "core/entropy_encode.py",
                "core/checkpoint.py", "utils/debug.py", "native/build.py",
                "native/runtime.py", "native/src/jdt_entropy.cpp",
                "native/src/jdt_encode.cpp"):
        assert (PORT / rel).is_file(), rel


def _public_names(path: Path) -> set[str]:
    """The names a package's __init__ binds at its top level: imports,
    functions, classes and assignments (an ast walk; nothing is imported)."""
    names = set()
    for node in ast.parse(path.read_text(), str(path)).body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0] for a in node.names)
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
    return names


def test_the_port_exports_every_name_the_reference_exports():
    ours = _public_names(PORT / "__init__.py")
    theirs = _public_names(REPO / "jpeg_decoder_tpu" / "__init__.py")
    assert {"parse", "decode_oracle", "host_decode_batch", "CoefficientPlanes",
            "FrameHeader", "JpegStructure", "__version__"} <= theirs
    assert theirs <= ours, sorted(theirs - ours)


def test_jax_free_sees_the_jax_package_too():
    """This process imported both, so jax_free() is False here; a clean
    process is (b)'s."""
    assert "jpeg_decoder_tpu" in sys.modules and not jax_free()


# ---------------------------------------------------------------------------
# (b) a process that refuses both imports
# ---------------------------------------------------------------------------

_REFUSING = """
import sys

class Refuse:
    def find_spec(self, name, path=None, target=None):
        root = name.split(".")[0]
        if root in ("jax", "jaxlib", "jpeg_decoder_tpu"):
            raise ImportError("refused: " + name)
        return None

sys.meta_path.insert(0, Refuse())
try:
    import jpeg_decoder_tpu
except ImportError:
    pass
else:
    raise SystemExit("the finder did not refuse jpeg_decoder_tpu")

import jpeg_decoder_tpu_torch as jtt
from jpeg_decoder_tpu_torch.native import build, runtime
from jpeg_decoder_tpu_torch.utils import jax_free

data = open(sys.argv[1], "rb").read()
assert runtime.available()
shapes = []
for backend in (jtt.EntropyBackend.PALLAS, jtt.EntropyBackend.NATIVE):
    img = jtt.decode(data, jtt.DecodeConfig(entropy_backend=backend), device="cpu")
    shapes.append(img.rgb.shape)
    if backend is jtt.EntropyBackend.PALLAS:
        first = img.rgb
assert (first == img.rgb).all()
print(jax_free(), shapes, build.lib_path().parent.name, build.lib_path().parent.parent.name)
"""


def test_port_runs_in_a_process_that_refuses_jax_and_the_jax_package(tmp_path):
    stream = tmp_path / "dri.jpg"
    stream.write_bytes(corpus.dri_corpus()[2][1])
    r = subprocess.run([sys.executable, "-c", _REFUSING, str(stream)], cwd=REPO,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split("\n")[0] == \
        "True [(64, 64, 3), (64, 64, 3)] build jpeg_decoder_tpu_torch"


# ---------------------------------------------------------------------------
# (c) the copied layers give the JAX package's results
# ---------------------------------------------------------------------------


def _streams():
    out = dict(corpus.baseline_corpus()[:5])
    out.update({f"dri_{n}": d for n, d, _ in corpus.dri_corpus()[:3]})
    out.update({f"prog_{n}": d for n, d in corpus.progressive_corpus()[:2]})
    out["cmyk_q90"] = dict(corpus.baseline_corpus())["cmyk_q90"]
    out["wild_markers"] = corpus.with_wild_markers(corpus.baseline_corpus()[0][1])
    for name in ("ipython_2x2.jpg", "pygame_red.jpg", "cpython-email_python.jpg"):
        out[name] = (WILD / name).read_bytes()
    return out


STREAMS = _streams()


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_parse_matches_field_for_field(name):
    got, want = parse(STREAMS[name]), jparse(STREAMS[name])
    assert type(got) is not type(want)
    assert_same_fields(got, want)


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_native_entropy_decode_matches_bitwise(name):
    data = STREAMS[name]
    got, got_q = runtime.entropy_decode(parse(data), jtt.DecodeConfig())
    want, want_q = j_runtime.entropy_decode(jparse(data), jt.DecodeConfig())
    assert_same_fields(got.planes, want.planes)
    assert_same_fields(got_q, want_q)


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_numpy_entropy_decode_matches_bitwise(name):
    data = STREAMS[name]
    got, _ = entropy_np.entropy_decode(parse(data), jtt.DecodeConfig())
    want, _ = j_entropy_np.entropy_decode(jparse(data), jt.DecodeConfig())
    assert_same_fields(got.planes, want.planes)


@pytest.mark.parametrize("quirks", ["REFERENCE", "CORRECT"])
@pytest.mark.parametrize("name", sorted(STREAMS))
def test_oracle_decode_matches_bitwise(name, quirks):
    data = STREAMS[name]
    want_cfg = jt.DecodeConfig(quirks=jt.Quirks[quirks])
    got = oracle.decode(data, convert.config_from(want_cfg))
    want = j_oracle.decode(data, want_cfg)
    assert_same_fields(got.frame, want.frame)
    assert_same_fields(got.planes, want.planes)
    np.testing.assert_array_equal(got.rgb, want.rgb)


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_structure_dumps_match(name, capsys):
    """The port's copy of utils/debug.py: structure_summary equal to the
    original's and print_structure printing the same text."""
    from jpeg_decoder_tpu.utils import debug as j_debug
    from jpeg_decoder_tpu_torch.utils import debug

    got, want = parse(STREAMS[name]), jparse(STREAMS[name])
    assert debug.structure_summary(got) == j_debug.structure_summary(want)
    debug.print_structure(got)
    mine = capsys.readouterr().out
    j_debug.print_structure(want)
    assert mine == capsys.readouterr().out and mine


def test_two_native_libraries_two_directories():
    mine, theirs = t_build.lib_path(), j_build.lib_path()
    assert mine.parent == PORT / "build"
    assert theirs.parent == REPO / "jpeg_decoder_tpu" / "native" / "build"
    assert runtime.available() and j_runtime.available()
    assert runtime._load() is not j_runtime._load()
    assert (t_build.SRC_DIR / "jdt_entropy.cpp").read_bytes() != b""
    assert t_build.SRC_DIR == PORT / "native" / "src"
    assert t_build._pair_shift_flag() == j_build._pair_shift_flag()


# ---------------------------------------------------------------------------
# Crossings (convert.py): another package's objects by field names and arrays
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "cfg",
    [jt.DecodeConfig(),
     jt.DecodeConfig(quirks=jt.Quirks.CORRECT, idct_precision=jt.IdctPrecision.FLOAT32,
                     entropy_backend=jt.EntropyBackend.PALLAS, num_threads=3,
                     upsample="fancy", scale=4, collect_metrics=True, use_device=False)],
    ids=["default", "all_fields"])
def test_config_from_maps_enum_members_by_name(cfg):
    got = convert.config_from(cfg)
    assert type(got) is jtt.DecodeConfig and got != cfg
    assert_same_fields(got, cfg)
    assert got.entropy_backend is jtt.EntropyBackend[cfg.entropy_backend.name]
    assert got.entropy_backend is not cfg.entropy_backend
    assert convert.config_from(got) == got


def test_tables_and_planes_cross_as_arrays():
    data = corpus.dri_corpus()[0][1]
    theirs, mine = jparse(data), parse(data)
    scan = theirs.scans[0]
    for tid, spec in {**scan.dc_tables, **{k + 4: v for k, v in scan.ac_tables.items()}}.items():
        crossed = convert.huff_spec_from(spec)
        assert type(crossed) is jtt.core.types.HuffTableSpec
        assert_same_fields(crossed, spec)
        np.testing.assert_array_equal(convert.ladder_for_spec(crossed),
                                      convert.ladder_for_spec(mine.scans[0].dc_tables[tid]
                                                              if tid < 4 else
                                                              mine.scans[0].ac_tables[tid - 4]))
    for tid, q in scan.quant_tables.items():
        assert_same_fields(convert.quant_table_from(q), mine.scans[0].quant_tables[tid])
    want, _ = j_runtime.entropy_decode(theirs, jt.DecodeConfig())
    planes = convert.planes_from(mine.frame, want.planes)
    assert planes.frame is mine.frame
    assert_same_fields(planes.planes, want.planes)
    pix = oracle.pixels_from_coeffs(mine.frame, planes, {
        t: q.values for t, q in mine.scans[0].quant_tables.items()})
    assert_same_fields(pix, j_oracle.decode(data).planes)


@pytest.mark.parametrize("name", ["JpegError", "JpegFormatError", "JpegTruncatedError",
                                  "JpegUnsupportedError", "JpegEntropyError",
                                  "JpegConfigError", "JpegNativeError"])
def test_error_classes_are_counterparts_not_the_same_objects(name):
    mine, theirs = getattr(errors, name), getattr(j_errors, name)
    assert mine is not theirs
    assert_same_error_class(mine, theirs)


def test_a_format_error_is_the_ports_own_class():
    with pytest.raises(errors.JpegFormatError) as ei:
        parse(b"\xff\xd8\xff\xd9")
    assert not isinstance(ei.value, j_errors.JpegError)
    with pytest.raises(j_errors.JpegFormatError) as ej:
        jparse(b"\xff\xd8\xff\xd9")
    assert str(ei.value) == str(ej.value)


def test_device_trace_is_a_torch_profiler_range():
    """utils/metrics.span, which took over device_trace: enabled, a
    torch.profiler range "jpegtpu.<name>" and the host timer; disabled, the
    timer alone."""
    import torch.profiler

    from jpeg_decoder_tpu_torch.utils import metrics

    before = metrics.GLOBAL_METRICS.stages.get("jdt_region", metrics.StageStat())
    calls, items = before.calls, before.total_items
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with metrics.span("jdt_region", False, items=2):
            np.zeros(1)
        with metrics.span("jdt_region", True, items=3):
            np.zeros(1)
    assert [e.name for e in prof.events() if "jdt_region" in e.name] == ["jpegtpu.jdt_region"]
    st = metrics.GLOBAL_METRICS.stages["jdt_region"]
    assert (st.calls, st.total_items) == (calls + 2, items + 5)
    assert not hasattr(metrics, "device_trace")


# ---------------------------------------------------------------------------
# The encoder's host layer: core/entropy_encode.py
# ---------------------------------------------------------------------------


def _mcu_blocks(seed: int, n_mcus: int, units: list[int]):
    """Random zigzag blocks in MCU order with a zero tail per block (runs,
    ZRL and EOB all occur); units lists each unit's scan component."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_mcus):
        for sci in units:
            b = rng.integers(-300, 301, 64) * (rng.random(64) < 0.3)
            b[0] = rng.integers(-1024, 1024)
            b[rng.integers(1, 64):] = 0
            out.append((sci, b.astype(np.int32)))
    return out


@pytest.mark.parametrize("ri", [0, 1, 5])
@pytest.mark.parametrize("units", [[0], [0, 0, 0, 0, 1, 2]], ids=["gray", "420"])
def test_entropy_encode_matches_the_jax_package(units, ri):
    """The port's copy of core/entropy_encode gives the original's bytes and
    symbol counts on the same blocks: encode_blocks, count_symbols and the
    progressive encode_dc_scan / encode_ac_scan."""
    blocks = _mcu_blocks(ri + len(units), 40, units)
    n_t = 1 if len(units) == 1 else 2
    tables = [(0, 0) if sci == 0 else (n_t - 1, n_t - 1) for sci in units]
    got_f = entropy_encode.count_symbols(blocks, n_t, n_t, tables, len(units), ri)
    want_f = j_entropy_encode.count_symbols(blocks, n_t, n_t, tables, len(units), ri)
    for g, w in zip(got_f, want_f, strict=True):
        for a, b in zip(g, w, strict=True):
            np.testing.assert_array_equal(a, b)
    specs = [(huffman.optimal_code_lengths(got_f[0][t]), huffman.optimal_code_lengths(got_f[1][t]))
             for t in range(n_t)]
    jspecs = [(j_huffman.optimal_code_lengths(want_f[0][t]),
               j_huffman.optimal_code_lengths(want_f[1][t])) for t in range(n_t)]
    dc = [huffman.build_encode_table(s[0]) for s in specs]
    ac = [huffman.build_encode_table(s[1]) for s in specs]
    jdc = [j_huffman.build_encode_table(s[0]) for s in jspecs]
    jac = [j_huffman.build_encode_table(s[1]) for s in jspecs]
    got = entropy_encode.encode_blocks(blocks, dc, ac, tables, len(units), ri)
    assert got == j_entropy_encode.encode_blocks(blocks, jdc, jac, tables, len(units), ri)
    assert len(got) > 100
    dcs = np.array([b[0] for _, b in blocks])
    sci = [s for s, _ in blocks[: len(units)]]
    dc_t = [t for t, _ in tables]
    freq = [np.zeros(256, np.int64) for _ in range(n_t)]
    jfreq = [np.zeros(256, np.int64) for _ in range(n_t)]
    entropy_encode.encode_dc_scan(dcs, sci, dc_t, None, freq=freq)
    j_entropy_encode.encode_dc_scan(dcs, sci, dc_t, None, freq=jfreq)
    for a, b in zip(freq, jfreq, strict=True):
        np.testing.assert_array_equal(a, b)
    dc = [huffman.build_encode_table(huffman.optimal_code_lengths(f)) for f in freq]
    jdc = [j_huffman.build_encode_table(j_huffman.optimal_code_lengths(f)) for f in jfreq]
    assert entropy_encode.encode_dc_scan(dcs, sci, dc_t, dc) == \
        j_entropy_encode.encode_dc_scan(dcs, sci, dc_t, jdc)
    seq = np.stack([b for _, b in blocks])
    freq, jfreq = np.zeros(256, np.int64), np.zeros(256, np.int64)
    entropy_encode.encode_ac_scan(seq, 1, 63, None, freq=freq)
    j_entropy_encode.encode_ac_scan(seq, 1, 63, None, freq=jfreq)
    np.testing.assert_array_equal(freq, jfreq)
    spec = huffman.optimal_code_lengths(freq)
    assert entropy_encode.encode_ac_scan(seq, 1, 63, huffman.build_encode_table(spec)) == \
        j_entropy_encode.encode_ac_scan(seq, 1, 63, j_huffman.build_encode_table(
            j_huffman.optimal_code_lengths(jfreq)))
