"""Cells written down for a later PR to add to BENCHMARK.json, which the
benchmark's cell-driven tests take before then. A queued cell is its
workload entry, with its configuration and traffic as the files would hold
them; it runs through `harness.run(bench=..., traffic=...)` with its
configuration file in a temporary directory. Once BENCHMARK.json holds a
cell of its name, the queued one drops out and the real one takes its
place in the same tests, read from its own files.
"""

from __future__ import annotations

import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent

#: Sizes at which the control (FLOAT32) departs from EXACT on the CPU in the
#: first call of the window (it holds the whole pool).
REHEARSE_MIXED = {"sizes": [[128, 96], [96, 128], [128, 80]], "size_weights": [1, 1, 1],
                  "pool": 6, "batch": 6, "warmup_batches": 1, "sample": 6}


def mixed_traffic(**over) -> dict:
    """The loader cell the mixed keys were made for: ILSVRC2012's three
    common 4:2:0 sizes, per-image quality 75-95."""
    return {"name": "loader_mixed_photo_b256", "loop": "many_batches",
            "sizes": [[500, 375], [375, 500], [500, 333]], "size_weights": [6, 3, 1],
            "sampling": "420", "restart_interval": 0, "layout": "alternate",
            "tables": "per_image", "quality": "75-95", "pool": 320, "batch": 256,
            "warmup_batches": 5, "sample": 32, "rehearse": {**REHEARSE_MIXED, **over}}


MIXED_SOURCE = ("https://github.com/NVIDIA/DALI/tree/main/docs/examples/use_cases/pytorch/"
                "resnet50 (fn.decoders.image, batch 256 a GPU) on ILSVRC2012 train JPEGs as they"
                " come: mixed sizes, each its own quality")


def mixed_config() -> dict:
    """The configuration file of the loader cell that takes mixed pools."""
    return {
        "name": "imagenet_mixed_pallas",
        "source": MIXED_SOURCE,
        "deployment": "a training data loader on one GPU: 256 images of mixed size and quant"
                      " tables a call, bytes in, host RGB out, one call after another",
        "entry": "BatchDecoder.decode_many",
        "decode_config": {"entropy_backend": "PALLAS", "idct_precision": "EXACT",
                          "upsample": "fancy", "num_threads": 4},
        "guarantees": "EXACT: RGB bitwise the reference decoder's IDCT and colour arithmetic"
                      " with libjpeg's fancy upsampling, every image at its own size and tables",
        "control": {"idct_precision": "FLOAT32"},
        "batch_size": 256,
        "image_sizes": [[500, 375], [375, 500], [500, 333]],
        "size_weights": [6, 3, 1],
        "quality": "75-95",
        "reduced": ["image_sizes"],
        "assumed": [
            "ILSVRC2012's three most common 4:2:0 sizes at weights 6:3:1 stand for its whole"
            " spread",
            "each image's quant tables are libjpeg's at a whole quality drawn from 75-95; the"
            " blocks are the repository's two 4:2:0 photographs', tiled and rolled by the seed",
            "Annex K Huffman tables",
            "num_threads 4: the example's own setting",
        ],
    }


#: The queued cells' workload entries, and their configurations and traffic
#: by name.
QUEUED = [{"name": "loader_mixed_b256", "config": "imagenet_mixed_pallas",
           "traffic": "loader_mixed_photo_b256", "chips": 1}]
CONFIGS = {"imagenet_mixed_pallas": mixed_config}
TRAFFIC = {"loader_mixed_photo_b256": mixed_traffic}


def load_bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _held(bench: dict, cell: dict) -> bool:
    return any(w["name"] == cell["name"] for w in bench["workloads"])


def workloads(bench: dict) -> list:
    """BENCHMARK.json's cells, then the queued cells it does not hold yet."""
    return bench["workloads"] + [q for q in QUEUED if not _held(bench, q)]


def config(bench: dict, cell: dict) -> dict:
    """A cell's configuration: the file BENCHMARK.json names, else the
    queued body."""
    for c in bench["configs"]:
        if c["name"] == cell["config"]:
            return json.loads((ROOT / c["file"]).read_text())
    return CONFIGS[cell["config"]]()


def traffic(name: str) -> dict:
    """A traffic mix: its file, else the queued body."""
    f = HERE / "traffic" / f"{name}.json"
    return json.loads(f.read_text()) if f.exists() else TRAFFIC[name]()


def bench_for(bench: dict, cell: dict, tmp_path: Path) -> dict | None:
    """What `harness.run(bench=...)` takes for the cell: None for a cell of
    BENCHMARK.json; for a queued one, a BENCHMARK.json that holds it alone,
    its configuration file written to `tmp_path`."""
    if _held(bench, cell):
        return None
    f = tmp_path / f"{cell['config']}.json"
    f.write_text(json.dumps(config(bench, cell)))
    return {"configs": [{"name": cell["config"], "file": str(f)}], "workloads": [cell],
            "end_to_end": [], "per_layer": []}
