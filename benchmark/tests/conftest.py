"""Fixtures of the benchmark's tests: a tiny cell on the CPU, added beside
the real ones as new files in a temporary directory.

Tests that need a CUDA card carry the ``card`` marker and decide inside the
test whether one is present."""
import json
import pathlib
import shutil

import pytest
import torch

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
TINY = "tiny-t4"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")
    # a few threads a worker: the CPU decodes oversubscribe the cores under
    # several workers otherwise
    torch.set_num_threads(4)


def tiny_config() -> dict:
    """A configuration at a size a test run holds: m=6 r=1/2, 2 bytes an
    oligo, L=4, an 8-byte file."""
    cfg = json.loads((BENCH / "configs" / "exp7.json").read_text())
    cfg.update(name="tiny", bytes_per_oligo=2, rs_redundancy=0.5,
               conv_mem=6, conv_rate=1, list_size=4, max_deviation=8,
               file_bytes=8)
    return cfg


def make_tree(tmp: pathlib.Path, grouping: str = "orientation"):
    """(root, here): a copy of BENCHMARK.json with the tiny cell added, and
    a benchmark directory holding the real metrics and the tiny cell's
    config and traffic files."""
    here = tmp / "bench"
    shutil.copytree(BENCH / "metrics", here / "metrics")
    shutil.copytree(BENCH / "traffic", here / "traffic")
    (here / "configs").mkdir()
    (here / "configs" / "tiny.json").write_text(json.dumps(tiny_config()))
    (here / "traffic" / "t4.json").write_text(json.dumps(
        {"batch": 2, "pool_reads": 4, "rc_share": 0.5,
         "grouping": grouping, "check_reads": 2,
         "reference_chunk": 2}))
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "tiny", "source": "test",
                           "file": "bench/configs/tiny.json", "reduced": [],
                           "why": "a test's size"})
    man["workloads"].append({"name": TINY, "config": "tiny",
                             "traffic": "t4", "chips": 1, "why": "test"})
    for m in man["per_layer"]:
        m["workloads"].append(TINY)
    (tmp / "BENCHMARK.json").write_text(json.dumps(man))
    return tmp, here


@pytest.fixture
def tiny(tmp_path):
    return make_tree(tmp_path)
