"""BENCHMARK.json against the benchmark's contract, and its files found by
name."""
import json
import re

import pytest

from benchmark import manifest
from conftest import BENCH, ROOT, TINY, make_tree

MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def test_manifest_keys_and_limits():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(MAN["paths"]) <= 16
    for p in MAN["paths"]:
        assert PATH.match(p) and ".." not in p and not p.startswith("/")
        assert not p.endswith("_torch")
    assert 1 <= len(MAN["command"]) <= 32
    assert 1 <= MAN["run_seconds"] <= 51
    cells = len(MAN["workloads"])
    # a full check with 24 cells fits its time
    assert (2 + 14 * 24) * (MAN["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert 1 <= cells <= 24
    assert len(json.dumps(MAN)) <= 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_units_and_keys(kind):
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves"}}[kind]
    names = [e["name"] for e in MAN[kind]]
    assert len(names) == len(set(names))
    for e in MAN[kind]:
        assert set(e) - {"workloads"} == keys, e
        assert NAME.match(e["name"])
        for text in ("why", "layer", "source"):
            if text in e:
                assert 1 <= len(e[text]) <= 200 and "\n" not in e[text]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                             "higher")
    if kind == "end_to_end":
        bounds = {e["name"]: e["bound"] for e in MAN[kind]}
        assert bounds["setup_s"] <= 0.25
        assert all(0.01 <= b <= 0.25 for b in bounds.values())
        assert all(e["source"] in ("host_clock", "device_trace")
                   for e in MAN[kind])
    if kind == "per_layer":
        e2e = {e["name"] for e in MAN["end_to_end"]}
        assert all(e["moves"] in e2e for e in MAN[kind])


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_cell_resolves_its_files(cell):
    w = manifest.cell(MAN, cell)
    assert w["chips"] in (1, 4) and NAME.match(w["traffic"])
    cfg = manifest.config(ROOT, MAN, w)
    entry = next(c for c in MAN["configs"] if c["name"] == w["config"])
    assert entry["file"].startswith(MAN["paths"][0] + "/")
    for key in entry["reduced"]:
        assert key in cfg and key in cfg["reduced"]
    traffic = manifest.traffic(w["traffic"])
    assert {"batch", "pool_reads", "rc_share", "grouping",
            "check_reads", "reference_chunk"} <= set(traffic)
    e2e = manifest.metrics(MAN, cell, "end_to_end")
    layer = manifest.metrics(MAN, cell, "per_layer")
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert layer
    for m in e2e + layer:
        assert callable(manifest.metric_module(m["name"]).read)


def test_new_files_are_found_without_an_edit(tmp_path):
    root, here = make_tree(tmp_path)
    (here / "metrics" / "calls_made.py").write_text(
        "def read(rec):\n    return rec['window']['calls']\n")
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["end_to_end"].append({"name": "calls_made", "unit": "calls",
                              "better": "higher", "bound": 0.25,
                              "source": "host_clock", "workloads": [TINY]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    man = manifest.load(root)
    cell = manifest.cell(man, TINY)
    assert manifest.config(root, man, cell)["conv_mem"] == 6
    assert manifest.traffic(cell["traffic"], here)["batch"] == 2
    names = [m["name"] for m in manifest.metrics(man, TINY, "end_to_end")]
    assert names == ["reads_per_s", "setup_s", "calls_made"]
    mod = manifest.metric_module("calls_made", here)
    assert mod.read({"window": {"calls": 7}}) == 7
    # the real cells do not report the tiny cell's metric
    assert "calls_made" not in [
        m["name"] for m in manifest.metrics(man, "exp7-grouped-b24",
                                            "end_to_end")]


def test_paths_hold_the_benchmark_alone():
    files = [p for p in BENCH.rglob("*") if p.is_file()
             and "__pycache__" not in p.parts]
    for p in files:
        rel = p.relative_to(ROOT).as_posix()
        assert PATH.match(rel), rel
    cmd = " ".join(MAN["command"])
    assert "nanopore_dna_storage_tpu" not in cmd
