"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration, whose ``file`` the
manifest gives, and a traffic mix, found as ``traffic/<name>.json`` beside
this module. A metric, end to end or per layer, is the module
``metrics/<name>.py`` beside this module: ``read(rec)`` takes the run's
record and returns the metric's value, or None where it finds nothing to
read; a per-layer metric may also define ``collect(ctx)``, which the traced
run calls after its window to gather what ``read`` needs. A later change
adds a cell, a configuration, a mix or a metric by adding files and
entries, and edits none of these.
"""
from __future__ import annotations

import importlib.util
import json
import pathlib
from types import ModuleType
from typing import List

HERE = pathlib.Path(__file__).resolve().parent


def load(root: pathlib.Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(root: pathlib.Path, manifest: dict, cell_: dict) -> dict:
    for c in manifest["configs"]:
        if c["name"] == cell_["config"]:
            return json.loads((root / c["file"]).read_text())
    raise KeyError(f"no config {cell_['config']!r} in BENCHMARK.json")


def traffic(name: str, here: pathlib.Path = HERE) -> dict:
    return json.loads((here / "traffic" / f"{name}.json").read_text())


def metrics(manifest: dict, cell_name: str, kind: str) -> List[dict]:
    """The ``kind`` metrics (``end_to_end`` or ``per_layer``) that cell
    ``cell_name`` reports: those with no ``workloads`` key and those that
    list it."""
    return [m for m in manifest[kind]
            if cell_name in m.get("workloads", [cell_name])]


def metric_module(name: str, here: pathlib.Path = HERE) -> ModuleType:
    path = here / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{name.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
