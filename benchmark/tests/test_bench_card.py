"""The cells on the card: one short run of each, and the control at the
cell's size on three seeds. They skip without a CUDA card; on the card:

    python3 -m pytest benchmark/tests/test_bench_card.py -m card -n 0
"""
import json
import subprocess
import sys

import pytest
import torch

from conftest import ROOT

CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct(cell):
    need_card()
    res = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", cell,
         "--seed", str(2**31 + 17), "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_at_the_cells_size(cell):
    need_card()
    res = subprocess.run(
        [sys.executable, "-m", "benchmark.control", "--workload", cell,
         "--seeds", "11", "12", "13"],
        cwd=ROOT, capture_output=True, text=True, timeout=1800)
    assert res.returncode == 0, res.stderr[-4000:]
    lines = [json.loads(x) for x in res.stdout.strip().splitlines()]
    assert len(lines) == 3 and not any(x["correct"] for x in lines)
