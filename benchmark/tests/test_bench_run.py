"""The harness's window arithmetic, its no-JAX check, its refusal without a
card and its result line, on the CPU."""
import functools
import json
import subprocess
import sys
import types

import pytest
import torch

from benchmark import manifest, run
from conftest import ROOT, TINY


class FakeClock:
    """A clock that a call advances by its own duration."""

    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now


def test_rate_is_all_the_work_over_all_the_time():
    clock = FakeClock()
    durations = [3.0, 1.0, 2.0]
    sizes = [24, 24, 10]

    def call(i):
        clock.now += durations[i]
        return sizes[i]

    w = run.run_window(call, 3, 7.5, clock)
    # calls of 3, 1, 2, then 3 s again: the clock passes 7.5 s in the 4th
    assert w == {"reads": 24 + 24 + 10 + 24, "calls": 4, "seconds": 9.0}
    reads_per_s = manifest.metric_module("reads_per_s")
    assert reads_per_s.read({"window": w}) == 82 / 9.0


def test_window_runs_whole_calls_at_least_once():
    clock = FakeClock()

    def call(i):
        clock.now += 5.0
        return 2

    assert run.run_window(call, 1, 0.0, clock) == {
        "reads": 2, "calls": 1, "seconds": 5.0}


@pytest.mark.parametrize("planted,found", [
    (["jax"], ["jax"]), (["jax.numpy", "numpy"], ["jax.numpy"]),
    (["jaxlib.xla_client"], ["jaxlib.xla_client"]), (["flax"], ["flax"]),
    (["nanopore_dna_storage_tpu"], ["nanopore_dna_storage_tpu"]),
    (["nanopore_dna_storage_tpu.ops.lva"], ["nanopore_dna_storage_tpu.ops.lva"]),
    (["nanopore_dna_storage_tpu_torch", "nanopore_dna_storage_tpu_torch.ops",
      "jaxtyping", "flax_like"], []),
])
def test_forbidden_modules_by_whole_top_level_name(planted, found):
    assert run.forbidden_modules(planted) == found


def test_no_result_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run.main(["--workload", "exp7-grouped-b24", "--seed", "1",
                     "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_harness_imports_no_jax():
    code = ("import sys, benchmark.run, benchmark.control; "
            "from benchmark.run import forbidden_modules; "
            "print(forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, text=True,
                         capture_output=True, check=True).stdout
    assert out.strip() == "[]"


def fake_card(monkeypatch, tiny):
    root, here = tiny
    monkeypatch.setattr(run, "ROOT", root)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(run, "run_cell", functools.partial(
        run.run_cell, root=root, here=here, device="cpu"))


ARGS = ["--workload", TINY, "--seed", str(2**31 + 5), "--seconds", "0"]


def test_result_line_has_the_contracts_keys(monkeypatch, tiny, capsys):
    fake_card(monkeypatch, tiny)
    assert run.main(ARGS) == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert {"correct", "attempted", "failed", "metrics", "device"} \
        <= set(line)
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] == 2
    assert set(line["metrics"]) == {"reads_per_s", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in line["metrics"].values())
    assert {"platform", "kind", "count", "memory_peak_bytes"} \
        <= set(line["device"])
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert tail == [f"check {n} {c['value']} limit {c['limit']}"
                    for n, c in line["checks"].items()]


def test_traced_line_reads_the_spans(monkeypatch, tiny, capsys):
    fake_card(monkeypatch, tiny)
    assert run.main(ARGS + ["--trace", "1"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is True
    # off the card the profile and the ACS events read nothing
    assert set(line["metrics"]) == {"pipeline_self_share", "traceback_share"}
    assert 0 < line["metrics"]["traceback_share"]["value"] < 100


@pytest.mark.parametrize("planted", ["jax", "nanopore_dna_storage_tpu"])
def test_no_result_when_jax_is_loaded(monkeypatch, tiny, capsys, planted):
    fake_card(monkeypatch, tiny)
    monkeypatch.setitem(sys.modules, planted, types.ModuleType(planted))
    assert run.main(ARGS) != 0
    out, err = capsys.readouterr()
    assert out == "" and planted in err
