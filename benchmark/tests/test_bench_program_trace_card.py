"""The program's spans on the card: each cell's traced run prints the
traceback's three metrics and stays correct, and in one synchronised pass
with the benchmark's wrappers and the program's spans both on, the
program's ``decoder.traceback`` and ``pipeline.decode_posts`` totals lie
within 3% of the wrappers'; the profile pass's ranges sit at one clock
offset from the spans (under 50 us apart). They skip without a CUDA card;
on the card:

    python3 -m pytest benchmark/tests/test_bench_program_trace_card.py \\
        -m card -n 0 -s
"""
import gc
import json
import subprocess
import sys

import pytest
import torch

from benchmark import manifest, program_trace, run, tracing
from benchmark.traffic import make_pool
from conftest import ROOT

CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]
METRICS = ("traceback_us_per_block", "traceback_launches_per_block",
           "traceback_syncs_per_block")
SEED = 2**31 + 29
# the spans the wrappers and the program share, and how near their totals
SHARED = ("decoder.traceback", "pipeline.decode_posts")
AGREE = 0.03


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_prints_the_traceback_metrics(cell):
    need_card()
    res = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", cell,
         "--seed", str(SEED), "--seconds", "2", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert set(METRICS) <= set(line["metrics"]), line["metrics"]
    print(json.dumps({"cell": cell, **{m: line["metrics"][m]["value"]
                                       for m in METRICS}}))


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_program_spans_agree_with_the_wrappers(cell):
    need_card()
    from nanopore_dna_storage_tpu_torch.utils import profiling

    man = manifest.load(ROOT)
    w = manifest.cell(man, cell)
    config = manifest.config(ROOT, man, w)
    traffic = manifest.traffic(w["traffic"])
    prog = run.Program(config, torch.device("cuda"))
    ctx = run.Context(prog, make_pool(config, traffic, SEED), config,
                      traffic)
    try:
        batches = [ctx.batch_of(rc) for rc in (False, True)]
        for idx in batches:
            ctx.call(idx)
        spans = tracing.Spans()
        prog.instrument(spans, sync_traceback=True)
        profiling.reset()
        try:
            with profiling.tracing(sync=True):
                for idx in batches:
                    ctx.call(idx)
            snap = profiling.snapshot()
        finally:
            prog.uninstrument()
            profiling.reset()
        wrapped = {}
        for name, t0, t1 in spans.spans:
            wrapped[name] = wrapped.get(name, 0.0) + (t1 - t0)
        ratios = {n: snap["spans"][n]["total_s"] / wrapped[n]
                  for n in SHARED}
        prof = program_trace.profile_pass(ctx)
        print(json.dumps({"cell": cell, "program_over_wrapper": ratios,
                          "profile": prof}))
        assert all(abs(r - 1) < AGREE for r in ratios.values()), ratios
        assert prof is not None and prof["offset_spread_us"] < 50.0
    finally:
        ctx = prog = None
        gc.collect()
        torch.cuda.empty_cache()
