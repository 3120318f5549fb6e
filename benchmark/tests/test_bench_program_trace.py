"""The traceback's three metrics on made-up records, and ``program_trace``'s
reduction of a profile, on the CPU."""
import types

import pytest
import torch

from benchmark import manifest, program_trace

SPAN = "traceback_us_per_block"
LAUNCHES = "traceback_launches_per_block"
SYNCS = "traceback_syncs_per_block"


def metric(name):
    return manifest.metric_module(name)


@pytest.mark.parametrize("name,rec,want", [
    (SPAN, {"program_span_pass": {"traceback_s": 0.5, "blocks": 400}},
     1250.0),
    (LAUNCHES, {"program_profile_pass": {"launches": 32000, "syncs": 400,
                                         "blocks": 400}}, 80.0),
    (SYNCS, {"program_profile_pass": {"launches": 32000, "syncs": 402,
                                      "blocks": 400}}, 1.005),
    (SYNCS, {"program_profile_pass": {"launches": 32000, "syncs": 0,
                                      "blocks": 400}}, 0.0),
])
def test_read_on_made_up_records(name, rec, want):
    assert metric(name).read(rec) == pytest.approx(want)


@pytest.mark.parametrize("name", [SPAN, LAUNCHES, SYNCS])
@pytest.mark.parametrize("rec", [
    {}, {"window": {"reads": 24, "calls": 1, "seconds": 1.0}},
    {"program_span_pass": None, "program_profile_pass": None},
    {"program_span_pass": {"traceback_s": 0.5, "blocks": 0},
     "program_profile_pass": {"launches": 9, "syncs": 1, "blocks": 0}},
    {"program_span_pass": {"blocks": 400},
     "program_profile_pass": {"blocks": 400}},
])
def test_read_is_none_without_the_reading(name, rec):
    assert metric(name).read(rec) is None


def test_reduce_counts_calls_inside_the_traceback_ranges():
    # spans in ns on the program's clock; ranges 1000 us later on the
    # profiler's
    spans = [("decoder.traceback", 10_000, 20_000),
             ("decoder.traceback", 30_000, 40_000),
             ("decoder.decode", 5_000, 45_000)]
    events = [("decoder.decode", 1005.0, 1045.0),
              ("decoder.traceback", 1010.0, 1020.0),
              ("decoder.traceback", 1030.002, 1040.0),
              ("cudaLaunchKernel", 1011.0, 1011.5),
              ("cudaLaunchKernelExC", 1012.0, 1012.5),
              ("cuLaunchKernel", 1031.0, 1031.5),
              ("cudaStreamSynchronize", 1013.0, 1014.0),
              ("cudaMemcpy", 1035.0, 1035.2),
              ("cudaMemcpyAsync", 1035.5, 1035.7),
              ("cudaStreamWaitEvent", 1036.0, 1036.1),
              # outside the traceback, inside the decode
              ("cudaLaunchKernel", 1025.0, 1025.5),
              ("cudaDeviceSynchronize", 1044.0, 1044.5),
              ("aten::add", 1015.0, 1016.0)]
    out = program_trace.reduce_profile(events, spans)
    assert (out["launches"], out["syncs"]) == (3, 2)
    assert out["by_span"]["decoder.decode"] == {"launches": 4, "syncs": 3}
    assert out["offset_spread_us"] == pytest.approx(0.002)


@pytest.mark.parametrize("drop", ["decoder.traceback", "decoder.decode"])
def test_reduce_is_none_when_a_span_has_no_range(drop):
    spans = [("decoder.traceback", 10_000, 20_000),
             ("decoder.decode", 5_000, 25_000)]
    events = [(n, s, e) for n, s, e in [
        ("decoder.decode", 1005.0, 1025.0),
        ("decoder.traceback", 1010.0, 1020.0)] if n != drop]
    assert program_trace.reduce_profile(events, spans) is None


def test_reduce_is_none_without_a_traceback():
    spans = [("decoder.decode", 5_000, 25_000)]
    events = [("decoder.decode", 1005.0, 1025.0),
              ("cudaLaunchKernel", 1011.0, 1011.5)]
    assert program_trace.reduce_profile(events, spans) is None


def test_passes_read_nothing_off_the_card():
    ctx = types.SimpleNamespace(device=torch.device("cpu"))
    assert program_trace.span_pass(ctx) is None
    assert program_trace.profile_pass(ctx) is None
    for name in (SPAN, LAUNCHES, SYNCS):
        assert metric(name).collect(ctx) == {}


def test_passes_read_nothing_from_a_program_without_a_tracer(monkeypatch):
    monkeypatch.setattr(program_trace, "_tracer", lambda: None)
    ctx = types.SimpleNamespace(device=torch.device("cuda"))
    assert program_trace.span_pass(ctx) is None
    assert program_trace.profile_pass(ctx) is None


def test_a_pass_runs_once_a_context():
    calls = []
    ctx = types.SimpleNamespace(device=torch.device("cpu"))
    for _ in range(3):
        program_trace._cached(ctx, "x", lambda c: calls.append(c) or 7)
    assert calls == [ctx]
