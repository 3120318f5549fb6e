"""The port's tracer (``utils/profiling.py``: ``span``, ``count``,
``tracing``, ``snapshot``, ``reset``, ``profile``) on a small CPU decode:
off, it records nothing and reads no clock; on, the lists stay bit-equal,
the spans nest as named, ``decoder.blocks`` counts the block steps, and
under ``torch.profiler`` every span is a range of its name at one clock
offset. Also ``sync=True``'s order against the clock, ``cli --trace-dir``
and ``bench.busy_seconds``."""
import collections
import json
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity

from nanopore_dna_storage_tpu_torch import bench, cli
from nanopore_dna_storage_tpu_torch.config import ExperimentConfig
from nanopore_dna_storage_tpu_torch.io.post import pack_posts
from nanopore_dna_storage_tpu_torch.pipeline import encode_bytes
from nanopore_dna_storage_tpu_torch.pipeline import simulate as sim
from nanopore_dna_storage_tpu_torch.pipeline.decode import PipelineDecoder
from nanopore_dna_storage_tpu_torch.utils import profiling

EXP = ExperimentConfig(bytes_per_oligo=2, rs_redundancy=0.5, conv_mem=6,
                       conv_rate=1)
# each child span's parent; the decoder's spans run once a decoder call
PARENT = {"pipeline.pack_posts": "pipeline.decode_posts",
          "pipeline.classify": "pipeline.decode_posts",
          "decoder.decode": "pipeline.decode_posts",
          **{f"decoder.{n}": "decoder.decode"
             for n in ("schedule", "copy_in", "forward", "traceback",
                       "order", "copy_out", "unpack")}}
NAMES = set(PARENT) | {"pipeline.decode_posts"}
OUTCOME = ("msgs", "valid", "index", "payload", "chosen_msg", "best_score")


class CountingClock:
    def __init__(self, clock):
        self.clock, self.calls = clock, 0

    def __call__(self):
        self.calls += 1
        return self.clock()


@pytest.fixture(scope="module")
def runs():
    """Two reads, one of each orientation, decoded with tracing off (the
    clock counted), on in sync mode, and on under a CPU profiler."""
    torch.set_num_threads(4)
    enc = encode_bytes(bytes(range(8)), EXP)
    posts, rcs, _ = sim.simulate_posts(enc.oligos, 2,
                                       np.random.default_rng(1),
                                       sub_prob=0.01, del_prob=0.01,
                                       ins_prob=0.0)
    assert rcs.any() and (~rcs).any()
    total = enc.num_oligos_data + enc.num_oligos_rs
    dec = PipelineDecoder(EXP, list_size=2, max_deviation=8, device="cpu")
    _, nblks = pack_posts(posts)
    out = {"T": sum(int(nblks[rcs == f].max()) for f in (False, True))}

    profiling.reset()
    clock = CountingClock(time.perf_counter_ns)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(time, "perf_counter_ns", clock)
        out["off"] = dec.decode_posts(posts, rcs, total)
    out["clock_calls"], out["off_snap"] = clock.calls, profiling.snapshot()

    profiling.reset()
    with profiling.tracing(sync=True):
        out["on"] = dec.decode_posts(posts, rcs, total)
    out["on_snap"] = profiling.snapshot()
    out["on_sections"] = profiling.timing_summary()

    profiling.reset()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.tracing(sync=False):
            dec.decode_posts(posts, rcs, total)
    out["prof_snap"] = profiling.snapshot()
    out["events"] = [e for e in prof.events() if e.name in NAMES]
    profiling.reset()
    return out


def test_tracing_off_records_no_span_and_reads_no_clock(runs):
    assert runs["clock_calls"] == 0
    snap = runs["off_snap"]
    assert snap["spans"] == {} and snap["raw"] == []
    assert profiling.timing_summary() == {}
    # counters count with spans off
    assert snap["counters"]["decoder.blocks"] == runs["T"]
    assert profiling.span("a") is profiling.span("b", sync=True)


def test_traced_decode_is_bit_equal(runs):
    for field in OUTCOME:
        assert np.array_equal(getattr(runs["on"], field),
                              getattr(runs["off"], field)), field


def test_spans_nest_as_named(runs):
    snap = runs["on_snap"]
    assert set(snap["spans"]) == NAMES
    for name, s in snap["spans"].items():
        assert s["n"] == (2 if name.startswith("decoder.") else 1), name
    raw = snap["raw"]
    for name, t0, t1 in raw:
        assert t0 <= t1
        if name in PARENT:
            # inside a span of its parent's name
            assert any(p == PARENT[name] and p0 <= t0 and t1 <= p1
                       for p, p0, p1 in raw), name
    children = collections.defaultdict(float)
    for child, parent in PARENT.items():
        children[parent] += snap["spans"][child]["total_s"]
    for parent, total in children.items():
        assert snap["spans"][parent]["total_s"] >= total
    # spans also write into the section registry that ``timed`` writes
    assert {k: v["n"] for k, v in runs["on_sections"].items()} == {
        k: v["n"] for k, v in snap["spans"].items()}


def test_blocks_counter_sums_the_decoder_calls_T(runs):
    for key in ("off_snap", "on_snap", "prof_snap"):
        assert runs[key]["counters"]["decoder.blocks"] == runs["T"]


def test_profiler_ranges_share_the_spans_clock(runs):
    raw = runs["prof_snap"]["raw"]
    ranges = collections.defaultdict(list)
    for e in runs["events"]:
        if e.device_type == torch.autograd.DeviceType.CPU:
            ranges[e.name].append(e.time_range.start)
    spans = collections.defaultdict(list)
    for name, t0, _ in raw:
        spans[name].append(t0 / 1e3)
    assert set(spans) == NAMES
    offsets = []
    for name in NAMES:
        assert len(ranges[name]) == len(spans[name]), name
        offsets += [r - s for r, s in zip(sorted(ranges[name]),
                                          sorted(spans[name]))]
    assert max(offsets) - min(offsets) < 50.0


def test_sync_spans_synchronise_before_each_clock_reading(monkeypatch):
    order = []
    clock = time.perf_counter_ns
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: order.append("sync"))
    monkeypatch.setattr(time, "perf_counter_ns",
                        lambda: order.append("clock") or clock())
    profiling.reset()
    try:
        with profiling.span("off", sync=True):
            pass
        assert order == []
        with profiling.tracing(sync=True):
            with profiling.span("synced", sync=True):
                order.append("body")
            assert order == ["sync", "clock", "body", "sync", "clock"]
            order.clear()
            with profiling.span("unsynced"):
                pass
            assert order == ["clock", "clock"]
        order.clear()
        with profiling.tracing(sync=False):
            with profiling.span("not sync mode", sync=True):
                pass
        assert order == ["clock", "clock"]
        assert [n for n, _, _ in profiling.snapshot()["raw"]] == [
            "synced", "unsynced", "not sync mode"]
    finally:
        profiling.reset()


def test_tracing_restores_the_mode_and_reset_clears():
    profiling.reset()
    with profiling.tracing(sync=True):
        with profiling.tracing(sync=False):
            assert isinstance(profiling.span("a"), profiling._Span)
        assert profiling.span("a", sync=True).sync is True
    assert profiling.span("a") is profiling._OFF
    profiling.count("x")
    profiling.count("x", 4)
    assert profiling.counter("x") == 5 and profiling.counter("y") == 0
    with pytest.raises(KeyError):
        with profiling.tracing():
            with profiling.span("raised"):
                raise KeyError("a span that raises is still recorded")
    snap = profiling.snapshot()
    assert snap["counters"] == {"x": 5}
    assert snap["spans"]["raised"]["n"] == 1
    profiling.reset()
    assert profiling.snapshot() == {"spans": {}, "raw": [], "counters": {}}


def test_profile_records_the_programs_ranges(tmp_path):
    logdir = tmp_path / "trace"
    with profiling.profile(str(logdir)):
        with profiling.span("program.part"):
            torch.ones(64).cumsum(0)
    assert profiling.span("after") is profiling._OFF
    traces = list(logdir.glob("*.pt.trace.json"))
    assert len(traces) == 1
    names = {e.get("name") for e in
             json.loads(traces[0].read_text())["traceEvents"]}
    assert "program.part" in names
    profiling.reset()


def test_cli_trace_dir_writes_a_trace(tmp_path, capsys):
    f = tmp_path / "data.bin"
    f.write_bytes(bytes(range(8)))
    logdir = tmp_path / "trace"
    rec, stats = cli.main(
        ["sim-decode", "-i", str(f), "--mem", "6", "--rate", "1",
         "--bytes-per-oligo", "2", "--rs-redundancy", "0.5",
         "--num-reads", "2", "--batch", "2", "--list-size", "2",
         "--device", "cpu", "--trace-dir", str(logdir)])
    traces = list(logdir.glob("*.pt.trace.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0
    err = capsys.readouterr().err.strip().splitlines()[-1]
    summary = json.loads(err)
    assert summary["spans"]["decoder.traceback"]["n"] >= 1
    assert summary["counters"]["decoder.blocks"] > 0
    assert rec["reads"] == stats.num_reads == 2
    profiling.reset()


@pytest.mark.parametrize("intervals,busy", [
    ([], 0.0), ([(0.0, 1.0)], 1.0),
    # two streams overlapping: the union, not the sum
    ([(0.0, 2.0), (1.0, 3.0)], 3.0), ([(1.0, 3.0), (0.0, 2.0)], 3.0),
    ([(0.0, 4.0), (1.0, 2.0)], 4.0), ([(0.0, 1.0), (2.0, 3.5)], 2.5),
    ([(0.0, 1.0), (1.0, 2.0), (5.0, 6.0)], 3.0),
])
def test_bench_busy_seconds_is_the_union(intervals, busy):
    assert bench.busy_seconds(intervals) == pytest.approx(busy)
