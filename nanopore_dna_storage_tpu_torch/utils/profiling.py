"""Tracing and profiling utilities: the program's one tracer.

Counterpart of ``nanopore_dna_storage_tpu/utils/profiling.py``. The
reference's observability is a per-read posterior trace dump (flappie
--trace, decode.c:499-543 + fast5_interface.c:126-143, viewed with
misc/trace_flipflop.py) and ad-hoc gprof. Here:

* ``span(name, sync=False)``: a span of the program's own work, placed where
  the work happens (``pipeline/decode.py``, ``ops/lva.py``). Spans are off
  by default, and then a span is one shared no-op context manager: it reads
  no clock and touches no CUDA. Inside ``tracing(sync)`` a span reads
  ``time.perf_counter_ns`` at both ends and records ``(name, t0, t1)``;
  while a ``torch.profiler`` records, it also opens a profiler range of
  the same name and reads its clock inside it, so one offset aligns the
  spans with the profiler's trace. In sync mode (``tracing(sync=True)``) a
  span made with ``sync=True`` synchronises the device before each of its
  clock readings, so that it holds its own device work and nothing queued
  before it;
* ``count(name, n=1)``: counters that always count (``counter`` reads
  one); ``snapshot`` and ``reset`` read and clear spans, counters and the
  section registry;
* ``timed``: wall-clock section timing into the registry that spans also
  write. Where CUDA is in use it synchronises before each reading of the
  clock, so a section holds its own device work;
* ``profile(logdir)``: a context manager around ``torch.profiler`` that
  writes a trace of the host and, where a card is present, of the device
  into ``logdir`` (TensorBoard's format; ``chrome://tracing`` reads it),
  with spans on, so the trace carries the program's ranges;
* ``dump_trace_hdf5``: a posterior heat-map dump in an HDF5 layout in the
  spirit of flappie's trace output (a dataset per read, blocks x states).

Spans and counters of the decode (PERF.md section 3 names the metric that
reads each): ``pipeline.decode_posts``, ``pipeline.pack_posts``,
``pipeline.classify``; ``decoder.decode``, ``decoder.schedule``,
``decoder.copy_in``, ``decoder.forward``, ``decoder.traceback``,
``decoder.order``, ``decoder.copy_out``, ``decoder.unpack``; the counters
``decoder.blocks`` (block steps a decode runs, T a call), ``acs.launches``
and ``acs.lse_launches`` (the ACS kernels' launches), ``traceback.launches``
(the traceback kernel's, one a decode on the card).
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

# seconds by name: ``timed``'s sections and the spans' durations
_TIMINGS: Dict[str, list] = defaultdict(list)
# (name, t0 ns, t1 ns) of every span recorded while tracing
_SPANS: List[Tuple[str, int, int]] = []
_COUNTERS: Dict[str, int] = defaultdict(int)
# None: spans off; False: spans on; True: on, and sync=True spans synchronise
_MODE: Optional[bool] = None


def _sync() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _profiler_range(name: str):
    """A ``torch.profiler`` range of ``name``, or None when no profiler
    records. The fast form where torch has it: the public
    ``record_function`` enters through the dispatcher, which puts 10-30 us
    of jitter between the range's start and the caller's clock."""
    if not torch._C._autograd._profiler_enabled():
        return None
    fast = getattr(torch._C._profiler, "_RecordFunctionFast", None)
    return fast(name) if fast is not None else \
        torch.profiler.record_function(name)


# the span of tracing off, shared by every call
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "sync", "range", "t0")

    def __init__(self, name: str, sync: bool):
        self.name, self.sync = name, sync

    def __enter__(self):
        if self.sync:
            _sync()
        self.range = _profiler_range(self.name)
        if self.range is not None:
            self.range.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self.sync:
            _sync()
        t1 = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        _SPANS.append((self.name, self.t0, t1))
        _TIMINGS[self.name].append((t1 - self.t0) / 1e9)
        return False


def span(name: str, sync: bool = False):
    """A span of ``name`` around the work it encloses: the shared no-op while
    tracing is off; with ``sync`` the device is synchronised before each
    clock reading, in sync mode only."""
    if _MODE is None:
        return _OFF
    return _Span(name, sync and _MODE)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name``; counters count whether or not spans
    are on."""
    _COUNTERS[name] += n


def counter(name: str) -> int:
    """Counter ``name``'s value (0 before its first count)."""
    return _COUNTERS.get(name, 0)


@contextlib.contextmanager
def tracing(sync: bool = False):
    """Spans on inside the context (``sync``: sync mode); the mode before it
    is restored after."""
    global _MODE
    before, _MODE = _MODE, bool(sync)
    try:
        yield
    finally:
        _MODE = before


def snapshot() -> Dict[str, object]:
    """``spans``: count and total seconds by span name; ``raw``: every span
    as (name, t0 ns, t1 ns) on ``time.perf_counter_ns``; ``counters``."""
    spans: Dict[str, Dict[str, float]] = {}
    for name, t0, t1 in _SPANS:
        s = spans.setdefault(name, {"n": 0, "total_s": 0.0})
        s["n"] += 1
        s["total_s"] += (t1 - t0) / 1e9
    return {"spans": spans, "raw": list(_SPANS),
            "counters": dict(_COUNTERS)}


def reset() -> None:
    """Clear the spans, the counters and the section registry."""
    _SPANS.clear()
    _COUNTERS.clear()
    _TIMINGS.clear()


@contextlib.contextmanager
def profile(logdir: Optional[str]):
    """A ``torch.profiler`` trace into ``logdir`` when it is set, with spans
    on while it records; no-op otherwise."""
    if not logdir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)):
        with tracing(sync=False):
            yield


@contextlib.contextmanager
def timed(name: str):
    _sync()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _sync()
        _TIMINGS[name].append(time.perf_counter() - t0)


def timing_summary() -> Dict[str, Dict[str, float]]:
    return {k: {"n": len(v), "total_s": float(np.sum(v)),
                "mean_s": float(np.mean(v))}
            for k, v in _TIMINGS.items()}


def reset_timings() -> None:
    _TIMINGS.clear()


def dump_trace_hdf5(path: str, posteriors: Dict[str, np.ndarray],
                    scale: float = 255.0) -> None:
    """Posterior trace dump: per read, a uint8 heat map [T, 40] like
    flappie's trace output (probability * 255, fast5_interface.c:126-143)
    from each read's log-posteriors."""
    import h5py

    with h5py.File(path, "w") as f:
        for rid, post in posteriors.items():
            p = np.exp(np.asarray(post, np.float32).reshape(post.shape[0], -1))
            f.create_dataset(rid, data=np.clip(p * scale, 0, 255)
                             .astype(np.uint8))


def read_length_histogram(fastq_path: str) -> Dict[int, int]:
    """Read-length histogram from a fastq (util/read_length_distribution.cpp)."""
    hist: Dict[int, int] = defaultdict(int)
    with open(fastq_path) as f:
        for i, line in enumerate(f):
            if i % 4 == 1:
                hist[len(line.rstrip("\n"))] += 1
    return dict(hist)
