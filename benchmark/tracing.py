"""Spans around the calls into the program's layers, and the reduction of a
``torch.profiler`` trace to the device's busy time and its idle gaps.

The spans are recorded from the benchmark's own files: a wrapper around a
layer's entry point takes the host clock at both ends and, while a profiler
runs, opens a ``record_function`` range of the span's name, so that a gap on
the device can be labelled with what the host was doing.
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

WINDOW = "bench.window"


class Spans:
    """Host spans (name, start, end) on ``clock``; with ``annotate`` each is
    also a profiler range."""

    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        self.clock = clock
        self.spans: List[Tuple[str, float, float]] = []
        self.annotate = False

    @contextlib.contextmanager
    def span(self, name: str, sync: Optional[torch.device] = None):
        """A span of ``name``; with ``sync`` (a CUDA device) the device is
        synchronised at both ends, so the span holds the device's work of
        what it wraps and nothing queued before it."""
        rf = (torch.profiler.record_function(name) if self.annotate
              else contextlib.nullcontext())
        with rf:
            if sync is not None:
                torch.cuda.synchronize(sync)
            t0 = self.clock()
            try:
                yield
            finally:
                if sync is not None:
                    torch.cuda.synchronize(sync)
                self.spans.append((name, t0, self.clock()))

    def wrap(self, name: str, fn: Callable, sync=None) -> Callable:
        def wrapped(*args, **kwargs):
            with self.span(name, sync):
                return fn(*args, **kwargs)
        return wrapped


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of [start, end] intervals, as disjoint sorted intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def reduce_trace(events, span_names, top: int = 10) -> Dict:
    """The device's busy time inside the ``WINDOW`` range of a profile.

    ``events``: the profiler's events (``prof.events()``): a device
    operation is an event on a CUDA device that is not a span's range
    mirrored onto the device. Returns ``busy_s`` (the union of the device
    operations' intervals inside the window), ``window_s``, ``device_ops``
    (the ``top`` operations by summed device seconds) and ``idle_gaps``
    (the device's idle seconds by what the host was doing: each gap between
    device operations named by the innermost span the host was in at its
    middle, or ``harness`` outside every span, and summed by name, the
    ``top`` largest); None where the trace holds no window."""
    from torch.autograd import DeviceType

    names = set(span_names) | {WINDOW}
    window = None
    ops, spans = [], []
    for e in events:
        s, t = e.time_range.start / 1e6, e.time_range.end / 1e6
        if e.device_type == DeviceType.CPU:
            if e.name == WINDOW:
                window = (s, t)
            elif e.name in names:
                spans.append((s, t, e.name))
        elif (e.device_type == DeviceType.CUDA and e.name not in names
              and not getattr(e, "is_user_annotation", False)):
            ops.append((s, t, e.name))
    if window is None:
        return None
    w0, w1 = window
    inside = [(max(s, w0), min(t, w1)) for s, t, _ in ops if t > w0 and s < w1]
    busy = union(inside)
    by_name: Dict[str, float] = {}
    for s, t, n in ops:
        by_name[n] = by_name.get(n, 0.0) + (t - s)
    idle: Dict[str, float] = {}
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            mid = (a + b) / 2
            around = [(t - s, n) for s, t, n in spans if s <= mid <= t]
            label = min(around)[1] if around else "harness"
            idle[label] = idle.get(label, 0.0) + (b - a)
    return {"busy_s": sum(t - s for s, t in busy), "window_s": w1 - w0,
            "device_ops": sorted(([n[:120], v] for n, v in by_name.items()),
                                 key=lambda x: -x[1])[:top],
            "idle_gaps": sorted(([n, v] for n, v in idle.items()),
                                key=lambda x: -x[1])[:top]}


def profile(fn: Callable[[], None], spans: Spans, device) -> Optional[Dict]:
    """``fn()`` under ``torch.profiler`` with the spans annotated, reduced
    by ``reduce_trace``."""
    from torch.profiler import ProfilerActivity, record_function

    spans.annotate = True
    try:
        with torch.profiler.profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(WINDOW):
                torch.cuda.synchronize(device)
                fn()
                torch.cuda.synchronize(device)
    finally:
        spans.annotate = False
    return reduce_trace(prof.events(), {n for n, _, _ in spans.spans})
