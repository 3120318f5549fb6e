"""The program's own spans and counters (the port's ``utils/profiling.py``),
read after a traced run's window by the metrics of the traceback.

Two passes, each made once a traced run and kept on the ``Context``. Each
decodes the pool's first batch of each orientation (``Context.batch_of``),
and each leaves the program's tracing off and its registry reset:

* ``span_pass``: the program's spans in sync mode (its forward and
  traceback synchronised with the device at both ends), no profiler: the
  seconds inside the program's ``decoder.traceback`` spans and the block
  steps its ``decoder.blocks`` counter counted;
* ``profile_pass``: the spans on without synchronisation, under
  ``torch.profiler``: the CUDA runtime's kernel launches and host
  synchronisations whose host start lies inside a program range, by span
  name, and the block steps. ``offset_spread_us`` is how far the ranges'
  starts minus the spans' starts spread over every span of the pass (one
  offset aligns the two clocks).

Off the card, or where the program has no tracer (a program older than its
spans), a pass returns None and the metrics that read it read nothing.
"""
from __future__ import annotations

import bisect
import contextlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity

TRACEBACK = "decoder.traceback"
BLOCKS = "decoder.blocks"
# CUDA API calls (``cuda*`` and their ``cu*`` forms), by name: kernel
# launches (their ``Ex``, ``ExC`` forms by prefix) and calls that hold the
# host until the device has finished
LAUNCH_PREFIXES = ("cudaLaunchKernel", "cuLaunchKernel")
SYNCS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                   "cudaEventSynchronize", "cudaMemcpy"})


def _tracer():
    """The program's tracer module, or None where it has none."""
    try:
        from nanopore_dna_storage_tpu_torch.utils import profiling
    except ImportError:
        return None
    if all(hasattr(profiling, n) for n in ("tracing", "snapshot", "reset")):
        return profiling
    return None


def _cached(ctx, name: str, make: Callable) -> Optional[dict]:
    done = ctx.__dict__.setdefault("_program_trace", {})
    if name not in done:
        done[name] = make(ctx)
    return done[name]


def _decode_warm_batches(ctx) -> None:
    for rc in (False, True):
        idx = ctx.batch_of(rc)
        if len(idx):
            ctx.call(idx)


def _traced(ctx, tracer, sync: bool,
            around=contextlib.nullcontext()) -> dict:
    """Both warm batches decoded with the program's spans on; its snapshot.
    ``around``, a context manager, encloses the decodes."""
    tracer.reset()
    try:
        with around:
            with tracer.tracing(sync=sync):
                _decode_warm_batches(ctx)
        return tracer.snapshot()
    finally:
        tracer.reset()


def span_pass(ctx) -> Optional[dict]:
    return _cached(ctx, "span", _span_pass)


def _span_pass(ctx) -> Optional[dict]:
    tracer = _tracer()
    if tracer is None or ctx.device.type != "cuda":
        return None
    snap = _traced(ctx, tracer, sync=True)
    if TRACEBACK not in snap["spans"]:
        return None
    return {"traceback_s": snap["spans"][TRACEBACK]["total_s"],
            "blocks": snap["counters"].get(BLOCKS, 0),
            "spans": snap["spans"]}


def profile_pass(ctx) -> Optional[dict]:
    return _cached(ctx, "profile", _profile_pass)


def _profile_pass(ctx) -> Optional[dict]:
    tracer = _tracer()
    if tracer is None or ctx.device.type != "cuda":
        return None
    prof = torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA])
    snap = _traced(ctx, tracer, sync=False, around=prof)
    events = [(e.name, e.time_range.start, e.time_range.end)
              for e in prof.events() if e.device_type == DeviceType.CPU]
    out = reduce_profile(events, snap["raw"])
    if out is None:
        return None
    out["blocks"] = snap["counters"].get(BLOCKS, 0)
    return out


def call_kind(name: str) -> Optional[str]:
    """``launches`` or ``syncs`` for a runtime call's name, else None."""
    if name.startswith(LAUNCH_PREFIXES):
        return "launches"
    if name in SYNCS:
        return "syncs"
    return None


def reduce_profile(events: Sequence[Tuple[str, float, float]],
                   spans: Sequence[Tuple[str, int, int]]) -> Optional[Dict]:
    """Launches and syncs inside the program's ranges.

    ``events``: the profile's host-side events as (name, start us, end us);
    ``spans``: the program's spans of the same pass as (name, t0 ns, t1 ns).
    A program range is an event named as a span; the i-th range of a name
    is the i-th span of that name. Returns ``launches`` and ``syncs``
    inside the ``decoder.traceback`` ranges, ``by_span`` (the two counts
    inside each span name's ranges) and ``offset_spread_us``; None where
    the traceback has no range, or a span no range of its own."""
    names = {n for n, _, _ in spans}
    ranges: Dict[str, List[Tuple[float, float]]] = {n: [] for n in names}
    starts: Dict[str, List[float]] = {"launches": [], "syncs": []}
    for name, s, e in events:
        if name in ranges:
            ranges[name].append((s, e))
        kind = call_kind(name)
        if kind is not None:
            starts[kind].append(s)
    for v in starts.values():
        v.sort()
    offsets = []
    for n in names:
        mine = sorted(t0 / 1e3 for m, t0, _ in spans if m == n)
        if len(ranges[n]) != len(mine):
            return None
        ranges[n].sort()
        offsets += [r[0] - t for r, t in zip(ranges[n], mine)]
    if not ranges.get(TRACEBACK):
        return None
    def inside(times: List[float], n: str) -> int:
        return sum(bisect.bisect_right(times, e) - bisect.bisect_left(times, s)
                   for s, e in ranges[n])

    by_span = {n: {k: inside(v, n) for k, v in starts.items()}
               for n in names}
    return {"launches": by_span[TRACEBACK]["launches"],
            "syncs": by_span[TRACEBACK]["syncs"], "by_span": by_span,
            "offset_spread_us": max(offsets) - min(offsets)}


def per_block(rec: dict, pass_key: str, key: str,
              scale: float = 1.0) -> Optional[float]:
    """``rec[pass_key][key]`` over the pass's block steps, times ``scale``;
    None where the record lacks either."""
    p = rec.get(pass_key)
    if not p or not p.get("blocks") or p.get(key) is None:
        return None
    return scale * p[key] / p["blocks"]
