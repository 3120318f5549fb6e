"""Tracing and profiling utilities.

Counterpart of ``nanopore_dna_storage_tpu/utils/profiling.py``. The
reference's observability is a per-read posterior trace dump (flappie
--trace, decode.c:499-543 + fast5_interface.c:126-143, viewed with
misc/trace_flipflop.py) and ad-hoc gprof. Here:

* ``profile(logdir)``: a context manager around ``torch.profiler`` that
  writes a trace of the host and, where a card is present, of the device
  into ``logdir`` (TensorBoard's format; ``chrome://tracing`` reads it);
* ``timed``: wall-clock section timing with a global registry. Where CUDA is
  in use it synchronises before each reading of the clock, so a section
  holds its own device work;
* ``dump_trace_hdf5``: a posterior heat-map dump in an HDF5 layout in the
  spirit of flappie's trace output (a dataset per read, blocks x states).
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Optional

import numpy as np
import torch

_TIMINGS: Dict[str, list] = defaultdict(list)


@contextlib.contextmanager
def profile(logdir: Optional[str]):
    """A ``torch.profiler`` trace into ``logdir`` when it is set; no-op
    otherwise."""
    if not logdir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)):
        yield


def _sync() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


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
