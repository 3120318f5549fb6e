"""Raw-signal preparation: quantiles, med/MAD normalization, stall trimming.

Numpy equivalents of flappie's signal prep (util.c:100-212,
flappie_common.c:13-81). These run host-side in the input pipeline (shapes are
data-dependent); the normalized, padded batches then stream to the device.

The port's own copy of ``nanopore_dna_storage_tpu/signal/normalize.py`` (numpy only,
unchanged), so that the port imports nothing of the JAX package.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

MAD_SCALE = 1.4826  # util.c:165

# flappie CLI defaults (flappie.c:98-101)
TRIM_START = 200
TRIM_END = 10
VARSEG_CHUNK = 100
VARSEG_THRESH = 0.0


def quantile_linear(x: np.ndarray, p: float) -> float:
    """Sorted linear-interpolation quantile (util.c:100-141)."""
    s = np.sort(np.asarray(x, dtype=np.float32))
    idx = int(p * (len(s) - 1))
    rem = p * (len(s) - 1) - idx
    if idx < len(s) - 1:
        return float((1.0 - rem) * s[idx] + rem * s[idx + 1])
    return float(s[idx])


def medmad_normalize(x: np.ndarray) -> np.ndarray:
    """(x - median) / (MAD_SCALE * mad) (util.c:198-212)."""
    x = np.asarray(x, dtype=np.float32)
    med = np.median(x)
    mad = np.median(np.abs(x - med)) * MAD_SCALE
    if mad == 0:
        mad = 1.0
    return (x - med) / mad


def trim_raw_by_mad(x: np.ndarray, chunk_size: int = VARSEG_CHUNK,
                    perc: float = VARSEG_THRESH) -> Tuple[int, int]:
    """(start, end) sample range after trimming low-variation chunks
    (flappie_common.c:47-81)."""
    x = np.asarray(x, dtype=np.float32)
    nchunk = len(x) // chunk_size
    end = nchunk * chunk_size
    if nchunk == 0:
        return 0, len(x)
    chunks = x[:end].reshape(nchunk, chunk_size)
    med = np.median(chunks, axis=1, keepdims=True)
    mads = np.median(np.abs(chunks - med), axis=1) * MAD_SCALE
    thresh = quantile_linear(mads, perc)
    start = 0
    for m in mads:
        if m > thresh:
            break
        start += chunk_size
    for m in mads[::-1]:
        if m > thresh:
            break
        end -= chunk_size
    return start, end


def trim_and_segment(x: np.ndarray, trim_start: int = TRIM_START,
                     trim_end: int = TRIM_END,
                     varseg_chunk: int = VARSEG_CHUNK,
                     varseg_thresh: float = VARSEG_THRESH
                     ) -> Tuple[int, int]:
    """Full trim: MAD segmentation then fixed start/end trims
    (flappie_common.c:13-28). Returns (start, end); start >= end means the
    read is unusable."""
    start, end = trim_raw_by_mad(x, varseg_chunk, varseg_thresh)
    n = len(x)
    start = start + trim_start if (n - start) > trim_start else n
    end = end - trim_end if end > trim_end else 0
    return start, end
