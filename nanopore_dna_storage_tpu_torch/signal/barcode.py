"""Barcode localization in the basecall and posterior truncation.

Vectorized rebuild of find_barcode_pos_in_post + truncate_post_file
(reference helper.py:157-224): scan the start barcode over the first half of
the basecall and the end barcode over the second half by Levenshtein
distance, map the best matches through the per-base block indices (the
``.trans`` data) to a [start, end] block window of the posterior.

The per-window edit distances are computed with a single DP whose inner two
loops run over the (short) barcode, vectorized across all window positions —
O(|barcode|^2 * n) total instead of n independent python-level DPs.

The port's own copy of ``nanopore_dna_storage_tpu/signal/barcode.py`` (numpy
only, unchanged), so that the port imports nothing of the JAX package.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def levenshtein_windows(needle: str, haystack: str,
                        starts: np.ndarray, wlen: int) -> np.ndarray:
    """Edit distance between ``needle`` and haystack[s:s+wlen] for each s."""
    nl = len(needle)
    hs = np.frombuffer(haystack.encode(), dtype=np.uint8)
    nd = np.frombuffer(needle.encode(), dtype=np.uint8)
    starts = np.asarray(starts)
    nwin = len(starts)
    # windows matrix [nwin, wlen]
    win = hs[starts[:, None] + np.arange(wlen)[None, :]]
    # DP over (needle x window) vectorized across windows
    prev = np.broadcast_to(np.arange(wlen + 1), (nwin, wlen + 1)).copy()
    for i in range(1, nl + 1):
        curr = np.empty_like(prev)
        curr[:, 0] = i
        for j in range(1, wlen + 1):
            sub = prev[:, j - 1] + (win[:, j - 1] != nd[i - 1])
            curr[:, j] = np.minimum(np.minimum(prev[:, j] + 1,
                                               curr[:, j - 1] + 1), sub)
        prev = curr
    return prev[:, -1]


def levenshtein(a: str, b: str) -> int:
    if len(b) == 0:
        return len(a)
    return int(levenshtein_windows(a, b, np.array([0]), len(b))[0])


def find_barcode_window(basecall: str, trans_arr: np.ndarray,
                        start_barcode: str, end_barcode: str
                        ) -> Tuple[int, int, float, float]:
    """(start_pos, end_pos, start_dist, end_dist) in posterior blocks.

    Mirrors helper.py:157-209: the start barcode is searched in the first
    half of the basecall, the end barcode in the second half; the posterior
    window is [trans[start_match_end + 1] - 1, trans[end_match_start - 1] - 1].
    Returns (-1, -1, inf, inf) on failure.
    """
    n = len(basecall)
    sl, el = len(start_barcode), len(end_barcode)
    if sl + el > n:
        return (-1, -1, np.inf, np.inf)
    s_starts = np.arange(n // 2 + 1 - sl)
    if len(s_starts) == 0:
        return (-1, -1, np.inf, np.inf)
    s_dist = levenshtein_windows(start_barcode, basecall, s_starts, sl)
    e_starts = np.arange(n // 2, n - el)
    if len(e_starts) == 0:
        return (-1, -1, np.inf, np.inf)
    e_dist = levenshtein_windows(end_barcode, basecall, e_starts, el)

    s_first = int(np.argmin(s_dist))
    e_first = n // 2 + int(np.argmin(e_dist))
    s_last = s_first + sl - 1
    trans_arr = np.asarray(trans_arr)
    start_pos = int(trans_arr[s_last + 1]) - 1
    end_pos = int(trans_arr[e_first - 1]) - 1
    if end_pos < start_pos:
        return (-1, -1, np.inf, np.inf)
    return (start_pos, end_pos, float(s_dist.min()), float(e_dist.min()))


def truncate_post(post: np.ndarray, start_pos: int, end_pos: int) -> np.ndarray:
    """post [T, 5, 8] -> blocks [start_pos, end_pos] inclusive
    (helper.py:211-224)."""
    assert end_pos >= start_pos and post.shape[0] >= end_pos + 1
    return post[start_pos: end_pos + 1]
