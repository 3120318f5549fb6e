"""Synthetic flip-flop transition posteriors for tests and benchmarks.

Produces `.post`-layout matrices (nblk x 5 x 8 float32, the format written by
the modified flappie at flappie/src/flappie.c:267-272 and read by
viterbi_convolutional_code.cpp:553-575) directly from a base sequence, walking
the flip/flop CRF state machine with random dwell times and additive noise.
This gives reproducible, non-trivial decoding problems without a basecaller.

CRF transition layout per block (5 x 8):
  rows 0..3: transition into flip state A+..T+ from each of the 8 states;
  row 4:     transition into the unique flop state reachable from each state
             (state j -> flop (j %% 4) + 4).

Frozen copy of ``nanopore_dna_storage_tpu_torch/ops/synthetic.py`` at commit 35018d1,
kept by the benchmark so that its yardstick does not move with the program.
"""
from __future__ import annotations

import numpy as np

NSTATE_CRF = 8
NBASE = 4


def crf_state_path(bases: np.ndarray) -> np.ndarray:
    """Sequence of CRF states visited when emitting ``bases``.

    A new base always enters the flip state of that base, except that a repeat
    of the current base alternates flip->flop->flip (flappie flip-flop rule).
    """
    states = []
    cur = -1
    for b in np.asarray(bases):
        if cur >= 0 and cur % NBASE == b:
            nxt = b + NBASE if cur < NBASE else b
        else:
            nxt = int(b)
        states.append(nxt)
        cur = nxt
    return np.asarray(states, dtype=np.int64)


def transition_cell(st_from: int, st_to: int):
    """(row, col) of transition st_from -> st_to in the 5x8 post matrix."""
    if st_to < NBASE:
        return st_to, st_from
    assert st_to == (st_from % NBASE) + NBASE, "illegal flop transition"
    return NBASE, st_from


def synthetic_post(bases: np.ndarray, rng: np.random.Generator, *,
                   rc: bool = False, noise: float = 1.0,
                   stay_prob: float = 0.35, background: float = -7.0,
                   min_dwell: int = 2, max_dwell: int = 5) -> np.ndarray:
    """Build a synthetic posterior for a read of ``bases`` (0..3).

    Args:
      bases: the forward-strand encoded oligo. If ``rc`` the emitted read is
        its reverse complement (as a sequenced RC read would be).
    Returns:
      float32 [nblk, 5, 8] log-score matrix.
    """
    bases = np.asarray(bases)
    if rc:
        bases = (3 - bases)[::-1]
    states = crf_state_path(bases)
    post_rows = []
    prev = int(states[0])  # first block: enter the first state from itself
    first = True
    for st in states:
        st = int(st)
        dwell = int(rng.integers(min_dwell, max_dwell + 1))
        for d in range(dwell):
            mat = background + noise * rng.standard_normal((NBASE + 1, NSTATE_CRF))
            if d == 0 and not first:
                r, c = transition_cell(prev, st)
            else:
                # stay in state st (first block of the read counts as a stay)
                r, c = transition_cell(st, st) if st < NBASE else (NBASE, st)
            mat[r, c] = noise * 0.25 * rng.standard_normal()
            post_rows.append(mat)
            first = False
        prev = st
    return np.asarray(post_rows, dtype=np.float32)
