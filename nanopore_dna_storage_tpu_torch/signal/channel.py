"""Synthesis/sequencing error channel: iid substitutions, deletions,
insertions over a base sequence (reference helper.simulate_indelsubs,
helper.py:34-64).

Vectorized formulation: instead of the reference's per-character python loop,
we draw per-position deletion/substitution fates and insertion run lengths
(geometric, matching the Bernoulli-per-slot process) in bulk.

The port's own copy of ``nanopore_dna_storage_tpu/signal/channel.py`` (numpy only,
unchanged), so that the port imports nothing of the JAX package.
"""
from __future__ import annotations

import numpy as np


def simulate_indelsubs(bases: np.ndarray, rng: np.random.Generator,
                       sub_prob: float = 0.0, del_prob: float = 0.0,
                       ins_prob: float = 0.0) -> np.ndarray:
    """Apply iid channel errors to a base-index sequence (0..3)."""
    bases = np.asarray(bases)
    n = len(bases)
    # insertion runs before each kept position and at the end: geometric
    nins = rng.geometric(1.0 - ins_prob, size=n + 1) - 1 if ins_prob > 0 \
        else np.zeros(n + 1, dtype=np.int64)
    dels = rng.random(n) < del_prob
    subs = rng.random(n) < sub_prob
    out = []
    for i in range(n):
        if nins[i]:
            out.extend(rng.integers(0, 4, nins[i]))
        if dels[i]:
            continue
        if subs[i]:
            # substitute uniformly among the other three bases
            out.append((bases[i] + 1 + rng.integers(0, 3)) % 4)
        else:
            out.append(bases[i])
    if nins[n]:
        out.extend(rng.integers(0, 4, nins[n]))
    return np.asarray(out, dtype=np.uint8)
