"""Decode configuration of the port.

Counterpart of ``nanopore_dna_storage_tpu/config.py`` ``DecodeConfig``. The
reference config validates a JAX backend name and carries the XLA-oracle
dials (``merge_rounds``, ``exact_dedup``, ``window_chunks``) and the TPU
tiling dials (``pallas_ct``, ``pallas_chunk``); none of them has a meaning
here, so the port has its own config. The code, framing and experiment
configs are the reference's own, re-exported.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from nanopore_dna_storage_tpu.config import (ConvCodeConfig,
                                             ExperimentConfig,
                                             FramingConfig)

__all__ = ["ConvCodeConfig", "DecodeConfig", "ExperimentConfig",
           "FramingConfig"]


@dataclasses.dataclass(frozen=True)
class DecodeConfig:
    """List-Viterbi decode parameters (viterbi_convolutional_code.cpp:137-173).

    ``path_combine`` is "max" (the production binary: a duplicate message
    keeps its better score). "logsumexp" (the older binary's
    --use-logsumexp) is not ported yet.
    """

    code: ConvCodeConfig
    list_size: int = 1
    # Beam half-width around the expected diagonal position; None = exact
    # Viterbi (the reference default). Production uses 20.
    max_deviation: Optional[int] = 20
    path_combine: str = "max"

    def __post_init__(self):
        if self.path_combine == "logsumexp":
            raise NotImplementedError(
                "logsumexp path combining is not ported yet")
        if self.path_combine != "max":
            raise ValueError("path_combine must be 'max' or 'logsumexp'")
        if self.list_size < 1:
            raise ValueError("list_size must be >= 1")
