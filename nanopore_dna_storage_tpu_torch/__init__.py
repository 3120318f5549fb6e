"""PyTorch / CUDA port of the nanopore DNA storage decode path.

The JAX package ``nanopore_dna_storage_tpu`` is the reference. This package
re-hosts its list-Viterbi decode slice (``sim-decode``: encode -> simulated
reads -> list-Viterbi -> CRC/index -> majority vote -> Reed-Solomon) in
PyTorch, with the per-block ACS step as a CUDA kernel written for Hopper
(``csrc/lva_acs.cu``). It owns copies of the JAX package's numpy-only host
modules (codes, framing, RS, trellis tables, channel, encode) under the
same module paths, and imports neither ``jax`` nor the JAX package. The
decoder entry points run on the card (``device="cuda"``) unless the
caller asks for ``"cpu"``.
"""

from .config import (ConvCodeConfig, DecodeConfig, ExperimentConfig,
                     FramingConfig)

__all__ = ["ConvCodeConfig", "DecodeConfig", "ExperimentConfig",
           "FramingConfig"]
__version__ = "0.1.0"
