"""PyTorch / CUDA port of the nanopore DNA storage decode path.

The JAX package ``nanopore_dna_storage_tpu`` is the reference. This package
re-hosts in PyTorch:

* its list-Viterbi decode slice (``sim-decode``: encode -> simulated reads
  -> list-Viterbi -> CRC/index -> majority vote -> Reed-Solomon), with the
  per-block ACS step as a CUDA kernel written for Hopper
  (``csrc/lva_acs.cu``; logsumexp combining in ``csrc/lva_lse.cu``);
* its basecaller chain, from raw signal to decoded lists: the flip-flop
  network (``models/flipflop.py``), the CRF forward-backward posteriors
  (``ops/fwdbwd.py``), the Viterbi basecall (``ops/crf_decode.py``),
  ``pipeline/basecall.py`` and the signal-fidelity simulation
  (``pipeline/simulate.py``), in plain PyTorch as the JAX package runs
  it in XLA; the weight parsers ``models/weights.py`` and
  ``models/import_taiyaki.py``;
* the TPU probe scripts' kernels, as hand-written CUDA (``probes/``).

It owns copies of the JAX package's numpy-only host modules (codes,
framing, RS, trellis tables, channel, encode, signal normalisation and
squiggle, weight parsers) under the same module paths, and imports neither
``jax`` nor the JAX package. The entry points run on the card
(``device="cuda"``) unless the caller asks for ``"cpu"``.
"""

from .config import (ConvCodeConfig, DecodeConfig, ExperimentConfig,
                     FramingConfig)

__all__ = ["ConvCodeConfig", "DecodeConfig", "ExperimentConfig",
           "FramingConfig"]
__version__ = "0.1.0"
