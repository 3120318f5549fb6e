"""Pipeline stages of the port.

``decode``, ``simulate`` and ``basecall`` are re-hosted here on the port's
decoder and basecaller chain: channel- and signal-fidelity simulation, and
standalone basecalling from raw signal to fastq / fasta / sam. ``encode``
and ``experiments`` are the port's own numpy copies of the JAX package's
modules of the same names.
"""

from .encode import EncodeResult, encode_bytes, encode_file
from .experiments import experiment

__all__ = ["EncodeResult", "encode_bytes", "encode_file", "experiment"]
