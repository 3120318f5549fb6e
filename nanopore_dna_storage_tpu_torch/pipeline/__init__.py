"""Pipeline stages of the port.

``decode`` and ``simulate`` are re-hosted here. Encoding and the published
experiment configs are numpy-only, so they are the reference package's own
(``nanopore_dna_storage_tpu/pipeline/encode.py`` and ``experiments.py``),
re-exported.
"""

from nanopore_dna_storage_tpu.pipeline.encode import (EncodeResult,
                                                      encode_bytes,
                                                      encode_file)
from nanopore_dna_storage_tpu.pipeline.experiments import experiment

__all__ = ["EncodeResult", "encode_bytes", "encode_file", "experiment"]
