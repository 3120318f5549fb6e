"""Configuration of the port.

``ConvCodeConfig``, ``FramingConfig`` and ``ExperimentConfig`` are the
port's own copies of those in ``nanopore_dna_storage_tpu/config.py``
(unchanged), so that the port imports nothing of the JAX package.
``DecodeConfig`` is the port's own: the reference config validates a JAX
backend name and carries the XLA-oracle dials (``merge_rounds``,
``exact_dedup``, ``window_chunks``) and the TPU tiling dials
(``pallas_ct``, ``pallas_chunk``); none of them has a meaning here.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["CONV_MEMORIES", "CONV_RATES", "ConvCodeConfig", "DecodeConfig",
           "ExperimentConfig", "FramingConfig"]

# Supported convolutional code memories (viterbi_convolutional_code.cpp:269-293).
CONV_MEMORIES = (6, 8, 11, 14)
# Supported rate indices r -> rate (r+1)/(r+2) except r=7 -> 7/8
# (viterbi_convolutional_code.cpp:299-339).
CONV_RATES = (1, 2, 3, 4, 5, 7)


@dataclasses.dataclass(frozen=True)
class ConvCodeConfig:
    """Convolutional inner code parameters.

    Mirrors the parameter surface of `set_conv_params`
    (reference viterbi/viterbi_convolutional_code.cpp:264-415).
    """

    mem: int  # code memory m in {6, 8, 11, 14}
    rate: int  # rate index in {1,2,3,4,5,7} = rates 1/2,2/3,3/4,4/5,5/6,7/8
    msg_len: int  # input message length in bits (incl. index+crc+pad)
    rc: bool = False  # decode a reverse-complemented read
    sync_marker: str = ""  # e.g. "110"; empty = disabled
    sync_period: int = 0

    def __post_init__(self):
        if self.mem not in CONV_MEMORIES:
            raise ValueError(f"mem must be one of {CONV_MEMORIES}, got {self.mem}")
        if self.rate not in CONV_RATES:
            raise ValueError(f"rate must be one of {CONV_RATES}, got {self.rate}")
        if self.sync_marker and self.sync_period < len(self.sync_marker):
            raise ValueError("sync_period shorter than sync marker")


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


@dataclasses.dataclass(frozen=True)
class FramingConfig:
    """Index + CRC framing (reference helper.py:27-32)."""

    index_len: int = 12
    crc_len: int = 8
    prp_a: int = 1751
    prp_b: int = 2532
    prp_a_inv: int = 3303  # modular inverse of prp_a mod 2**index_len


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    """One storage experiment = outer RS + framing + inner conv code.

    Mirrors encode_experiments.py:35-113 plus helper.compute_parameters
    (helper.py:353-363).
    """

    bytes_per_oligo: int
    rs_redundancy: float  # e.g. 0.3 for 30%
    conv_mem: int
    conv_rate: int
    pad: bool = False
    framing: FramingConfig = dataclasses.field(default_factory=FramingConfig)
    start_barcode: str = ""
    end_barcode: str = ""

    def msg_len(self) -> int:
        f = self.framing
        return f.index_len + f.crc_len + 8 * self.bytes_per_oligo + int(self.pad)

    def oligo_counts(self, data_size_padded: int) -> Tuple[int, int, int]:
        """(num_oligos_data, num_oligos_rs, num_oligos). helper.py:353-363."""
        assert data_size_padded % self.bytes_per_oligo == 0
        num_data = data_size_padded // self.bytes_per_oligo
        num_rs = int(num_data * self.rs_redundancy)
        return num_data, num_rs, num_data + num_rs
