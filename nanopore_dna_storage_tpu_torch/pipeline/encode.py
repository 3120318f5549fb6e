"""File -> oligos encode pipeline.

In-memory, batched equivalent of helper.encode (reference helper.py:231-273):
pad file to oligo multiple -> RS parity oligos -> PRP index + CRC8 framing ->
convolutional encode -> DNA, plus optional flanking barcodes
(encode_experiments.py:117-128).

The port's own copy of ``nanopore_dna_storage_tpu/pipeline/encode.py`` (numpy only,
unchanged), so that the port imports nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np

from ..config import ConvCodeConfig, ExperimentConfig
from ..coding import conv as convmod
from ..coding.framing import frame_oligos
from ..coding.rs import rs_encode_oligos


@dataclasses.dataclass
class EncodeResult:
    oligos: List[str]  # DNA without barcodes
    oligos_barcoded: List[str]
    msg_len: int
    num_oligos_data: int
    num_oligos_rs: int
    oligo_len: int
    writing_rate: float  # data bits per base (helper.py:272)
    # per-oligo payload bytes incl. RS parity oligos [num_oligos, bpo] —
    # the ground truth for per-read accuracy accounting
    payloads: "np.ndarray" = None


def encode_bytes(data: bytes, exp: ExperimentConfig) -> EncodeResult:
    bpo = exp.bytes_per_oligo
    if bpo % 2:
        raise ValueError("bytes_per_oligo must be even (16-bit RS symbols)")
    data_size = len(data)
    padded_size = math.ceil(data_size / bpo) * bpo
    # reference pads with ASCII '0' bytes (helper.py:249)
    padded = data.ljust(padded_size, b"0")
    num_data, num_rs, num_oligos = exp.oligo_counts(padded_size)
    payloads = np.frombuffer(padded, dtype=np.uint8).reshape(num_data, bpo)
    with_rs = rs_encode_oligos(payloads, num_rs)
    msgs = frame_oligos(with_rs, exp.framing, pad=exp.pad)
    code = convmod.make_conv_code(ConvCodeConfig(
        mem=exp.conv_mem, rate=exp.conv_rate, msg_len=exp.msg_len()))
    bases = convmod.conv_encode_bases(code, msgs)
    oligos = convmod.bases_to_str(bases)
    barcoded = [exp.start_barcode + o + exp.end_barcode for o in oligos]
    oligo_len = len(oligos[0])
    return EncodeResult(
        oligos=oligos,
        oligos_barcoded=barcoded,
        msg_len=exp.msg_len(),
        num_oligos_data=num_data,
        num_oligos_rs=num_rs,
        oligo_len=oligo_len,
        writing_rate=data_size * 8 / (oligo_len * num_oligos),
        payloads=with_rs,
    )


def encode_file(data_file: str, exp: ExperimentConfig) -> EncodeResult:
    with open(data_file, "rb") as f:
        return encode_bytes(f.read(), exp)


def write_fasta(path: str, oligos: List[str], prefix: str = "oligo") -> None:
    with open(path, "w") as f:
        for i, o in enumerate(oligos):
            f.write(f">{prefix}_{i}\n{o}\n")
