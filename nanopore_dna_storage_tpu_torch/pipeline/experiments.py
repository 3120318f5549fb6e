"""The 13 published storage experiments (reference encode_experiments.py:3-113).

Experiment grid: conv memory {8, 11, 14} x rate {1/2, 3/4, 5/6} at RS 30%,
plus m=11 r=3/4 at RS 20% / 40% and two repeats; 25-nt flanking barcodes per
experiment (supplementary section 6). These are configuration data, kept for
drop-in compatibility with the reference's real-read archives.

The port's own copy of ``nanopore_dna_storage_tpu/pipeline/experiments.py`` (numpy only,
unchanged), so that the port imports nothing of the JAX package.
"""
from __future__ import annotations

from typing import List

from ..config import ExperimentConfig

_BARCODE_START = [
    "CTGGCTCCTCTGTATGTTGGAGAAT",
    "TGCGGATGCGGAAGTATGGTCCTCG",
    "AGTAACGCCTATTGATAACGAAGCA",
    "CTGGCGGCCTTGGCCGACTATCTGC",
    "TAGTCCGCGCTCGAATTCCGAGGCC",
    "ATGTTCGGAACGTCAAGACCGAGGA",
    "GCTAGTACGCGAACAGAGTGCAGTA",
    "CACCTGTGCTGCGTCAGGCTGTGTC",
    "CGTACAATCGTATTAGGCACCTTCC",
    "GTATACATTCCTTGCCAACATAGTA",
    "TATCGATTGCATGATACATCCGCAC",
    "GGCCTACCGAGGACCGCTTAGTAGG",
    "GATACTATCGAGATTACTCCAAGTC",
]

_BARCODE_END = [
    "CCTATATGTACCTCTATCGTAAGTC",
    "CACTAGAAGCATGTCGCTATCGAGT",
    "TAACCTTCGCTGCTAGGAACTGTCT",
    "ACCATGTCGTACAGTCGTTGTAACA",
    "TACAAGACTACGCAAGATCGCGCTA",
    "TGGCTCCATTATGCTACAATCACTA",
    "ACAGATGCAGTAATTCTCACGAACT",
    "GCTGTCCGTTCCGCATTGACACGGC",
    "GCGGACCTCCAGATCCACTTGTCTG",
    "TGAATCTGGATACGCGTTCCTCAAC",
    "GACCTGTGGAAGTTCCTCATTACTA",
    "CCTATCATGAATTAGATGCTTGGAC",
    "GCTAGTCGATCCTCTGCTGCAATCG",
]

_RS = [0.3] * 9 + [0.2, 0.4, 0.3, 0.3]
_MEM = [8, 11, 14, 8, 11, 14, 8, 11, 14, 11, 11, 11, 11]
_RATE = [1, 1, 1, 3, 3, 3, 5, 5, 5, 3, 3, 3, 3]
_PAD = [False] * 8 + [True] + [False] * 4
_BPO = [10, 10, 10, 18, 18, 18, 20, 20, 20, 18, 18, 18, 18]

# default list sizes per memory (supplementary section 5.2)
DEFAULT_LIST_SIZE = {8: 64, 11: 8, 14: 4}


def experiment(i: int) -> ExperimentConfig:
    return ExperimentConfig(
        bytes_per_oligo=_BPO[i],
        rs_redundancy=_RS[i],
        conv_mem=_MEM[i],
        conv_rate=_RATE[i],
        pad=_PAD[i],
        start_barcode=_BARCODE_START[i],
        end_barcode=_BARCODE_END[i],
    )


def all_experiments() -> List[ExperimentConfig]:
    return [experiment(i) for i in range(13)]
