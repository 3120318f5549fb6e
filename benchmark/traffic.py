"""The one traffic generator: a deployment's file, encoded, read back as a pool
of simulated reads, and cut into the decode calls of a traffic mix.

A configuration file (``configs/<name>.json``) gives the deployment: the
experiment's code and framing, the file size, the list size and beam, and
the channel. A traffic file (``traffic/<name>.json``) gives the mix:

* ``batch``: reads a call;
* ``pool_reads``: reads simulated, cycled through the window;
* ``rc_share``: the share of them read in reverse-complement orientation,
  exact in every pool (so every seed decodes the same amount of work);
* ``grouping``: ``orientation`` puts reads of one orientation into each
  call, calls alternating between the two; ``arrival`` keeps the draw
  order, so a call holds both orientations;
* ``check_reads``: reads of the window whose lists the plain reference
  decodes again after it, the longest among them (``check.sample``);
* ``reference_chunk``: reads of one orientation the reference decodes at
  once, as many as the card's memory holds at the configuration's sizes.

Everything is drawn from one generator of ``--seed``. The encoder and the
read simulation are the frozen copies under ``frozen/``: the file is padded
to whole oligos, RS parity oligos appended, each framed with its PRP index
and CRC8 and convolutionally encoded (``pipeline/encode.py``
``encode_bytes``); a read picks an oligo and an orientation, takes iid
substitutions, deletions and insertions, and is rendered into synthetic
flip-flop posteriors (``pipeline/simulate.py`` ``simulate_posts``), as in
``nanopore_dna_storage_tpu_torch`` at commit 35018d1.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np

from .frozen import conv as convmod
from .frozen.channel import simulate_indelsubs
from .frozen.config import ConvCodeConfig, ExperimentConfig, FramingConfig
from .frozen.framing import frame_oligos
from .frozen.rs import rs_encode_oligos
from .frozen.synthetic import synthetic_post


def experiment(config: dict) -> ExperimentConfig:
    """The configuration's experiment, as the frozen ``ExperimentConfig``."""
    return ExperimentConfig(
        bytes_per_oligo=config["bytes_per_oligo"],
        rs_redundancy=config["rs_redundancy"], conv_mem=config["conv_mem"],
        conv_rate=config["conv_rate"], pad=config["pad"],
        framing=FramingConfig(**config["framing"]))


def code_config(config: dict, rc: bool = False) -> ConvCodeConfig:
    exp = experiment(config)
    return ConvCodeConfig(mem=exp.conv_mem, rate=exp.conv_rate,
                          msg_len=exp.msg_len(), rc=rc)


@dataclasses.dataclass
class Pool:
    """A deployment's reads and the calls of a mix over them."""

    posts: List[np.ndarray]  # [T_i, 5, 8] float32 each
    rc: np.ndarray  # [n] bool
    oligo: np.ndarray  # [n] int64, the oligo each read came from
    payloads: np.ndarray  # [num_oligos, bytes_per_oligo] uint8, with RS
    num_oligos: int
    calls: List[np.ndarray]  # read indices of each call

    def nblks(self) -> np.ndarray:
        return np.asarray([len(p) for p in self.posts], np.int64)


def generator(seed: int) -> np.random.Generator:
    """The run's generator; any whole number is a seed."""
    return np.random.default_rng(seed % 2**64)


def encode(data: bytes, exp: ExperimentConfig):
    """(bases uint8 [num_oligos, n_bases], payloads with RS [num_oligos,
    bytes_per_oligo]) of ``data``: ``encode_bytes`` of the frozen copy."""
    bpo = exp.bytes_per_oligo
    padded_size = math.ceil(len(data) / bpo) * bpo
    padded = data.ljust(padded_size, b"0")
    num_data, num_rs, _ = exp.oligo_counts(padded_size)
    payloads = np.frombuffer(padded, dtype=np.uint8).reshape(num_data, bpo)
    with_rs = rs_encode_oligos(payloads, num_rs)
    msgs = frame_oligos(with_rs, exp.framing, pad=exp.pad)
    code = convmod.make_conv_code(ConvCodeConfig(
        mem=exp.conv_mem, rate=exp.conv_rate, msg_len=exp.msg_len()))
    return convmod.conv_encode_bases(code, msgs), with_rs


def make_pool(config: dict, traffic: dict, seed: int) -> Pool:
    """The pool of a cell: the file, its oligos, its reads, its calls."""
    rng = generator(seed)
    data = rng.integers(0, 256, config["file_bytes"], dtype=np.uint8)
    bases, payloads = encode(data.tobytes(), experiment(config))
    ch = config["channel"]
    n, batch = traffic["pool_reads"], traffic["batch"]
    n_rc = round(n * traffic["rc_share"])
    rc = rng.permutation(np.arange(n) < n_rc)
    oligo = rng.integers(0, len(bases), n)
    posts = []
    for oid, flag in zip(oligo, rc):
        b = bases[oid]
        noisy = simulate_indelsubs(
            convmod.reverse_complement_bases(b) if flag else b, rng,
            ch["sub_prob"], ch["del_prob"], ch["ins_prob"])
        posts.append(synthetic_post(noisy, rng, rc=False, noise=ch["noise"],
                                    stay_prob=ch["stay_prob"]))
    if traffic["grouping"] == "orientation":
        groups = [np.nonzero(~rc)[0], np.nonzero(rc)[0]]
        parts = [[g[i:i + batch] for i in range(0, len(g), batch)]
                 for g in groups]
        calls = [c for pair in zip(*parts) for c in pair]
        calls += parts[0][len(parts[1]):] + parts[1][len(parts[0]):]
    elif traffic["grouping"] == "arrival":
        calls = [np.arange(i, min(i + batch, n)) for i in range(0, n, batch)]
    else:
        raise ValueError(f"unknown grouping {traffic['grouping']!r}")
    return Pool(posts=posts, rc=rc, oligo=oligo, payloads=payloads,
                num_oligos=len(bases), calls=calls)
