"""Monte-Carlo end-to-end simulation at channel fidelity: sample reads,
render synthetic flip-flop posteriors, decode, CRC/index, vote, RS.

Counterpart of ``nanopore_dna_storage_tpu/pipeline/simulate.py``
(``SimStats``, ``simulate_posts``, ``simulate_and_decode``). The channel
(``signal/channel.py``) and the posterior renderer (``ops/synthetic.py``)
are the reference's numpy modules, so one seed gives the same reads in both
packages.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from nanopore_dna_storage_tpu.coding import conv as convmod
from nanopore_dna_storage_tpu.ops.synthetic import synthetic_post
from nanopore_dna_storage_tpu.signal.channel import simulate_indelsubs

from ..config import ExperimentConfig
from . import EncodeResult
from .decode import PipelineDecoder, majority_vote, recover_file


@dataclasses.dataclass
class SimStats:
    """Outcome counters of ``simulate_and_decode`` (the reference's
    ``top_correct`` / ``list_correct`` belong to its signal-fidelity loop,
    which is not ported)."""

    num_reads: int = 0
    crc_pass: int = 0
    unique_indices: int = 0
    steps: int = 0  # forward block steps the decoders ran


def simulate_posts(oligos: Sequence[str], num_reads: int,
                   rng: np.random.Generator, *,
                   sub_prob: float = 0.004, del_prob: float = 0.0085,
                   ins_prob: float = 0.0005, noise: float = 1.0,
                   stay_prob: float = 0.35):
    """Sample reads (random oligo, random orientation), apply channel errors,
    render synthetic posteriors. Returns (posts, rc_flags, oligo_ids)."""
    posts: List[np.ndarray] = []
    rcs: List[bool] = []
    ids: List[int] = []
    arr = convmod.str_to_bases(list(oligos))
    for _ in range(num_reads):
        oid = int(rng.integers(len(oligos)))
        rc = bool(rng.integers(2))
        bases = arr[oid]
        noisy = simulate_indelsubs(bases if not rc else
                                   convmod.reverse_complement_bases(bases),
                                   rng, sub_prob, del_prob, ins_prob)
        # the emitted read is already oriented; synthetic_post without extra rc
        posts.append(synthetic_post(noisy, rng, rc=False, noise=noise,
                                    stay_prob=stay_prob))
        rcs.append(rc)
        ids.append(oid)
    return posts, np.asarray(rcs), np.asarray(ids)


def simulate_and_decode(enc: EncodeResult, exp: ExperimentConfig,
                        num_reads: int, data_size: int, *, batch: int,
                        list_size: int = 8, seed: int = 0,
                        sub_prob: float = 0.004, del_prob: float = 0.0085,
                        ins_prob: float = 0.0005,
                        max_deviation: Optional[int] = 20, device="cpu"):
    """Full loop: sample reads -> decode -> CRC/index -> vote -> RS -> bytes.

    ``batch`` reads are decoded together; each read holds its selections,
    ``[T, W, 8L, C]`` int8, for the whole decode, so the caller sizes
    ``batch`` to the device memory. Returns (ok, recovered_bytes,
    SimStats).
    """
    rng = np.random.default_rng(seed)
    dec = PipelineDecoder(exp, list_size, max_deviation, device=device)
    num_oligos = enc.num_oligos_data + enc.num_oligos_rs
    stats = SimStats()
    all_idx: List[np.ndarray] = []
    all_payload: List[np.ndarray] = []
    for lo in range(0, num_reads, batch):
        n = min(batch, num_reads - lo)
        posts, rcs, ids = simulate_posts(enc.oligos, n, rng,
                                         sub_prob=sub_prob,
                                         del_prob=del_prob,
                                         ins_prob=ins_prob)
        out = dec.decode_posts(posts, rcs, num_oligos)
        stats.num_reads += n
        stats.crc_pass += int((out.index >= 0).sum())
        all_idx.append(out.index)
        all_payload.append(out.payload)
    indices = np.concatenate(all_idx)
    payloads = np.concatenate(all_payload)
    voted = majority_vote(indices, payloads)
    stats.unique_indices = len(voted)
    stats.steps = dec.steps
    ok, data = recover_file(voted, exp, data_size)
    return ok, data, stats
