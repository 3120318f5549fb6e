"""Monte-Carlo end-to-end simulation (the reference's simulator.py and
helper.simulate_and_decode, helper.py:275-351), batched.

Counterpart of ``nanopore_dna_storage_tpu/pipeline/simulate.py``
(``SimStats``, ``simulate_posts``, ``simulate_and_decode``,
``simulate_posts_signal``, ``simulate_and_decode_signal``), at two channel
fidelities:

* ``channel``: sequence-level sub/del/ins errors rendered straight into
  synthetic flip-flop posteriors (``ops/synthetic.py``);
* ``signal``: squiggle synthesis (``signal/squiggle.py``), then the
  basecaller's network and its forward-backward posteriors on the device,
  from a basecaller the caller gives or one trained from scratch on the
  hermetic pore model (``models/train.py``).

The channel, the posterior renderer, the squiggle and the normalisation are
the port's own copies of the reference's numpy modules, so one seed gives
the same reads in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..coding import conv as convmod
from ..config import ExperimentConfig
from ..models import flipflop as ff
from ..models import train as trainmod
from ..ops.fwdbwd import batched_transition_posteriors
from ..ops.synthetic import synthetic_post
from ..signal.channel import simulate_indelsubs
from ..signal.normalize import medmad_normalize
from ..signal.squiggle import simulate_raw_signal
from ..utils.profiling import timed
from . import EncodeResult
from .decode import PipelineDecoder, majority_vote, recover_file


@dataclasses.dataclass
class SimStats:
    """Outcome counters of ``simulate_and_decode`` and, with ``top_correct``
    and ``list_correct``, of ``simulate_and_decode_signal``."""

    num_reads: int = 0
    top_correct: int = 0
    list_correct: int = 0
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


def simulate_raw_reads(oligos: Sequence[str], num_reads: int,
                       rng: np.random.Generator, *, kmer: int = 6,
                       deepsim_dwell: bool = False, profile=None):
    """The host half of ``simulate_posts_signal``: random oligo, random
    orientation, raw signal from the pore model, drawn from ``rng`` in the
    reference's order. Returns (raw signals, rc_flags, ids).

    ``profile`` (signal/squiggle.ChannelProfile) injects real-data
    failure modes: junk (unaligned-analog) and chimeric reads carry
    id=-1 — they are never countable as correct, like real reads that
    align to no oligo — plus untrimmed flank bases and the profile's
    burst/drift signal degradations.
    """
    arr = convmod.str_to_bases(list(oligos))
    raws, rcs, ids = [], [], []
    for _ in range(num_reads):
        oid = int(rng.integers(len(oligos)))
        rc = bool(rng.integers(2))
        bases = arr[oid] if not rc else convmod.reverse_complement_bases(
            arr[oid])
        if profile is not None:
            u = rng.random()
            if u < profile.junk_frac:
                # unaligned-read analog: unrelated sequence of this length
                bases = rng.integers(0, 4, len(bases)).astype(bases.dtype)
                oid = -1
            elif u < profile.junk_frac + profile.chimeric_frac:
                # chimera: prefix of this read + suffix of another
                o2 = int(rng.integers(len(oligos)))
                b2 = arr[o2] if not rng.integers(2) else \
                    convmod.reverse_complement_bases(arr[o2])
                cut = int(rng.integers(len(bases) // 5,
                                       4 * len(bases) // 5 + 1))
                bases = np.concatenate(
                    [bases[:cut], b2[len(b2) - (len(bases) - cut):]])
                oid = -1
            if profile.flank_bases > 0:
                pre = rng.integers(0, 4, rng.integers(
                    0, profile.flank_bases + 1)).astype(bases.dtype)
                post_fl = rng.integers(0, 4, rng.integers(
                    0, profile.flank_bases + 1)).astype(bases.dtype)
                bases = np.concatenate([pre, bases, post_fl])
        raws.append(simulate_raw_signal(bases, rng,
                                        deepsim_dwell=deepsim_dwell,
                                        kmer=kmer, profile=profile))
        rcs.append(rc)
        ids.append(oid)
    return raws, np.asarray(rcs), np.asarray(ids)


def signal_batch(raws: Sequence[np.ndarray], multiple: int = 16):
    """Raw signals medmad-normalised and zero-padded to one length, a
    multiple of ``multiple``: (signal [B, T] float32, nsamples [B] int64)."""
    normed = [medmad_normalize(r) for r in raws]
    T = -(-max(len(r) for r in normed) // multiple) * multiple
    sig = np.zeros((len(normed), T), np.float32)
    ns = np.zeros(len(normed), np.int64)
    for i, r in enumerate(normed):
        sig[i, : len(r)] = r
        ns[i] = len(r)
    return sig, ns


def simulate_posts_signal(oligos: Sequence[str], num_reads: int,
                          rng: np.random.Generator, params,
                          model_cfg: Optional[ff.FlipflopConfig] = None, *,
                          kmer: int = 6, deepsim_dwell: bool = False,
                          profile=None, device="cuda"):
    """Signal-fidelity read simulation: squiggle synthesis -> the
    basecaller's network -> forward-backward transition posteriors.

    The full simulator.py loop (simulator.py:59-116) with no
    synthetic-posterior shortcut: the reads of ``simulate_raw_reads``,
    medmad-normalised and padded to a multiple of 16 samples
    (``signal_batch``), then the flip-flop network and transpost on
    ``device``, the card unless the caller passes ``"cpu"``. ``params``: a
    ``FlipflopNet`` or a parameter dict (``models/flipflop.py``
    ``as_net``). Returns (posts, rc_flags, ids).
    """
    net = ff.as_net(params, model_cfg, device)
    raws, rcs, ids = simulate_raw_reads(oligos, num_reads, rng, kmer=kmer,
                                        deepsim_dwell=deepsim_dwell,
                                        profile=profile)
    sig, ns = signal_batch(raws)
    nsamples = torch.from_numpy(ns).to(net.device)
    trans = net(torch.from_numpy(sig).to(net.device), nsamples)
    posts = batched_transition_posteriors(
        trans, -(-nsamples // net.cfg.stride)).cpu().numpy()
    nblk = -(-ns // net.cfg.stride)
    return [posts[i, : nblk[i]] for i in range(num_reads)], rcs, ids


def simulate_and_decode_signal(enc: EncodeResult, exp: ExperimentConfig,
                               num_reads: int, *, params=None,
                               model_cfg: Optional[ff.FlipflopConfig] = None,
                               list_size: int = 8, seed: int = 0,
                               max_deviation: Optional[int] = 20,
                               train_steps: int = 300, kmer: int = 1,
                               learning_rate: float = 1e-2,
                               lr_schedule: bool = False,
                               batch: int = 16, train_seq_len: int = 40,
                               profile=None, device="cuda", **decode_kw):
    """End-to-end SIGNAL-fidelity Monte-Carlo decode accuracy:
    msg -> conv encode -> squiggle -> basecaller -> fwd-bwd -> list-Viterbi
    -> CRC/index classification, per-read accuracy as in the
    simulator.py:59-116 loop. Returns (SimStats, params): the caller's
    ``params`` as given, or the net trained here.

    Without ``params`` (a ``FlipflopNet`` or a parameter dict) it first
    trains a basecaller from scratch on the hermetic pore model
    (``models/train.py`` ``train_on_synthetic``: ``train_steps`` steps of 8
    reads of ``train_seq_len`` bases, Adam at ``learning_rate``, warm-up
    and cosine under ``lr_schedule``, seeded with ``seed``). kmer=1 keeps
    it trainable in seconds; kmer=6 is the production pore model and needs
    the schedule and longer training. ``model_cfg`` defaults to the
    reference's small trainable model; ``device`` runs the training, the
    network, the posteriors and the decode. The training and the decode
    are timed apart (``utils/profiling.timed``, sections
    ``simulate_signal/train`` and ``simulate_signal/decode``).
    """
    if model_cfg is None:
        model_cfg = ff.FlipflopConfig(winlen=7, stride=2, conv_filters=16,
                                      hidden=32, layer_dirs=("b", "f"))
    if params is None:
        with timed("simulate_signal/train"):
            state, _ = trainmod.train_on_synthetic(
                model_cfg, steps=train_steps, batch=8,
                seq_len=train_seq_len, seed=seed,
                learning_rate=learning_rate, schedule=lr_schedule,
                kmer=kmer, device=device)
        params = state.net.requires_grad_(False)
    with timed("simulate_signal/decode"):
        net = ff.as_net(params, model_cfg, device)
        rng = np.random.default_rng(seed + 1)
        dec = PipelineDecoder(exp, list_size, max_deviation, device=device,
                              **decode_kw)
        num_oligos = enc.num_oligos_data + enc.num_oligos_rs
        stats = SimStats()
        seen = set()
        for lo in range(0, num_reads, batch):
            n = min(batch, num_reads - lo)
            posts, rcs, ids = simulate_posts_signal(
                enc.oligos, n, rng, net, kmer=kmer, profile=profile,
                device=device)
            out = dec.decode_posts(posts, rcs, num_oligos)
            stats.num_reads += n
            stats.crc_pass += int((out.index >= 0).sum())
            for j in range(n):
                if out.index[j] < 0 or int(out.index[j]) != int(ids[j]):
                    continue
                stats.list_correct += 1
                seen.add(int(ids[j]))
                # top = the CRC-passing candidate sits in list slot 0
                if out.valid[j, 0] and (out.msgs[j, 0]
                                        == out.chosen_msg[j]).all():
                    stats.top_correct += 1
        stats.unique_indices = len(seen)
        stats.steps = dec.steps
    return stats, params


def simulate_and_decode(enc: EncodeResult, exp: ExperimentConfig,
                        num_reads: int, data_size: int, *, batch: int,
                        list_size: int = 8, seed: int = 0,
                        sub_prob: float = 0.004, del_prob: float = 0.0085,
                        ins_prob: float = 0.0005,
                        max_deviation: Optional[int] = 20, device="cuda"):
    """Full loop: sample reads -> decode -> CRC/index -> vote -> RS -> bytes.

    ``batch`` reads are decoded together; each read holds its selections,
    ``[T, W, 8L, C]`` int8, for the whole decode, so the caller sizes
    ``batch`` to the device memory. The decode runs on ``device``, the
    card unless the caller passes ``"cpu"``. Returns (ok, recovered_bytes,
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
