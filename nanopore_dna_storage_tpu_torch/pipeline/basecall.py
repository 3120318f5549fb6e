"""Standalone basecalling: raw signal -> fastq / fasta / sam, in PyTorch.

Counterpart of ``nanopore_dna_storage_tpu/pipeline/basecall.py``, flappie's
per-read flow (flappie.c:235-305): trim and med/MAD normalise on the host,
then on the device the flip-flop network, the forward-backward posteriors
and the Viterbi basecall over them; per-base phred qualities from the
chosen transitions' posteriors (util.h:196-217); fastq / fasta / sam out
(flappie_output.c:69-133). Reads are padded to a multiple of ``bucket``
samples and run as one batch.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models import flipflop as ff
from ..ops.crf_decode import basecall_from_path, viterbi_flipflop_batch
from ..ops.fwdbwd import batched_transition_posteriors
from ..signal.normalize import medmad_normalize, trim_and_segment

MAX_POST_PROB = 0.99999  # util.h clip


def phred_char(p: np.ndarray) -> np.ndarray:
    p = np.clip(p, 0.0, MAX_POST_PROB)
    q = -(10.0 * np.log10(np.e)) * np.log1p(-p)
    return np.clip(np.round(33.0 + q), 33, 126).astype(np.uint8)


@dataclasses.dataclass
class Basecall:
    read_id: str
    sequence: str
    quality: str
    block_index: np.ndarray  # block of each base (the .trans data)
    score: float
    nblocks: int
    trimmed: Tuple[int, int]
    posterior: Optional[np.ndarray] = None  # [T,5,8] log posteriors


class Basecaller:
    """The basecaller on one torch device, ``cuda`` unless the caller asks
    for ``cpu``. ``params``: a ``FlipflopNet`` or a parameter dict
    (``models/flipflop.py`` ``as_net``); None draws ``init_params`` from a
    ``torch.Generator`` seeded with ``seed``."""

    def __init__(self, params=None, cfg: Optional[ff.FlipflopConfig] = None,
                 seed: int = 0, *, device="cuda"):
        self.device = torch.device(device)
        if params is None:
            cfg = cfg or ff.FlipflopConfig()
            params = ff.init_params(cfg, torch.Generator().manual_seed(seed))
        self.net = ff.as_net(params, cfg, self.device)
        self.cfg = self.net.cfg

    def _run(self, signal: np.ndarray, nsamples: np.ndarray):
        """The device part on a padded batch: signal [B, T] float32 and
        nsamples [B] -> (posteriors [B, T', 5, 8], paths [B, T' + 1],
        scores [B]) as numpy arrays."""
        sig = torch.from_numpy(signal).to(self.device)
        ns = torch.from_numpy(np.asarray(nsamples, np.int64)).to(self.device)
        trans = self.net(sig, ns)
        nblk = -(-ns // self.cfg.stride)
        post = batched_transition_posteriors(trans, nblk)
        paths, scores = viterbi_flipflop_batch(post, nblk)
        return post.cpu().numpy(), paths.cpu().numpy(), scores.cpu().numpy()

    def basecall(self, read_ids: Sequence[str],
                 signals: Sequence[np.ndarray], *, trim: bool = True,
                 keep_posterior: bool = False,
                 bucket: int = 512) -> List[Basecall]:
        """Basecall a batch of raw signals (variable length, padded)."""
        prepped = []
        ranges = []
        for sig in signals:
            if trim:
                s, e = trim_and_segment(sig)
                if s >= e:
                    s, e = 0, len(sig)
            else:
                s, e = 0, len(sig)
            prepped.append(medmad_normalize(sig[s:e]))
            ranges.append((s, e))
        ns = np.asarray([len(p) for p in prepped], np.int32)
        T = -(-int(ns.max()) // bucket) * bucket
        batch = np.zeros((len(prepped), T), np.float32)
        for i, p in enumerate(prepped):
            batch[i, : len(p)] = p
        post, paths, scores = self._run(batch, ns)
        out = []
        for i, rid in enumerate(read_ids):
            nblk = -(-int(ns[i]) // self.cfg.stride)
            call, ch = basecall_from_path(paths[i], nblk)
            # per-base quality: posterior prob of the transition taken at the
            # base's block (flappie.c:273-279 via qpath)
            probs = []
            for idx in ch:
                frm, to = int(paths[i][idx - 1]), int(paths[i][idx])
                row = to if to < 4 else 4
                probs.append(np.exp(post[i, idx - 1, row, frm]))
            qual = "".join(map(chr, phred_char(np.asarray(probs))))
            out.append(Basecall(
                read_id=rid, sequence=call, quality=qual, block_index=ch,
                score=float(scores[i]), nblocks=nblk, trimmed=ranges[i],
                posterior=post[i, :nblk] if keep_posterior else None))
        return out


def write_fastq(path: str, calls: Iterable[Basecall]) -> None:
    with open(path, "w") as f:
        for c in calls:
            f.write(f"@{c.read_id}\n{c.sequence}\n+\n{c.quality}\n")


def write_fasta(path: str, calls: Iterable[Basecall]) -> None:
    with open(path, "w") as f:
        for c in calls:
            f.write(f">{c.read_id}\n{c.sequence}\n")


def write_sam(path: str, calls: Iterable[Basecall]) -> None:
    """Unaligned SAM records (flappie_output.c:69-90): flag 4, no ref."""
    with open(path, "w") as f:
        f.write("@HD\tVN:1.4\tSO:unknown\n")
        for c in calls:
            f.write(f"{c.read_id}\t4\t*\t0\t0\t*\t*\t0\t0\t"
                    f"{c.sequence}\t{c.quality}\n")
