"""Posterior batches -> decoded lists -> CRC/index filter -> majority vote ->
RS -> file bytes.

Counterpart of ``nanopore_dna_storage_tpu/pipeline/decode.py``
(``ListDecodeOutcome``, ``PipelineDecoder.decode_posts``,
``decode_posts_auto_orientation`` and ``classify``, ``majority_vote``,
``recover_file``, ``ErrorRateCounters``). The numpy stages are the
reference's own, re-hosted here because the reference module imports its
JAX decoder; the list decode runs on the port's ``LVADecoder``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from ..coding.framing import check_and_extract, extract_payload
from ..coding.rs import rs_decode_oligos
from ..config import ConvCodeConfig, DecodeConfig, ExperimentConfig
from ..io.post import pack_posts
from ..ops.lva import LVADecoder


@dataclasses.dataclass
class ListDecodeOutcome:
    """Per-read candidate lists + CRC/index classification."""

    msgs: np.ndarray  # [B, L, msg_len] uint8
    valid: np.ndarray  # [B, L] bool
    index: np.ndarray  # [B] int64, -1 if no candidate passed
    payload: np.ndarray  # [B, bytes_per_oligo] uint8 (valid where index >= 0)
    chosen_msg: np.ndarray  # [B, msg_len] uint8
    # best (top-entry) path score per read; -inf when the list is empty
    best_score: Optional[np.ndarray] = None  # [B] float32


class PipelineDecoder:
    """Forward and reverse-complement decoders of one experiment on one
    torch device, ``cuda`` unless the caller asks for ``cpu``
    (``pipeline/decode.py`` ``PipelineDecoder``); ``path_combine`` goes to
    both orientations' ``DecodeConfig``, as the reference passes its
    keywords on."""

    def __init__(self, exp: ExperimentConfig, list_size: int,
                 max_deviation: Optional[int] = 20, *,
                 path_combine: str = "max", device="cuda"):
        self.exp = exp
        self.list_size = list_size
        base = dict(mem=exp.conv_mem, rate=exp.conv_rate,
                    msg_len=exp.msg_len())
        self.fwd, self.rc = (
            LVADecoder(DecodeConfig(
                code=ConvCodeConfig(rc=rc, **base), list_size=list_size,
                max_deviation=max_deviation, path_combine=path_combine),
                device=device)
            for rc in (False, True))

    @property
    def steps(self) -> int:
        """Forward block steps run by both decoders so far."""
        return self.fwd.steps + self.rc.steps

    def decode_posts(self, posts: Sequence[np.ndarray],
                     rc_flags: Sequence[bool], num_oligos: int,
                     acs: Optional[Callable] = None) -> ListDecodeOutcome:
        """Decode a batch of truncated posts with per-read orientation;
        ``acs`` is the ACS step, as in ``LVADecoder.decode``."""
        batch, nblks = pack_posts(posts)
        rc_flags = np.asarray(rc_flags, dtype=bool)
        L = self.list_size
        msg_len = self.exp.msg_len()
        msgs = np.zeros((len(posts), L, msg_len), np.uint8)
        valid = np.zeros((len(posts), L), bool)
        best = np.full(len(posts), -np.inf, np.float32)
        for flag, dec in ((False, self.fwd), (True, self.rc)):
            sel = np.nonzero(rc_flags == flag)[0]
            if len(sel) == 0:
                continue
            m, sc, v = dec.decode(batch[sel], nblks[sel], acs=acs)
            msgs[sel] = m
            valid[sel] = v
            best[sel] = np.where(v[:, 0], sc[:, 0], -np.inf)
        out = self.classify(msgs, valid, num_oligos)
        out.best_score = best
        return out

    def decode_posts_auto_orientation(
            self, posts: Sequence[np.ndarray], num_oligos: int,
            gated: bool = True
    ) -> Tuple[ListDecodeOutcome, np.ndarray]:
        """Per-read orientation pick for posts that arrive WITHOUT a
        basecall (the reference's decode script always has one and picks
        orientation by barcode edit distance before the expensive decode,
        generate_decoded_lists.py:68-74 — `decode_posts` with known
        rc_flags is that 1x-cost path).

        ``gated`` (default): decode forward first and re-decode ONLY the
        reads with no CRC-passing candidate — the CRC check is the
        pipeline's own orientation oracle, so a fwd CRC pass settles the
        read at 1x cost; cost is (1 + fail_fraction)x instead of the 2x of
        decoding every read both ways. ``gated=False`` decodes everything
        both ways and keeps the higher top path score (lists are
        score-sorted, cpp:817-824). Returns (outcome, rc_used [B] bool).
        """
        n = len(posts)
        out_f = self.decode_posts(posts, [False] * n, num_oligos)
        if not gated:
            out_r = self.decode_posts(posts, [True] * n, num_oligos)
            use_rc = out_r.best_score > out_f.best_score  # tie -> fwd
            pick = lambda a, b: np.where(  # noqa: E731
                use_rc.reshape((-1,) + (1,) * (a.ndim - 1)), a, b)
            merged = ListDecodeOutcome(
                msgs=pick(out_r.msgs, out_f.msgs),
                valid=pick(out_r.valid, out_f.valid),
                index=pick(out_r.index, out_f.index),
                payload=pick(out_r.payload, out_f.payload),
                chosen_msg=pick(out_r.chosen_msg, out_f.chosen_msg),
                best_score=pick(out_r.best_score, out_f.best_score))
            return merged, use_rc
        need = np.nonzero(out_f.index < 0)[0]
        rc_used = np.zeros(n, bool)
        if len(need) == 0:
            return out_f, rc_used
        out_r = self.decode_posts([posts[i] for i in need],
                                  [True] * len(need), num_oligos)
        # RC wins where it CRC-passes (fwd did not), or where neither
        # passes and RC's top path score is higher (tie -> fwd)
        take = (out_r.index >= 0) | (out_r.best_score >
                                     out_f.best_score[need])
        rows = need[take]
        rc_used[rows] = True
        merged = ListDecodeOutcome(
            msgs=out_f.msgs.copy(), valid=out_f.valid.copy(),
            index=out_f.index.copy(), payload=out_f.payload.copy(),
            chosen_msg=out_f.chosen_msg.copy(),
            best_score=out_f.best_score.copy())
        merged.msgs[rows] = out_r.msgs[take]
        merged.valid[rows] = out_r.valid[take]
        merged.index[rows] = out_r.index[take]
        merged.payload[rows] = out_r.payload[take]
        merged.chosen_msg[rows] = out_r.chosen_msg[take]
        merged.best_score[rows] = out_r.best_score[take]
        return merged, rc_used

    def classify(self, msgs: np.ndarray, valid: np.ndarray,
                 num_oligos: int) -> ListDecodeOutcome:
        """CRC+index check each list entry; keep the first passing candidate
        (helper.py:371-388 iterates the list in order)."""
        ok, index = check_and_extract(msgs, self.exp.framing, num_oligos,
                                      pad=self.exp.pad)
        ok &= valid
        first = np.argmax(ok, axis=1)  # first True (0 if none)
        any_ok = ok.any(axis=1)
        B = msgs.shape[0]
        chosen = msgs[np.arange(B), first]
        payload = extract_payload(chosen, self.exp.framing,
                                  self.exp.bytes_per_oligo, pad=self.exp.pad)
        return ListDecodeOutcome(
            msgs=msgs, valid=valid,
            index=np.where(any_ok, index[np.arange(B), first], -1),
            payload=payload, chosen_msg=chosen)


def majority_vote(indices: np.ndarray, payloads: np.ndarray
                  ) -> Dict[int, bytes]:
    """index -> majority payload over reads (decode_RS_from_decoded_lists.py:
    40-52: per index, the most common payload wins)."""
    votes: Dict[int, Dict[bytes, int]] = {}
    for idx, pl in zip(indices, payloads):
        if idx < 0:
            continue
        b = bytes(pl)
        votes.setdefault(int(idx), {})
        votes[int(idx)][b] = votes[int(idx)].get(b, 0) + 1
    return {i: max(v.items(), key=lambda kv: kv[1])[0]
            for i, v in votes.items()}


def recover_file(voted: Dict[int, bytes], exp: ExperimentConfig,
                 data_size: int) -> Tuple[bool, bytes]:
    """RS decode the voted payload set back to file bytes."""
    bpo = exp.bytes_per_oligo
    padded_size = math.ceil(data_size / bpo) * bpo
    num_data, num_rs, num_oligos = exp.oligo_counts(padded_size)
    idxs = np.asarray(sorted(voted.keys()), dtype=np.int64)
    pls = np.asarray([np.frombuffer(voted[int(i)], dtype=np.uint8)
                      for i in idxs], dtype=np.uint8) if len(idxs) else \
        np.zeros((0, bpo), np.uint8)
    ok, decoded = rs_decode_oligos(idxs, pls, num_rs, num_oligos)
    data = decoded.reshape(-1)[:data_size].tobytes()
    return ok, data


@dataclasses.dataclass
class ErrorRateCounters:
    """compute_error_rate_from_decoded_lists.py:22-56 counters."""

    num_reads: int = 0
    num_correct: int = 0
    num_erasure_crc: int = 0  # no CRC match in the list
    num_error_crc: int = 0  # a wrong message passed CRC

    def update(self, outcome: ListDecodeOutcome, true_index: np.ndarray,
               true_payload: np.ndarray) -> None:
        B = outcome.index.shape[0]
        self.num_reads += B
        got = outcome.index >= 0
        correct = got & (outcome.index == true_index) & \
            (outcome.payload == true_payload).all(axis=1)
        self.num_correct += int(correct.sum())
        self.num_erasure_crc += int((~got).sum())
        self.num_error_crc += int((got & ~correct).sum())
