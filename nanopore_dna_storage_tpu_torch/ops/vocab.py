"""Vocabulary (k-mer word) Viterbi decoding over flip-flop posteriors, in
PyTorch.

Counterpart of ``nanopore_dna_storage_tpu/ops/vocab.py``, the rebuild of
``decode_post_vocab`` (reference viterbi/extra/viterbi_nanopore.cpp:398-602):
the message is a sequence of ``msg_len`` words from a fixed DNA vocabulary;
the decoder runs max-product Viterbi over the joint state (msg position,
word, position-in-word, flip/flop bit) plus 8 pre-message init states, with
traceback, and emits the word index sequence.

State layout: a dense padded tensor [npos, nwords, maxlen, 2] with -inf at
positions past each word's length. Each block is one step of tensor ops on
the device: the stay term, then the one other transition that can enter
each state (the init entry at position 0 of the first word, the word
boundary at position 0 of a later word, the advance within a word), taken
where it is strictly greater. Each step stores the winning predecessor's
packed state id per state (int64 here, uint32 in the JAX package); the
traceback and the message extraction run on the host. Ties go to the first
candidate: strict ``>`` against the stay, and the first maximal index among
candidates (index 0 where every candidate is -inf), as ``jnp.argmax``.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..trellis.tables import crf_move_mask, move_post_index, stay_post_index

NBASE = 4
NCRF = 8


def load_vocab_file(path: str) -> List[str]:
    with open(path) as f:
        return [l.strip() for l in f if l.strip()]


class VocabTables:
    def __init__(self, words: Sequence[str], msg_len: int):
        lut = {c: i for i, c in enumerate("ACGT")}
        self.words = list(words)
        self.msg_len = msg_len
        self.nwords = len(words)
        self.maxlen = max(len(w) for w in words)
        self.wordlen = np.asarray([len(w) for w in words], np.int32)
        base = np.zeros((self.nwords, self.maxlen), np.int32)
        for i, w in enumerate(words):
            for j, c in enumerate(w):
                base[i, j] = lut[c]
        self.base = base  # [W, P]
        self.valid = (np.arange(self.maxlen)[None, :]
                      < self.wordlen[:, None])  # [W, P]
        self.last_idx = self.wordlen - 1


def _first_max(x: torch.Tensor):
    """(max, index of its first occurrence) over the last dimension; index
    0 where every entry is -inf, as ``jnp.argmax``."""
    best = x.max(dim=-1).values
    pos = torch.arange(x.shape[-1], device=x.device)
    idx = torch.where(x == best[..., None], pos, x.shape[-1]).min(dim=-1)
    return best, idx.values


def decode_post_vocab(post: np.ndarray, msg_len: int, words: Sequence[str],
                      device="cuda") -> np.ndarray:
    """post [T, 5, 8] -> word-index message [msg_len] (int32), the block
    loop on ``device`` (the card unless the caller asks for ``cpu``).

    Mirrors the reference exactly, including tie-breaking (strict > updates,
    candidate enumeration order) and the final argmax over word-end states.
    """
    vt = VocabTables(words, msg_len)
    T = post.shape[0]
    if T < msg_len:
        raise ValueError("Too small post matrix")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda requested but CUDA is not available")
    W, P = vt.nwords, vt.maxlen
    npos = msg_len

    def on(a):
        return torch.as_tensor(np.asarray(a), device=dev)

    postf = on(np.asarray(post, np.float32).reshape(T, 40))
    stay_idx = on(stay_post_index()).long()  # [8]
    move_idx = on(move_post_index()).long()  # [to, from]
    crfmask = on(crf_move_mask()).bool()  # [to, from]
    base = on(vt.base).long()  # [W, P]
    valid = on(vt.valid)[None, :, :, None]
    last = on(vt.last_idx).long()  # [W]
    ffs = torch.arange(2, device=dev)
    wi = torch.arange(W, device=dev)
    # crf state of vocab state (w, p, ff)
    crf = base[:, :, None] + NBASE * ffs  # [W, P, 2]
    crf0 = crf[:, 0]  # [W, 2]: first base of each word
    # packed ids of all vocab states [pos, W, P, 2]:
    # (((pos*W + w)*P + p)*2 + ff) + NCRF; init states are 0..7
    ids = torch.arange(npos * W * P * 2, device=dev).reshape(
        npos, W, P, 2) + NCRF
    # word boundary into (pos, w, 0, ff) from (pos-1, w1, last[w1], ff1),
    # pos >= 1: predecessor ids [pos-1, W1 * 2] in (w1, ff1) order, and
    # the transitions [W, 2, W1 * 2] from their crf states
    bnd_ids = ids[:-1, wi, last].reshape(npos - 1, W * 2)
    bnd_crf = (base[wi, last][:, None]
               + NBASE * ffs).reshape(-1)  # [W1 * 2]
    bnd_ok = crfmask[crf0][:, :, bnd_crf]
    init_ok = crfmask[crf0]  # [W, 2, 8]
    # within a word: (pos, w, p, ff2) from (pos, w, p-1, ff1), p >= 1
    in_to, in_from = crf[:, 1:, :, None], crf[:, :-1, None, :]
    in_ok = crfmask[in_to, in_from]  # [W, P-1, 2, 2]
    in_base = ids[:, :, 1:] - 2 - ffs  # id of (pos, w, p-1, 0)
    neg = torch.tensor(-torch.inf, device=dev)

    init_s = torch.zeros(NCRF, dtype=torch.float32, device=dev)
    vs = torch.full((npos, W, P, 2), -torch.inf, dtype=torch.float32,
                    device=dev)
    bps = torch.empty((T, NCRF + ids.numel()), dtype=torch.int64,
                      device=dev)
    bps[:, :NCRF] = torch.arange(NCRF, device=dev)  # init states: stay
    for t in range(T):
        pt = postf[t]
        stay_tr = pt[stay_idx]  # [8]
        move_tr = pt[move_idx]  # [to, from]
        move0 = move_tr[crf0]  # [W, 2, from]: into each word's first base
        best = vs + stay_tr[crf]  # stay, the first candidate (cpp:480-485)
        bp = ids.clone()

        # from the init states into position 0 of the first word
        cand = torch.where(init_ok, init_s + move0, neg)
        sc, arg = _first_max(cand)  # [W, 2]
        take = sc > best[0, :, 0]
        best[0, :, 0] = torch.where(take, sc, best[0, :, 0])
        bp[0, :, 0] = torch.where(take, arg, bp[0, :, 0])

        # word boundary into position 0 of a later word
        if npos > 1:
            prev = vs[:-1, wi, last].reshape(npos - 1, 1, 1, W * 2)
            cand = torch.where(bnd_ok, prev + move0[:, :, bnd_crf], neg)
            sc, arg = _first_max(cand)  # [pos-1, W, 2]
            take = sc > best[1:, :, 0]
            best[1:, :, 0] = torch.where(take, sc, best[1:, :, 0])
            bp[1:, :, 0] = torch.where(
                take, bnd_ids.gather(1, arg.reshape(npos - 1, -1)).reshape(
                    npos - 1, W, 2), bp[1:, :, 0])

        # within a word
        if P > 1:
            cand = torch.where(in_ok, vs[:, :, :-1, None, :]
                               + move_tr[in_to, in_from], neg)
            sc, arg = _first_max(cand)  # [pos, W, P-1, 2]
            take = sc > best[:, :, 1:]
            best[:, :, 1:] = torch.where(take, sc, best[:, :, 1:])
            bp[:, :, 1:] = torch.where(take, in_base + arg, bp[:, :, 1:])

        # invalid (padded) positions stay -inf
        vs = torch.where(valid, best, neg)
        init_s = init_s + stay_tr  # init states: stay only
        bps[t, NCRF:] = bp.reshape(-1)

    # final state: pos = npos-1, p = wordlen-1, both ff; argmax
    fin = vs[npos - 1].cpu().numpy()  # [W, P, 2]
    cand_sc = fin[np.arange(vt.nwords), vt.last_idx]  # [W, 2]
    w_star, ff_star = np.unravel_index(np.argmax(cand_sc), cand_sc.shape)
    pack_id = ((npos - 1) * W + w_star) * P + vt.last_idx[w_star]
    state = int(pack_id * 2 + ff_star + NCRF)

    bps = bps.cpu().numpy()  # [T, S]
    path = np.empty(T + 1, np.int64)
    path[T] = state
    for t in range(T, 0, -1):
        path[t - 1] = bps[t - 1, path[t]]

    # extract message: word index at every pos increment (cpp:583-599)
    msg = []
    cur_pos = -1
    for st in path:
        if st < NCRF:
            continue
        v = int(st) - NCRF
        ff = v % 2
        v //= 2
        p = v % P
        v //= P
        w = v % W
        pos = v // W
        if pos > cur_pos:
            if pos != cur_pos + 1 or p != 0:
                raise RuntimeError("inconsistent vocab path")
            cur_pos = pos
            msg.append(w)
    if len(msg) != msg_len:
        raise RuntimeError("decoded message length mismatch")
    return np.asarray(msg, np.int32)
