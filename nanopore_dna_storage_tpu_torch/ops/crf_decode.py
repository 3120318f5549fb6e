"""Viterbi basecall over the flip-flop CRF in PyTorch.

Counterpart of ``nanopore_dna_storage_tpu/ops/crf_decode.py``, the rebuild
of decode_crf_flipflop and change_positions (flappie/src/decode.c:119-204,
66-79): a max-product forward pass over the 8 flip / flop states with
traceback, then the basecall at the blocks where the state changes (the
reference's ``.trans`` file, flappie.c:280-285).

Batched over reads by a leading dimension. The forward pass and the
traceback are loops over time on the tensors' device; ``basecall_from_path``
stays numpy. Ties resolve as in the JAX package: a flip's backpointer is
the first maximal source (``torch.max`` over a dimension returns the first
maximal index, as ``jnp.argmax`` does), a flop keeps the stay unless the
move is strictly greater (decode.c:158-164), and the final state is the
first maximal one.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..models.flipflop import active_blocks

NBASE = 4
NSTATE = 8


def viterbi_flipflop_batch(posts: torch.Tensor,
                           nblk: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """posts [B, T, 5, 8] log scores -> (paths [B, T + 1] int32, scores
    [B]). path[:, 0] is the start state (zero-initialised scores,
    decode.c:130-142). nblk [B]: each read's valid block count; past it the
    scores carry through and the backpointers are the identity, so the
    traceback and the final argmax reflect block nblk exactly."""
    B, T = posts.shape[:2]
    dev = posts.device
    act = active_blocks(
        nblk if nblk is not None else
        torch.full((B,), T, dtype=torch.int64, device=dev), T)[..., None]
    flips = torch.arange(NBASE, dtype=torch.int64, device=dev)
    ident = torch.arange(NSTATE, dtype=torch.int64, device=dev)
    bps = torch.empty((B, T, NSTATE), dtype=torch.int64, device=dev)
    prev = posts.new_zeros((B, NSTATE))
    for t in range(T):
        p = posts[:, t]
        # moves into flip b1 from any state: the first maximal source
        flip, flip_bp = torch.max(p[:, :NBASE] + prev[:, None, :], dim=2)
        # flop b2: stay, unless the move from flip b2 is strictly greater
        stay = prev[:, NBASE:] + p[:, NBASE, NBASE:]
        move = prev[:, :NBASE] + p[:, NBASE, :NBASE]
        take_move = move > stay
        flop = torch.where(take_move, move, stay)
        flop_bp = torch.where(take_move, flips, flips + NBASE)
        prev = torch.where(act[:, t], torch.cat([flip, flop], dim=1), prev)
        bps[:, t] = torch.where(act[:, t], torch.cat([flip_bp, flop_bp],
                                                     dim=1), ident)
    score, last = torch.max(prev, dim=1)
    path = torch.empty((B, T + 1), dtype=torch.int64, device=dev)
    state = last[:, None]
    for t in range(T - 1, -1, -1):
        path[:, t + 1] = state[:, 0]
        state = bps[:, t].gather(1, state)
    path[:, 0] = state[:, 0]
    return path.to(torch.int32), score


def viterbi_flipflop(post: torch.Tensor, nblk: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One read: post [T, 5, 8] -> (path [T + 1] int32, score)."""
    n = None if nblk is None else torch.tensor([int(nblk)],
                                               device=post.device)
    paths, scores = viterbi_flipflop_batch(post[None], n)
    return paths[0], scores[0]


def basecall_from_path(path: np.ndarray, nblk: int
                       ) -> Tuple[str, np.ndarray]:
    """(basecall string, block index of each base) from a state path.

    change_positions (decode.c:66-79): a base is emitted at every block where
    the state differs from the previous block; position range is [1, nblk).
    """
    path = np.asarray(path)[: nblk + 1]
    ch = np.nonzero(path[1:nblk] != path[:nblk - 1])[0] + 1
    bases = "ACGT"
    call = "".join(bases[int(path[i]) % NBASE] for i in ch)
    return call, ch.astype(np.int64)
