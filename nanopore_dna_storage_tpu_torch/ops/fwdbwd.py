"""Flip-flop CRF forward-backward transition posteriors in PyTorch.

Counterpart of ``nanopore_dna_storage_tpu/ops/fwdbwd.py``, the rebuild of
transpost_crf_flipflop (flappie/src/decode.c:377-497): given per-block
transition weights [T, 40] it gives, for every block and every allowed
transition, log P(transition | whole signal), normalised per block over the
40 entries (log_row_normalise, flappie_matrix.c:450-467). The [T, 40] output
is the decoder's [T, 5, 8] post layout (rows into flip A..T from each of 8
states; row 4 into the from-state's flop).

Batched over reads by a leading dimension, where the JAX package maps one
read at a time. Both scans are loops over time on the tensors' device.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..models.flipflop import active_blocks

NBASE = 4
NSTATE = 8
NPARAM = 40


def _fwd_step(prev: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """t: [B, 5, 8] block transitions; prev: [B, 8]."""
    flip = torch.logsumexp(t[:, :NBASE] + prev[:, None, :], dim=2)
    flop = torch.logaddexp(prev[:, NBASE:] + t[:, NBASE, NBASE:],
                           prev[:, :NBASE] + t[:, NBASE, :NBASE])
    return torch.cat([flip, flop], dim=1)


def _bwd_step(nxt: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Backward vector update (decode.c:466-489); nxt is beta at blk + 1."""
    from_flip_to_flop = nxt[:, NBASE:] + t[:, NBASE, :NBASE]
    stay_flop = nxt[:, NBASE:] + t[:, NBASE, NBASE:]
    into_flips = torch.logsumexp(t[:, :NBASE] + nxt[:, :NBASE, None],
                                 dim=1)  # [B, 8]
    return torch.cat([torch.logaddexp(from_flip_to_flop,
                                      into_flips[:, :NBASE]),
                      torch.logaddexp(stay_flop, into_flips[:, NBASE:])],
                     dim=1)


def batched_transition_posteriors(trans: torch.Tensor,
                                  nblk: Optional[torch.Tensor] = None
                                  ) -> torch.Tensor:
    """trans [B, T, 40] -> log posteriors [B, T, 5, 8], each block normalised
    over its 40 entries. nblk [B]: each read's valid block count; past it
    both scans carry their vector through unchanged, so the valid prefix is
    exact and the blocks after it are garbage."""
    B, T, _ = trans.shape
    t58 = trans.reshape(B, T, NBASE + 1, NSTATE)
    if nblk is None:
        nblk = torch.full((B,), T, dtype=torch.int64, device=trans.device)
    act = active_blocks(nblk, T)[..., None]

    fwd = trans.new_empty((B, T, NSTATE))  # alpha_t, before block t
    vec = trans.new_zeros((B, NSTATE))
    for t in range(T):
        fwd[:, t] = vec
        vec = torch.where(act[:, t], _fwd_step(vec, t58[:, t]), vec)
    bwd_next = trans.new_empty((B, T, NSTATE))  # beta_{t+1}
    vec = trans.new_zeros((B, NSTATE))
    for t in range(T - 1, -1, -1):
        bwd_next[:, t] = vec
        vec = torch.where(act[:, t], _bwd_step(vec, t58[:, t]), vec)

    # tpost[t, to-row, from] = alpha_t[from] + beta_{t+1}[dest] + trans
    flip_rows = (fwd[:, :, None, :] + bwd_next[:, :, :NBASE, None]
                 + t58[:, :, :NBASE])
    flop_dest = bwd_next[:, :, NBASE:].repeat(1, 1, 2)  # flop(from % 4)
    stay_row = fwd + flop_dest + t58[:, :, NBASE]
    tp = torch.cat([flip_rows, stay_row[:, :, None, :]], dim=2)
    logz = torch.logsumexp(tp.reshape(B, T, NPARAM), dim=2)
    return tp - logz[:, :, None, None]


def transition_posteriors(trans: torch.Tensor,
                          nblk: Optional[int] = None) -> torch.Tensor:
    """One read: trans [T, 40] -> [T, 5, 8]; nblk its valid block count."""
    n = None if nblk is None else torch.tensor([int(nblk)],
                                               device=trans.device)
    return batched_transition_posteriors(trans[None], n)[0]
