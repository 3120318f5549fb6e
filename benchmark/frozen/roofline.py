"""The ACS step's yardstick: the bytes a block step must move, and the card's
memory rate.

Frozen copy of ``acs_needed_bytes`` and ``HBM_BYTES_PER_S`` from
``nanopore_dna_storage_tpu_torch/probes/merge_roofline.py`` at commit
35018d1, kept by the benchmark so that ``acs_roofline_share`` counts the
same bytes whatever the program's kernel does.
"""
from __future__ import annotations

import torch

from .lva_consts import NCRF, NQ_MAX, sel_format

NEG = float("-inf")
# H100 SXM device memory rate, NVIDIA's data sheet (700 W): the bytes
# bounds of the ACS step (``acs_needed_bytes``) are over it
HBM_BYTES_PER_S = 3.35e12


def acs_needed_bytes(tabs, prev_sc, out_sc, sel, stay_tr, move_tr, start1,
                     active) -> int:
    """The bytes one ACS block step must move on these inputs when it merges
    the sorted candidate rows K ways, as ``csrc/lva_acs.cu`` does.

    The merge pops candidates in the order (score descending, flat index
    ``q*L + slot`` ascending) up to the one it emits last in slot L - 1, or
    every finite one when a slot stays empty; a row whose first p slots are
    popped has read min(L, p + 1) slots (its head after the last pop). A
    slot of the previous buffer is counted once however many rows read it:
    its stay row and the move rows of the next position. Trellis position 0
    reads each stay row's slot-0 score and all its hashes. Every live
    (read active, state valid) row writes its L slots, and every read its
    selections. The step's tables (under 0.1% of the bytes at m=11) are not
    counted. ``prev_sc``: the previous scores [B, P, 8, L, C]; ``out_sc`` and
    ``sel``: the step's output scores (the stale buffer after the step) and
    selections; the rest as in ``acs_block``."""
    B, P, _, L, C = prev_sc.shape
    W = sel.shape[1]
    dev = prev_sc.device
    code_shift = sel_format(L)[1]
    f = torch.arange(NCRF, device=dev)
    s = torch.arange(C, device=dev)
    j = torch.arange(L, device=dev)
    g = tabs["qmap"].long()[:, 1:]  # [8, 7], -1 pads
    gc = g.clamp(min=0)
    flat = torch.arange(NQ_MAX, device=dev)[:, None] * L + j  # [8q, L]
    nbytes = B * W * NCRF * L * C * sel.element_size()
    for b in range(B):
        if not bool(active[b]):
            continue
        pos = int(start1[b]) + torch.arange(W, device=dev)
        live = (tabs["valid"][pos] != 0) & (pos != 1)[:, None]  # [W, C]
        pat = tabs["pattern"].long()[pos]
        c = tabs["cstar"].long()[pat[:, None], f % 4]  # [W, 8f, C]
        pred = ((s << (1 + (pat != 0).long())[:, None, None]) + c) & (C - 1)
        # candidate scores [W, 8f, 8q, L, C]: the stay row, then the moves
        stay = prev_sc[b, pos] + stay_tr[b][:, None, None]
        mv = prev_sc[b][(pos - 1)[:, None, None, None, None],
                        gc[None, :, :, None, None], j[:, None],
                        pred[:, :, None, None, :]]
        mv = mv + move_tr[b][f[:, None], gc][:, :, None, None]
        cand = torch.cat([stay[:, :, None], mv], 2)
        has = torch.cat([torch.ones_like(c[:, :, None] >= 0),
                         (g >= 0)[None, :, :, None] & (c >= 0)[:, :, None]],
                        2)  # [W, 8f, 8q, C]
        last = sel[b].reshape(W, NCRF, L, C)[:, :, L - 1].long()
        s_last = out_sc[b, pos][:, :, L - 1][:, :, None, None]
        i_last = ((last // code_shift) * L + last % code_shift)[:, :, None,
                                                               None]
        ahead = (cand > s_last) | ((cand == s_last)
                                   & (flat[:, :, None] <= i_last))
        popped = torch.where((last >= 0)[:, :, None, None], ahead,
                             cand > NEG).sum(3)
        read = torch.where(has & live[:, None, None],
                           (popped + 1).clamp(max=L), 0)
        # slots read of each previous row (position, state g, conv state)
        depth = torch.zeros(P * NCRF * C, dtype=torch.long, device=dev)
        at = ((pos[:, None, None] * NCRF + f[:, None]) * C + s).reshape(-1)
        depth.scatter_reduce_(0, at, read[:, :, 0].reshape(-1), "amax")
        depth.scatter_reduce_(
            0, (((pos - 1)[:, None, None, None] * NCRF + gc[:, :, None]) * C
                + pred[:, :, None]).reshape(-1),
            read[:, :, 1:].reshape(-1), "amax")
        hdepth = depth.clone()
        first = ((tabs["valid"][pos] != 0) & (pos == 1)[:, None])[:, None]
        at0 = at.reshape(W, NCRF, C)[first.expand(W, NCRF, C)]
        depth[at0] = depth[at0].clamp(min=1)
        hdepth[at0] = L
        nlive = int((tabs["valid"][pos] != 0).sum()) * NCRF
        nbytes += 4 * int(depth.sum()) + 8 * int(hdepth.sum()) \
            + 12 * L * nlive
    return nbytes
