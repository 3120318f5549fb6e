"""List-Viterbi decode over the ACS step: the forward block loop, the
selection traceback and the final ordering.

Counterpart of ``nanopore_dna_storage_tpu/ops/lva_pallas.py``
``_init_buffers``, ``_forward_chunk``, ``_final_scores``,
``window_bounds``, ``_tb_init``, ``_lastwrite``, ``_tb_chunk`` and
``PallasDecoder``. The forward runs one ACS step per signal block and keeps
the selections of every block, ``[T, B, W, 8L, C]``, on the device (block
major, so each step writes one contiguous slice); the traceback walks them
backward to rebuild the 8L final-state messages of each read, in one launch
of ``csrc/lva_traceback.cu`` on the card and in ``traceback_ref``'s loop
over the blocks on the CPU. Where the JAX decoder pairs blocks in its scan
to avoid buffer copies, here the (prev, stale) roles swap by swapping two
Python references after every block, inactive blocks included.
"""
from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from ..utils import profiling
from ._build import check_tensor, load_lva_traceback
from .lva_acs import acs_block
from .lva_consts import NCRF, NQ_MAX, DecodeSpec, LVAConsts, sel_format

def init_buffers(spec: DecodeSpec, init_state: int, B: int, device):
    """(prev, stale) buffer triples (score, h1, h2), each [B, P, 8, L, C]:
    prev seeds trellis position 0 (padded row 1) at the initial conv state
    in list slot 0; stale starts empty (cpp:607-620)."""
    C, L, P = spec.code.nstate_conv, spec.list_size, spec.npos_pad
    shape = (B, P, NCRF, L, C)

    def triple():
        return (torch.full(shape, float("-inf"), device=device),
                torch.zeros(shape, dtype=torch.int32, device=device),
                torch.zeros(shape, dtype=torch.int32, device=device))

    prev, stale = triple(), triple()
    prev[0][:, 1, :, 0, init_state] = 0.0
    return prev, stale


def window_bounds(starts: np.ndarray, nblk: int, npos_pad: int, W: int):
    """Per padded row, the first/last block t (< nblk) whose beam window
    [starts[t]+1, starts[t]+W] covers it; rows never covered get (0, -10)."""
    rows = np.arange(npos_pad)
    s = np.asarray(starts[:nblk])
    tlo = np.searchsorted(s, rows - W, side="left")
    thi = np.searchsorted(s, rows - 1, side="right") - 1
    none = tlo > thi
    tlo[none] = 0
    thi[none] = -10
    return tlo, thi


def lastwrite(tlo, thi, row, tmax, par):
    """Largest block t' <= tmax with parity ``par`` whose window wrote
    ``row`` (per read: tlo/thi [B, P], row [B, N]); -1 if the read would
    hit the initial buffers."""
    x = torch.minimum(torch.as_tensor(tmax, device=row.device),
                      thi.gather(1, row))
    x = x - ((x - par) & 1)
    return torch.where(x >= tlo.gather(1, row), x, -1)


def forward(spec: DecodeSpec, consts: LVAConsts, tabs, posts: torch.Tensor,
            starts: torch.Tensor, nblks: torch.Tensor,
            acs: Callable = acs_block):
    """Run the ACS step over every block of a batch.

    posts f32 [B, T, 5, 8], starts int32 [B, T] (beam starts), nblks [B]
    int64, all on one device. Returns (sels [T, B, W, 8L, C], fin_sc
    [B, 8, L]): the selections of every block, and the scores at the last
    position and final conv state after each read's last active block.
    """
    B, T = posts.shape[:2]
    dev = posts.device
    W, L, C = spec.window, spec.list_size, spec.code.nstate_conv
    postf = posts.reshape(B, T, 40)
    stay_tr = postf[:, :, tabs["stay_idx"]].transpose(0, 1).contiguous()
    move_tr = postf[:, :, tabs["move_idx"]].transpose(0, 1).contiguous()
    start1 = (starts + 1).to(torch.int32).t().contiguous()  # [T, B]
    active = (torch.arange(T, device=dev)[:, None]
              < nblks[None, :]).contiguous()  # [T, B]
    sels = torch.empty((T, B, W, NCRF * L, C), dtype=sel_format(L)[0],
                       device=dev)
    bufs = init_buffers(spec, consts.init_state, B, dev)
    prev, stale = bufs
    for t in range(T):
        acs(tabs, prev, stale, stay_tr[t], move_tr[t], start1[t], active[t],
            sels[t])
        prev, stale = stale, prev
    # block t wrote bufs[(t + 1) % 2]; a read's last active block is nblk-1
    # (buffers keep swapping through its inactive blocks, which write nothing)
    last_row = spec.code.nstate_pos  # last position, +1 for the ghost row
    fin = [b[0][:, last_row, :, :, consts.final_state] for b in bufs]
    fin_sc = torch.where((nblks % 2 == 0)[:, None, None], fin[0], fin[1])
    return sels, fin_sc


def traceback(spec: DecodeSpec, consts: LVAConsts, tabs,
              sels: torch.Tensor, starts: torch.Tensor, nblks: torch.Tensor,
              tlo: torch.Tensor, thi: torch.Tensor):
    """Rebuild the packed messages of all 8L final-state chains per read.

    Arguments and returns as in ``traceback_ref``, which states the
    semantics. CPU tensors run ``traceback_ref``; any other device launches
    ``csrc/lva_traceback.cu`` once, counted as ``traceback.launches``
    (``utils/profiling.py``), or raises: one thread a chain, jumping from
    each block where the chain acts to the next.
    """
    if sels.device.type == "cpu":
        return traceback_ref(spec, consts, tabs, sels, starts, nblks, tlo,
                             thi)
    return _launch_traceback(spec, consts, tabs, sels, starts, nblks, tlo,
                             thi)


def _launch_traceback(spec: DecodeSpec, consts: LVAConsts, tabs,
                      sels: torch.Tensor, starts: torch.Tensor,
                      nblks: torch.Tensor, tlo: torch.Tensor,
                      thi: torch.Tensor):
    """Check the traceback's arguments against ``sels``'s device and launch
    the kernel on the current stream; raises on anything it does not
    take, before any launch."""
    dev = sels.device
    T, B = sels.shape[:2]
    L, C, W, P = (spec.list_size, spec.code.nstate_conv, spec.window,
                  spec.npos_pad)
    Mw = spec.n_msg_words
    if Mw > 32:
        raise ValueError("the traceback kernel supports up to 32 message "
                         "words")
    check_tensor("sels", sels, sel_format(L)[0], (T, B, W, NCRF * L, C), dev)
    check_tensor("starts", starts, torch.int64, (B, T), dev)
    check_tensor("nblks", nblks, torch.int64, (B,), dev)
    check_tensor("tlo", tlo, torch.int64, (B, P), dev)
    check_tensor("thi", thi, torch.int64, (B, P), dev)
    check_tensor("qmap", tabs["qmap"], torch.int32, (NCRF, NQ_MAX), dev)
    check_tensor("pattern", tabs["pattern"], torch.int32, (P,), dev)
    check_tensor("nbits", tabs["nbits"], torch.int32, (2, C), dev)
    check_tensor("cstar", tabs["cstar"], torch.int32, (4, 4, C), dev)
    if dev.type != "cuda":
        raise ValueError(f"the traceback runs on cpu or cuda, not {dev}")
    words = torch.empty((B, NCRF * L, Mw), dtype=torch.int64, device=dev)
    okend = torch.empty((B, NCRF * L), dtype=torch.bool, device=dev)
    lib = load_lva_traceback()
    ptrs = [t.data_ptr() for t in (sels, starts, nblks, tlo, thi,
                                   tabs["qmap"], tabs["pattern"],
                                   tabs["nbits"], tabs["cstar"], words,
                                   okend)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.lva_traceback_launch(
            *ptrs, B, T, W, L, C, P, Mw, spec.code.nstate_pos,
            consts.init_state, consts.final_state, stream)
    if err != 0:
        raise RuntimeError("lva_traceback launch failed: "
                           + lib.lva_traceback_error_string(err).decode())
    profiling.count("traceback.launches")
    return words, okend


def traceback_ref(spec: DecodeSpec, consts: LVAConsts, tabs,
                  sels: torch.Tensor, starts: torch.Tensor,
                  nblks: torch.Tensor, tlo: torch.Tensor, thi: torch.Tensor):
    """Plain PyTorch traceback: the packed messages of all 8L final-state
    chains per read, one step of torch ops for every block.

    sels [T, B, W, 8L, C] (``forward``'s), starts int64 [B, T], nblks int64
    [B], tlo and thi int64 [B, P] (``window_bounds`` per read), all on one
    device. A block t read row r as last written at the largest t' <= t-1
    with t' = t-1 (mod 2) whose window covered r; if there is none, the
    read hit the initial buffers, where only padded row 1 at the initial
    state in slot 0 is live (``okend``) (cpp:607-620, 667-687).
    Returns (words int64 [B, 8L, Mw] holding uint32 values, okend bool
    [B, 8L]).
    """
    T, B, W, nch, C = sels.shape
    L = spec.list_size
    Mw = spec.n_msg_words
    dev = sels.device
    sshift = sel_format(L)[1]
    qmap = tabs["qmap"].long()
    pattern = tabs["pattern"].long()
    nbits = tabs["nbits"].long()
    cstar = tabs["cstar"].long()
    ch = torch.arange(nch, device=dev).expand(B, nch)
    last_row = spec.code.nstate_pos
    pos = torch.full((B, nch), last_row, dtype=torch.long, device=dev)
    conv = torch.full((B, nch), consts.final_state, dtype=torch.long,
                      device=dev)
    f, slot = ch // L, ch % L
    tw = lastwrite(tlo, thi, pos, (nblks - 1)[:, None],
                   (nblks - 1)[:, None] % 2)
    words = torch.zeros((B, nch, Mw), dtype=torch.long, device=dev)
    bitcnt = torch.zeros((B, nch), dtype=torch.long, device=dev)
    alive = torch.ones((B, nch), dtype=torch.bool, device=dev)
    okend = torch.zeros((B, nch), dtype=torch.bool, device=dev)
    wi_ids = torch.arange(Mw, device=dev)
    for t in range(T - 1, -1, -1):
        act = alive & (tw == t)
        w_i = (pos - starts[:, t:t + 1] - 1).clamp(0, W - 1)
        flat = (w_i * nch + f * L + slot) * C + conv
        code = sels[t].reshape(B, -1).gather(1, flat).long()
        q = torch.div(code, sshift, rounding_mode="floor").clamp(
            0, NQ_MAX - 1)
        lsrc = torch.remainder(code, sshift).clamp(0, L - 1)
        g = qmap[f, q]
        is_stay = q == 0
        pat = pattern[pos]
        kvar = (pat != 0).long()
        nb = nbits[kvar, conv]
        c = cstar[pat.clamp(0, 3), f % 4, conv].clamp(0, 3)
        csrc = ((2 << kvar) * conv + c) % C  # natural predecessor state
        off = bitcnt % 32
        widx = bitcnt // 32
        lo = (nb << off) & 0xFFFFFFFF
        hi = torch.where(off == 0, 0, (nb >> 1) >> (31 - off))
        add = (torch.where(wi_ids == widx[..., None], lo[..., None], 0)
               | torch.where(wi_ids == widx[..., None] + 1, hi[..., None], 0))
        do_move = act & ~is_stay
        words = torch.where(do_move[..., None], words | add, words)
        bitcnt = torch.where(do_move, bitcnt + 1 + kvar, bitcnt)
        npos = torch.where(is_stay, pos, pos - 1)
        nconv = torch.where(is_stay, conv, csrc)
        nf = torch.where(is_stay, f, g)
        par = (t - 1) & 1
        ntw = lastwrite(tlo, thi, npos, t - 1, par)
        hit_init = act & (ntw < 0)
        okend = okend | (hit_init & (par == 1) & (npos == 1)
                         & (nconv == consts.init_state) & (lsrc == 0))
        pos = torch.where(act, npos, pos)
        conv = torch.where(act, nconv, conv)
        f = torch.where(act, nf, f)
        slot = torch.where(act, lsrc, slot)
        tw = torch.where(act, ntw, tw)
        alive = alive & ~hit_init
    return words, okend


def order(fin_sc: torch.Tensor, words: torch.Tensor, okend: torch.Tensor,
          L: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Keep the best L of the 8L chains: a stable sort of -score over the
    chains in (CRF state, slot) order (lva_pallas.py:1236-1239)."""
    flat = fin_sc.reshape(fin_sc.shape[0], -1)
    idx = torch.argsort(-flat, dim=1, stable=True)[:, :L]
    bi = torch.arange(flat.shape[0], device=flat.device)[:, None]
    return flat[bi, idx], words[bi, idx], okend[bi, idx]
