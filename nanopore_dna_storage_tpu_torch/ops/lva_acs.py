"""One signal block of the list-Viterbi ACS (add-compare-select) step.

Counterpart of ``nanopore_dna_storage_tpu/ops/lva_pallas.py`` ``acs_block``
and ``_make_kernel`` (the Pallas kernel at ``lva_pallas.py:929``), batched
over reads and in natural conv indexing. ``acs_block`` launches the CUDA
kernel of ``csrc/lva_acs.cu`` on CUDA tensors and runs ``acs_block_ref``,
the same function in plain PyTorch, on CPU tensors.

Semantics, for every read b, window row w (padded position
``pos = start1[b] + w``), CRF destination f and conv state s:

* inactive read: the stale buffer is left as it is, selections are -1;
* candidates: the stay row ``prev[pos, f, :, s] + stay_tr[f]`` with its
  hashes, then one move row per CRF predecessor g in ``G_LISTS[f]`` reading
  ``prev[pos-1, g, :, (k*s + c) mod C] + move_tr[f, g]`` for the unique
  candidate ``c = cstar[pattern[pos], f % 4, s]`` (a -inf row if none),
  with hashes ``h <- (h * 2^shift + nbits[s]) mod p``; candidate ``q*L +
  slot`` is slot ``slot`` of row q;
* suppression merge: L rounds, each popping the highest score (the lowest
  flat index wins ties), emitting ``(score, h1, h2, q*shift + slot)`` and
  knocking out every candidate with the same (h1, h2); a round with nothing
  left emits ``(-inf, 0, 0, -1)``;
* position 0 (padded row 1) is stay-only: slot 0 takes the stay score, the
  other slots -inf, hashes pass through, the code is the slot;
* where ``valid[pos, s]`` holds the result is written in place into the
  stale buffer, elsewhere the stale buffer is left and the selection is -1.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from .lva_consts import HASH_P1, HASH_P2, NCRF, NQ_MAX, sel_format

# Kernel launches made through ``acs_block`` (CUDA tensors only).
LAUNCHES = 0

Buffers = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def acs_block_ref(tabs: Dict[str, torch.Tensor], prev: Buffers,
                  stale: Buffers, stay_tr: torch.Tensor,
                  move_tr: torch.Tensor, start1: torch.Tensor,
                  active: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch ACS block step; arguments as in ``acs_block``."""
    p_sc, p_h1, p_h2 = prev
    s_sc, s_h1, s_h2 = stale
    B, P, _, L, C = p_sc.shape
    W = sel.shape[1]
    dev = p_sc.device
    neg = float("-inf")
    shift = sel_format(L)[1]
    bi = torch.arange(B, device=dev)[:, None]
    pos = start1.long()[:, None] + torch.arange(W, device=dev)  # [B, W]
    # Candidates are laid out [B, W, 8f, C, 8q * L], the candidate axis
    # last, so that the L merge rounds reduce over contiguous memory.

    def stay(buf):  # [B, W, 8f, C, L]
        return buf[bi, pos].transpose(-1, -2)

    st_sc = stay(p_sc) + stay_tr[:, None, :, None, None]
    st_h1, st_h2 = stay(p_h1), stay(p_h2)

    # move rows from CRF predecessor g = qmap[f, 1 + q] at conv state
    # pred = (k*s + c) mod C: [B, W, 8f, C, 7q, L]
    pat = tabs["pattern"].long()[pos]  # [B, W]
    kvar = (pat != 0).long()
    s = torch.arange(C, device=dev)
    c = tabs["cstar"].long()[pat[:, :, None],
                             torch.arange(NCRF, device=dev) % 4]  # [B,W,8,C]
    pred = ((2 << kvar)[:, :, None, None] * s + c.clamp(min=0)) % C
    g = tabs["qmap"].long()[:, 1:]  # [8, 7], -1 pads
    gc = g.clamp(min=0)
    # row (b*W + w, g, pred) of the previous position's [B*W*8*C, L] rows
    bw = torch.arange(B * W, device=dev)[:, None, None, None]
    src_row = ((bw * NCRF + gc[None, :, None, :]) * C
               + pred.reshape(B * W, NCRF, C)[..., None]).reshape(-1)

    def moves(buf):
        src = buf[bi, pos - 1].transpose(-1, -2).reshape(-1, L)
        return src.index_select(0, src_row).reshape(
            B, W, NCRF, C, NQ_MAX - 1, L)

    mtr = move_tr.gather(2, gc[None].expand(B, NCRF, NQ_MAX - 1))  # [B,8,7]
    mv_sc = moves(p_sc) + mtr[:, None, :, None, :, None]
    ok = ((g >= 0)[None, None, :, None, :, None]
          & (c >= 0)[:, :, :, :, None, None]
          & (pos > 1)[:, :, None, None, None, None])
    mv_sc = mv_sc.masked_fill(~ok, neg)
    nb = tabs["nbits"].long()[kvar][:, :, None, :, None, None]  # [B,W,1,C,1,1]
    sh = (1 + kvar)[:, :, None, None, None, None]

    def hashed(buf, p):  # h < p < 2^30, so (h << 2) + 3 is exact in int64
        return torch.remainder((moves(buf).long() << sh) + nb, p)

    def rows(st, mv):  # flat candidate index q*L + slot
        return torch.cat([st[..., None, :], mv], -2).reshape(
            B, W, NCRF, C, NQ_MAX * L)

    # both hashes lie below 2^30, so the pair is one int64 key h1 << 30 | h2
    cand_sc = rows(st_sc, mv_sc)
    cand_key = rows((st_h1.long() << 30) | st_h2,
                    (hashed(p_h1, HASH_P1) << 30) | hashed(p_h2, HASH_P2))

    # suppression merge: torch.argmax returns the FIRST maximal index, also
    # when the maximum is an infinity shared by several candidates; that is
    # the reference's tie rule (tests/test_torch_acs.py checks it on the
    # CPU, chip_smoke.py holds this function bit-equal to the kernel's
    # strict-> scan on the card).
    outs = []
    for _ in range(L):
        bq = cand_sc.argmax(dim=-1, keepdim=True)
        best = cand_sc.gather(-1, bq)
        key = cand_key.gather(-1, bq)
        hit = best > neg
        outs.append((best, torch.where(hit, key, 0),
                     torch.where(hit, (bq // L) * shift + bq % L, -1)))
        cand_sc.masked_fill_(cand_key == key, neg)
    out_sc, out_key, code = (torch.cat(o, -1) for o in zip(*outs))
    out_h1, out_h2 = (out_key >> 30).int(), (out_key & (2**30 - 1)).int()

    # position 0 (padded row 1): stay-only (cpp:706-713)
    isp0 = (pos == 1)[:, :, None, None, None]
    slot = torch.arange(L, device=dev)
    out_sc = torch.where(isp0, st_sc.masked_fill(slot > 0, neg), out_sc)
    out_h1 = torch.where(isp0, st_h1, out_h1)
    out_h2 = torch.where(isp0, st_h2, out_h2)
    code = torch.where(isp0, slot, code)

    wm = ((tabs["valid"][pos] != 0)
          & active[:, None, None])[:, :, None, None, :]  # [B,W,1,1,C]
    for buf, new in ((s_sc, out_sc), (s_h1, out_h1), (s_h2, out_h2)):
        buf[bi, pos] = torch.where(wm, new.transpose(-1, -2), buf[bi, pos])
    sel.copy_(torch.where(wm, code.transpose(-1, -2), -1).reshape(
        B, W, NCRF * L, C))
    return sel


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def acs_block(tabs: Dict[str, torch.Tensor], prev: Buffers, stale: Buffers,
              stay_tr: torch.Tensor, move_tr: torch.Tensor,
              start1: torch.Tensor, active: torch.Tensor,
              sel: torch.Tensor) -> torch.Tensor:
    """One ACS block step over the beam window, for a batch of reads.

    Args:
      tabs: ``LVAConsts.to(device)`` tables.
      prev: (score f32, h1 i32, h2 i32) buffers, each [B, P, 8, L, C].
      stale: buffers of the same shape; updated in place.
      stay_tr: f32 [B, 8]; move_tr: f32 [B, 8, 8] (this block's posts).
      start1: int32 [B], padded row of window row 0; the caller guarantees
        ``1 <= start1`` and ``start1 + W <= P``.
      active: bool [B], whether the block lies inside each read.
      sel: output selections [B, W, 8L, C], int8 (L <= 16) or int16.
    Returns ``sel``. CPU tensors run ``acs_block_ref``; CUDA tensors launch
    the kernel, and anything else raises.
    """
    global LAUNCHES
    dev = prev[0].device
    if dev.type == "cpu":
        return acs_block_ref(tabs, prev, stale, stay_tr, move_tr, start1,
                             active, sel)
    if dev.type != "cuda":
        raise ValueError(f"acs_block runs on cpu or cuda, not {dev}")
    B, P, _, L, C = prev[0].shape
    W = sel.shape[1]
    if L > 64:
        raise ValueError("the ACS kernel supports list sizes up to 64")
    if C & (C - 1) or C > (1 << 14):
        raise ValueError("conv state count must be a power of two <= 2^14")
    if W * NCRF > 65535 or B > 65535:
        raise ValueError("beam window or batch too large for the grid")
    bufshape = (B, P, NCRF, L, C)
    for name, bufs in (("prev", prev), ("stale", stale)):
        for t, dt in zip(bufs, (torch.float32, torch.int32, torch.int32)):
            _check(name, t, dt, bufshape, dev)
    _check("sel", sel, sel_format(L)[0], (B, W, NCRF * L, C), dev)
    _check("stay_tr", stay_tr, torch.float32, (B, NCRF), dev)
    _check("move_tr", move_tr, torch.float32, (B, NCRF, NCRF), dev)
    _check("start1", start1, torch.int32, (B,), dev)
    _check("active", active, torch.bool, (B,), dev)
    _check("cstar", tabs["cstar"], torch.int32, (4, 4, C), dev)
    _check("nbits", tabs["nbits"], torch.int32, (2, C), dev)
    _check("valid", tabs["valid"], torch.uint8, (P, C), dev)
    _check("pattern", tabs["pattern"], torch.int32, (P,), dev)
    _check("qmap", tabs["qmap"], torch.int32, (NCRF, NQ_MAX), dev)

    from ._build import load_lva_acs

    lib = load_lva_acs()
    ptrs = [t.data_ptr() for t in (*prev, *stale, sel, stay_tr, move_tr,
                                   start1, active, tabs["cstar"],
                                   tabs["nbits"], tabs["valid"],
                                   tabs["pattern"], tabs["qmap"])]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.lva_acs_launch(*ptrs, B, P, L, C, W, stream)
    if err != 0:
        raise RuntimeError("lva_acs launch failed: "
                           + lib.lva_acs_error_string(err).decode())
    LAUNCHES += 1
    return sel
