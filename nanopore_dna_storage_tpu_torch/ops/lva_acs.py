"""One signal block of the list-Viterbi ACS (add-compare-select) step.

Counterpart of ``nanopore_dna_storage_tpu/ops/lva_pallas.py`` ``acs_block``
and ``_make_kernel`` (the Pallas kernel at ``lva_pallas.py:929``), batched
over reads and in natural conv indexing. Two merges, one per
``DecodeConfig.path_combine``, each a CUDA kernel on CUDA tensors and the
same function in plain PyTorch on CPU tensors:

* max combining: ``acs_block`` launches ``csrc/lva_acs.cu``, a K-way merge
  of the sorted candidate rows (one thread a destination at L <= 8, eight
  lanes of a warp a destination above); ``acs_block_ref`` is its plain
  version. The
  K-way merge has a precondition: every row of ``prev`` is non-increasing
  in slot. Every buffer of a max decode holds it.
* logsumexp combining (the Pallas kernel's branch at
  ``lva_pallas.py:614-646``): ``acs_block_lse`` launches ``csrc/lva_lse.cu``,
  a merge over every candidate (one thread a destination at L <= 8, a
  group of lanes of a warp a destination above); ``acs_block_lse_ref`` is
  its plain version. It has no precondition on the rows, and its outputs
  are not sorted in slot (a class of several members can outscore the one
  popped before it), so the K-way kernel must never read its buffers.

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
  left emits ``(-inf, 0, 0, -1)``. Under logsumexp combining the emitted
  score is ``best + log(sum)`` instead, where ``sum`` adds, in f32 from 0
  in ascending flat index, ``exp(csc - best)`` for every candidate of the
  popped class still live (``csc > -inf``), the popped one included. Each
  exp and log is evaluated in f64 and rounded once to f32: that is the
  correctly rounded f32 value but for double-rounding cases (about one in
  2^29), so the plain version, the kernel and a numpy model of it agree bit
  for bit whatever their libraries' f32 exp and log do (torch's CPU exp
  rounds differently on a vector's lanes and on a loop's tail);
* position 0 (padded row 1) is stay-only: slot 0 takes the stay score, the
  other slots -inf, hashes pass through, the code is the slot;
* where ``valid[pos, s]`` holds the result is written in place into the
  stale buffer, elsewhere the stale buffer is left and the selection is -1.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Dict, Tuple

import torch

from ..utils import profiling
from ._build import check_tensor, load_lva_acs, load_lva_lse
from .lva_consts import HASH_P1, HASH_P2, NCRF, NQ_MAX, sel_format

Buffers = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
NEG = float("-inf")


def candidates(tabs: Dict[str, torch.Tensor], prev: Buffers,
               stay_tr: torch.Tensor, move_tr: torch.Tensor,
               start1: torch.Tensor, W: int):
    """The candidates of one block step over the beam window, as the module
    docstring states them. Returns ``(pos, cand_sc, cand_key, stay)``: the
    padded positions [B, W]; the candidate scores f32 and (h1, h2) keys
    int64 ``h1 << 30 | h2``, each [B, W, 8f, C, 8q * L] with candidate ``q*L
    + slot`` last, so that merge rounds reduce over contiguous memory; and
    the stay row's (scores, h1, h2), each [B, W, 8f, C, L]."""
    p_sc, p_h1, p_h2 = prev
    B, P, _, L, C = p_sc.shape
    dev = p_sc.device
    bi = torch.arange(B, device=dev)[:, None]
    pos = start1.long()[:, None] + torch.arange(W, device=dev)  # [B, W]

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
    mv_sc = mv_sc.masked_fill(~ok, NEG)
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
    return pos, cand_sc, cand_key, (st_sc, st_h1, st_h2)


def _pop(cand_sc, cand_key, L):
    """One round's pop: the first maximal candidate (torch.argmax returns the
    FIRST maximal index, also when the maximum is an infinity shared by
    several candidates; that is the reference's tie rule, which
    tests/test_torch_acs.py checks on the CPU and chip_smoke.py holds to the
    kernels' strict-> scans on the card). Returns (best, key, hit, code)."""
    bq = cand_sc.argmax(dim=-1, keepdim=True)
    best = cand_sc.gather(-1, bq)
    key = cand_key.gather(-1, bq)
    hit = best > NEG
    code = torch.where(hit, (bq // L) * sel_format(L)[1] + bq % L, -1)
    return best, key, hit, code


def _merge_max(cand_sc, cand_key, L):
    """The suppression merge with max combining: [..., L] (score, key,
    code)."""
    outs = []
    for _ in range(L):
        best, key, hit, code = _pop(cand_sc, cand_key, L)
        outs.append((best, torch.where(hit, key, 0), code))
        cand_sc.masked_fill_(cand_key == key, NEG)
    return tuple(torch.cat(o, -1) for o in zip(*outs))


def _merge_lse(cand_sc, cand_key, L):
    """The suppression merge with logsumexp combining: [..., L] (score, key,
    code). The class sum runs one f32 add per candidate in ascending flat
    index; a candidate outside the live class adds an exact 0, which leaves
    the sum as a sum over the live members alone would."""
    outs = []
    for _ in range(L):
        best, key, hit, code = _pop(cand_sc, cand_key, L)
        cls = cand_key == key
        live = (cls & (cand_sc > NEG)).view(-1).nonzero().squeeze(1)
        term = torch.zeros_like(cand_sc)
        term.view(-1)[live] = torch.exp(
            (cand_sc - best).view(-1)[live].double()).float()
        total = torch.zeros_like(best)
        for t in term.movedim(-1, 0).contiguous()[..., None]:
            total = total + t
        # no hit: best = -inf and total = 0, so the score is -inf
        outs.append((best + torch.log(total.double()).float(),
                     torch.where(hit, key, 0), code))
        cand_sc.masked_fill_(cls, NEG)
    return tuple(torch.cat(o, -1) for o in zip(*outs))


def _step_ref(merge: Callable, tabs, prev: Buffers, stale: Buffers,
              stay_tr, move_tr, start1, active, sel) -> torch.Tensor:
    """One plain block step with ``merge``; arguments as in ``acs_block``."""
    B, P, _, L, C = prev[0].shape
    W = sel.shape[1]
    dev = prev[0].device
    pos, cand_sc, cand_key, (st_sc, st_h1, st_h2) = candidates(
        tabs, prev, stay_tr, move_tr, start1, W)
    out_sc, out_key, code = merge(cand_sc, cand_key, L)
    out_h1, out_h2 = (out_key >> 30).int(), (out_key & (2**30 - 1)).int()

    # position 0 (padded row 1): stay-only (cpp:706-713)
    isp0 = (pos == 1)[:, :, None, None, None]
    slot = torch.arange(L, device=dev)
    out_sc = torch.where(isp0, st_sc.masked_fill(slot > 0, NEG), out_sc)
    out_h1 = torch.where(isp0, st_h1, out_h1)
    out_h2 = torch.where(isp0, st_h2, out_h2)
    code = torch.where(isp0, slot, code)

    bi = torch.arange(B, device=dev)[:, None]
    wm = ((tabs["valid"][pos] != 0)
          & active[:, None, None])[:, :, None, None, :]  # [B,W,1,1,C]
    for buf, new in zip(stale, (out_sc, out_h1, out_h2)):
        buf[bi, pos] = torch.where(wm, new.transpose(-1, -2), buf[bi, pos])
    sel.copy_(torch.where(wm, code.transpose(-1, -2), -1).reshape(
        B, W, NCRF * L, C))
    return sel


def acs_block_ref(tabs: Dict[str, torch.Tensor], prev: Buffers,
                  stale: Buffers, stay_tr: torch.Tensor,
                  move_tr: torch.Tensor, start1: torch.Tensor,
                  active: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch ACS block step, max combining; arguments as in
    ``acs_block``."""
    return _step_ref(_merge_max, tabs, prev, stale, stay_tr, move_tr, start1,
                     active, sel)


def acs_block_lse_ref(tabs: Dict[str, torch.Tensor], prev: Buffers,
                      stale: Buffers, stay_tr: torch.Tensor,
                      move_tr: torch.Tensor, start1: torch.Tensor,
                      active: torch.Tensor,
                      sel: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch ACS block step, logsumexp combining; arguments as in
    ``acs_block_lse``."""
    return _step_ref(_merge_lse, tabs, prev, stale, stay_tr, move_tr,
                     start1, active, sel)


def _launch(kind: str, tabs, prev: Buffers, stale: Buffers, stay_tr,
            move_tr, start1, active, sel) -> None:
    """Check the arguments of a block step on the card and launch the kernel
    of library ``kind`` (``lva_acs`` or ``lva_lse``) on the current
    stream; raises on anything the kernel does not take."""
    dev = prev[0].device
    B, P, _, L, C = prev[0].shape
    W = sel.shape[1]
    if L > 64:
        raise ValueError("the ACS kernels support list sizes up to 64")
    if C & (C - 1) or C > (1 << 14):
        raise ValueError("conv state count must be a power of two <= 2^14")
    if W * NCRF > 65535 or B > 65535:
        raise ValueError("beam window or batch too large for the grid")
    bufshape = (B, P, NCRF, L, C)
    for name, bufs in (("prev", prev), ("stale", stale)):
        for t, dt in zip(bufs, (torch.float32, torch.int32, torch.int32)):
            check_tensor(name, t, dt, bufshape, dev)
    check_tensor("sel", sel, sel_format(L)[0], (B, W, NCRF * L, C), dev)
    check_tensor("stay_tr", stay_tr, torch.float32, (B, NCRF), dev)
    check_tensor("move_tr", move_tr, torch.float32, (B, NCRF, NCRF), dev)
    check_tensor("start1", start1, torch.int32, (B,), dev)
    check_tensor("active", active, torch.bool, (B,), dev)
    check_tensor("cstar", tabs["cstar"], torch.int32, (4, 4, C), dev)
    check_tensor("nbits", tabs["nbits"], torch.int32, (2, C), dev)
    check_tensor("valid", tabs["valid"], torch.uint8, (P, C), dev)
    check_tensor("pattern", tabs["pattern"], torch.int32, (P,), dev)
    check_tensor("qmap", tabs["qmap"], torch.int32, (NCRF, NQ_MAX), dev)

    lib = load_lva_acs() if kind == "lva_acs" else load_lva_lse()
    ptrs = [t.data_ptr() for t in (*prev, *stale, sel, stay_tr, move_tr,
                                   start1, active, tabs["cstar"],
                                   tabs["nbits"], tabs["valid"],
                                   tabs["pattern"], tabs["qmap"])]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, f"{kind}_launch")(*ptrs, B, P, L, C, W, stream)
    if err != 0:
        raise RuntimeError(f"{kind} launch failed: "
                           + getattr(lib, f"{kind}_error_string")(err)
                           .decode())


def _device(name: str, prev: Buffers) -> str:
    """``cpu`` or ``cuda``, the device type of the step's buffers; raises on
    any other."""
    dev = prev[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {dev}")
    return dev.type


def acs_block(tabs: Dict[str, torch.Tensor], prev: Buffers, stale: Buffers,
              stay_tr: torch.Tensor, move_tr: torch.Tensor,
              start1: torch.Tensor, active: torch.Tensor,
              sel: torch.Tensor) -> torch.Tensor:
    """One ACS block step over the beam window, for a batch of reads, with
    max combining.

    Args:
      tabs: ``LVAConsts.to(device)`` tables.
      prev: (score f32, h1 i32, h2 i32) buffers, each [B, P, 8, L, C].
        Precondition: in every (read, position, CRF state, conv state) row,
        scores do not increase with the slot. The kernel merges the rows as
        sorted lists and relies on it; every buffer a max decode makes holds
        it (initial buffers, position 0, merge outputs), and no buffer of a
        logsumexp decode does.
      stale: buffers of the same shape; updated in place.
      stay_tr: f32 [B, 8]; move_tr: f32 [B, 8, 8] (this block's posts).
      start1: int32 [B], padded row of window row 0; the caller guarantees
        ``1 <= start1`` and ``start1 + W <= P``.
      active: bool [B], whether the block lies inside each read.
      sel: output selections [B, W, 8L, C], int8 (L <= 16) or int16.
    Returns ``sel``. CPU tensors run ``acs_block_ref``; CUDA tensors launch
    the kernel, each launch counted as ``acs.launches``
    (``utils/profiling.py``), and anything else raises.
    """
    if _device("acs_block", prev) == "cpu":
        return acs_block_ref(tabs, prev, stale, stay_tr, move_tr, start1,
                             active, sel)
    _launch("lva_acs", tabs, prev, stale, stay_tr, move_tr, start1, active,
            sel)
    profiling.count("acs.launches")
    return sel


def acs_block_lse(tabs: Dict[str, torch.Tensor], prev: Buffers,
                  stale: Buffers, stay_tr: torch.Tensor,
                  move_tr: torch.Tensor, start1: torch.Tensor,
                  active: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """One ACS block step with logsumexp combining; arguments and returns as
    in ``acs_block``, with no precondition on the rows of ``prev``: the
    kernel merges every candidate. CPU tensors run ``acs_block_lse_ref``;
    CUDA tensors launch the kernel, counted as ``acs.lse_launches``, and
    anything else raises."""
    if _device("acs_block_lse", prev) == "cpu":
        return acs_block_lse_ref(tabs, prev, stale, stay_tr, move_tr, start1,
                                 active, sel)
    _launch("lva_lse", tabs, prev, stale, stay_tr, move_tr, start1, active,
            sel)
    profiling.count("acs.lse_launches")
    return sel


def _info(kind: str, L: int) -> Dict[str, int]:
    lib = load_lva_acs() if kind == "lva_acs" else load_lva_lse()
    out = (ctypes.c_int * 3)()
    err = getattr(lib, f"{kind}_info")(L, out)
    if err != 0:
        raise RuntimeError(f"{kind}_info failed: "
                           + getattr(lib, f"{kind}_error_string")(err)
                           .decode())
    return {"registers": out[0], "local_bytes": out[1],
            "threads_per_sm": out[2]}


def kernel_info(L: int) -> Dict[str, int]:
    """Registers, local memory in bytes (stack frame and spills) and
    resident threads per SM (the occupancy calculator, at the bucket's
    block: 128 threads at L <= 8, 256 in the lane buckets above) of the
    K-way kernel that runs list size ``L`` on the current CUDA device."""
    return _info("lva_acs", L)


def lse_kernel_info(L: int) -> Dict[str, int]:
    """``kernel_info`` of the logsumexp kernel."""
    return _info("lva_lse", L)
