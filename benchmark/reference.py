"""The plain reference of the decode the benchmark times: list-Viterbi over the
joint (position x conv state x CRF state) trellis with max path combining,
then the CRC/index classification of each list (the reference C++
``decode_post_conv_parallel_LVA``, viterbi_convolutional_code.cpp:589-858,
and helper.py:371-388).

Plain PyTorch and numpy. It imports nothing of the program. What is whose:

* the tables (``frozen/``: trellis tables, beam schedule, conv code, CRC
  and framing) and the forward block loop (``candidates``, ``step``, the
  double-buffered rows of ``forward``) follow the program at commit
  35018d1 (``ops/lva_consts.py``, ``trellis/tables.py``, ``ops/lva_acs.py``
  and ``ops/lva_decode.py`` of ``nanopore_dna_storage_tpu_torch``);
* the merge is written afresh as a sort: a destination's 8L candidates in
  (score descending, flat index ascending) order, the first of each
  (h1, h2) key kept, the first L kept emitted. That is what the C++ L
  rounds of pop-and-knock-out give (a candidate is knocked out exactly
  when an earlier one in that order has its key);
* the traceback is written afresh as an explicit walk: the forward loop
  records, for each block and window row, which block last wrote the row
  its stay and move candidates were read from, and each chain follows its
  cells' selections back through those writers to the start, appending
  each move's input bits;

and the whole decode is held to the C++ decoder's own lists
(``golden/``; ``tests/test_bench_reference.py``), at m=6 and m=8 on the
CPU and at the cells' codes (m=11 r=5/6 L=8 both ways, m=8 r=1/2 L=64)
on the card.

``dtype`` is the scores' precision: float32, as the configuration states;
the control computes them in bfloat16.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from .frozen import tables as tb
from .frozen.config import ConvCodeConfig, DecodeConfig, FramingConfig
from .frozen.framing import check_and_extract, extract_payload
from .frozen.lva_consts import (HASH_P1, HASH_P2, NCRF, NQ_MAX, DecodeSpec,
                                LVAConsts, sel_format)

NEG = float("-inf")
# the writer of a row that no block has written yet, per buffer
INIT = (-1, -2)


def candidates(tabs, prev, stay_tr, move_tr, start1, W: int):
    """A block step's candidates over the beam window: (pos [B, W], scores
    [B, W, 8f, C, 8q*L], keys int64 ``h1 << 30 | h2`` of the same shape,
    the stay row's (scores, h1, h2) [B, W, 8f, C, L]). Candidate ``q*L +
    slot`` is slot ``slot`` of row q: the stay row, then one move row per
    CRF predecessor g reading ``prev[pos-1, g, :, (k*s + c) mod C]``."""
    p_sc, p_h1, p_h2 = prev
    B, P, _, L, C = p_sc.shape
    dev = p_sc.device
    bi = torch.arange(B, device=dev)[:, None]
    pos = start1.long()[:, None] + torch.arange(W, device=dev)  # [B, W]

    def stay(buf):  # [B, W, 8f, C, L]
        return buf[bi, pos].transpose(-1, -2)

    st_sc = stay(p_sc) + stay_tr[:, None, :, None, None]
    st_h1, st_h2 = stay(p_h1), stay(p_h2)
    pat = tabs["pattern"].long()[pos]  # [B, W]
    kvar = (pat != 0).long()
    s = torch.arange(C, device=dev)
    c = tabs["cstar"].long()[pat[:, :, None],
                             torch.arange(NCRF, device=dev) % 4]  # [B,W,8,C]
    pred = ((2 << kvar)[:, :, None, None] * s + c.clamp(min=0)) % C
    g = tabs["qmap"].long()[:, 1:]  # [8, 7], -1 pads
    gc = g.clamp(min=0)
    bw = torch.arange(B * W, device=dev)[:, None, None, None]
    src_row = ((bw * NCRF + gc[None, :, None, :]) * C
               + pred.reshape(B * W, NCRF, C)[..., None]).reshape(-1)

    def moves(buf):  # [B, W, 8f, C, 7q, L]
        src = buf[bi, pos - 1].transpose(-1, -2).reshape(-1, L)
        return src.index_select(0, src_row).reshape(
            B, W, NCRF, C, NQ_MAX - 1, L)

    mtr = move_tr.gather(2, gc[None].expand(B, NCRF, NQ_MAX - 1))  # [B,8,7]
    mv_sc = moves(p_sc) + mtr[:, None, :, None, :, None]
    ok = ((g >= 0)[None, None, :, None, :, None]
          & (c >= 0)[:, :, :, :, None, None]
          & (pos > 1)[:, :, None, None, None, None])
    mv_sc = mv_sc.masked_fill(~ok, NEG)
    nb = tabs["nbits"].long()[kvar][:, :, None, :, None, None]
    sh = (1 + kvar)[:, :, None, None, None, None]

    def hashed(buf, p):  # h < p < 2^30, so (h << 2) + 3 is exact in int64
        return torch.remainder((moves(buf).long() << sh) + nb, p)

    def rows(st, mv):
        return torch.cat([st[..., None, :], mv], -2).reshape(
            B, W, NCRF, C, NQ_MAX * L)

    cand_sc = rows(st_sc, mv_sc)
    cand_key = rows((st_h1.long() << 30) | st_h2,
                    (hashed(p_h1, HASH_P1) << 30) | hashed(p_h2, HASH_P2))
    return pos, cand_sc, cand_key, (st_sc, st_h1, st_h2)


def merge(cand_sc: torch.Tensor, cand_key: torch.Tensor, L: int):
    """The suppression merge of each destination by sorting: [..., L]
    (score, key, code ``q*shift + slot``), empty slots (-inf, 0, -1)."""
    order = torch.sort(-cand_sc, dim=-1, stable=True).indices
    sc = cand_sc.gather(-1, order)
    key = cand_key.gather(-1, order)
    by_key = torch.sort(key, dim=-1, stable=True)
    k2 = by_key.values
    lead2 = torch.ones_like(k2, dtype=torch.bool)
    lead2[..., 1:] = k2[..., 1:] != k2[..., :-1]
    lead = torch.empty_like(lead2).scatter_(-1, by_key.indices, lead2)
    keep = lead & (sc > NEG)
    first = torch.sort((~keep).to(torch.uint8), dim=-1,
                       stable=True).indices[..., :L]
    hit = torch.arange(L, device=sc.device) < keep.sum(-1, keepdim=True)
    flat = order.gather(-1, first)
    code = torch.where(hit, (flat // L) * sel_format(L)[1] + flat % L, -1)
    return (torch.where(hit, sc.gather(-1, first), NEG),
            torch.where(hit, key.gather(-1, first), 0), code)


def step(tabs, prev, stale, stay_tr, move_tr, start1, active, sel):
    """One block step: the merge of every destination in the window written
    into ``stale`` where the state is valid and the read active; position 0
    (padded row 1) is stay-only; selections -1 elsewhere."""
    B, P, _, L, C = prev[0].shape
    W = sel.shape[1]
    dev = prev[0].device
    pos, cand_sc, cand_key, (st_sc, st_h1, st_h2) = candidates(
        tabs, prev, stay_tr, move_tr, start1, W)
    out_sc, out_key, code = merge(cand_sc, cand_key, L)
    out_h1, out_h2 = (out_key >> 30).int(), (out_key & (2**30 - 1)).int()
    isp0 = (pos == 1)[:, :, None, None, None]
    slot = torch.arange(L, device=dev)
    out_sc = torch.where(isp0, st_sc.masked_fill(slot > 0, NEG), out_sc)
    out_h1 = torch.where(isp0, st_h1, out_h1)
    out_h2 = torch.where(isp0, st_h2, out_h2)
    code = torch.where(isp0, slot, code)
    bi = torch.arange(B, device=dev)[:, None]
    wm = ((tabs["valid"][pos] != 0)
          & active[:, None, None])[:, :, None, None, :]
    for buf, new in zip(stale, (out_sc, out_h1, out_h2)):
        buf[bi, pos] = torch.where(wm, new.transpose(-1, -2), buf[bi, pos])
    sel.copy_(torch.where(wm, code.transpose(-1, -2), -1).reshape(
        B, W, NCRF * L, C))


class ReferenceDecoder:
    """The plain decode of one orientation of a code on ``device``, scores
    in ``dtype``."""

    def __init__(self, code: ConvCodeConfig, list_size: int,
                 max_deviation: int, device, dtype=torch.float32):
        self.spec, self.tables = DecodeSpec.build(DecodeConfig(
            code=code, list_size=list_size, max_deviation=max_deviation))
        self.consts = LVAConsts.build(self.spec, self.tables)
        self.device = torch.device(device)
        self.tabs = self.consts.to(self.device)
        self.dtype = dtype

    def schedule(self, nblks: np.ndarray, T: int) -> np.ndarray:
        out = np.zeros((len(nblks), T), dtype=np.int32)
        for b, n in enumerate(np.asarray(nblks)):
            s = tb.beam_schedule(self.tables, int(n))
            out[b, : int(n)] = s
            out[b, int(n):] = s[-1] if len(s) else 0
        return out

    def forward(self, posts, starts1, nblks):
        """Every block step of a batch: (sels [T, B, W, 8L, C]; src [T, 2,
        B, W], the block that last wrote the row each window row's stay
        (row ``pos``) and move (row ``pos - 1``) candidates were read from,
        ``INIT[k]`` where that was buffer k as initialised; the final
        state's scores [B, 8, L] and the block that wrote them)."""
        spec, consts, tabs = self.spec, self.consts, self.tabs
        B, T = posts.shape[:2]
        dev = posts.device
        W, L, C = spec.window, spec.list_size, spec.code.nstate_conv
        P = spec.npos_pad
        postf = posts.reshape(B, T, 40)
        stay_tr = postf[:, :, tabs["stay_idx"]].transpose(0, 1)
        move_tr = postf[:, :, tabs["move_idx"]].transpose(0, 1)
        active = torch.arange(T, device=dev)[:, None] < nblks[None, :]
        sels = torch.empty((T, B, W, NCRF * L, C), dtype=sel_format(L)[0],
                           device=dev)
        shape = (B, P, NCRF, L, C)

        def buffers():
            return (torch.full(shape, NEG, dtype=self.dtype, device=dev),
                    torch.zeros(shape, dtype=torch.int32, device=dev),
                    torch.zeros(shape, dtype=torch.int32, device=dev))

        # block t reads buffer t % 2 and writes buffer (t + 1) % 2; only
        # buffer 0 holds a finite start, at row 1, slot 0, the initial state
        bufs = (buffers(), buffers())
        bufs[0][0][:, 1, :, 0, consts.init_state] = 0.0
        writer = torch.tensor(INIT, device=dev)[:, None, None].repeat(1, B, P)
        src = torch.empty((T, 2, B, W), dtype=torch.long, device=dev)
        bi = torch.arange(B, device=dev)[:, None]
        for t in range(T):
            pos = starts1[:, t:t + 1] + torch.arange(W, device=dev)
            src[t, 0] = writer[t % 2].gather(1, pos)
            src[t, 1] = writer[t % 2].gather(1, pos - 1)
            step(tabs, bufs[t % 2], bufs[(t + 1) % 2], stay_tr[t],
                 move_tr[t], starts1[:, t].int(), active[t], sels[t])
            out = writer[(t + 1) % 2]
            out[bi, pos] = torch.where(active[t][:, None], t, out[bi, pos])
        last, b = spec.code.nstate_pos, torch.arange(B, device=dev)
        fin = torch.stack([buf[0][:, last, :, :, consts.final_state]
                           for buf in bufs])
        return sels, src, fin[nblks % 2, b], writer[nblks % 2, b, last]

    def traceback(self, sels, src, starts1, fin_blk):
        """Each of the 8L final-state chains of each read walked back cell
        by cell, a cell being (the block that wrote it, row, CRF state f,
        slot, conv state): that block's selection names the candidate the
        cell kept (q = 0 the stay, else the move from CRF state qmap[f, q],
        and its slot), ``src`` the block that wrote the candidate's cell,
        and a move appends its input bits. Returns (bits uint8 [B, 8L,
        msg_len + mem] in walk order, from the end; ok bool [B, 8L]: the
        walk ended on the finite start and appended msg_len + mem bits)."""
        spec, consts, tabs = self.spec, self.consts, self.tabs
        T, B, W, nch, C = sels.shape
        L = spec.list_size
        nbit = spec.code.config.msg_len + spec.code.mem
        shift = sel_format(L)[1]
        qmap, pattern = tabs["qmap"].long(), tabs["pattern"].long()
        nbits, cstar = tabs["nbits"].long(), tabs["cstar"].long()
        dev = sels.device
        bi = torch.arange(B, device=dev)[:, None]
        ch = torch.arange(nch, device=dev).expand(B, nch)
        blk = fin_blk[:, None].expand(B, nch).clone()
        row = torch.full((B, nch), spec.code.nstate_pos, device=dev)
        conv = torch.full((B, nch), consts.final_state, device=dev)
        f, slot = ch // L, ch % L
        bits = torch.zeros((B, nch, nbit + 2), dtype=torch.uint8, device=dev)
        cnt = torch.zeros((B, nch), dtype=torch.long, device=dev)
        for t in range(T - 1, -1, -1):
            act = blk == t
            if not bool(act.any()):
                continue
            w = (row - starts1[:, t:t + 1]).clamp(0, W - 1)
            code = sels[t][bi, w, f * L + slot, conv].long()
            q = torch.div(code, shift, rounding_mode="floor").clamp(
                0, NQ_MAX - 1)
            move = act & (q > 0)
            two = (pattern[row] != 0).long()  # a move here shifts 1 + two bits
            nb = nbits[two, conv]
            for j in range(2):
                at = (cnt + j).clamp(max=nbit + 1)
                put = move & ((j == 0) | (two == 1))
                bits[bi, ch, at] = torch.where(
                    put, ((nb >> j) & 1).to(torch.uint8), bits[bi, ch, at])
            cnt = torch.where(move, cnt + 1 + two, cnt)
            c = cstar[pattern[row], f % 4, conv].clamp(min=0)
            pred = ((2 << two) * conv + c) % C
            nblk = torch.where(q > 0, src[t, 1][bi, w], src[t, 0][bi, w])
            row = torch.where(move, row - 1, row)
            conv = torch.where(move, pred, conv)
            f = torch.where(move, qmap[f, q].clamp(min=0), f)
            slot = torch.where(act, torch.remainder(code, shift).clamp(
                0, L - 1), slot)
            blk = torch.where(act, nblk, blk)
        ok = ((blk == INIT[0]) & (row == 1) & (conv == consts.init_state)
              & (slot == 0) & (cnt == nbit))
        return bits[..., :nbit], ok

    def message(self, bits: np.ndarray) -> np.ndarray:
        """A chain's bits in walk order [.., msg_len + mem] -> its message
        [.., msg_len]: the walk meets the termination bits first and the
        first message bit last; reversed under rc (cpp:828-836)."""
        msg = bits[..., ::-1][..., :self.spec.code.config.msg_len]
        if self.spec.code.config.rc:
            msg = msg[..., ::-1]
        return np.ascontiguousarray(msg)

    def decode(self, posts: Sequence[np.ndarray]):
        """The lists of each read: (msgs uint8 [B, L, msg_len], scores f32
        [B, L], valid bool [B, L]), best first (ties to the lower chain
        f * L + slot); -inf scores where invalid."""
        nblks = np.asarray([p.shape[0] for p in posts], np.int64)
        if (nblks < self.spec.code.nstate_pos + 1).any():
            raise ValueError("post shorter than nstate_pos + 1 blocks")
        T = int(nblks.max())
        batch = np.zeros((len(posts), T, 5, 8), np.float32)
        for i, p in enumerate(posts):
            batch[i, : len(p)] = p
        dev = self.device
        starts1 = torch.from_numpy(self.schedule(nblks, T) + 1).long().to(dev)
        nblks_d = torch.from_numpy(nblks).to(dev)
        sels, src, fin_sc, fin_blk = self.forward(
            torch.from_numpy(batch).to(dev).to(self.dtype), starts1, nblks_d)
        bits, ok = self.traceback(sels, src, starts1, fin_blk)
        del sels
        L = self.spec.list_size
        flat = fin_sc.float().reshape(len(posts), -1)
        idx = torch.argsort(-flat, dim=1, stable=True)[:, :L]
        bi = torch.arange(len(posts), device=dev)[:, None]
        sc = flat[bi, idx].cpu().numpy()
        valid = (sc > -np.inf) & ok[bi, idx].cpu().numpy()
        msgs = self.message(bits[bi, idx].cpu().numpy())
        return msgs, np.where(valid, sc, -np.inf).astype(np.float32), valid


def classify(msgs: np.ndarray, valid: np.ndarray, framing: FramingConfig,
             bytes_per_oligo: int, pad: bool, num_oligos: int
             ) -> Dict[str, np.ndarray]:
    """The first list entry that passes the CRC and index check, per read
    (helper.py:371-388): its index (-1 where none passes), payload and
    message."""
    ok, index = check_and_extract(msgs, framing, num_oligos, pad=pad)
    ok &= valid
    first = np.argmax(ok, axis=1)
    rows = np.arange(msgs.shape[0])
    chosen = msgs[rows, first]
    return {"index": np.where(ok.any(axis=1), index[rows, first], -1),
            "payload": extract_payload(chosen, framing, bytes_per_oligo,
                                       pad=pad),
            "chosen_msg": chosen}


def decode_reads(code: ConvCodeConfig, list_size: int, max_deviation: int,
                 posts: Sequence[np.ndarray], rc: np.ndarray, device,
                 dtype=torch.float32, chunk: int = 1
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Each read's lists by the decoder of its orientation, ``chunk`` reads
    of one orientation at a time: (msgs, scores, valid) in read order."""
    n = len(posts)
    out = [None] * n
    for flag in (False, True):
        sel = [i for i in range(n) if bool(rc[i]) == flag]
        if not sel:
            continue
        dec = ReferenceDecoder(
            ConvCodeConfig(mem=code.mem, rate=code.rate,
                           msg_len=code.msg_len, rc=flag),
            list_size, max_deviation, device, dtype)
        for i in range(0, len(sel), chunk):
            part = sel[i:i + chunk]
            m, s, v = dec.decode([posts[j] for j in part])
            for k, j in enumerate(part):
                out[j] = (m[k], s[k], v[k])
    return tuple(np.stack(x) for x in zip(*out))
