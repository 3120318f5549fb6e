"""The lane layout of K1's large-list buckets (``csrc/lva_acs.cu``
``lva_acs_lanes_kernel``, the L <= 16 and L <= 64 buckets) as a PyTorch
model, held bit for bit against ``acs_block_ref``.

The CUDA kernel cannot run here, so its algorithm is written out step by
step over every destination (read, window row, CRF destination f, conv
state) at once, with G lanes a destination (``LANES``, the kernel's
``kLanes``): merge row q sits in lane q % G with its head and the slot
after it, loaded from the flat previous buffers at the kernel's offsets;
each pop takes each lane's best row (its rows in ascending q), then the
kernel's shuffle steps on (score, row) across the lanes, the lower row
winning a tie, with lane 0's result broadcast when the destination has
fewer rows than lanes (a flop's 2); the winner's hashes and slot come from
its lane; every lane checks the popped pair against its share of the
emitted pairs (pair r in lane r % G, newest first) and the group's ``any``
decides; only the popped row advances; each emitted round is staged, with
the count of rounds, and the staged rounds are written as whole rows at
the end, slots past the count (-inf, 0, 0, -1). The inactive-read and
position-0 paths are the kernel's block-wide ones.

It runs at L = 12 (the L <= 16 bucket, 16 / G pairs a lane) and 34 and 64
(the L <= 64 bucket, 64 / G a lane), on synthetic sorted rows built to
break a merge (ties, repeated hash pairs, exhausted and absent rows,
position 0, an inactive read; every block has flips and flops) and on the
states of small CPU decodes at m=6, C=64, max deviation 4; and once at
L = 64 as the ACS step of a whole decode, whose lists must equal the JAX
package's ``LVADecoder`` on the same seeded posteriors. Scores are single
f32 adds and everything else is integer, so the tolerance is zero.
"""
import numpy as np
import pytest
import torch

from nanopore_dna_storage_tpu.coding.conv import (conv_encode_bases,
                                                  make_conv_code)
from nanopore_dna_storage_tpu.config import ConvCodeConfig
from nanopore_dna_storage_tpu.config import DecodeConfig as JaxDecodeConfig
from nanopore_dna_storage_tpu.ops.lva import LVADecoder as JaxLVADecoder
from nanopore_dna_storage_tpu.ops.synthetic import synthetic_post
from nanopore_dna_storage_tpu_torch import config as port_config
from nanopore_dna_storage_tpu_torch.config import DecodeConfig
from nanopore_dna_storage_tpu_torch.ops import lva_acs
from nanopore_dna_storage_tpu_torch.ops.lva import LVADecoder
from nanopore_dna_storage_tpu_torch.ops.lva_consts import (
    HASH_P1, HASH_P2, NCRF, NQ_MAX, DecodeSpec, LVAConsts, sel_format)
from test_torch_acs import _port_reads
from test_torch_host import twin

torch.set_num_threads(1)

NEG = float("-inf")
# the lanes a destination takes in the kernel (``kLanes``; 2 and 8 were
# built and timed too, PERF.md)
LANES = (4,)
# ``kNoPair`` in both halves of a key p1 << 32 | p2: no hash reaches it
NO_KEY = -1


def _hash_update(h, shift, nb, p):
    """``hash_update``: (h << shift) + nb, less p up to three times."""
    t = (h << shift) + nb
    for _ in range(3):
        t = torch.where(t >= p, t - p, t)
    return t


def _group_best(v, k, nq, G):
    """``group_best`` over the lane axis of v, k [G, N]: the shuffle steps
    below each destination's row count ``nq`` [N], then lane 0's result
    broadcast where ``nq`` < G. Returns the group's (score, row) [N]."""
    lane = torch.arange(G)
    off = 1
    while off < G:
        partner = lane ^ off
        v2, k2 = v[partner], k[partner]
        take = ((v2 > v) | ((v2 == v) & (k2 < k))) & (off < nq)
        v, k = torch.where(take, v2, v), torch.where(take, k2, k)
        off <<= 1
    v = torch.where(nq < G, v[0], v)
    k = torch.where(nq < G, k[0], k)
    assert bool((v == v[:1]).all()) and bool((k == k[:1]).all())
    return v[0], k[0]


def lanes_step(tabs, prev, stale, stay_tr, move_tr, start1, active, sel,
               G=LANES[0]):
    """One block step of ``lva_acs_lanes_kernel`` with ``G`` lanes a
    destination; arguments as ``acs_block``'s (L > 8). Writes ``stale`` and
    ``sel`` and returns ``sel``."""
    p_sc, p_h1, p_h2 = prev
    B, P, _, L, C = p_sc.shape
    W = sel.shape[1]
    LB = 16 if L <= 16 else 64
    K = LB // G
    shift_code = sel_format(L)[1]
    LC = L * C
    f_sc = p_sc.reshape(-1)
    f_h1, f_h2 = (x.reshape(-1).long() & 0xFFFFFFFF for x in prev[1:])
    qmap = tabs["qmap"].long()
    # the block's row count: rows while qmap[f, n] >= 0
    nq_f = torch.tensor([next((n for n in range(1, NQ_MAX)
                               if qmap[f, n] < 0), NQ_MAX)
                         for f in range(NCRF)])

    # every destination (b, w, f, s), flat
    b, w, f, s = (x.reshape(-1) for x in torch.meshgrid(
        torch.arange(B), torch.arange(W), torch.arange(NCRF),
        torch.arange(C), indexing="ij"))
    pos = start1.long()[b] + w
    act = active[b]
    valid = tabs["valid"][pos, s] != 0
    live = act & valid & (pos != 1)
    pat = tabs["pattern"].long()[pos]
    kvar = (pat != 0).long()
    shift = 1 + kvar
    nb = tabs["nbits"].long()[kvar, s]
    c = tabs["cstar"].long()[pat, f & 3, s]
    pred = ((s << shift) + c) & (C - 1)
    plane = (b * P + (pos - 1)) * NCRF * LC
    nq = nq_f[f]

    # merge row q (in lane q % G, its row q // G there): its table entry
    # and its slot 0
    q = torch.arange(NQ_MAX)[:, None]
    g = qmap[f, q]
    row_base = torch.where(q == 0, (NCRF + f) * LC, g.clamp(min=0) * LC)
    tr = torch.where(q == 0, stay_tr[b, f],
                     torch.where(g < 0, torch.zeros(()),
                                 move_tr[b, f, g.clamp(min=0)]))
    has = (q < nq) & ((q == 0) | (c >= 0))
    at = row_base + torch.where(q == 0, s, pred)

    # the live destinations' state, the destination last; a destination
    # leaves it when it is done
    N = len(b)
    d = {"n": torch.arange(N), "at": at, "tr": tr, "has": has,
         "plane": plane, "shift": shift, "nb": nb, "nq": nq}
    d = {k: v[..., live] for k, v in d.items()}
    n_live = len(d["n"])

    def load(off, mask):
        """``load_head`` at offsets [8, n] (rows q) of each destination's
        plane, where ``mask``; (-inf, 0, 0) elsewhere. Row 0 is the stay
        row; the others update their hashes for the move."""
        sc = torch.full(mask.shape, NEG)
        h1, h2 = torch.zeros((2, *mask.shape), dtype=torch.long)
        lq, n = mask.nonzero(as_tuple=True)
        i = d["plane"][n] + off[lq, n]
        sc[lq, n] = f_sc[i] + d["tr"][lq, n]
        for h, fh, p in ((h1, f_h1, HASH_P1), (h2, f_h2, HASH_P2)):
            x = fh[i]
            h[lq, n] = torch.where(
                lq != 0, _hash_update(x, d["shift"][n], d["nb"][n], p), x)
        return sc, h1, h2

    d["hs"], d["ha"], d["hb"] = load(d["at"], d["has"])
    d["ns"], d["na"], d["nb2"] = load(d["at"] + C, d["has"] & (L > 1))
    d["j"] = torch.zeros((NQ_MAX, n_live), dtype=torch.long)
    # each lane's share of the emitted pairs (p1, p2) as keys p1 << 32 | p2,
    # newest first
    d["pk"] = torch.full((G, K, n_live), NO_KEY)
    d["r"] = torch.zeros(n_live, dtype=torch.long)  # rounds emitted
    st_sc = torch.zeros(LB, N)
    st_h1, st_h2, st_sel = (torch.zeros(LB, N, dtype=torch.long)
                            for _ in range(3))
    st_n = torch.full((N,), -1)
    d["done"] = torch.zeros(n_live, dtype=torch.bool)
    lane = torch.arange(G)[:, None]
    while len(d["n"]):
        # each lane's best row (its rows in ascending q), then the group's
        rows = d["hs"].view(NQ_MAX // G, G, -1)
        v, k = rows[0], lane.expand_as(rows[0])
        for i in range(1, NQ_MAX // G):
            take = rows[i] > v
            v, k = torch.where(take, rows[i], v), torch.where(take, i * G
                                                               + lane, k)
        top, bq = _group_best(v, k, d["nq"], G)
        ta, tb, tj = (d[k].gather(0, bq[None])[0] for k in ("ha", "hb", "j"))
        go = ~d["done"] & (top > NEG)
        adv = go & (q == bq)  # the popped row advances, in its lane
        for x, y in (("hs", "ns"), ("ha", "na"), ("hb", "nb2")):
            d[x] = torch.where(adv, d[y], d[x])
        d["j"] = d["j"] + adv
        xs, xa, xb = load(d["at"] + (d["j"] + 1) * C, adv & (d["j"] + 1 < L))
        for x, y in (("ns", xs), ("na", xa), ("nb2", xb)):
            d[x] = torch.where(adv, y, d[x])
        # each lane against its share, then the group's any
        key = ta << 32 | tb
        seen = (d["pk"] == key).any(1)
        emit = go & ~seen.any(0)
        r = d["r"]
        at_r = (r[emit], d["n"][emit])
        st_sc[at_r] = top[emit]
        st_h1[at_r], st_h2[at_r] = ta[emit], tb[emit]
        st_sel[at_r] = (bq * shift_code + tj)[emit]
        # the owner of pair r shifts its share and takes it in front
        lq, n = (emit & (lane == r % G)).nonzero(as_tuple=True)
        pk = d["pk"]
        pk[lq, 1:, n] = pk[lq, :-1, n]
        pk[lq, 0, n] = key[n]
        d["r"] = r = r + emit
        ends = ~d["done"] & (~go | (r >= L))
        st_n[d["n"][ends]] = r[ends]
        d["done"] |= ends
        # done destinations take no more part; drop them now and then
        if 4 * int(d["done"].sum()) >= len(r):
            d = {k: v[..., ~d["done"]] for k, v in d.items()}

    # the staged rounds as whole rows [L, N]
    slot = torch.arange(L)[:, None]
    hit = slot < st_n
    out_sc = torch.where(hit, st_sc[:L], NEG)
    out_h1 = torch.where(hit, st_h1[:L], 0)
    out_h2 = torch.where(hit, st_h2[:L], 0)
    out_sel = torch.where(hit, st_sel[:L], -1)
    # position 0: the stay score in slot 0, hashes passed through
    p0 = act & valid & (pos == 1)
    out_sc = torch.where(p0, torch.where(
        slot == 0, p_sc[b, 1, f, 0, s] + stay_tr[b, f], NEG), out_sc)
    out_h1 = torch.where(p0, p_h1[b, 1, f, :, s].T.long(), out_h1)
    out_h2 = torch.where(p0, p_h2[b, 1, f, :, s].T.long(), out_h2)
    out_sel = torch.where(p0, slot, out_sel)

    wrote = live | p0
    idx = (b[wrote], pos[wrote], f[wrote], slice(None), s[wrote])
    stale[0][idx] = out_sc[:, wrote].T
    stale[1][idx] = out_h1[:, wrote].T.int()
    stale[2][idx] = out_h2[:, wrote].T.int()
    sel.view(B, W, NCRF, L, C)[b, w, f, :, s] = torch.where(
        wrote, out_sel, -1).T.to(sel.dtype)
    return sel


def _same_as_ref(tabs, prev, stale, args, W, G):
    """``acs_block_ref`` and ``lanes_step`` on copies of one step's buffers:
    buffers and selections bit-equal. Returns the selections."""
    B, _, _, L, C = prev[0].shape
    outs = []
    for step in (lva_acs.acs_block_ref,
                 lambda *a: lanes_step(*a, G=G)):
        st = [x.clone() for x in stale]
        sel = torch.empty((B, W, NCRF * L, C), dtype=sel_format(L)[0])
        step(tabs, prev, st, *args, sel)
        outs.append((st, sel))
    (want, want_sel), (got, got_sel) = outs
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert torch.equal(got_sel, want_sel)
    return want_sel


def _rows(L, seed):
    """A decode spec at m=6 r=5/6, max deviation 4, list size L, and a block
    step's inputs whose previous buffers hold sorted rows built to break a
    merge: integer scores and transitions (ties within and across rows),
    -inf tails of random length (whole rows exhausted), hashes from {0..H-1}
    with H = max(4, L / 4), so that pairs repeat within rows, across move
    rows and between the stay row and move rows once updated, while L
    distinct pairs can still be found. Reads: one whose window covers
    trellis position 0, one mid-read, one inactive."""
    rng = np.random.default_rng(seed)
    code = port_config.ConvCodeConfig(mem=6, rate=5, msg_len=30)
    spec, tabs_np = DecodeSpec.build(DecodeConfig(code=code, list_size=L,
                                                  max_deviation=4))
    tabs = LVAConsts.build(spec, tabs_np).to("cpu")
    B, P, C, W = 3, spec.npos_pad, spec.code.nstate_conv, spec.window
    sc = -rng.integers(0, 4, (B, P, NCRF, L, C)).astype(np.float32)
    sc = -np.sort(-sc, axis=3)  # each row non-increasing in slot
    keep = rng.integers(0, L + 1, (B, P, NCRF, 1, C))  # finite slots
    sc = np.where(np.arange(L)[:, None] < keep, sc, np.float32(NEG))
    H = max(4, L // 4)
    h1, h2 = rng.integers(0, H, (2, B, P, NCRF, L, C)).astype(np.int32)
    prev = tuple(map(torch.from_numpy, (sc, h1, h2)))
    stale = tuple(torch.from_numpy(x.copy()) for x in (sc[:, ::-1], h2, h1))
    stay_tr = torch.from_numpy(-rng.integers(0, 2, (B, NCRF)).astype(
        np.float32))
    move_tr = torch.from_numpy(-rng.integers(0, 2, (B, NCRF, NCRF)).astype(
        np.float32))
    start1 = torch.tensor([1, (P - W) // 2, P - W], dtype=torch.int32)
    active = torch.tensor([True, True, False])
    return spec, tabs, prev, stale, (stay_tr, move_tr, start1, active)


def _dropped(sel, L) -> bool:
    """Whether some destination of selections ``sel`` [.., W, 8L, C]
    emitted slot k of a row without every slot below it: a row's slots pop
    in order, so the missing one was dropped as a pair already emitted."""
    codes = sel.reshape(-1, NCRF, L, sel.shape[-1]).transpose(2, 3).reshape(
        -1, L).long()
    shift = sel_format(L)[1]
    q = torch.where(codes >= 0, codes // shift, NQ_MAX)
    count = torch.zeros(len(q), NQ_MAX + 1, dtype=torch.long).scatter_add_(
        1, q, torch.ones_like(q))
    top = torch.zeros_like(count).scatter_reduce_(1, q, codes % shift + 1,
                                                  "amax")
    return bool((top[:, :NQ_MAX] > count[:, :NQ_MAX]).any())


@pytest.mark.parametrize("G", LANES)
@pytest.mark.parametrize("L", [12, 34, 64])
def test_lanes_on_adversarial_rows(L, G):
    """Sorted rows with ties within and across rows, repeated hash pairs,
    -inf tails and whole rows exhausted, move rows absent, a read at
    trellis position 0, one mid-read and one inactive (``_rows``)."""
    spec, tabs, prev, stale, args = _rows(L, seed=L + 7)
    assert bool((prev[0] == NEG).all(3).any()) and (tabs["cstar"] < 0).any()
    rows = 1 + (tabs["qmap"][:, 1:] >= 0).sum(1)
    assert set(rows.tolist()) == {2, NQ_MAX}  # flops and flips
    sel = _same_as_ref(tabs, prev, stale, args, spec.window, G)
    codes = sel[:2][sel[:2] >= 0].long()
    shift = sel_format(L)[1]
    # rows past the stay row and slots past the first were taken, some
    # destinations ran out of pairs and some filled all L slots, and the
    # inactive read selected nothing
    assert bool((codes >= shift).any()) and bool((codes % shift > 0).any())
    last = sel[1].view(spec.window, NCRF, L, -1)[:, :, L - 1]
    assert bool((last == -1).any()) and bool((last >= 0).any())
    assert bool((sel[2] == -1).all())
    assert bool((sel[0] >= 0).any())  # position 0's window wrote
    # a popped pair was dropped: some slot took a later candidate of a row
    # whose earlier one was not emitted
    assert _dropped(sel[:2], L)


class _Checked:
    """An ACS step that runs ``lanes_step`` and, at the blocks ``check``
    accepts, holds it against ``acs_block_ref`` on the same inputs first."""

    def __init__(self, check, G):
        self.check, self.G = check, G
        self.blocks = 0
        self.checked = []

    def __call__(self, tabs, prev, stale, *args):
        *rest, sel = args
        if self.check(self.blocks):
            _same_as_ref(tabs, prev, stale, rest, sel.shape[1], self.G)
            self.checked.append(self.blocks)
        lanes_step(tabs, prev, stale, *args, G=self.G)
        self.blocks += 1
        return sel


def _decoder(L, rate, rc=False):
    code = ConvCodeConfig(mem=6, rate=rate, msg_len=12, rc=rc)
    dec = LVADecoder(DecodeConfig(code=twin(code, port_config), list_size=L,
                                  max_deviation=4), device="cpu")
    return code, dec


@pytest.mark.parametrize("G", LANES)
@pytest.mark.parametrize("L,rate,rc", [(12, 5, False), (34, 1, True)])
def test_lanes_on_decode_states(L, rate, rc, G):
    """The model as the ACS step of a CPU decode (m=6, two reads of
    different lengths), held against the plain step at the first blocks
    (trellis position 0 in the window), the middle one and the last (one
    read inactive)."""
    code, dec = _decoder(L, rate, rc)
    posts, nblks = _port_reads(code, (rate + L, rate + L + 1))
    T = int(nblks.max())
    want = {0, 1, T // 2, T - 1}
    step = _Checked(want.__contains__, G)
    _, _, valid = dec.decode(posts, nblks, acs=step)
    assert step.blocks == T and set(step.checked) == want
    assert nblks.min() < T and valid[:, 0].all()


def _short_read(code, seed):
    """A message of ``code`` from ``seed`` and the seeded numpy posteriors
    of its read, one or two blocks a base (``synthetic_post``): (message,
    post [T, 5, 8])."""
    rng = np.random.default_rng(seed)
    msg = rng.integers(0, 2, (1, code.msg_len), dtype=np.uint8)
    bases = conv_encode_bases(make_conv_code(code), msg)[0]
    return msg[0], synthetic_post(bases, rng, noise=0.9, min_dwell=1,
                                  max_dwell=2)


@pytest.mark.parametrize("G", LANES)
def test_lanes_decode_matches_jax(G):
    """At L = 64 the model is the ACS step of a whole decode (m=6 r=1/2,
    msg_len 6, max deviation 2: a short read, since the JAX package's XLA
    decoder takes about a minute at L = 64 on the CPU whatever its length),
    held against the plain step at its first, middle and last blocks; the
    lists, scores and validity equal the JAX package's ``LVADecoder`` on
    the same posteriors, and the top entry is the read's message."""
    L = 64
    code = ConvCodeConfig(mem=6, rate=1, msg_len=6)
    msg, post = _short_read(code, 64)
    dec = LVADecoder(DecodeConfig(code=twin(code, port_config), list_size=L,
                                  max_deviation=2), device="cpu")
    T = len(post)
    step = _Checked({0, T // 2, T - 1}.__contains__, G)
    mp, sp, vp = dec.decode(post[None], acs=step)
    assert step.blocks == T and len(step.checked) == 3
    mj, sj, vj = JaxLVADecoder(JaxDecodeConfig(
        code=code, list_size=L, max_deviation=2,
        backend="xla")).decode(post[None])
    assert np.array_equal(vp, vj)
    assert np.array_equal(sp, sj)
    assert np.array_equal(mp, mj)
    assert vp.sum() == L and (mp[0, 0] == msg).all()
