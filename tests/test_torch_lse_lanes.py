"""The lane layout of the lse kernel's large-list buckets (``csrc/lva_lse.cu``
``lva_lse_lanes_kernel``, the L <= 16 and L <= 64 buckets) as a PyTorch
model, held bit for bit against ``acs_block_lse_ref``.

The CUDA kernel cannot run here, so its algorithm is written out step by
step over every destination (read, window row, CRF destination f, conv
state) of one f at once. Its nq candidate rows sit at padded index
``q * LB + slot`` (LB = 16 or 64, the slots past L -inf), 2 rows for a
flop and 8 for a flip, and G lanes a destination (the kernel's
``kLanes16`` or ``kLanes64``, read from the source) hold them in
contiguous ranges: lane l the N = NQ * LB / G candidates at
``[l * N, (l + 1) * N)``, so ascending lanes hold ascending flat indices.
Each round runs the kernel's steps: a tree pop in each lane (adjacent
pairs, the right child only on a strict ``>``), the shuffle steps on
(score, padded index) across the lanes (the lower index wins a tie), the
winner's hashes from its owner lane, each lane's member mask, the ballot
that takes a class of the winner alone to a sum of exactly 1.0 (output
``best + 0.0f``, no log), and otherwise the class sum chained from 0.0f
through the member lanes in ascending order, each adding its terms (the
winner's 1.0, the others ``exp`` in f64 rounded to f32) in ascending index;
then the knockout. The popped rounds are staged and written as whole rows,
slots past the count (-inf, 0, 0, -1); position 0 and inactive reads take
the kernel's block-wide paths.

It runs at L = 12 and 16 (the L <= 16 bucket, 12 leaving dead slots) and
34 and 64 (the L <= 64 bucket) on candidates built to break the merge
(a class spread over every lane, one in the first and last lanes only,
maxima tied across lanes, all -inf, +0.0 against -0.0) at a flop's 2 rows
and a flip's 8; at L = 12, 16 and 64 on block steps whose rows are built
to break it (unsorted quarter-step scores, repeated hashes, -inf at
random, position 0, an inactive read, a read with no finite score); on
the states of a small CPU decode at m=6; and once as the ACS step of a
whole m=6 logsumexp
decode at L = 16, whose lists must equal the JAX package's ``LVADecoder``
on the same seeded posteriors. The scores are f32 adds and
double-evaluated exp and log rounded once, as in the plain version, so
the tolerance is zero; against JAX, which combines a class in its own
order, scores within rtol 1e-5 as in ``tests/test_torch_lse.py``.
"""
import pathlib
import re

import numpy as np
import pytest
import torch

from nanopore_dna_storage_tpu.config import ConvCodeConfig
from nanopore_dna_storage_tpu.config import DecodeConfig as JaxDecodeConfig
from nanopore_dna_storage_tpu.ops.lva import LVADecoder as JaxLVADecoder
from nanopore_dna_storage_tpu_torch import config as port_config
from nanopore_dna_storage_tpu_torch.config import DecodeConfig
from nanopore_dna_storage_tpu_torch.ops import lva_acs
from nanopore_dna_storage_tpu_torch.ops.lva import LVADecoder
from nanopore_dna_storage_tpu_torch.ops.lva_consts import (
    HASH_P1, HASH_P2, NCRF, NQ_MAX, sel_format)
from test_torch_acs import _port_reads
from test_torch_acs_lanes import _short_read
from test_torch_host import twin
from test_torch_lse import _adversarial

torch.set_num_threads(1)

NEG = float("-inf")
LSE = "logsumexp"
RTOL = 1e-5
_SRC = (pathlib.Path(lva_acs.__file__).resolve().parent.parent / "csrc"
        / "lva_lse.cu").read_text()
# the lanes a destination takes in each bucket, as the kernel is built
LANES = {LB: int(re.search(rf"constexpr int kLanes{LB} = (\d+);",
                           _SRC).group(1)) for LB in (16, 64)}


def _bucket(L):
    """(LB, G) of the bucket that runs list size L > 8."""
    LB = 16 if L <= 16 else 64
    return LB, LANES[LB]


def _hash_update(h, shift, nb, p):
    """``hash_update``: (h << shift) + nb, less p up to three times."""
    t = (h << shift) + nb
    for _ in range(3):
        t = torch.where(t >= p, t - p, t)
    return t


def _tree_max(v):
    """``tree_max`` over the middle axis of v [G, N, D] (N a power of two):
    adjacent pairs at every level, the right one taken only on a strict
    ``>``. Returns each lane's (score, index) [G, D]."""
    k = torch.arange(v.shape[1])[None, :, None].expand_as(v)
    while v.shape[1] > 1:
        right = v[:, 1::2] > v[:, 0::2]
        v = torch.where(right, v[:, 1::2], v[:, 0::2])
        k = torch.where(right, k[:, 1::2], k[:, 0::2])
    return v[:, 0], k[:, 0]


def _group_max(v, k, G):
    """``group_max``: the shuffle steps on (score, index) over the lanes
    axis of v, k [G, D], each lane taking its partner's pair on a higher
    score or an equal one with a lower index. Every lane must end with the
    same pair; returns it [D]."""
    lane = torch.arange(G)
    off = 1
    while off < G:
        partner = lane ^ off
        v2, k2 = v[partner], k[partner]
        take = (v2 > v) | ((v2 == v) & (k2 < k))
        v, k = torch.where(take, v2, v), torch.where(take, k2, k)
        off <<= 1
    assert bool((v == v[:1]).all()) and bool((k == k[:1]).all())
    return v[0], k[0]


def lanes_merge(cs, c1, c2, nq, L, LB, G, stats=None):
    """The merge of ``lva_lse_lanes_kernel``'s lanes over destinations:
    candidates cs f32, c1, c2 int64, each [NQ * LB, D] at padded index q *
    LB + slot (NQ = 2 for a flop's nq = 2 rows, else 8; -inf where there is
    no candidate), L rounds. Returns the outputs (score, h1, h2, code), each
    [L, D], slots past a destination's popped rounds (-inf, 0, 0, -1); and
    counts in ``stats``: rounds that popped, took the ballot's fast path,
    chained their sum, and chain steps (member lanes)."""
    NQ = 2 if nq == 2 else NQ_MAX
    n, D = cs.shape
    assert n == NQ * LB
    N = n // G
    shift = sel_format(L)[1]
    cs = cs.reshape(G, N, D).clone()
    c1, c2 = c1.reshape(G, N, D), c2.reshape(G, N, D)
    lane = torch.arange(G)[:, None, None]
    idx = torch.arange(N)[None, :, None]
    out = [torch.full((L, D), NEG), torch.zeros((L, D), dtype=torch.long),
           torch.zeros((L, D), dtype=torch.long),
           torch.full((L, D), -1, dtype=torch.long)]
    stats = {} if stats is None else stats
    for key in ("pops", "fast", "chained", "chain_lanes"):
        stats.setdefault(key, 0)
    for r in range(L):
        v, k = _tree_max(cs)
        best, gi = _group_max(v, k + torch.arange(G)[:, None] * N, G)
        pop = best > NEG
        if not bool(pop.any()):
            break
        owner, kk = gi // N, gi % N
        d = torch.arange(D)
        a, bb = c1[owner, kk, d], c2[owner, kk, d]
        member = (c1 == a) & (cs > NEG) & (c2 == bb)  # [G, N, D]
        own = (lane == owner) & (idx == kk)
        other = member & ~own
        extra = other.any(1).any(0)  # the ballot, over the group's lanes
        # the chained sum: each member lane in ascending order adds its
        # terms in ascending index onto the sum of the lanes before (the
        # winner's term 1.0); outside the chained classes the terms are an
        # exact 0.0, which leaves a sum as it is
        total = torch.where(extra, torch.zeros(D), torch.ones(D))
        chained = member & extra
        stats["chain_lanes"] += int(chained.any(1).sum())
        terms = torch.exp((cs - best).double()).float()
        terms = torch.where(own, torch.ones(()), terms)
        terms = torch.where(chained, terms, torch.zeros(())).reshape(G * N, D)
        for i in chained.reshape(G * N, D).any(1).nonzero()[:, 0].tolist():
            total = total + terms[i]
        log = torch.log(total.double()).float()
        val = best + torch.where(extra, log, torch.zeros(D))
        cs = cs.masked_fill(member, NEG)
        out[0][r] = torch.where(pop, val, NEG)
        out[1][r] = torch.where(pop, a, 0)
        out[2][r] = torch.where(pop, bb, 0)
        out[3][r] = torch.where(pop, (gi // LB) * shift + gi % LB, -1)
        stats["pops"] += int(pop.sum())
        stats["fast"] += int((pop & ~extra).sum())
        stats["chained"] += int((pop & extra).sum())
    return out


def _load(tabs, prev, stay_tr, move_tr, start1, W, f, LB):
    """The candidates of CRF destination f at the kernel's offsets, each
    [NQ * LB, B * W * C] at padded index q * LB + slot: the stay row at
    position pos, move row q from CRF predecessor qmap[f, q] at position
    pos - 1 and conv state (k*s + c) mod C, its hashes updated; -inf past
    L, past the rows and where no conv candidate emits f's base. Returns
    (cs, c1, c2, nq)."""
    p_sc, p_h1, p_h2 = prev
    B, P, _, L, C = p_sc.shape
    g = [f] + [int(x) for x in tabs["qmap"][f, 1:] if x >= 0]
    nq = len(g)
    NQ = 2 if nq == 2 else NQ_MAX
    pos = start1.long()[:, None] + torch.arange(W)  # [B, W]
    pat = tabs["pattern"].long()[pos]
    kvar = (pat != 0).long()
    shift = (1 + kvar)[..., None]
    s = torch.arange(C)
    nb = tabs["nbits"].long()[kvar]  # [B, W, C]
    c = tabs["cstar"].long()[pat, f % 4]  # [B, W, C]
    pred = ((s << shift) + c) & (C - 1)
    bi = torch.arange(B)[:, None, None]
    cs = torch.full((NQ * LB, B, W, C), NEG)
    c1, c2 = torch.zeros((2, NQ * LB, B, W, C), dtype=torch.long)
    for q, gq in enumerate(g):
        for j in range(L):
            if q == 0:
                at = (bi, pos[..., None], f, j, s)
                sc = p_sc[at] + stay_tr[:, f, None, None]
                h1, h2 = p_h1[at].long(), p_h2[at].long()
            else:
                at = (bi, pos[..., None] - 1, gq, j, pred)
                sc = torch.where(c >= 0, p_sc[at] + move_tr[:, f, gq, None,
                                                             None], NEG)
                h1 = torch.where(c >= 0, _hash_update(
                    p_h1[at].long(), shift, nb, HASH_P1), 0)
                h2 = torch.where(c >= 0, _hash_update(
                    p_h2[at].long(), shift, nb, HASH_P2), 0)
            cs[q * LB + j], c1[q * LB + j], c2[q * LB + j] = sc, h1, h2
    return (cs.reshape(NQ * LB, -1), c1.reshape(NQ * LB, -1),
            c2.reshape(NQ * LB, -1), nq)


def lse_lanes_step(tabs, prev, stale, stay_tr, move_tr, start1, active, sel,
                   stats=None):
    """One block step of ``lva_lse_lanes_kernel`` (L > 8), its G from the
    source; arguments as ``acs_block_lse``'s. Writes ``stale`` and ``sel``
    and returns ``sel``."""
    p_sc, p_h1, p_h2 = prev
    B, P, _, L, C = p_sc.shape
    W = sel.shape[1]
    LB, G = _bucket(L)
    pos = start1.long()[:, None] + torch.arange(W)  # [B, W]
    live = (active[:, None, None] & (tabs["valid"][pos] != 0))  # [B, W, C]
    p0 = live & (pos == 1)[..., None]
    merged = live & ~p0
    slot = torch.arange(L)[:, None, None, None]
    bi = torch.arange(B)[:, None]
    for f in range(NCRF):
        cs, c1, c2, nq = _load(tabs, prev, stay_tr, move_tr, start1, W, f,
                               LB)
        # a destination that is not live merges nothing
        cs = cs.masked_fill(~merged.reshape(1, -1), NEG)
        out = [x.reshape(L, B, W, C)
               for x in lanes_merge(cs, c1, c2, nq, L, LB, G, stats)]
        # position 0: the stay score in slot 0, hashes passed through
        st_sc = p_sc[bi, pos, f].permute(2, 0, 1, 3)  # [L, B, W, C]
        out[0] = torch.where(p0, torch.where(
            slot == 0, st_sc + stay_tr[:, f, None, None], NEG), out[0])
        for k, buf in ((1, p_h1), (2, p_h2)):
            out[k] = torch.where(p0, buf[bi, pos, f].permute(2, 0, 1, 3)
                                 .long(), out[k])
        out[3] = torch.where(p0, slot, out[3])
        for buf, o in zip(stale, out[:3]):
            old = buf[bi, pos, f]  # [B, W, L, C]
            buf[bi, pos, f] = torch.where(live[:, :, None], o.permute(
                1, 2, 0, 3).to(buf.dtype), old)
        sel.view(B, W, NCRF, L, C)[:, :, f] = torch.where(
            live[:, :, None], out[3].permute(1, 2, 0, 3), -1).to(sel.dtype)
    return sel


def _same_as_ref(tabs, prev, stale, args, W, stats=None):
    """``acs_block_lse_ref`` and ``lse_lanes_step`` on copies of one step's
    buffers: buffers and selections bit-equal. Returns the selections."""
    B, _, _, L, C = prev[0].shape
    outs = []
    for step in (lva_acs.acs_block_lse_ref,
                 lambda *a: lse_lanes_step(*a, stats=stats)):
        st = [x.clone() for x in stale]
        sel = torch.empty((B, W, NCRF * L, C), dtype=sel_format(L)[0])
        step(tabs, prev, st, *args, sel)
        outs.append((st, sel))
    (want, want_sel), (got, got_sel) = outs
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert torch.equal(got_sel, want_sel)
    return want_sel


def _merge_case(kind, nrows, L, LB, G, D=64, seed=0):
    """Candidates of D destinations with ``nrows`` rows of L, each [NQ *
    LB, D] at padded index q * LB + slot (-inf past L and past the rows),
    built so that the lanes meet ``kind``: ``spread_class`` (one slot of
    every row in one class, so its members span every lane that holds a
    row), ``end_lanes`` (a class whose only members lie in the first and
    the last lane), ``tied_lanes`` (the maximum in the first and the last
    lane), ``all_neg_inf``, ``neg_zero`` (+0.0 and -0.0 tied at the top,
    classes across them) and ``random`` (quarter-step scores, -inf at
    random, hashes from {0..3})."""
    rng = np.random.default_rng(seed)
    NQ = 2 if nrows == 2 else NQ_MAX
    N = NQ * LB // G
    sc = (-rng.integers(0, 13, (NQ, LB, D)) / 4).astype(np.float32)
    h1 = rng.integers(0, 1 << 29, (NQ, LB, D))
    h2 = rng.integers(0, 1 << 29, (NQ, LB, D))
    col = np.arange(D)
    if kind == "spread_class":
        j = col % L
        h1[:, j, col], h2[:, j, col] = 7, 9
    elif kind in ("end_lanes", "tied_lanes"):
        flat = np.arange(NQ * LB).reshape(NQ, LB)
        real = (np.arange(NQ)[:, None] < nrows) & (np.arange(LB) < L)
        lo = flat[real].min() + rng.integers(0, 2, D)
        hi = flat[real][flat[real] >= (flat[real].max() // N) * N]
        hi = rng.choice(hi, D)
        s2, a1, a2 = sc.reshape(-1, D), h1.reshape(-1, D), h2.reshape(-1, D)
        if kind == "end_lanes":
            a1[lo, col], a2[lo, col] = a1[hi, col], a2[hi, col]
        else:
            s2[:] = -1
            s2[lo, col] = s2[hi, col] = 0
    elif kind == "all_neg_inf":
        sc[:] = NEG
    elif kind == "neg_zero":
        sc = rng.choice(np.array([0.0, -0.0, -0.5, NEG], np.float32),
                        (NQ, LB, D))
        h1, h2 = rng.integers(0, 2, (2, NQ, LB, D))
    else:
        sc[rng.random(sc.shape) < 0.3] = NEG
        h1, h2 = rng.integers(0, 4, (2, NQ, LB, D))
    sc[nrows:] = NEG
    sc[:, L:] = NEG
    return (torch.from_numpy(sc.reshape(-1, D)),
            torch.from_numpy(h1.reshape(-1, D)),
            torch.from_numpy(h2.reshape(-1, D)))


@pytest.mark.parametrize("L", [12, 16, 34, 64])
@pytest.mark.parametrize("kind", ["spread_class", "end_lanes", "tied_lanes",
                                  "all_neg_inf", "neg_zero", "random"])
def test_lanes_merge_matches_merge_lse(kind, L):
    """The lanes' merge at a flop's 2 rows and a flip's 8, bit-equal to the
    plain version's merge ``lva_acs._merge_lse`` on the flat candidates."""
    LB, G = _bucket(L)
    shift = sel_format(L)[1]
    stats = {}
    for nrows in (2, NQ_MAX):
        NQ = 2 if nrows == 2 else NQ_MAX
        N = NQ * LB // G
        cs, c1, c2 = _merge_case(kind, nrows, L, LB, G, seed=nrows * 100 + L)
        out = lanes_merge(cs, c1, c2, nrows, L, LB, G, stats)
        # the plain merge over the flat candidates q * L + slot
        flat = cs.reshape(NQ, LB, -1)[:nrows, :L].reshape(nrows * L, -1)
        key = (c1 << 30 | c2).reshape(NQ, LB, -1)[:nrows, :L].reshape(
            nrows * L, -1)
        want = lva_acs._merge_lse(flat.T.contiguous(), key.T.contiguous(), L)
        assert torch.equal(out[0].T.contiguous().view(torch.int32),
                           want[0].view(torch.int32))
        assert torch.equal((out[1] << 30 | out[2]).T, want[1])
        assert torch.equal(out[3].T, want[2])
        lanes_hit = (out[3] >= 0) * ((out[3] // shift) * LB + out[3] % shift
                                     ) // N
        if kind == "all_neg_inf":
            assert stats["pops"] == 0 and bool((out[3] == -1).all())
        elif kind == "spread_class":
            # the class spans the lanes: its sum was chained over them
            assert stats["chained"] > 0 and stats["chain_lanes"] > \
                stats["chained"]
        elif kind == "end_lanes":
            assert stats["chained"] > 0 and stats["fast"] > 0
        elif kind == "tied_lanes":
            # the lower index of the two maxima wins: the first lane's
            assert bool((lanes_hit[0] == 0).all())
        elif kind == "neg_zero":
            # the lowest index of the tied zeros (0.0 and -0.0 alike) wins
            zero = (cs == 0).any(0)
            first = (out[3][0] // shift) * LB + out[3][0] % shift
            assert bool(zero.any())
            assert bool((first == (cs == 0).int().argmax(0))[zero].all())
        else:
            assert int(lanes_hit.max()) > 0
    if kind in ("neg_zero", "random"):
        assert stats["chained"] > 0
    if kind == "random":
        assert stats["fast"] > 0


@pytest.mark.parametrize("L", [12, 16, 64])
def test_lanes_step_on_adversarial_rows(L):
    """Block steps whose rows are built to break a logsumexp merge
    (``test_torch_lse._adversarial``: unsorted quarter-step scores, -inf at
    random, hashes from {0..3}, a read at position 0, one mid-read, one
    inactive and one with no finite score), in a window of 5 rows (max
    deviation 2) so that the plain step stays a few seconds at L = 64."""
    spec, tabs, prev, stale, args = _adversarial(L, seed=L + 3,
                                                 max_deviation=2)
    stats = {}
    sel = _same_as_ref(tabs, prev, stale, args, spec.window, stats)
    codes = sel[:2][sel[:2] >= 0].long()
    shift = sel_format(L)[1]
    assert bool((codes >= shift).any()) and bool((codes % shift > 0).any())
    assert bool((sel[2] == -1).all()) and bool((sel[3] == -1).all())
    assert stats["chained"] > 0


class _Checked:
    """An ACS step that runs ``step`` (the model by default) and, at the
    blocks ``check`` accepts, holds the model against ``acs_block_lse_ref``
    on the same inputs first."""

    def __init__(self, check, step=lse_lanes_step):
        self.check, self.step = check, step
        self.blocks = 0
        self.checked = []
        self.stats = {}

    def __call__(self, tabs, prev, stale, *args):
        *rest, sel = args
        if self.check(self.blocks):
            _same_as_ref(tabs, prev, stale, rest, sel.shape[1], self.stats)
            self.checked.append(self.blocks)
        self.step(tabs, prev, stale, *args)
        self.blocks += 1
        return sel


def test_lanes_on_decode_states():
    """The model on the states of a CPU logsumexp decode through the plain
    step (m=6 r=5/6, L = 12, max deviation 2, two reads of different
    lengths), held against the plain step at the first blocks (trellis
    position 0 in the window), the middle one and the last (one read
    inactive)."""
    L = 12
    code = ConvCodeConfig(mem=6, rate=5, msg_len=12)
    dec = LVADecoder(DecodeConfig(code=twin(code, port_config), list_size=L,
                                  max_deviation=2, path_combine=LSE),
                     device="cpu")
    posts, nblks = _port_reads(code, (5 + L, 6 + L))
    T = int(nblks.max())
    want = {0, 1, T // 2, T - 1}
    step = _Checked(want.__contains__, lva_acs.acs_block_lse_ref)
    _, _, valid = dec.decode(posts, nblks, acs=step)
    assert step.blocks == T and set(step.checked) == want
    assert nblks.min() < T and valid[:, 0].all()
    assert step.stats["chained"] > 0


def test_lanes_decode_matches_jax():
    """At L = 16 the model is the ACS step of a whole logsumexp decode
    (m=6 r=1/2, msg_len 6, max deviation 2), held against the plain step at
    its first, middle and last blocks; the lists and validity equal the
    JAX package's ``LVADecoder`` on the same posteriors, its scores within
    rtol 1e-5, and the top entry is the read's message. The JAX decoder
    runs its XLA merge with a round for every candidate (``merge_rounds``),
    which combines each class's whole mass as the Pallas kernel's lse
    branch does (``tests/test_lva_traceback.py``) in a tenth of the time of
    that kernel in interpret mode."""
    L = 16
    code = ConvCodeConfig(mem=6, rate=1, msg_len=6)
    msg, post = _short_read(code, 16)
    kw = dict(list_size=L, max_deviation=2, path_combine=LSE)
    dec = LVADecoder(DecodeConfig(code=twin(code, port_config), **kw),
                     device="cpu")
    T = len(post)
    step = _Checked({0, T // 2, T - 1}.__contains__)
    mp, sp, vp = dec.decode(post[None], acs=step)
    assert step.blocks == T and len(step.checked) == 3
    mj, sj, vj = JaxLVADecoder(JaxDecodeConfig(
        code=code, merge_rounds=NQ_MAX * L + 1, **kw)).decode(post[None])
    assert np.array_equal(vp, vj)
    assert np.array_equal(mp, mj)
    np.testing.assert_allclose(sp, sj, rtol=RTOL, atol=0)
    assert vp.sum() == L and (mp[0, 0] == msg).all()
