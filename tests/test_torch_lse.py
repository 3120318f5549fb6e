"""The port's logsumexp path combining against the Pallas kernel's lse
branch (ops/lva_pallas.py:614-646), and a numpy model of the CUDA kernel
(csrc/lva_lse.cu) against the plain step.

Against JAX the tolerance on scores is rtol 1e-5, the JAX suite's own
between its two lse paths (tests/test_lva_traceback.py): XLA's exp, log and
class-sum order are not the port's. Hashes, selections and messages are
exact, since the pops compare raw candidate scores, which are one f32 add
in the same order in both packages. The model repeats the kernel's loop
at L <= 8 (tree pop, class pass over a member mask, knockout), and above it
the flat loop whose order the lane buckets keep (strict-> scan, class pass
in ascending flat index; their lane layout is modelled in
tests/test_torch_lse_lanes.py), and must equal ``acs_block_lse_ref`` bit
for bit, on Pallas-derived states and on rows built to break it.
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
from nanopore_dna_storage_tpu_torch.ops import lva as port_lva
from nanopore_dna_storage_tpu_torch.ops import lva_acs
from nanopore_dna_storage_tpu_torch.ops.lva import LVADecoder
from nanopore_dna_storage_tpu_torch.ops.lva_consts import (
    HASH_P1, HASH_P2, NCRF, DecodeSpec, LVAConsts, sel_format)
from nanopore_dna_storage_tpu_torch.pipeline.decode import PipelineDecoder
from nanopore_dna_storage_tpu_torch.probes import merge_roofline
from test_lva_traceback import _posts
from test_torch_acs import CASES, _case, _hash_update
from test_torch_host import twin

torch.set_num_threads(1)

LSE = "logsumexp"
RTOL = 1e-5
NEG = np.float32(-np.inf)


def _check_against_pallas(got, got_sel, want, want_sel):
    """Hashes, selections and -inf positions exact; finite scores within
    RTOL."""
    assert np.array_equal(got_sel, want_sel)
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g, w)
    fin = torch.isfinite(want[0])
    assert torch.equal(torch.isfinite(got[0]), fin)
    np.testing.assert_allclose(got[0][fin].numpy(), want[0][fin].numpy(),
                               rtol=RTOL, atol=0)


@pytest.mark.parametrize("rate,rc,block,active,dev", CASES)
def test_lse_block_matches_pallas(rate, rc, block, active, dev):
    spec, tabs, t_prev, t_stale, args, want, want_sel = _case(
        rate, rc, block, active, dev, LSE)
    assert spec.combine_lse
    if block == 1:
        assert int(args[2]) == 1  # the window covers trellis position 0
    L, W, C = spec.list_size, spec.window, spec.code.nstate_conv
    st = [x.clone() for x in t_stale]
    sel = torch.empty((1, W, 8 * L, C), dtype=sel_format(L)[0])
    lva_acs.acs_block_lse_ref(tabs, t_prev, st, *args, sel)
    _check_against_pallas([x[0] for x in st], sel[0].numpy(), want,
                          want_sel)
    if not active:
        assert (want_sel == -1).all()
        return
    # the max merge on the same state: same pops, and some class combined
    mx = [x.clone() for x in t_stale]
    msel = torch.empty_like(sel)
    lva_acs.acs_block_ref(tabs, t_prev, mx, *args, msel)
    assert torch.equal(msel, sel)
    assert bool((st[0] > mx[0]).any()) and bool((st[0] >= mx[0]).all())


KL = 8  # the kernel's register bucket: candidate q * KL + slot at L <= KL


def tree_pop(cs):
    """The kernel's pop over candidates cs [N, lanes] (N a power of two):
    adjacent pairs at every level, the right child taken only on a strict
    ``>``. Returns (best, index) per lane."""
    v = cs
    k = np.broadcast_to(np.arange(len(cs)).reshape(-1, *[1] * (cs.ndim - 1)),
                        cs.shape)
    while len(v) > 1:
        right = v[1::2] > v[0::2]
        v = np.where(right, v[1::2], v[0::2])
        k = np.where(right, k[1::2], k[0::2])
    return v[0], k[0]


def scan_pop(cs):
    """An ascending strict-``>`` scan over cs [N, lanes] from -inf: (best,
    index), index -1 where every candidate is -inf."""
    best = np.full(cs.shape[1:], NEG)
    bi = np.full(cs.shape[1:], -1)
    for i in range(len(cs)):
        up = cs[i] > best
        best = np.where(up, cs[i], best)
        bi = np.where(up, i, bi)
    return best, bi


def _lowest_bit(m):
    """Index of the lowest set bit of each nonzero uint64 in m."""
    low = m & (~m + np.uint64(1))
    return np.frexp(low.astype(np.float64))[1] - 1


def thread_merge(cs, c1, c2, nrows, L, code_shift):
    """Numpy model of one thread's merge in ``csrc/lva_lse.cu``, over
    lanes: candidates cs f32, c1, c2 int64, each [nrows * L, lanes] in
    flat order q * L + slot. At L <= 8 the register bucket: the candidates
    laid out at q * 8 + slot in 2 rows (a flop) or 8, the slots past L and
    the absent rows -inf; each round a tree pop, the winner's hashes, the
    members as a uint64 mask, a loop over each lane's members in ascending
    index (the winner's term 1.0), the knockout. Above, the flat order
    that the lane buckets keep: a strict-``>`` scan and a class pass in
    ascending flat index. Returns
    the outputs (score, h1, h2, code), each [L, lanes], and per lane and
    round whether it popped and its member count (int arrays [L, lanes])."""
    lanes = cs.shape[1:]
    regs = L <= KL
    if regs:
        nq = 2 if nrows == 2 else 8
        pad = np.full((nq, KL, *lanes), NEG, np.float32)
        pad[:nrows, :L] = cs.reshape(nrows, L, *lanes)
        cs = pad.reshape(nq * KL, *lanes)
        h = []
        for x in (c1, c2):
            hp = np.zeros((nq, KL, *lanes), np.int64)
            hp[:nrows, :L] = x.reshape(nrows, L, *lanes)
            h.append(hp.reshape(nq * KL, *lanes))
        c1, c2 = h
        per_row = KL
    else:
        cs = cs.copy()
        per_row = L
    out = [np.full((L, *lanes), NEG, np.float32),
           np.zeros((L, *lanes), np.int64), np.zeros((L, *lanes), np.int64),
           np.full((L, *lanes), -1, np.int64)]
    popped = np.zeros((L, *lanes), np.int64)
    nmem = np.zeros((L, *lanes), np.int64)
    left = np.ones(lanes, bool)
    for r in range(L):
        if regs:
            best, bi = tree_pop(cs)
            best = np.where(left, best, NEG)
            left = left & (best > NEG)
        else:
            best, bi = scan_pop(np.where(left, cs, NEG))
            left = bi >= 0
        bi = bi.clip(0)
        a, bb = (np.where(left, np.take_along_axis(x, bi[None], 0)[0], 0)
                 for x in (c1, c2))
        member = left & (c1 == a) & (c2 == bb) & (cs > NEG)
        total = np.zeros(lanes, np.float32)
        if regs:
            m = (member.astype(np.uint64)
                 << np.arange(len(cs), dtype=np.uint64).reshape(
                     -1, *[1] * len(lanes))).sum(0, dtype=np.uint64)
            while m.any():
                has = m != 0
                i = np.where(has, _lowest_bit(m), 0)
                sc = np.take_along_axis(cs, i[None], 0)[0]
                with np.errstate(invalid="ignore"):
                    t = np.where(i == bi, np.float32(1), np.exp(
                        (sc - best).astype(np.float64)).astype(np.float32))
                total = np.where(has, total + t, total)
                m = m & (m - np.uint64(1))
        else:
            for i in range(len(cs)):
                with np.errstate(invalid="ignore"):
                    t = np.exp((cs[i] - best).astype(np.float64)).astype(
                        np.float32)
                total = np.where(member[i], total + t, total)
        cs = np.where(member, NEG, cs)
        with np.errstate(divide="ignore"):
            val = best + np.log(total.astype(np.float64)).astype(np.float32)
        out[0][r] = np.where(left, val, NEG)
        out[1][r], out[2][r] = a, bb
        out[3][r] = np.where(left, (bi // per_row) * code_shift
                             + bi % per_row, -1)
        popped[r] = left
        nmem[r] = member.sum(0)
    return out, popped, nmem


def lse_model(tabs, prev, stale, stay_tr, move_tr, start1, active, W):
    """Numpy model of one block step of ``csrc/lva_lse.cu``. Per CRF
    destination f, every (read, window row, conv state) is a lane: the
    kernel's candidate loads (the stay row at pos, move row q from CRF
    predecessor g at pos - 1 and conv state (k*s + c) mod C), then L rounds
    of its merge (``thread_merge``), the position-0 path and the writes
    where the read is active and the state valid. Returns the new stale
    buffers, the selections [B, W, 8L, C] and the counts over the merged
    lanes: scans, class passes, exp and log calls, and the operations by
    ``acs_lse_needed``'s weights (per candidate 3 a scan and 4 a class
    pass; per lane the score adds, the move rows' hashes and 4 a slot; 2
    an exp term, 1 a log)."""
    tabs = {k: v.numpy().astype(np.int64) for k, v in tabs.items()}
    p_sc = prev[0].numpy()
    p_h1, p_h2 = (x.numpy().astype(np.int64) for x in prev[1:])
    new = [x.numpy().copy() for x in stale]
    stay_tr, move_tr = stay_tr.numpy(), move_tr.numpy()
    B, _, _, L, C = p_sc.shape
    code_shift = sel_format(L)[1]
    b = np.arange(B)[:, None, None]
    s = np.arange(C)
    pos = start1.numpy().astype(np.int64)[:, None, None] \
        + np.arange(W)[:, None]  # [B, W, 1]
    live = active.numpy()[:, None, None] & (tabs["valid"][pos[..., 0]] != 0)
    merged = live & (pos != 1)  # [B, W, C]
    pat = tabs["pattern"][pos]
    kvar = (pat != 0).astype(np.int64)
    shift = 1 + kvar
    nb = tabs["nbits"][kvar, s]
    sel = np.full((B, W, NCRF, L, C), -1, np.int64)
    count = dict(scans=0, passes=0, exp=0, log=0, ops=0)
    for f in range(NCRF):
        g = [f] + [int(x) for x in tabs["qmap"][f, 1:] if x >= 0]
        c = tabs["cstar"][pat, f % 4, s]
        pred = ((s << shift) + c) & (C - 1)
        cs, c1, c2 = [], [], []
        for q, gq in enumerate(g):
            for j in range(L):
                if q == 0:
                    at = (b, pos, f, j, s)
                    tr = stay_tr[:, f]
                else:
                    at = (b, pos - 1, gq, j, pred)
                    tr = move_tr[:, f, gq]
                sc = p_sc[at] + tr[:, None, None]
                h1, h2 = p_h1[at], p_h2[at]
                if q:
                    has = c >= 0
                    sc = np.where(has, sc, NEG)
                    h1 = np.where(has, _hash_update(h1, shift, nb, HASH_P1), 0)
                    h2 = np.where(has, _hash_update(h2, shift, nb, HASH_P2), 0)
                cs.append(sc)
                c1.append(h1)
                c2.append(h2)
        n = len(cs)
        out, popped, nmem = thread_merge(np.stack(cs), np.stack(c1),
                                         np.stack(c2), len(g), L, code_shift)
        # a scan runs in every round up to the first that pops nothing
        scans = np.concatenate([np.ones((1, B, W, C), np.int64),
                                popped[:-1]]).sum(0)
        count["scans"] += int(np.where(merged, scans, 0).sum())
        count["passes"] += int(np.where(merged, popped.sum(0), 0).sum())
        count["exp"] += int(np.where(merged, nmem.sum(0), 0).sum())
        count["log"] += int(np.where(merged, popped.sum(0), 0).sum())
        count["ops"] += int(np.where(merged, n + 22 * (len(g) - 1) * L
                                     + 4 * L + 3 * n * scans
                                     + 4 * n * popped.sum(0)
                                     + 2 * nmem.sum(0) + popped.sum(0),
                                     0).sum())
        # trellis position 0 (padded row 1): stay only
        p0 = pos == 1
        slot = np.arange(L)[:, None, None, None]
        st = [p_sc[b, pos, f, j, s] + stay_tr[:, f, None, None]
              for j in range(L)]
        out[0] = np.where(p0, np.where(slot == 0, np.stack(st), NEG), out[0])
        for k, buf in ((1, p_h1), (2, p_h2)):
            out[k] = np.where(p0, np.stack([buf[b, pos, f, j, s]
                                            for j in range(L)]), out[k])
        out[3] = np.where(p0, slot, out[3])
        bi_, pi_ = np.arange(B)[:, None], pos[..., 0]
        for buf, o in zip(new, out[:3]):
            old = buf[bi_, pi_, f]  # [B, W, L, C]
            buf[bi_, pi_, f] = np.where(live[:, :, None],
                                        o.transpose(1, 2, 0, 3), old)
        sel[:, :, f] = np.where(live[:, :, None], out[3].transpose(1, 2, 0, 3),
                                -1)
    return new, sel.reshape(B, W, NCRF * L, C), count


def _same_as_lse_ref(tabs, prev, stale, args, W):
    """Run ``acs_block_lse_ref`` and ``lse_model`` on one step, assert the
    same buffers and selections bit for bit; return the selections, the
    new stale buffers and the model's counts."""
    B, _, _, L, C = prev[0].shape
    st = [x.clone() for x in stale]
    sel = torch.empty((B, W, NCRF * L, C), dtype=sel_format(L)[0])
    lva_acs.acs_block_lse_ref(tabs, prev, st, *args, sel)
    new, msel, count = lse_model(tabs, prev, stale, *args, W)
    assert np.array_equal(new[0].view(np.int32), st[0].numpy().view(np.int32))
    for got, want in zip(new[1:], st[1:]):
        assert np.array_equal(got, want.numpy())
    assert np.array_equal(msel, sel.numpy())
    return sel, st, count


@pytest.mark.parametrize("rate,rc,block,active,dev", CASES)
def test_lse_model_on_pallas_states(rate, rc, block, active, dev):
    spec, tabs, t_prev, t_stale, args, _, want_sel = _case(
        rate, rc, block, active, dev, LSE)
    sel, _, _ = _same_as_lse_ref(tabs, t_prev, t_stale, args, spec.window)
    assert np.array_equal(sel[0].numpy(), want_sel)


def _adversarial(L, seed, max_deviation=6):
    """A logsumexp decode spec at m=6 r=5 with list size L (and
    ``max_deviation``, which sets the window), and a block
    step's inputs whose previous buffers are built to break a flat lse
    merge: scores in quarter steps from 0 to -3 in random slot order (ties
    within and across rows, rows unsorted), -inf at random slots (tied -inf),
    hashes from {0..3} (pairs repeated within a row, across rows, and
    between the stay row and the moves once updated), transitions in half
    steps. Reads: one whose window covers trellis position 0, one mid-read,
    one inactive, and one mid-read with no finite score at all."""
    rng = np.random.default_rng(seed)
    code = ConvCodeConfig(mem=6, rate=5, msg_len=30)
    spec, tabs_np = DecodeSpec.build(DecodeConfig(
        code=code, list_size=L, max_deviation=max_deviation,
        path_combine=LSE))
    tabs = LVAConsts.build(spec, tabs_np).to("cpu")
    B, P, C, W = 4, spec.npos_pad, spec.code.nstate_conv, spec.window
    sc = -rng.integers(0, 13, (B, P, NCRF, L, C)).astype(np.float32) / 4
    sc[rng.random(sc.shape) < 0.3] = -np.inf
    sc[3] = -np.inf
    h1, h2 = rng.integers(0, 4, (2, B, P, NCRF, L, C)).astype(np.int32)
    prev = tuple(map(torch.from_numpy, (sc, h1, h2)))
    stale = tuple(torch.from_numpy(x.copy()) for x in (sc[:, ::-1], h2, h1))
    stay_tr, move_tr = (torch.from_numpy(
        -rng.integers(0, 3, shape).astype(np.float32) / 2)
        for shape in ((B, NCRF), (B, NCRF, NCRF)))
    start1 = torch.tensor([1, (P - W) // 2, P - W, (P - W) // 2],
                          dtype=torch.int32)
    active = torch.tensor([True, True, False, True])
    return spec, tabs, prev, stale, (stay_tr, move_tr, start1, active)


@pytest.mark.parametrize("L", [1, 2, 3, 5, 8, 34])
def test_lse_model_on_adversarial_rows(L):
    spec, tabs, prev, stale, args = _adversarial(L, seed=L)
    sc = prev[0]
    assert bool((sc[:, :, :, 1:] > sc[:, :, :, :-1]).any()) or L == 1
    W = spec.window
    sel, st, count = _same_as_lse_ref(tabs, prev, stale, args, W)
    codes = sel[:2][sel[:2] >= 0]
    # classes of several live members were summed, slots past the first
    # were taken, rounds popped nothing, and the empty read selected nothing
    assert count["exp"] > count["log"] > 0
    assert bool((codes >= sel_format(L)[1]).any())
    assert bool((sel[:2] == -1).any()) and bool((sel[2] == -1).all())
    assert bool((sel[3] == -1).all())
    if L > 1:
        assert bool((codes % sel_format(L)[1] > 0).any())
        # a later slot outscores an earlier one: the outputs are unsorted
        out = st[0][1, int(args[2][1]):int(args[2][1]) + W]
        assert bool((out[:, :, 1:] > out[:, :, :-1]).any())


def _merge_case(kind, nrows, L, lanes=96, seed=0):
    """Candidates of ``lanes`` threads with ``nrows`` rows of L, flat index
    q * L + slot: scores f32 and hashes (h1, h2), each [nrows * L, lanes],
    built so that the register merge's layout, tree and member loop meet
    ``kind``: ``row_class`` (every slot of one row in one class),
    ``spread_class`` (one slot of every row in one class), ``tied_halves``
    (the maximum both in the tree's lower and upper half), ``all_neg_inf``,
    ``neg_zero`` (+0.0 and -0.0 tied at the top, classes across them) and
    ``random`` (quarter-step scores, -inf at random, hashes from {0..3})."""
    rng = np.random.default_rng(seed)
    n = nrows * L
    sc = (-rng.integers(0, 13, (n, lanes)) / 4).astype(np.float32)
    h1 = rng.integers(0, 1 << 29, (n, lanes))
    h2 = rng.integers(0, 1 << 29, (n, lanes))
    lane = np.arange(lanes)
    at = np.arange(n).reshape(nrows, L)
    if kind == "row_class":
        rows = at[lane % nrows]  # [lanes, L]
        h1[rows.T, lane], h2[rows.T, lane] = 7, 9
    elif kind == "spread_class":
        cols = at[:, lane % L]  # [nrows, lanes]
        h1[cols, lane], h2[cols, lane] = 7, 9
    elif kind == "tied_halves":
        sc[:] = -1
        half = n // 2 if L > 1 or nrows > 1 else 1
        lo = rng.integers(0, half, lanes)
        hi = rng.integers(half, n, lanes) if half < n else lo
        sc[lo, lane] = sc[hi, lane] = 0
    elif kind == "all_neg_inf":
        sc[:] = NEG
    elif kind == "neg_zero":
        sc = rng.choice(np.array([0.0, -0.0, -0.5, NEG], np.float32),
                        (n, lanes))
        h1, h2 = rng.integers(0, 2, (2, n, lanes))
    else:
        sc[rng.random(sc.shape) < 0.3] = NEG
        h1, h2 = rng.integers(0, 4, (2, n, lanes))
    return sc, h1, h2


@pytest.mark.parametrize("L", [1, 3, 5, 8])
@pytest.mark.parametrize("kind", ["row_class", "spread_class", "tied_halves",
                                  "all_neg_inf", "neg_zero", "random"])
def test_thread_merge_matches_merge_lse(kind, L):
    """The model of the kernel's thread, register bucket (L <= 8: tree pop,
    member mask, member loop) at a flop's 2 rows and a flip's 8, bit-equal
    to the plain version's merge ``lva_acs._merge_lse`` on candidates built
    to break it."""
    shift = sel_format(L)[1]
    for nrows in (2, 8):
        sc, h1, h2 = _merge_case(kind, nrows, L, seed=nrows * 10 + L)
        out, popped, nmem = thread_merge(sc, h1, h2, nrows, L, shift)
        key = torch.from_numpy((h1 << 30 | h2).T.copy())
        want = lva_acs._merge_lse(torch.from_numpy(sc.T.copy()), key, L)
        assert np.array_equal(out[0].T.view(np.int32),
                              want[0].numpy().view(np.int32))
        assert np.array_equal((out[1] << 30 | out[2]).T, want[1].numpy())
        assert np.array_equal(out[3].T, want[2].numpy())
        top = out[3][0]
        if kind == "all_neg_inf":
            assert (out[3] == -1).all() and not popped.any()
        elif kind in ("row_class", "spread_class"):
            # a class of several members was summed
            assert (nmem > 1).any() or L == 1 and kind == "row_class" \
                or nrows == 1
        else:
            # the lowest index of the tied maxima (0.0 and -0.0 alike) wins
            zero = (sc == 0).any(0)
            if kind in ("tied_halves", "neg_zero"):
                assert zero.all() if kind == "tied_halves" else zero.any()
            first = (top // shift) * L + top % shift
            assert (first == np.argmax(sc == 0, axis=0))[zero].all()


@pytest.mark.parametrize("L", [1, 2, 8])
def test_lse_needed_counts_the_kernels_work(L):
    """``acs_lse_needed``, the flat yardstick beside the lse kernel's bound
    on the card, counts from the step's output the scans, class passes and
    exp and log calls that the model of the kernel makes in its loop."""
    spec, tabs, prev, stale, args = _adversarial(L, seed=50 + L)
    sel, st, count = _same_as_lse_ref(tabs, prev, stale, args, spec.window)
    got = merge_roofline.acs_lse_needed(tabs, prev, st, sel, *args)
    assert got == (count["ops"], count["exp"], count["log"])
    # some lane ran out of classes: a scan found nothing
    assert count["scans"] > count["passes"] == count["log"]


def group_merge(sc, key, L, code_shift):
    """Numpy model of the grouping merge that ``acs_lse_grouped_needed``
    counts, on one cell's candidates ``sc`` [n] (flat index q * L + slot)
    and class keys ``key`` [n]: the finite candidates sorted by (key,
    index), each class's best (the highest score, the lowest index on a
    tie), the classes ordered by their best, and the first L summed in
    index order. Returns the L outputs (score, key, code) and the counts
    (nf, classes, h, members, classes of more than one member)."""
    live = np.flatnonzero(sc > NEG)
    order = live[np.lexsort((live, key[live]))]
    classes = np.split(order, np.flatnonzero(np.diff(key[order])) + 1) \
        if len(order) else []
    best = [(-sc[c].max(), c[np.argmax(sc[c] == sc[c].max())], c)
            for c in classes]
    out_sc = np.full(L, NEG, np.float32)
    out_key = np.zeros(L, np.int64)
    code = np.full(L, -1, np.int64)
    members = multi = 0
    for r, (_, i, c) in enumerate(sorted(best, key=lambda x: x[:2])[:L]):
        total = np.float32(0)
        for j in c:  # ascending index
            total = np.float32(total + np.float32(
                np.exp(np.float64(np.float32(sc[j] - sc[i])))))
        out_sc[r] = np.float32(sc[i] + np.float32(np.log(np.float64(total))))
        out_key[r] = key[i]
        code[r] = (i // L) * code_shift + i % L
        members += len(c)
        multi += len(c) > 1
    h = min(len(classes), L)
    return (out_sc, out_key, code), (len(live), len(classes), h, members,
                                     multi)


@pytest.mark.parametrize("L", [2, 5, 8])
def test_lse_grouped_needed_counts_the_grouping_merge(L):
    """The grouping merge that ``acs_lse_grouped_needed`` counts for the lse
    kernel's bound gives the plain step's outputs bit for bit on every live
    cell of an adversarial step, and that function's operations and exp and
    log calls are those of the model's own tallies."""
    spec, tabs, prev, stale, args = _adversarial(L, seed=70 + L)
    W = spec.window
    sel, st, _ = _same_as_lse_ref(tabs, prev, stale, args, W)
    stay_tr, move_tr, start1, active = args
    shift = sel_format(L)[1]
    rows = [1 + int((tabs["qmap"][f, 1:] >= 0).sum()) for f in range(NCRF)]
    ops = nexp = nlog = 0
    lg = lambda x: int(np.ceil(np.log2(max(x, 1))))  # noqa: E731
    for b in range(len(active)):
        if not bool(active[b]):
            continue
        one = slice(b, b + 1)
        pos, cand_sc, cand_key, _ = lva_acs.candidates(
            tabs, tuple(x[one] for x in prev), stay_tr[one], move_tr[one],
            start1[one], W)
        pos = pos[0].numpy()
        cs, ck = cand_sc[0].numpy(), cand_key[0].numpy()
        out_sc = st[0][b].numpy()
        out_key = (st[1][b].numpy().astype(np.int64) << 30) | st[2][b].numpy()
        codes = sel[b].numpy().reshape(W, NCRF, L, -1)
        valid = tabs["valid"].numpy()
        for w, f, c in zip(*np.nonzero(np.ones(cs.shape[:3], bool))):
            if pos[w] == 1 or not valid[pos[w], c]:
                continue
            (o_sc, o_key, code), (nf, k, h, m, multi) = group_merge(
                cs[w, f, c], ck[w, f, c], L, shift)
            assert np.array_equal(o_sc.view(np.int32),
                                  out_sc[pos[w], f, :, c].view(np.int32))
            assert np.array_equal(np.where(code >= 0, o_key, 0),
                                  out_key[pos[w], f, :, c])
            assert np.array_equal(code, codes[w, f, :, c])
            n = rows[f] * L
            ops += (n + 22 * (rows[f] - 1) * L + 3 * nf * lg(nf) + nf
                    + 3 * k * lg(k) + 2 * m + h + 4 * L)
            nexp += m - h
            nlog += multi
    got = merge_roofline.acs_lse_grouped_needed(tabs, prev, st, sel, *args)
    assert got == (ops, nexp, nlog)
    # classes of several members were summed, and the count is below the
    # flat merge's
    assert nlog > 0
    assert ops < merge_roofline.acs_lse_needed(tabs, prev, st, sel, *args)[0]


def test_lse_decode_matches_pallas():
    """The port's CPU decode with logsumexp combining against the JAX
    decoder's Pallas kernel in interpret mode on one read (the JAX suite's
    lse case: m=6 r=1/2 msg_len 24, L=2, max deviation 8)."""
    rng = np.random.default_rng(7)
    enc = ConvCodeConfig(mem=6, rate=1, msg_len=24)
    msgs, packed, nblks = _posts(enc, 1, rng)
    kw = dict(list_size=2, max_deviation=8, path_combine=LSE)
    mj, sj, vj = JaxLVADecoder(JaxDecodeConfig(
        code=enc, backend="pallas_interpret", **kw)).decode(packed, nblks)
    dec = LVADecoder(DecodeConfig(code=twin(enc, port_config), **kw),
                     device="cpu")
    mp, sp, vp = dec.decode(packed, nblks)
    assert np.array_equal(vj, vp) and vp.all()
    assert np.array_equal(mj, mp)
    np.testing.assert_allclose(sp, sj, rtol=RTOL, atol=0)
    assert (mp[0, 0] == msgs[0]).all()


def test_path_combine_config():
    code = port_config.ConvCodeConfig(mem=6, rate=1, msg_len=24)
    assert DecodeSpec.build(DecodeConfig(code=code, path_combine=LSE))[
        0].combine_lse
    assert not DecodeSpec.build(DecodeConfig(code=code))[0].combine_lse
    with pytest.raises(ValueError, match="max' or 'logsumexp"):
        DecodeConfig(code=code, path_combine="sum")


def test_decoder_picks_the_step_by_path_combine(monkeypatch):
    """``LVADecoder`` runs ``acs_block_lse`` exactly when ``combine_lse`` is
    set and ``acs_block`` otherwise, and refuses the K-way step under
    logsumexp combining."""
    calls = {"max": 0, "lse": 0}

    def spy(kind, step):
        def run(*a):
            calls[kind] += 1
            return step(*a)
        return run

    monkeypatch.setattr(port_lva, "acs_block", spy("max", lva_acs.acs_block))
    monkeypatch.setattr(port_lva, "acs_block_lse",
                        spy("lse", lva_acs.acs_block_lse))
    code = ConvCodeConfig(mem=6, rate=1, msg_len=24)
    _, packed, nblks = _posts(code, 1, np.random.default_rng(3))
    for combine in ("max", LSE):
        dec = LVADecoder(DecodeConfig(code=twin(code, port_config),
                                      list_size=2, max_deviation=8,
                                      path_combine=combine), device="cpu")
        before = dict(calls)
        dec.decode(packed, nblks)
        ran = {k: calls[k] - before[k] for k in calls}
        kind = "lse" if combine == LSE else "max"
        assert ran == {kind: dec.steps, ("max" if kind == "lse" else "lse"): 0}
    with pytest.raises(ValueError, match="sorted buffer rows"):
        dec.decode(packed, nblks, acs=port_lva.acs_block)


def test_pipeline_decoder_passes_path_combine():
    exp = port_config.ExperimentConfig(bytes_per_oligo=4, rs_redundancy=0.5,
                                       conv_mem=6, conv_rate=1)
    for kw, want in (({}, "max"), ({"path_combine": LSE}, LSE)):
        dec = PipelineDecoder(exp, 2, 8, device="cpu", **kw)
        for d in (dec.fwd, dec.rc):
            assert d.cfg.path_combine == want
            assert d.spec.combine_lse == (want == LSE)
        assert (dec.fwd.cfg.code.rc, dec.rc.cfg.code.rc) == (False, True)


def test_lse_wrapper_takes_the_plain_path_on_cpu():
    """``acs_block_lse`` runs ``acs_block_lse_ref`` on CPU tensors and
    counts no launch; on another device it raises."""
    spec, tabs, prev, stale, args = _adversarial(4, seed=9)
    W, L, C = spec.window, spec.list_size, spec.code.nstate_conv
    launches = lva_acs.LSE_LAUNCHES, lva_acs.LAUNCHES
    outs = []
    for step in (lva_acs.acs_block_lse_ref, lva_acs.acs_block_lse):
        st = [x.clone() for x in stale]
        sel = torch.empty((4, W, 8 * L, C), dtype=torch.int8)
        step(tabs, prev, st, *args, sel)
        outs.append((st, sel))
    assert all(torch.equal(a, b) for a, b in zip(outs[1][0], outs[0][0]))
    assert torch.equal(outs[1][1], outs[0][1])
    assert (lva_acs.LSE_LAUNCHES, lva_acs.LAUNCHES) == launches
    meta = [x.to("meta") for x in prev]
    with pytest.raises(ValueError, match="cpu or cuda"):
        lva_acs.acs_block_lse(tabs, meta, meta, *args,
                              outs[0][1].to("meta"))


def test_lse_scores_dominate_max():
    """The JAX suite's property (tests/test_vocab.py) on the port: on a
    clean post both modes decode the true message at the top, and the
    logsumexp top score is at least the max top score. Under logsumexp
    combining the buffers also leave the slot order that the K-way merge
    needs: some row has a later slot above an earlier one."""
    rng = np.random.default_rng(11)
    cfg = ConvCodeConfig(mem=6, rate=1, msg_len=40)
    msg = rng.integers(0, 2, (1, 40), dtype=np.uint8)
    post = synthetic_post(conv_encode_bases(make_conv_code(cfg), msg)[0],
                          rng, noise=0.8)
    unsorted = []

    def lse_step(tabs, prev, stale, *args):
        sc = prev[0]
        unsorted.append(bool((sc[:, :, :, 1:] > sc[:, :, :, :-1]).any()))
        return lva_acs.acs_block_lse_ref(tabs, prev, stale, *args)

    out = {}
    for combine, step in (("max", None), (LSE, lse_step)):
        out[combine] = LVADecoder(DecodeConfig(
            code=twin(cfg, port_config), list_size=4, max_deviation=None,
            path_combine=combine), device="cpu").decode(post[None], acs=step)
    for m, _, v in out.values():
        assert v[0, 0] and (m[0, 0] == msg[0]).all()
    assert out[LSE][1][0, 0] >= out["max"][1][0, 0]
    assert any(unsorted)
