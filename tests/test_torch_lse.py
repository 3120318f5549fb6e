"""The port's logsumexp path combining against the Pallas kernel's lse
branch (ops/lva_pallas.py:614-646), and a numpy model of the CUDA kernel
(csrc/lva_lse.cu) against the plain step.

Against JAX the tolerance on scores is rtol 1e-5, the JAX suite's own
between its two lse paths (tests/test_lva_traceback.py): XLA's exp, log and
class-sum order are not the port's. Hashes, selections and messages are
exact, since the pops compare raw candidate scores, which are one f32 add
in the same order in both packages. The model repeats the kernel's loop
(strict-> scan, class pass in ascending flat index, knockout) and must equal
``acs_block_lse_ref`` bit for bit, on Pallas-derived states and on rows
built to break it.
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


def lse_model(tabs, prev, stale, stay_tr, move_tr, start1, active, W):
    """Numpy model of one block step of ``csrc/lva_lse.cu``. Per CRF
    destination f, every (read, window row, conv state) is a lane: the
    kernel's candidate loads (the stay row at pos, move row q from CRF
    predecessor g at pos - 1 and conv state (k*s + c) mod C), then L rounds
    of its strict-> scan and its class pass in ascending flat index, the
    position-0 path and the writes where the read is active and the state
    valid. Returns the new stale buffers, the selections [B, W, 8L, C] and
    the counts over the merged lanes: scans, class passes, exp and log calls,
    and the operations by ``acs_lse_needed``'s weights (per candidate 3 a
    scan and 4 a class pass; per lane the score adds, the move rows' hashes
    and 4 a slot; 2 an exp term, 1 a log)."""
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
        cs = np.stack(cs)
        c1, c2 = np.stack(c1), np.stack(c2)
        n = len(cs)
        out = [np.full((L, B, W, C), NEG), np.zeros((L, B, W, C), np.int64),
               np.zeros((L, B, W, C), np.int64),
               np.full((L, B, W, C), -1, np.int64)]
        left = np.ones((B, W, C), bool)  # some candidate is finite
        count["ops"] += (n + 22 * (len(g) - 1) * L + 4 * L) * int(
            merged.sum())
        for r in range(L):
            count["scans"] += int((left & merged).sum())
            count["ops"] += 3 * n * int((left & merged).sum())
            best = np.full((B, W, C), NEG)
            bi = np.full((B, W, C), -1)
            for i in range(n):
                up = left & (cs[i] > best)
                best = np.where(up, cs[i], best)
                bi = np.where(up, i, bi)
            left = bi >= 0
            count["passes"] += int((left & merged).sum())
            count["ops"] += 4 * n * int((left & merged).sum())
            a, bb = (np.where(left, np.take_along_axis(
                h, bi.clip(0)[None], 0)[0], 0) for h in (c1, c2))
            total = np.zeros((B, W, C), np.float32)
            for i in range(n):
                member = left & (c1[i] == a) & (c2[i] == bb)
                term = member & (cs[i] > NEG)
                with np.errstate(invalid="ignore"):
                    t = np.exp((cs[i] - best).astype(np.float64)).astype(
                        np.float32)
                total = np.where(term, total + t, total)
                count["exp"] += int((term & merged).sum())
                count["ops"] += 2 * int((term & merged).sum())
                cs[i] = np.where(member, NEG, cs[i])
            with np.errstate(divide="ignore"):
                val = best + np.log(total.astype(np.float64)).astype(
                    np.float32)
            out[0][r] = np.where(left, val, NEG)
            out[1][r], out[2][r] = a, bb
            out[3][r] = np.where(left, (bi // L) * code_shift + bi % L, -1)
            count["log"] += int((left & merged).sum())
            count["ops"] += int((left & merged).sum())
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


def _adversarial(L, seed):
    """A logsumexp decode spec at m=6 r=5 with list size L, and a block
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
        code=code, list_size=L, max_deviation=6, path_combine=LSE))
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


@pytest.mark.parametrize("L", [1, 2, 8, 34])
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


@pytest.mark.parametrize("L", [1, 2, 8])
def test_lse_needed_counts_the_kernels_work(L):
    """``acs_lse_needed``, which the lse kernel's bound on the card takes,
    counts from the step's output the scans, class passes and exp and log
    calls that the model of the kernel makes in its loop."""
    spec, tabs, prev, stale, args = _adversarial(L, seed=50 + L)
    sel, st, count = _same_as_lse_ref(tabs, prev, stale, args, spec.window)
    got = merge_roofline.acs_lse_needed(tabs, prev, st, sel, *args)
    assert got == (count["ops"], count["exp"], count["log"])
    # some lane ran out of classes: a scan found nothing
    assert count["scans"] > count["passes"] == count["log"]


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
