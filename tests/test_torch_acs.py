"""Block-level parity of the port's ACS step against the Pallas kernel, and
of a numpy model of the CUDA kernel's K-way merge against the plain step.

A mid-read decoder state is built by running the JAX ``acs_block``
(ops/lva_pallas.py, interpret mode) over the first blocks of a synthetic
read; that state is carried into the port with ``from_pallas_state`` and one
more block runs through both. The new buffers and the selections must be
bit-identical: every score is one f32 add in the same order, and hashes and
selections are integers, so the tolerance is zero.

The CUDA kernel (csrc/lva_acs.cu) cannot run here, so its algorithm is held
instead: ``kway_model`` repeats its K-way loop in numpy, the conv states as
lanes, and must equal ``acs_block_ref`` bit for bit on those Pallas states,
on the states of CPU decodes through the port, and on synthetic sorted rows
built to break it (ties within and across rows, tied -inf, repeated hash
pairs, exhausted rows, L from 1 to 34). The merge relies on every buffer
row being sorted in slot; a test checks that over whole decodes.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanopore_dna_storage_tpu.coding.conv import (conv_encode_bases,
                                                  make_conv_code)
from nanopore_dna_storage_tpu.config import ConvCodeConfig
from nanopore_dna_storage_tpu.config import DecodeConfig as JaxDecodeConfig
from nanopore_dna_storage_tpu.ops import lva_pallas
from nanopore_dna_storage_tpu.ops.lva import LVADecoder as JaxLVADecoder
from nanopore_dna_storage_tpu.ops.synthetic import synthetic_post
from nanopore_dna_storage_tpu_torch import config as port_config
from nanopore_dna_storage_tpu_torch.config import DecodeConfig
from nanopore_dna_storage_tpu_torch.io.post import pack_posts
from nanopore_dna_storage_tpu_torch.ops import lva_acs
from nanopore_dna_storage_tpu_torch.ops.lva import LVADecoder
from nanopore_dna_storage_tpu_torch.ops.lva_consts import (
    HASH_P1, HASH_P2, NCRF, DecodeSpec, LVAConsts, from_pallas_state,
    sel_format)
from nanopore_dna_storage_tpu_torch.probes import merge_roofline
from nanopore_dna_storage_tpu_torch.utils import profiling
from test_torch_host import twin

torch.set_num_threads(1)


def _read(code_cfg, seed):
    rng = np.random.default_rng(seed)
    code = make_conv_code(dataclasses.replace(code_cfg, rc=False))
    msg = rng.integers(0, 2, (1, code_cfg.msg_len), dtype=np.uint8)
    bases = conv_encode_bases(code, msg)[0]
    if code_cfg.rc:
        bases = (3 - bases)[::-1]
    return synthetic_post(bases, rng, noise=0.9)


@functools.lru_cache(maxsize=None)
def _jax_step(code, cfg):
    """The JAX Pallas decoder of ``cfg`` and its block step, jitted once per
    config; ``code`` is the JAX package's config of ``cfg.code``, and the
    decoder combines paths as ``cfg`` does."""
    jdec = JaxLVADecoder(JaxDecodeConfig(
        code=code, list_size=cfg.list_size,
        max_deviation=cfg.max_deviation, path_combine=cfg.path_combine,
        backend="pallas_interpret"))
    pd = jdec._pallas

    @jax.jit
    def step(prev, stale, postf, start1, active):
        return lva_pallas.acs_block(pd.spec, pd.consts, pd._cdev, prev,
                                    stale, postf, start1, active,
                                    interpret=True)

    return jdec, step


def _jax_states(code, cfg, post, t_stop):
    """Pallas decoder state (prev, stale) before block ``t_stop``, plus the
    decoder and the read's beam starts; ``code`` and ``cfg`` as in
    ``_jax_step``."""
    jdec, step = _jax_step(code, cfg)
    pd = jdec._pallas
    starts = jdec.schedule(np.array([post.shape[0]]), post.shape[0])[0]
    b = lva_pallas._init_buffers(pd.spec, pd.consts)
    prev, stale = b[:3], b[3:]
    for t in range(t_stop):
        out = step(prev, stale, jnp.asarray(post[t].reshape(-1)),
                   jnp.int32(starts[t] + 1), jnp.bool_(True))
        prev, stale = out[:3], prev
    return pd, step, prev, stale, starts


CASES = [
    # (rate, rc, block, active, dev): r=1 is pattern 0 only, r=5 mixes
    # patterns; block 1 has padded row 1 (trellis position 0) in its window
    (1, False, 30, True, 8),
    (5, False, 25, True, 6),
    (5, False, 1, True, 6),
    (5, False, 12, False, 6),
    (5, True, 20, True, 6),
]


@functools.lru_cache(maxsize=None)
def _case(rate, rc, block, active, dev, path_combine="max"):
    """One ``CASES`` entry: the port's tables, the Pallas state carried
    over, this block's inputs and the Pallas kernel's outputs of it, both
    decoders combining paths by ``path_combine``."""
    L = 4
    code = ConvCodeConfig(mem=6, rate=rate, msg_len=30, rc=rc)
    cfg = DecodeConfig(code=twin(code, port_config), list_size=L,
                       max_deviation=dev, path_combine=path_combine)
    post = _read(code, seed=rate * 10 + rc)
    pd, step, prev, stale, starts = _jax_states(code, cfg, post, block)
    start1 = int(starts[block]) + 1
    spec, tabs_np = DecodeSpec.build(cfg)
    tabs = LVAConsts.build(spec, tabs_np).to("cpu")
    t_prev = [x[None] for x in from_pallas_state(
        pd.consts, [np.asarray(a) for a in prev])]
    t_stale = [x[None] for x in from_pallas_state(
        pd.consts, [np.asarray(a) for a in stale])]
    postf = torch.from_numpy(post[block].reshape(1, 40))
    args = (postf[:, tabs["stay_idx"]], postf[:, tabs["move_idx"]],
            torch.tensor([start1], dtype=torch.int32), torch.tensor([active]))
    out = step(prev, stale, jnp.asarray(post[block].reshape(-1)),
               jnp.int32(start1), jnp.bool_(active))
    want = from_pallas_state(pd.consts, [np.asarray(a) for a in out[:3]])
    want_sel = np.asarray(out[3])[..., pd.consts.perm]
    return spec, tabs, t_prev, t_stale, args, want, want_sel


@pytest.mark.parametrize("rate,rc,block,active,dev", CASES)
def test_acs_block_matches_pallas(rate, rc, block, active, dev):
    spec, tabs, t_prev, t_stale, args, want, want_sel = _case(
        rate, rc, block, active, dev)
    if block == 1:
        assert int(args[2]) == 1  # the window covers trellis position 0
    L = spec.list_size
    t_stale = [x.clone() for x in t_stale]
    sel = torch.empty((1, spec.window, 8 * L, spec.code.nstate_conv),
                      dtype=sel_format(L)[0])
    lva_acs.acs_block_ref(tabs, t_prev, t_stale, *args, sel)
    for got, ref in zip(t_stale, want):
        assert torch.equal(got[0], ref)
    assert np.array_equal(sel[0].numpy(), want_sel)
    if active:
        assert (want_sel >= 0).any()
    else:
        assert (want_sel == -1).all()


def test_argmax_takes_first_of_tied_infinities():
    """The plain merge relies on torch.argmax returning the first maximal
    index, also when the maximum is an infinity several candidates share."""
    x = torch.tensor([[-np.inf, -np.inf, -np.inf],
                      [1.0, np.inf, np.inf],
                      [2.0, 0.5, 2.0]], dtype=torch.float32)
    assert x.argmax(dim=1).tolist() == [0, 1, 0]


def _hash_update(h, shift, nb, p):
    """The kernel's ``hash_update``: (h << shift) + nb, less p up to three
    times (the sum is below 4p)."""
    t = (h << shift) + nb
    for _ in range(3):
        t = np.where(t >= p, t - p, t)
    return t


def _kway_lanes(bufs, tabs, b, pos, f, stay_tr, move_tr):
    """The kernel's K-way loop for read ``b``, padded position ``pos`` and
    CRF destination ``f``, every conv state a lane. Returns the L output
    slots [L, C] (scores, h1, h2, selection codes), and what it read: the
    CRF state of each row, the move rows' conv state [C] and the slots read
    of each row [rows, C]."""
    p_sc, p_h1, p_h2 = bufs
    L, C = p_sc.shape[-2:]
    lanes = np.arange(C)
    neg = np.float32(-np.inf)
    # rows: the stay row, then one move row per CRF predecessor g
    g = np.array([f] + [int(x) for x in tabs["qmap"][f, 1:] if x >= 0])
    tr = np.array([stay_tr[b, f], *move_tr[b, f, g[1:]]], np.float32)
    pat = int(tabs["pattern"][pos])
    kvar = int(pat != 0)
    shift = 1 + kvar
    nb = tabs["nbits"][kvar]
    c = tabs["cstar"][pat, f % 4]
    pred = ((lanes << shift) + c) & (C - 1)

    def load(q, j):  # slot j of row q, per lane, as the kernel's load_head
        stay = q == 0
        at = (b, np.where(stay, pos, pos - 1), g[q], j,
              np.where(stay, lanes, pred))
        h1, h2 = p_h1[at], p_h2[at]
        return (p_sc[at] + tr[q],
                np.where(stay, h1, _hash_update(h1, shift, nb, HASH_P1)),
                np.where(stay, h2, _hash_update(h2, shift, nb, HASH_P2)))

    n = len(g)
    hs = np.full((n, C), neg, np.float32)  # heads: slot hj of each row
    ha, hb = np.zeros((2, n, C), np.int64)
    hj = np.zeros((n, C), np.int64)
    for q in range(n):
        has = np.ones(C, bool) if q == 0 else c >= 0  # c < 0: exhausted
        sc, h1, h2 = load(np.full(C, q), hj[q])
        hs[q] = np.where(has, sc, neg)
        ha[q], hb[q] = np.where(has, h1, 0), np.where(has, h2, 0)
    osc = np.full((L, C), neg, np.float32)
    o1, o2 = np.zeros((2, L, C), np.int64)
    oq = np.full((L, C), -1, np.int64)
    left = np.ones(C, bool)  # some head is finite
    code_shift = sel_format(L)[1]
    for r in range(L):
        look = left.copy()  # lanes still popping for slot r
        while look.any():
            bq = hs.argmax(0)  # the first maximum: rows in ascending q
            top, ta, tb, tj = (x[bq, lanes] for x in (hs, ha, hb, hj))
            out = look & (top == neg)
            left &= ~out
            look &= ~out
            # advance the popped row: its next slot, or -inf past the end
            jn = tj + 1
            sc, h1, h2 = load(bq, np.minimum(jn, L - 1))
            more = jn < L
            at = (bq[look], lanes[look])
            hs[at] = np.where(more, sc, neg)[look]
            ha[at] = np.where(more, h1, 0)[look]
            hb[at] = np.where(more, h2, 0)[look]
            hj[at] = jn[look]
            # a pair already emitted is dropped
            dup = ((o1[:r] == ta) & (o2[:r] == tb)).any(0)
            emit = look & ~dup
            osc[r] = np.where(emit, top, osc[r])
            o1[r] = np.where(emit, ta, o1[r])
            o2[r] = np.where(emit, tb, o2[r])
            oq[r] = np.where(emit, bq * code_shift + tj, oq[r])
            look &= dup
    present = np.array([np.ones(C, bool)] + [c >= 0] * (n - 1))
    read = np.where(present, np.minimum(hj + 1, L), 0)
    return (osc, o1, o2, oq), (g, pred, read)


def kway_model(tabs, prev, stale, stay_tr, move_tr, start1, active, W):
    """Numpy model of one block step of the CUDA kernel: the K-way loop per
    (read, window row, CRF destination), the position-0 path, and the
    writes only where the read is active and the state valid. Returns the
    new stale buffers, the selections [B, W, 8L, C], and the slots read of
    each previous row, scores and hashes apart ([B, P, 8, C] each)."""
    tabs = {k: v.numpy().astype(np.int64) for k, v in tabs.items()}
    bufs = [prev[0].numpy(), prev[1].numpy().astype(np.int64),
            prev[2].numpy().astype(np.int64)]
    new = [x.numpy().copy() for x in stale]
    stay_tr, move_tr = stay_tr.numpy(), move_tr.numpy()
    B, _, _, L, C = bufs[0].shape
    sel = np.full((B, W, NCRF, L, C), -1, np.int64)
    depth = np.zeros((2, B, bufs[0].shape[1], NCRF, C), np.int64)
    slot = np.arange(L)[:, None]
    for b in range(B):
        for w in range(W):
            pos = int(start1[b]) + w
            live = bool(active[b]) & (tabs["valid"][pos] != 0)
            for f in range(NCRF):
                if not live.any():
                    continue
                if pos == 1:  # trellis position 0: stay only
                    outs = (np.where(slot == 0, bufs[0][b, 1, f, 0]
                                     + stay_tr[b, f], np.float32(-np.inf)),
                            bufs[1][b, 1, f], bufs[2][b, 1, f],
                            np.broadcast_to(slot, (L, C)))
                    # slot 0's score and every slot's hashes
                    for d, k in zip(depth, (1, L)):
                        d[b, 1, f] = np.where(live, np.maximum(d[b, 1, f], k),
                                              d[b, 1, f])
                else:
                    outs, (g, pred, read) = _kway_lanes(
                        bufs, tabs, b, pos, f, stay_tr, move_tr)
                    read = np.where(live, read, 0)
                    lanes = np.arange(C)
                    for d in depth:
                        np.maximum.at(d, (b, pos, f, lanes), read[0])
                        for q in range(1, len(g)):
                            np.maximum.at(d, (b, pos - 1, g[q], pred),
                                          read[q])
                for buf, o in zip(new, outs):
                    buf[b, pos, f] = np.where(live, o, buf[b, pos, f])
                sel[b, w, f] = np.where(live, outs[3], -1)
    return new, sel.reshape(B, W, NCRF * L, C), depth


def _same_as_ref(tabs, prev, stale, args, W):
    """Run ``acs_block_ref`` and ``kway_model`` on one step and assert both
    give the same buffers and selections, bit for bit."""
    B, _, _, L, C = prev[0].shape
    st = [x.clone() for x in stale]
    sel = torch.empty((B, W, NCRF * L, C), dtype=sel_format(L)[0])
    lva_acs.acs_block_ref(tabs, prev, st, *args, sel)
    new, msel, _ = kway_model(tabs, prev, stale, *args, W)
    assert np.array_equal(new[0].view(np.int32), st[0].numpy().view(np.int32))
    for got, want in zip(new[1:], st[1:]):
        assert np.array_equal(got, want.numpy())
    assert np.array_equal(msel, sel.numpy())
    return sel


@pytest.mark.parametrize("rate,rc,block,active,dev", CASES)
def test_kway_model_on_pallas_states(rate, rc, block, active, dev):
    spec, tabs, t_prev, t_stale, args, _, want_sel = _case(
        rate, rc, block, active, dev)
    sel = _same_as_ref(tabs, t_prev, t_stale, args, spec.window)
    assert np.array_equal(sel[0].numpy(), want_sel)


def _port_reads(code_cfg, seeds):
    """Synthetic reads of ``code_cfg`` packed as a batch (posts, nblks)."""
    return pack_posts([_read(code_cfg, s) for s in seeds])


class _Steps:
    """An ACS step that runs ``acs_block_ref`` and hands every step's
    inputs to ``check`` first."""

    def __init__(self, check):
        self.check, self.blocks = check, 0

    def __call__(self, tabs, prev, stale, *args):
        self.check(self.blocks, tabs, prev, stale, args)
        lva_acs.acs_block_ref(tabs, prev, stale, *args)
        self.blocks += 1
        return args[-1]


def test_kway_model_on_port_decode():
    """The model against the plain step on the states of a CPU decode
    through the port: m=6, r=5, L=8, two reads of different lengths, every
    fifth block and the last."""
    code = ConvCodeConfig(mem=6, rate=5, msg_len=30)
    dec = LVADecoder(DecodeConfig(code=code, list_size=8, max_deviation=6),
                     device="cpu")
    posts, nblks = _port_reads(code, (3, 4))
    T = int(nblks.max())
    checked = []

    def check(t, tabs, prev, stale, args):
        if t % 5 == 0 or t == T - 1:
            _same_as_ref(tabs, prev, stale, args[:-1], dec.spec.window)
            checked.append(t)

    steps = _Steps(check)
    dec.decode(posts, nblks, acs=steps)
    assert steps.blocks == T and len(checked) == len(range(0, T, 5)) + (
        (T - 1) % 5 != 0)


def _adversarial(L, seed):
    """A decode spec at m=6 r=5 with list size L, and a block step's inputs
    whose previous buffers hold sorted rows built to break a merge: integer
    scores and transitions (ties within and across rows), -inf tails of
    random length (tied -inf, whole rows exhausted), hashes from {0..3}
    (pairs repeated within rows, across move rows and between the stay row
    and move rows once updated). Reads: one whose window covers trellis
    position 0, one mid-read, one inactive."""
    rng = np.random.default_rng(seed)
    code = ConvCodeConfig(mem=6, rate=5, msg_len=30)
    spec, tabs_np = DecodeSpec.build(DecodeConfig(code=code, list_size=L,
                                                  max_deviation=6))
    tabs = LVAConsts.build(spec, tabs_np).to("cpu")
    B, P, C, W = 3, spec.npos_pad, spec.code.nstate_conv, spec.window
    sc = -rng.integers(0, 4, (B, P, NCRF, L, C)).astype(np.float32)
    sc = -np.sort(-sc, axis=3)  # each row non-increasing in slot
    keep = rng.integers(0, L + 1, (B, P, NCRF, 1, C))  # finite slots
    sc = np.where(np.arange(L)[:, None] < keep, sc, np.float32(-np.inf))
    h1, h2 = rng.integers(0, 4, (2, B, P, NCRF, L, C)).astype(np.int32)
    prev = tuple(map(torch.from_numpy, (sc, h1, h2)))
    stale = tuple(torch.from_numpy(x.copy()) for x in (sc[:, ::-1], h2, h1))
    stay_tr = torch.from_numpy(-rng.integers(0, 2, (B, NCRF)).astype(
        np.float32))
    move_tr = torch.from_numpy(-rng.integers(0, 2, (B, NCRF, NCRF)).astype(
        np.float32))
    start1 = torch.tensor([1, (P - W) // 2, P - W], dtype=torch.int32)
    active = torch.tensor([True, True, False])
    return spec, tabs, prev, stale, (stay_tr, move_tr, start1, active)


@pytest.mark.parametrize("L", [1, 2, 8, 34])
def test_kway_model_on_adversarial_rows(L):
    spec, tabs, prev, stale, args = _adversarial(L, seed=L)
    sc = prev[0]
    assert bool((sc[:, :, :, 1:] <= sc[:, :, :, :-1]).all())
    assert bool((sc == -np.inf).all(3).any())  # some rows exhausted
    assert (tabs["cstar"] < 0).any()  # and some move rows absent
    sel = _same_as_ref(tabs, prev, stale, args, spec.window)
    codes = sel[:2][sel[:2] >= 0]
    # the merge took slots past the first of move rows and dropped pairs
    assert bool((codes >= sel_format(L)[1]).any())
    assert bool((sel[:2] == -1).any()) and bool((sel[2] == -1).all())
    if L > 1:
        assert bool((codes % sel_format(L)[1] > 0).any())


@pytest.mark.parametrize("rc", [False, True])
def test_decode_buffers_stay_sorted(rc):
    """The K-way merge's precondition: after every block of a CPU decode
    (m=6, r=5, L=8, both orientations), every (read, position, CRF state,
    conv state) row of both buffers has scores non-increasing in slot."""
    code = ConvCodeConfig(mem=6, rate=5, msg_len=30, rc=rc)
    dec = LVADecoder(DecodeConfig(code=code, list_size=8, max_deviation=6),
                     device="cpu")
    posts, nblks = _port_reads(code, (5, 6))

    def check(t, tabs, prev, stale, args):
        for buf in (prev[0], stale[0]):
            assert bool((buf[:, :, :, 1:] <= buf[:, :, :, :-1]).all()), t

    steps = _Steps(check)
    _, _, valid = dec.decode(posts, nblks, acs=steps)
    assert steps.blocks == int(nblks.max()) and valid.any()


@pytest.mark.parametrize("L", [1, 2, 8, 34])
def test_needed_bytes_count_the_kernels_loads(L):
    """``acs_needed_bytes``, which the bound of the kernel on the card takes,
    counts the previous-buffer slots that the numpy model of the kernel
    loads (each once, however many rows read it), the slots it writes and
    the selections, on adversarial rows: exhausted rows, ties and dropped
    pairs move where each row stops."""
    spec, tabs, prev, stale, args = _adversarial(L, seed=100 + L)
    W, C = spec.window, spec.code.nstate_conv
    st = [x.clone() for x in stale]
    sel = torch.empty((3, W, NCRF * L, C), dtype=sel_format(L)[0])
    lva_acs.acs_block_ref(tabs, prev, st, *args, sel)
    _, _, depth = kway_model(tabs, prev, stale, *args, W)
    start1, active = args[2], args[3]
    live = sum(int((tabs["valid"][int(s0):int(s0) + W] != 0).sum())
               for s0, a in zip(start1, active) if a)
    want = (4 * depth[0].sum() + 8 * depth[1].sum() + 12 * L * NCRF * live
            + sel.numel() * sel.element_size())
    got = merge_roofline.acs_needed_bytes(tabs, prev[0], st[0], sel, *args)
    assert got == want
    # every live stay row was read, and with L > 1 some row stopped early
    assert (depth[0] > 0).any()
    assert L == 1 or ((depth[0] > 0) & (depth[0] < L)).any()


def test_wrapper_takes_the_plain_path_on_cpu():
    """``acs_block`` runs ``acs_block_ref`` on CPU tensors and counts no
    launch; on another device it raises."""
    spec, tabs, prev, stale, args = _adversarial(4, seed=9)
    W, L, C = spec.window, spec.list_size, spec.code.nstate_conv
    launches = profiling.counter("acs.launches")
    outs = []
    for step in (lva_acs.acs_block_ref, lva_acs.acs_block):
        st = [x.clone() for x in stale]
        sel = torch.empty((3, W, 8 * L, C), dtype=torch.int8)
        step(tabs, prev, st, *args, sel)
        outs.append((st, sel))
    assert all(torch.equal(a, b) for a, b in zip(outs[1][0], outs[0][0]))
    assert torch.equal(outs[1][1], outs[0][1])
    assert profiling.counter("acs.launches") == launches
    meta = [x.to("meta") for x in prev]
    with pytest.raises(ValueError, match="cpu or cuda"):
        lva_acs.acs_block(tabs, meta, meta, *args, outs[0][1].to("meta"))
