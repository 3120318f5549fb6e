"""The tree-pop probe's register layout (``csrc/probes.cu``
``treepop_kernel``) as a numpy model, held bit for bit against
``treepop_ref`` and the Pallas bodies of ``scripts/tpu_treepop_probe.py``
in interpret mode.

The model follows the kernel step by step: the launcher's map of each
variant onto 64 slots (``tree_rows``: a candidate row, or -inf with payload
0), the slots split over G lanes (adjacent pairings: lane l holds slots
[l 64/G, (l+1) 64/G); halves: slots j G + l), each lane's part of the tree,
then the shuffle steps, in which the lane whose bit s is clear holds the
pair's first entry and the second wins only if strictly greater (adjacent
pairings at s = 1, 2, ...; halves at s = G/2, ..., 1); and the guard,
whose failure writes zeros. It runs at every G the kernel is built with
(``treepop.LANES``), on normal scores, integer ties with all -inf columns,
and +0.0 against -0.0 ties, every payload its own (a permutation), so that
which of the tied candidates a rule picks shows. The tolerance is zero.
"""
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from nanopore_dna_storage_tpu_torch.probes import treepop as tp
from test_torch_probes import TREE, _bits, _pallas

NEG = np.float32(-np.inf)
SHAPE = (64, 4, 32)  # NC, F, CT: 128 columns
KINDS = ("normal", "ties", "zeros")


def tree_rows(variant, nc):
    """The kernel's slot map: the candidate row of each of the 64 slots,
    -1 for a -inf slot. Adjacent pairings take the first nc (argmax),
    2^floor(log2 nc) (reshape_pair) or min(nc, 60) (concat) candidates in
    order; halves places candidate sum_k b_k (nc >> (k + 1)) at slot u <<
    (6 - lg), u's bits b_0 ... b_(lg-1) from the top, lg = floor(log2 nc)."""
    lg = nc.bit_length() - 1
    rows = np.full(64, -1)
    if variant == "halves":
        for u in range(1 << lg):
            rows[u << (6 - lg)] = sum(nc >> (k + 1) for k in range(lg)
                                      if u >> (lg - 1 - k) & 1)
        return rows
    n = {"argmax": nc, "reshape_pair": 1 << lg,
         "concat": min(nc, tp.CONCAT_N)}[variant]
    rows[:n] = np.arange(n)
    return rows


def treepop_lanes(x, h, variant, lanes, guarded=False):
    """The kernel over x f32 [nc, cols] and h int32 [nc, cols] with
    ``lanes`` lanes a column: (value f32 [cols], payload int32 [cols]),
    lane 0's."""
    if guarded and not x[0, 0] < tp.GUARD:
        return np.zeros(x.shape[1], np.float32), np.zeros(x.shape[1],
                                                          np.int32)
    rows = tree_rows(variant, len(x))[:, None]
    v = np.where(rows >= 0, x[rows.clip(0), np.arange(x.shape[1])], NEG)
    p = np.where(rows >= 0, h[rows.clip(0), np.arange(x.shape[1])], 0)
    n = 64 // lanes
    halves = variant == "halves"

    def split(a):  # [64, cols] -> [lanes, n, cols]
        if halves:  # slot j * lanes + l
            return a.reshape(n, lanes, -1).transpose(1, 0, 2).copy()
        return a.reshape(lanes, n, -1).copy()

    v, p = split(v), split(p)

    def keep(a, b):  # the pair (a, b) of slots: b only if strictly greater
        tk = v[:, b] > v[:, a]
        v[:, a] = np.where(tk, v[:, b], v[:, a])
        p[:, a] = np.where(tk, p[:, b], p[:, a])

    if halves:
        m = n // 2
        while m:
            for j in range(m):
                keep(j, j + m)
            m //= 2
    else:
        w = 1
        while w < n:
            for j in range(0, n, 2 * w):
                keep(j, j + w)
            w *= 2
    v, p = v[:, 0], p[:, 0]
    steps = [1 << k for k in range(lanes.bit_length() - 1)]
    lane = np.arange(lanes)[:, None]
    for s in (steps[::-1] if halves else steps):
        v2, p2 = v[lane[:, 0] ^ s], p[lane[:, 0] ^ s]
        tk = np.where(lane & s, ~(v > v2), v2 > v)
        v, p = np.where(tk, v2, v), np.where(tk, p2, p)
    return v[0], p[0]


def _inputs(kind, seed, shape=SHAPE):
    rng = np.random.default_rng(seed)
    if kind == "normal":
        x = rng.normal(size=shape).astype(np.float32)
    elif kind == "ties":  # integer scores, some columns all -inf
        x = rng.integers(0, 3, shape).astype(np.float32)
        x[:, 0, :4] = NEG
    else:  # +0.0 against -0.0 the maximum, below it -1 and -inf
        x = rng.choice(np.array([0.0, -0.0, -1.0, -np.inf], np.float32),
                       shape, p=[0.1, 0.1, 0.5, 0.3])
        x[:, 1, :4] = NEG
    h = rng.permutation(x.size).astype(np.int32).reshape(shape)
    return x, h


@functools.lru_cache(maxsize=None)
def _case(variant, kind):
    """(x, h) of ``kind``, the Pallas body's (value, payload) and
    ``treepop_ref``'s on them."""
    x, h = _inputs(kind, seed=KINDS.index(kind))
    want = _pallas(TREE.make(variant),
                   [jax.ShapeDtypeStruct(SHAPE[1:], jnp.float32),
                    jax.ShapeDtypeStruct(SHAPE[1:], jnp.int32)], x, h)
    ref = tp.treepop_ref(torch.from_numpy(x), torch.from_numpy(h), variant)
    return (x, h, tuple(np.asarray(a) for a in want),
            tuple(a.numpy() for a in ref))


def _model(x, h, variant, lanes, guarded=False):
    nc = len(x)
    v, p = treepop_lanes(x.reshape(nc, -1), h.reshape(nc, -1), variant,
                         lanes, guarded)
    return v.reshape(x.shape[1:]), p.reshape(x.shape[1:])


@pytest.mark.parametrize("lanes", tp.LANES)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("variant", tp.VARIANTS)
def test_lane_model_matches_ref_and_pallas(variant, kind, lanes):
    x, h, (want_v, want_p), (ref_v, ref_p) = _case(variant, kind)
    got_v, got_p = _model(x, h, variant, lanes)
    assert np.array_equal(got_p, want_p) and np.array_equal(got_p, ref_p)
    if variant == "argmax" and kind == "zeros":
        # the plain versions take the value from a max, which leaves the
        # sign of a zero maximum to the implementation (jnp.max gives +0.0,
        # torch.amax either); the kernel returns the first maximum itself
        first = np.take_along_axis(x, x.argmax(0)[None], 0)[0]
        assert np.array_equal(_bits(got_v), _bits(first))
        assert np.array_equal(got_v, want_v) and np.array_equal(got_v,
                                                                ref_v)
    else:
        assert np.array_equal(_bits(got_v), _bits(want_v))
        assert np.array_equal(_bits(got_v), _bits(ref_v))


@pytest.mark.parametrize("variant", tp.VARIANTS)
def test_lane_model_at_every_candidate_count(variant):
    """nc from 1 to 64 on tie and zero scores: the slot map reproduces
    each variant's dropped and carried odd entries at every level, at
    every G."""
    for nc in range(1, 65):
        for kind in ("ties", "zeros"):
            x, h = (a[:nc].copy() for a in _inputs(kind, seed=nc,
                                                   shape=(64, 2, 48)))
            ref_v, ref_p = (a.numpy() for a in tp.treepop_ref(
                torch.from_numpy(x), torch.from_numpy(h), variant))
            for lanes in tp.LANES:
                got_v, got_p = _model(x, h, variant, lanes)
                assert np.array_equal(got_p, ref_p), (nc, kind, lanes)
                assert np.array_equal(got_v, ref_v), (nc, kind, lanes)
                if variant != "argmax":
                    assert np.array_equal(_bits(got_v), _bits(ref_v))


@pytest.mark.parametrize("variant", tp.VARIANTS)
def test_slot_map_covers_the_variants_candidates(variant):
    """Every candidate the variant's tree reads sits in one slot, and
    none other; at nc = 64 slot v holds candidate v."""
    assert list(tree_rows(variant, 64)) == (
        list(range(60)) + [-1] * 4 if variant == "concat"
        else list(range(64)))
    for nc in range(1, 65):
        rows = tree_rows(variant, nc)
        used = sorted(rows[rows >= 0])
        assert len(set(used)) == len(used)
        lg = nc.bit_length() - 1
        assert len(used) == {"argmax": nc, "reshape_pair": 1 << lg,
                             "halves": 1 << lg,
                             "concat": min(nc, tp.CONCAT_N)}[variant]


@pytest.mark.parametrize("lanes", tp.LANES)
def test_guard_holds_and_fails(lanes):
    for kind in ("normal", "ties"):
        x, h = _inputs(kind, seed=5)
        for holds in (True, False):
            if not holds:
                x[0, 0, 0] = 2e9
            want = [a.numpy() for a in tp.treepop_ref(
                torch.from_numpy(x), torch.from_numpy(h), "reshape_pair",
                guarded=True)]
            got = _model(x, h, "reshape_pair", lanes, guarded=True)
            assert np.array_equal(_bits(got[0]), _bits(want[0]))
            assert np.array_equal(got[1], want[1])
            assert holds or not (got[0].any() or got[1].any())


def test_lane_model_matches_run_when(monkeypatch, capsys):
    """The script's own ``run_when(128)`` in interpret mode: every G gives
    its outputs on the inputs it made."""
    seen = {}

    def pallas_call(kernel, **kw):
        fn = pl.pallas_call(kernel, interpret=True, **kw)

        def call(*args):
            seen["args"] = [np.array(a) for a in args]
            seen["out"] = [np.array(o) for o in fn(*args)]
            return seen["out"]
        return call

    monkeypatch.setattr(TREE, "pl", types.SimpleNamespace(
        pallas_call=pallas_call, when=pl.when))
    TREE.run_when(128)
    assert "payload_ok=True" in capsys.readouterr().out
    x, h = seen["args"]
    for lanes in tp.LANES:
        got = _model(x, h, "reshape_pair", lanes, guarded=True)
        assert np.array_equal(_bits(got[0]), _bits(seen["out"][0]))
        assert np.array_equal(got[1], seen["out"][1])


def test_halves_differs_from_the_first_maximum():
    """On ties halves keeps its own order, which the model reproduces: it
    is not the adjacent tree's first maximum."""
    x, h, _, (_, ref_p) = _case("halves", "ties")
    first = np.take_along_axis(h, x.argmax(0)[None], 0)[0]
    assert not np.array_equal(ref_p, first)
    for lanes in tp.LANES:
        assert np.array_equal(_model(x, h, "halves", lanes)[1], ref_p)


def test_wrapper_lanes_argument():
    x, h = map(torch.from_numpy, _inputs("normal", seed=0))
    for lanes in (0, *tp.LANES):  # the CPU path takes the plain version
        got = tp.treepop(x, h, "concat", lanes=lanes)
        want = tp.treepop_ref(x, h, "concat")
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="lanes"):
        tp.treepop(x, h, "concat", lanes=3)
    with pytest.raises(ValueError, match="no tree-pop kernel"):
        tp.treepop_info("concat", 16)
