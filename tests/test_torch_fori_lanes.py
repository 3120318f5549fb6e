"""The fori probe's register layout in its ``regs`` placement
(``csrc/lowering.cu`` ``fori_regs_kernel``) as a numpy model, held bit for
bit against ``fori_ref``, ``np_fori`` and the Pallas body of ``p_fori``
(``scripts/tpu_pallas_probe.py``) in interpret mode.

The model follows the kernel step by step: a column's NQ scores split over
G lanes, lane l holding flat indices [l NQ/G, (l+1) NQ/G); each round an
adjacent-pair tree over each lane's scores (the right child only on a
strict ``>``), the shuffle steps at offsets 1, 2, ... in which the lane
whose bit is clear keeps its (score, flat index) unless its partner's score
is strictly greater, the owner's subtract, hash pick and count, the hash's
shuffle from the owner (at one lane a column, its read from h at the flat
index), and the f32 sum in round order; at the end the lanes' counts
summed. Besides the result it returns each round's (best, flat index,
hash), held to a numpy scan's first argmax: the result alone cannot show
which of tied candidates a round took, but with a hash of its own for
every candidate the trace does. It runs at both ``FORI_POINTS`` and
every G built (``lowering.LANES``). The tolerance is zero.
"""
import numpy as np
import pytest
import torch

from nanopore_dna_storage_tpu_torch.probes import lowering as lo
from test_torch_lowering import _rerun, _script
from test_torch_lse import tree_pop

ZERO = np.float32(0)


def fori_lanes(x, h, rounds, lanes):
    """The kernel over x f32 [NQ, C] and h uint32 [NQ, C] with ``lanes``
    lanes a column: (f32 [1, C], [(best, flat index, hash) per round])."""
    nq, cols = x.shape
    n = nq // lanes
    sc = x.reshape(lanes, n, cols).copy()  # lane l: flat l * n + j
    hv = h.reshape(lanes, n, cols)
    base = (np.arange(lanes) * n)[:, None]
    lane = np.arange(lanes)[:, None]
    c = np.arange(cols)
    acc = np.zeros(cols, np.float32)
    count = np.zeros((lanes, cols), np.int32)
    trace = []
    for r in range(rounds):
        best, k = tree_pop(sc.transpose(1, 0, 2))  # each lane's [n] tree
        f = base + k
        s = 1
        while s < lanes:
            v2, f2 = best[lane[:, 0] ^ s], f[lane[:, 0] ^ s]
            take = (v2 > best) | ((lane & s != 0) & (v2 == best))
            best, f = np.where(take, v2, best), np.where(take, f2, f)
            s <<= 1
        assert (best == best[:1]).all() and (f == f[:1]).all()
        d = f - base  # in [0, n) in the winner's lane only
        pick = np.zeros((lanes, cols), np.uint32)
        for j in range(n):  # the owner's subtract and hash
            sc[:, j] = np.where(d == j, sc[:, j] - np.float32(1), sc[:, j])
            pick = np.where(d == j, hv[:, j], pick)
        count += ((d >= 0) & (d < n)).astype(np.int32)
        # the shuffle from the owner; one lane a column reads h back
        hh = pick[f[0] // n, c] if lanes > 1 else h[f[0], c]
        acc = (acc + best[0]) + (hh & 1).astype(np.float32) * ZERO
        trace.append((best[0], f[0], hh))
    return (acc + count.sum(0).astype(np.float32))[None], trace


def scan_trace(x, h, rounds):
    """Each round's (best, first argmax, its hash) of the probe, by numpy's
    argmax."""
    sc, c, out = x.copy(), np.arange(x.shape[1]), []
    for _ in range(rounds):
        q = sc.argmax(0)
        out.append((sc[q, c], q, h[q, c]))
        sc[q, c] -= np.float32(1)
    return out


def _scores(kind, nq, rng):
    if kind == "normal":
        return rng.standard_normal((nq, 1024)).astype(np.float32)
    x = rng.integers(0, 3, (nq, 1024)).astype(np.float32)
    if kind == "ties_neg_inf":
        x[:, :8] = -np.inf
        x[5:, 8:16] = -np.inf
    elif kind == "zeros":  # +0.0 against -0.0 at the top, then -1
        x = np.select([x == 2, x == 1], [np.float32(-0.0), np.float32(0.0)],
                      np.float32(-1)).astype(np.float32)
    return x


def _hashes(kind, nq, rng):
    if kind == "threes":
        return np.full((nq, 1024), 3, np.uint32)
    # one hash of its own for every candidate
    return rng.permutation(nq * 1024).astype(np.uint32).reshape(nq, 1024)


def _check(x, h, rounds, want):
    """The model at every G against ``want`` and the plain versions, bit
    for bit, and its trace against the scan's."""
    ref = lo.fori_ref(*lo.tensors((x, h), "cpu"), rounds).numpy()
    assert lo.same(ref, want)
    assert lo.same(lo.np_fori(x, h, rounds), want)
    scan = scan_trace(x, h, rounds)
    for lanes in lo.LANES:
        got, trace = fori_lanes(x, h, rounds, lanes)
        assert lo.same(got, want), lanes
        for (b, f, hh), (sb, q, sh) in zip(trace, scan):
            assert np.array_equal(b.view(np.uint32), sb.view(np.uint32))
            assert np.array_equal(f, q), lanes
            assert np.array_equal(hh, sh), lanes


@pytest.mark.parametrize("scores", ["normal", "ties", "ties_neg_inf",
                                    "zeros"])
def test_lane_model_matches_the_script_kernel(scores, monkeypatch, capsys):
    """NQ = 32, R = 18: the script's own kernel in interpret mode (its
    hashes all 3) on the script's input and on tie scores."""
    kernel, kw, (x0,), y0 = _script("fori", monkeypatch, capsys)
    x = x0 if scores == "normal" else _scores(scores, len(x0),
                                              np.random.default_rng(6))
    y = y0 if scores == "normal" else _rerun(kernel, kw, x)
    _check(x, np.full(x.shape, 3, np.uint32), lo.FORI_POINTS[0][1], y)


@pytest.mark.parametrize("hashes", ["threes", "unique"])
@pytest.mark.parametrize("scores", ["normal", "ties", "ties_neg_inf",
                                    "zeros"])
@pytest.mark.parametrize("point", lo.FORI_POINTS)
def test_lane_model_matches_numpy(point, scores, hashes):
    """Both points, every G, against ``np_fori``; with a hash for every
    candidate, a rule that took the higher index of a tie would read
    another hash and fail the trace."""
    nq, rounds = point
    rng = np.random.default_rng(nq + rounds)
    x, h = _scores(scores, nq, rng), _hashes(hashes, nq, rng)
    _check(x, h, rounds, lo.np_fori(x, h, rounds))


def test_lane_model_at_zero_and_one_round():
    rng = np.random.default_rng(1)
    x, h = _scores("ties", 64, rng), _hashes("unique", 64, rng)
    for rounds in (0, 1):
        _check(x, h, rounds, lo.np_fori(x, h, rounds))


def test_fori_lanes_argument():
    nq, rounds = lo.FORI_POINTS[1]
    x = torch.randn(nq, 64)
    h = torch.full((nq, 64), 3, dtype=torch.int32)
    want = lo.fori_ref(x, h, rounds)
    for lanes in (0, *lo.LANES):  # the CPU path takes the plain version
        got = lo.fori(x, h, rounds, "regs", copies=2, lanes=lanes)
        assert all(torch.equal(g, want) for g in got)
    with pytest.raises(ValueError, match="no fori regs kernel"):
        lo.fori(x, h, rounds, "regs", lanes=16)
    with pytest.raises(ValueError, match="no fori local kernel"):
        lo.fori(x, h, rounds, "local", lanes=2)
    with pytest.raises(ValueError, match="no fori regs kernel"):
        lo.fori_ops(nq, "regs", 3)
    # the regs count at each G, against the 3 NQ + 8 the function needs
    assert [lo.fori_ops(64, "regs", g) for g in lo.LANES] == \
        [328, 410, 460, 584]
    assert lo.fori_ops(64) == 200
