"""How ``correct`` is decided, on the CPU: the plain reference against the
program, the control (the reference in bfloat16 in the program's place)
and each fault the cells can have, planted under a whole run."""
import json
import types

import numpy as np
import pytest
import torch

from benchmark import check, control, manifest, reference, run, traffic
from conftest import ROOT, TINY
from nanopore_dna_storage_tpu_torch.ops import lva, lva_acs
from nanopore_dna_storage_tpu_torch.ops.lva import LVADecoder
from nanopore_dna_storage_tpu_torch.pipeline.decode import PipelineDecoder

SEED = 2**31 + 101


def tiny_run(tiny, trace=False):
    root, here = tiny
    return run.run_cell(TINY, SEED, 0.0, trace, root=root, here=here,
                        device="cpu")


@pytest.mark.parametrize("L", [4, 8, 32])
def test_sorting_merge_is_the_rounds_merge(L):
    """The reference's merge by sorting against the program's plain merge
    of L pop-and-knock-out rounds, on scores with many ties and keys with
    many duplicates."""
    g = torch.Generator().manual_seed(L)
    shape = (3, 5, 8 * L)
    sc = torch.randint(-4, 2, shape, generator=g).float()
    sc[torch.rand(shape, generator=g) < 0.3] = float("-inf")
    key = torch.randint(0, 6, shape, generator=g)
    want = lva_acs._merge_max(sc.clone(), key.clone(), L)
    got = reference.merge(sc.clone(), key.clone(), L)
    for a, b in zip(want, got):
        assert torch.equal(a, b)


def test_sound_run_is_correct(tiny):
    out = tiny_run(tiny)
    assert out["correct"] and out["checks"]["reads_checked"]["value"] == 2


def stuck(tabs, prev, stale, stay_tr, move_tr, start1, active, sel):
    """A step that returns its state unchanged."""
    for a, b in zip(stale, prev):
        a.copy_(b)
    sel.zero_()
    return sel


def half_batch(decode, keep="first"):
    """Half of the batch decoded, the other half given its results."""
    def wrapped(self, posts, nblks=None, acs=None):
        n = (len(posts) + 1) // 2
        part = slice(None, n) if keep == "first" else slice(len(posts) - n,
                                                            None)
        m, s, v = decode(self, posts[part], nblks[part], acs)
        fill = np.arange(len(posts)) % n
        return m[fill], s[fill], v[fill]
    return wrapped


def altered(decode):
    """An answer altered where it is produced: one message bit flipped."""
    def wrapped(self, posts, nblks=None, acs=None):
        m, s, v = decode(self, posts, nblks, acs)
        m = m.copy()
        m[:, :, 0] ^= 1
        return m, s, v
    return wrapped


def misclassified(classify):
    def wrapped(self, msgs, valid, num_oligos):
        out = classify(self, msgs, valid, num_oligos)
        out.index = np.where(out.index >= 0, out.index + 1, 0)
        return out
    return wrapped


@pytest.mark.parametrize("fault", ["stuck_step", "half_batch", "altered",
                                   "misclassified"])
def test_fault_under_a_run_is_not_correct(tiny, monkeypatch, fault):
    if fault == "stuck_step":
        monkeypatch.setattr(lva, "acs_block", stuck)
    elif fault == "half_batch":
        monkeypatch.setattr(LVADecoder, "decode",
                            half_batch(LVADecoder.decode))
    elif fault == "altered":
        monkeypatch.setattr(LVADecoder, "decode", altered(LVADecoder.decode))
    else:
        monkeypatch.setattr(PipelineDecoder, "classify",
                            misclassified(PipelineDecoder.classify))
    out = tiny_run(tiny)
    assert out["correct"] is False
    assert out["failed"] > 0


def test_control_is_not_correct(tiny):
    root, here = tiny
    for seed in (SEED, SEED + 1):
        out = control.control(TINY, seed, root=root, here=here,
                              device="cpu")
        assert out["correct"] is False
        assert out["checks"]["lists_differ"]["value"] >= 1
        assert out["max_score_gap"] > 0
    same = control.control(TINY, SEED, root=root, here=here, device="cpu",
                           dtype=torch.float32)
    assert same["correct"] is True and same["max_score_gap"] == 0


CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_sample_holds_each_orientation_and_half(cell):
    """At a cell's own pool and batch, on many seeds: the sample holds the
    longest read, both orientations and both halves of a call's slots, so
    a fault in one decoder or in half of the batch meets a sampled read."""
    man = manifest.load(ROOT)
    w = manifest.cell(man, cell)
    mix = manifest.traffic(w["traffic"])
    pool = traffic.make_pool(manifest.config(ROOT, man, w), mix, 2**31 + 3)
    strat = check.strata(pool)
    assert len(set(strat.values())) == 4
    for seed in range(2**32, 2**32 + 40):
        reads = check.sample(range(len(pool.posts)), pool,
                             mix["check_reads"], seed)
        held = {strat[r] for r in reads}
        assert len(reads) == mix["check_reads"]
        assert int(np.argmax(pool.nblks())) in reads
        assert {h[0] for h in held} == {False, True}
        assert {h[1] for h in held} == {False, True}
        if mix["check_reads"] >= 4:
            assert len(held) == 4


def rc_altered(decode):
    """A fault in the reverse-complement decoder alone."""
    def wrapped(self, posts, nblks=None, acs=None):
        m, s, v = decode(self, posts, nblks, acs)
        if self.spec.code.config.rc:
            m = m.copy()
            m[:, :, 0] ^= 1
        return m, s, v
    return wrapped


class Ticks:
    """A clock that each reading advances by a second."""

    def __init__(self):
        self.now = 0.0

    def __call__(self):
        self.now += 1.0
        return self.now


def test_fault_in_the_rc_decoder_under_a_run_is_not_correct(tiny,
                                                            monkeypatch):
    """A window of two calls, one of each orientation."""
    monkeypatch.setattr(LVADecoder, "decode", rc_altered(LVADecoder.decode))
    root, here = tiny
    out = run.run_cell(TINY, SEED, 2, False, root=root, here=here,
                       device="cpu", clock=Ticks(), started=0.0)
    assert out["attempted"] == 4
    assert out["correct"] is False and out["failed"] > 0


class Truth:
    """Made-up lists and outcomes of every read of a pool, standing for a
    sound decode on both sides, so that the check runs at a cell's own
    pool and batch without decoding."""

    def __init__(self, pool, L=4, msg_len=12, seed=0):
        rng = np.random.default_rng(seed)
        n = len(pool.posts)
        self.msgs = rng.integers(0, 2, (n, L, msg_len), dtype=np.uint8)
        self.scores = -np.sort(rng.random((n, L)), axis=1).astype(np.float32)
        self.valid = np.ones((n, L), bool)
        self.index = rng.integers(0, 50, n)

    def outcome(self, r):
        return {"msgs": self.msgs[r], "valid": self.valid[r],
                "index": self.index[r], "payload": self.msgs[r, 0, :4],
                "chosen_msg": self.msgs[r, 0],
                "best_score": self.scores[r, 0]}

    def capture(self, pool, fault):
        """What a window through every call records where ``fault`` maps
        a call's slots to the slots whose results they are given, or
        alters a read's."""
        cap = run.Capture()
        for idx in pool.calls:
            src = fault(idx, pool)
            posts = [pool.posts[r] for r in idx]
            nblks = np.asarray([len(p) for p in posts])
            packed = np.zeros((len(idx), nblks.max(), 5, 8), np.float32)
            for i, p in enumerate(posts):
                packed[i, :len(p)] = p
            m, s, v = (self.msgs[src].copy(), self.scores[src],
                       self.valid[src])
            if fault is rc_only:
                m[pool.rc[idx]] ^= 1
            cap.lists.append((packed, nblks, (m, s, v)))
            rows = [self.outcome(r) for r in src]
            for i in np.nonzero(pool.rc[idx] & (fault is rc_only))[0]:
                rows[i] = dict(rows[i], msgs=m[i], chosen_msg=m[i, 0])
            cap.outcomes.append((idx, types.SimpleNamespace(**{
                f: np.stack([row[f] for row in rows])
                for f in check.OUTCOME})))
        return cap


def sound(idx, pool):
    return idx


def first_half(idx, pool):
    n = (len(idx) + 1) // 2
    return idx[np.arange(len(idx)) % n]


def last_half(idx, pool):
    n = (len(idx) + 1) // 2
    return idx[len(idx) - n:][np.arange(len(idx)) % n]


def rc_only(idx, pool):
    return idx


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [first_half, last_half, rc_only])
def test_fault_at_the_cells_batch_is_not_correct(monkeypatch, cell, fault):
    """At a cell's own pool and batch (24 or 16 reads a call), on ten
    seeds: half of each batch left out (either half) or the reverse-
    complement decoder at fault fails the check; the sound capture
    passes."""
    man = manifest.load(ROOT)
    w = manifest.cell(man, cell)
    mix = manifest.traffic(w["traffic"])
    config = manifest.config(ROOT, man, w)
    pool = traffic.make_pool(config, mix, 2**31 + 3)
    truth = Truth(pool)

    def ref(pool_, reads, config_, chunk, device, dtype=torch.float32):
        return ({r: (truth.msgs[r], truth.scores[r], truth.valid[r])
                 for r in reads}, {r: truth.outcome(r) for r in reads})
    monkeypatch.setattr(check, "reference_results", ref)
    for seed in range(2**33, 2**33 + 10):
        good = check.check(pool, truth.capture(pool, sound), config, mix,
                           seed, "cpu")
        assert check.passed(good)
        bad = check.check(pool, truth.capture(pool, fault), config, mix,
                          seed, "cpu")
        assert not check.passed(bad)
        assert bad["lists_differ"]["value"] + bad["class_differ"]["value"]
