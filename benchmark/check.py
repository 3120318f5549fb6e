"""How ``correct`` is decided: what the timed path produced against the
plain reference (``reference.py``), on a sample of the window's reads.

Three numbers are compared, each with the limit 0, since the configuration
guarantees exact lists and an exact classification:

* ``lists_differ``: sampled reads whose lists differ from the reference's,
  as the decoder returned them (each entry's validity, and the message and
  score of every valid entry) or as ``decode_posts`` handed them on (the
  messages and validity of its outcome);
* ``class_differ``: sampled reads whose classification differs: the index
  of the first entry passing the CRC and index check (-1 where none does),
  its payload and message, and the best score;
* ``repeats_differ``: later decodes of a read in the window that differ
  from its first decode there.

``reads_checked`` counts the sampled reads and must be at least 1. The
sample (``sample``) is the longest read, then reads drawn from the seed
that add an orientation or a half of a call's slots, so that a fault in
one of the two decoders or in half of a batch meets a sampled read.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from . import reference
from .traffic import Pool, code_config, experiment

OUTCOME = ("msgs", "valid", "index", "payload", "chosen_msg", "best_score")


def read_key(post: np.ndarray) -> bytes:
    """A read's identity in a decoder's input: its first two blocks and its
    length."""
    return post[:2].tobytes() + len(post).to_bytes(4, "little")


def same_lists(a: tuple, b: tuple) -> bool:
    """Two reads' (msgs, scores, valid) agree: validity, and messages and
    scores at the valid entries."""
    (ma, sa, va), (mb, sb, vb) = a, b
    return (np.array_equal(va, vb) and np.array_equal(ma[va], mb[vb])
            and np.array_equal(sa[va], sb[vb]))


def strata(pool: Pool) -> Dict[int, Tuple[bool, bool]]:
    """Each read's (orientation, whether it sits in the upper half of its
    call's slots): the calls are fixed and cycled, so a read always takes
    the same decoder and the same slot."""
    out = {}
    for call in pool.calls:
        for slot, r in enumerate(call):
            out[int(r)] = (bool(pool.rc[r]), 2 * slot >= len(call))
    return out


def sample(decoded: Sequence[int], pool: Pool, k: int, seed: int
           ) -> List[int]:
    """``k`` of the ``decoded`` reads: the longest (most blocks; the lowest
    index among equals), then, in an order drawn from the seed, at each
    pick a read that adds the most of a new orientation, a new half of the
    call's slots and a new pair of the two. Two reads cover both
    orientations and both halves, four every pair."""
    nblks, strat = pool.nblks(), strata(pool)
    longest = max(decoded, key=lambda r: (nblks[r], -r))
    rng = np.random.default_rng([seed % 2**63, 1])
    rest = [int(r) for r in rng.permutation(
        [r for r in decoded if r != longest])]
    picked = [int(longest)]
    while len(picked) < k and rest:
        held = [strat[r] for r in picked]

        def gain(r):
            s = strat[r]
            return ((s not in held) + all(h[0] != s[0] for h in held)
                    + all(h[1] != s[1] for h in held))
        best = max(rest, key=gain)  # the first of the best, in seed order
        rest.remove(best)
        picked.append(best)
    return sorted(picked)


def program_results(pool: Pool, capture):
    """Per read of the window, from its first decode there: its lists as
    the decoder returned them, and its ``decode_posts`` outcome's fields;
    and how many later decodes of a read differ from its first."""
    keys = {read_key(p): r for r, p in enumerate(pool.posts)}
    lists: Dict[int, tuple] = {}
    repeats = 0
    for posts, nblks, (m, s, v) in capture.lists:
        for i in range(len(posts)):
            r = keys.get(read_key(posts[i, :nblks[i]]))
            if r is None:
                continue
            if r in lists:
                repeats += not same_lists(lists[r], (m[i], s[i], v[i]))
            else:
                lists[r] = (m[i], s[i], v[i])
    outcomes: Dict[int, dict] = {}
    for idx, out in capture.outcomes:
        for k, r in enumerate(idx):
            row = {f: np.asarray(getattr(out, f))[k] for f in OUTCOME}
            if r in outcomes:
                repeats += not all(np.array_equal(row[f], outcomes[r][f])
                                   for f in OUTCOME)
            else:
                outcomes[int(r)] = row
    return lists, outcomes, repeats


def reference_results(pool: Pool, reads: List[int], config: dict,
                      chunk: int, device, dtype=torch.float32):
    """The reference's lists and outcome fields of ``reads``, keyed by read,
    ``chunk`` reads of one orientation at a time, its scores in
    ``dtype``."""
    if config["path_combine"] != "max":
        raise ValueError("the reference combines paths by max only")
    m, s, v = reference.decode_reads(
        code_config(config), config["list_size"], config["max_deviation"],
        [pool.posts[r] for r in reads], pool.rc[reads], device, dtype, chunk)
    exp = experiment(config)
    cls = reference.classify(m, v, exp.framing, exp.bytes_per_oligo,
                             exp.pad, pool.num_oligos)
    lists, outcomes = {}, {}
    for k, r in enumerate(reads):
        lists[r] = (m[k], s[k], v[k])
        outcomes[r] = {"msgs": m[k], "valid": v[k],
                       "index": cls["index"][k],
                       "payload": cls["payload"][k],
                       "chosen_msg": cls["chosen_msg"][k],
                       "best_score": np.float32(
                           s[k, 0] if v[k, 0] else -np.inf)}
    return lists, outcomes


def compare(reads, lists, outcomes, ref_lists, ref_outcomes, repeats
            ) -> Dict[str, dict]:
    """The numbers compared, each with its limit."""
    lists_differ = class_differ = 0
    for r in reads:
        ref, out, ref_out = ref_lists[r], outcomes.get(r), ref_outcomes[r]
        got = lists.get(r)
        lists_differ += not (
            got is not None and out is not None and same_lists(got, ref)
            and np.array_equal(out["valid"], ref[2])
            and np.array_equal(out["msgs"][ref[2]], ref[0][ref[2]]))
        class_differ += not (out is not None and all(
            np.array_equal(out[f], ref_out[f])
            for f in ("index", "payload", "chosen_msg", "best_score")))
    return {"reads_checked": {"value": len(reads), "limit": 1},
            "lists_differ": {"value": lists_differ, "limit": 0},
            "class_differ": {"value": class_differ, "limit": 0},
            "repeats_differ": {"value": repeats, "limit": 0}}


def check(pool: Pool, capture, config: dict, traffic: dict, seed: int,
          device) -> Dict[str, dict]:
    """The timed path's results against the reference's on the traffic
    mix's ``check_reads`` of the window's reads (``sample``), decoded
    ``reference_chunk`` at a time."""
    lists, outcomes, repeats = program_results(pool, capture)
    decoded = sorted(outcomes)
    reads = sample(decoded, pool, traffic["check_reads"], seed) \
        if decoded else []
    ref_lists, ref_outcomes = reference_results(
        pool, reads, config, traffic["reference_chunk"], device) \
        if reads else ({}, {})
    return compare(reads, lists, outcomes, ref_lists, ref_outcomes, repeats)


def passed(checks: Dict[str, dict]) -> bool:
    """Every number within its limit: ``reads_checked`` at least its limit,
    the others at most theirs."""
    return all(c["value"] >= c["limit"] if n == "reads_checked"
               else c["value"] <= c["limit"] for n, c in checks.items())


def check_lines(checks: Dict[str, dict]) -> List[str]:
    return [f"check {n} {c['value']} limit {c['limit']}"
            for n, c in checks.items()]
