"""The port's real-read path (``signal/barcode.py``,
``pipeline/real_data.py``) against the JAX package's.

Barcoded reads of the small config (m=6 r=1/2, 4 bytes an oligo) with
experiment 7's 25-nt barcodes, forward and reverse complement, go through
``synthetic_post``; each read's basecall and ``.trans`` block indices come
from the port's ``viterbi_flipflop_batch`` and ``basecall_from_path`` on the
CPU. Both packages then locate the barcodes, truncate and decode the same
inputs, each with its own config classes (``twin``). Edit distances,
windows, records and the list files must be equal exactly: the barcode
search is integer numpy, and the decoded lists are the list-Viterbi's,
which the port holds bit-equal to JAX (``test_torch_pipeline.py``).
"""
import dataclasses

import numpy as np
import pytest
import torch

from nanopore_dna_storage_tpu import config as jax_config
from nanopore_dna_storage_tpu.pipeline import real_data as jax_real
from nanopore_dna_storage_tpu.pipeline.experiments import experiment
from nanopore_dna_storage_tpu.signal import barcode as jax_barcode
from nanopore_dna_storage_tpu_torch import config as port_config
from nanopore_dna_storage_tpu_torch.coding.conv import str_to_bases
from nanopore_dna_storage_tpu_torch.coding.framing import frame_oligos
from nanopore_dna_storage_tpu_torch.io.post import pack_posts
from nanopore_dna_storage_tpu_torch.ops.crf_decode import (
    basecall_from_path, viterbi_flipflop_batch)
from nanopore_dna_storage_tpu_torch.ops.synthetic import synthetic_post
from nanopore_dna_storage_tpu_torch.pipeline import encode_bytes
from nanopore_dna_storage_tpu_torch.pipeline import real_data as port_real
from nanopore_dna_storage_tpu_torch.signal import barcode as port_barcode
from nanopore_dna_storage_tpu_torch.signal.channel import simulate_indelsubs
from test_torch_host import twin

torch.set_num_threads(1)

E7 = experiment(7)
EXP = jax_config.ExperimentConfig(
    bytes_per_oligo=4, rs_redundancy=0.5, conv_mem=6, conv_rate=1,
    start_barcode=E7.start_barcode, end_barcode=E7.end_barcode)
PORT_EXP = twin(EXP, port_config)
DATA = bytes(range(16))
LIST_SIZE, MAX_DEV = 2, 8
# read kinds: four whole reads, alternately forward and reverse complement;
# one with both barcodes replaced by random bases; one broken inside its
# barcodes (shorter than the two together: no window in either
# orientation); one whose payload is cut to 8 bases (a window shorter
# than the trellis)
KINDS = ["fwd", "rc"] * 2 + ["destroyed", "cut", "short"]


def _dna(rng, n: int) -> str:
    return "".join("ACGT"[i] for i in rng.integers(0, 4, n))


def basecall(posts):
    """Basecalls and ``.trans`` block indices of ``posts``, by the port's
    Viterbi over the flip-flop CRF on the CPU."""
    batch, nblk = pack_posts(posts, bucket=1)
    paths, _ = viterbi_flipflop_batch(torch.from_numpy(batch),
                                      torch.from_numpy(nblk))
    out = [basecall_from_path(p, int(n)) for p, n in zip(paths.numpy(), nblk)]
    return [c for c, _ in out], [t for _, t in out]


def make_reads(kinds=tuple(KINDS), seed: int = 0):
    """(ids, posts, basecalls, trans, kinds) of one read of each of
    ``kinds`` (names of ``KINDS``), channel errors (1% substitutions, 1%
    deletions) on the whole reads."""
    enc = encode_bytes(DATA, PORT_EXP)
    rng = np.random.default_rng(seed)
    bs, be = EXP.start_barcode, EXP.end_barcode
    posts = []
    for i, kind in enumerate(kinds):
        oligo = enc.oligos[i % len(enc.oligos)]
        seq = {"fwd": bs + oligo + be, "rc": bs + oligo + be,
               "destroyed": _dna(rng, len(bs)) + oligo + _dna(rng, len(be)),
               "cut": bs[:22] + be[-20:],
               "short": bs + oligo[:8] + be}[kind]
        bases = str_to_bases([seq])[0]
        if kind in ("fwd", "rc"):
            bases = simulate_indelsubs(bases, rng, 0.01, 0.01, 0.0)
        posts.append(synthetic_post(bases, rng, rc=kind == "rc"))
    calls, trans = basecall(posts)
    ids = [f"read_{i}" for i in range(len(kinds))]
    return ids, posts, calls, trans, list(kinds)


@pytest.fixture(scope="module")
def reads():
    return make_reads()


@pytest.fixture(scope="module")
def decoded(reads):
    """Both packages' records of ``reads`` (the JAX decode in one batch, the
    port's in batches of 3 on the CPU)."""
    ids, posts, calls, trans, _ = reads
    want = jax_real.decode_posts_with_barcodes(
        ids, posts, calls, trans, EXP, LIST_SIZE, max_deviation=MAX_DEV)
    got = port_real.decode_posts_with_barcodes(
        ids, posts, calls, trans, PORT_EXP, LIST_SIZE,
        max_deviation=MAX_DEV, batch=3, device="cpu")
    return got, want


def _barcode_case(case: str, rng):
    """(basecall, trans, start barcode, end barcode) of one case."""
    bs, be = EXP.start_barcode, EXP.end_barcode
    mid = _dna(rng, 60)

    def mutate(s, k):
        s = list(s)
        for j in rng.choice(len(s), k, replace=False):
            s[j] = "ACGT"[(("ACGT".index(s[j])) + 1) % 4]
        return "".join(s)

    call = {"exact": _dna(rng, 7) + bs + mid + be + _dna(rng, 5),
            "mutated": _dna(rng, 3) + mutate(bs, 4) + mid + mutate(be, 3)
            + _dna(rng, 9),
            # the end barcode in the last window, which the scan leaves out
            "last_window": bs + mid + be,
            "too_short": bs[:20] + be[:20],
            "reverse": port_real.reverse_complement_str(
                _dna(rng, 4) + bs + mid + be + _dna(rng, 6)),
            "random": _dna(rng, 110)}[case]
    # increasing block indices with dwell 1-4, as a basecall's .trans
    trans = np.cumsum(rng.integers(1, 5, len(call) + 1)).astype(np.int64)
    return call, trans, bs, be


CASES = ["exact", "mutated", "last_window", "too_short", "reverse", "random"]


@pytest.mark.parametrize("case", CASES)
def test_barcode_search_matches_jax(case):
    rng = np.random.default_rng(CASES.index(case))
    call, trans, bs, be = _barcode_case(case, rng)
    n = len(call)
    for needle in (bs, be):
        for starts, wlen in ((np.arange(max(n - len(needle), 0)), len(needle)),
                             (np.arange(0, max(n - 30, 0), 3), 30)):
            got = port_barcode.levenshtein_windows(needle, call, starts, wlen)
            want = jax_barcode.levenshtein_windows(needle, call, starts, wlen)
            assert got.dtype == want.dtype and np.array_equal(got, want)
    assert port_barcode.levenshtein(bs, call) == \
        jax_barcode.levenshtein(bs, call)
    got = port_barcode.find_barcode_window(call, trans, bs, be)
    assert got == jax_barcode.find_barcode_window(call, trans, bs, be)
    loc = port_real.locate_payload(call, trans, PORT_EXP)
    assert loc == jax_real.locate_payload(call, trans, EXP)
    if case == "exact":
        assert got[2] == 0 and got[3] == 0
        assert got[0] == trans[7 + len(bs)] - 1 and not loc[0]
    elif case == "last_window":
        # the exact end barcode sits in the excluded window: distance > 0
        assert got[2] == 0 and got[3] > 0
    elif case == "too_short":
        assert got == (-1, -1, np.inf, np.inf)
        assert loc == (False, -1, -1, np.inf)
    elif case == "reverse":
        assert loc[0] and loc[3] == 0
    if got[0] >= 0:
        post = np.arange((trans[-1] + 1) * 40, dtype=np.float32).reshape(
            -1, 5, 8)
        assert np.array_equal(port_barcode.truncate_post(post, *got[:2]),
                              jax_barcode.truncate_post(post, *got[:2]))


def test_orientation_tie_goes_forward():
    """A basecall that scores the same both ways decodes forward."""
    bs = EXP.start_barcode
    call = bs + "ACGT" * 10 + port_real.reverse_complement_str(bs)
    exp = dataclasses.replace(PORT_EXP, end_barcode=port_real
                              .reverse_complement_str(bs))
    trans = np.arange(1, len(call) + 2, dtype=np.int64)
    got = port_real.locate_payload(call, trans, exp)
    assert got == jax_real.locate_payload(
        call, trans, dataclasses.replace(EXP, end_barcode=exp.end_barcode))
    assert got[0] is False


def test_decode_posts_with_barcodes_matches_jax(reads, decoded):
    got, want = decoded
    kinds = reads[4]
    assert [dataclasses.asdict(r) for r in got] == \
        [dataclasses.asdict(r) for r in want]
    status = {k: r.status for k, r in zip(kinds, got)}
    assert status["cut"] == "barcode_failure"
    assert status["short"] == "too_short"
    ok = [(k, r) for k, r in zip(kinds, got) if k in ("fwd", "rc")]
    assert all(r.status == "ok" for _, r in ok)
    assert [r.rc for _, r in ok] == [k == "rc" for k, _ in ok]
    # the whole reads decode to their oligo's framed message
    enc = encode_bytes(DATA, PORT_EXP)
    truth = frame_oligos(enc.payloads, PORT_EXP.framing)
    hits = sum("".join(map(str, truth[i % len(truth)])) in (r.msgs or [])
               for i, (_, r) in enumerate(ok))
    assert hits >= 3


def test_decoded_list_files_match_jax(decoded, tmp_path):
    got, want = decoded
    out = {}
    for name, mod, recs in (("port", port_real, got),
                            ("jax", jax_real, want)):
        d = tmp_path / name
        d.mkdir()
        mod.write_decoded_lists(str(d), recs)
        out[name] = {p.name: p.read_bytes() for p in d.iterdir()}
    assert out["port"] == out["jax"]
    # list files numbered by the record's position, failures included
    ok = [i for i, r in enumerate(got) if r.status == "ok"]
    assert sorted(out["port"]) == sorted(
        ["info.txt"] + [f"list_{i}" for i in ok])
    assert len(out["port"]["info.txt"].splitlines()) == len(KINDS)


def test_flappie_artifacts_load_the_same(reads, tmp_path):
    from nanopore_dna_storage_tpu_torch.io.post import write_post

    _, posts, calls, trans, _ = reads
    write_post(str(tmp_path / "r.post"), posts[0])
    (tmp_path / "r.fastq").write_text(f"@r\n{calls[0]}\n+\n{'I' * 3}\n")
    np.savetxt(tmp_path / "r.trans", trans[0], fmt="%d")
    args = [str(tmp_path / f"r.{x}") for x in ("post", "fastq", "trans")]
    got = port_real.load_flappie_artifacts(*args)
    want = jax_real.load_flappie_artifacts(*args)
    assert np.array_equal(got[0], want[0]) and got[1] == want[1] == calls[0]
    assert got[2].dtype == want[2].dtype and np.array_equal(got[2], trans[0])


def test_decode_defaults_to_the_card(reads):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py runs the path")
    ids, posts, calls, trans, _ = reads
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_real.decode_posts_with_barcodes(ids, posts, calls, trans,
                                             PORT_EXP, LIST_SIZE)
