"""The port's vocabulary Viterbi (``ops/vocab.py``) on the CPU, against the
older reference binary's goldens and the JAX package's
``decode_post_vocab``.

The goldens' word sequences must equal the reference's ``.out`` files. On
seeded posts (normal scores, integer scores full of ties, all zeros, and a
crafted tie between two words) the port's message must equal JAX's
exactly, the same error included: every score is one f32 add per block in
the same order, and ties go to the first candidate in both.
"""
import json

import numpy as np
import pytest
import torch

from nanopore_dna_storage_tpu.ops import vocab as jax_vocab
from nanopore_dna_storage_tpu_torch.ops import vocab as port_vocab

torch.set_num_threads(1)


def _golden(golden_dir):
    return json.loads((golden_dir / "vocab" / "manifest.json").read_text())


@pytest.mark.parametrize("i", range(3))
def test_vocab_goldens_equal_the_reference(golden_dir, i):
    case = _golden(golden_dir)[i]
    root = golden_dir / "vocab"
    post = np.fromfile(root / f"{case['name']}.post",
                       dtype="<f4").reshape(-1, 5, 8)
    got = port_vocab.decode_post_vocab(post, case["msg_len"], case["vocab"],
                                       device="cpu")
    want = [int(x) for x in (root / f"{case['name']}.out").read_text()
            .split()]
    assert got.dtype == np.int32 and got.tolist() == want == case["ref"]


def _case(seed: int):
    """(post, msg_len, words) of one seeded case; seeds by kind: normal
    scores, integer scores in {-2, -1, 0}, all zeros."""
    rng = np.random.default_rng(seed)
    words = ["".join("ACGT"[j] for j in rng.integers(0, 4, rng.integers(1, 7)))
             for _ in range(rng.integers(1, 6))]
    msg_len = int(rng.integers(1, 5))
    T = int(rng.integers(msg_len, 45))
    kind = seed % 3
    if kind == 0:
        post = rng.standard_normal((T, 5, 8))
    elif kind == 1:
        post = rng.integers(-2, 1, (T, 5, 8))
    else:
        post = np.zeros((T, 5, 8))
    return post.astype(np.float32), msg_len, words


def _both(post, msg_len, words):
    """Each package's message, or the type and text of what it raised."""
    out = []
    for fn, kw in ((port_vocab.decode_post_vocab, {"device": "cpu"}),
                   (jax_vocab.decode_post_vocab, {})):
        try:
            out.append(fn(post, msg_len, words, **kw).tolist())
        except (RuntimeError, ValueError) as e:
            out.append((type(e).__name__, str(e)))
    return out


@pytest.mark.parametrize("seed", range(12))
def test_seeded_posts_match_jax(seed):
    got, want = _both(*_case(seed))
    assert got == want


def test_tie_between_two_words_goes_to_the_first():
    """Two words of the same bases in another order score the same on an
    all-zero post, and words that repeat a base tie flip against flop: both
    packages pick the same (first) candidates."""
    words = ["ACGA", "AGCA", "AAAA", "CCCC"]
    for msg_len in (1, 2, 3):
        post = np.zeros((4 * msg_len + 5, 5, 8), np.float32)
        got, want = _both(post, msg_len, words)
        assert got == want and isinstance(got, list)


def test_larger_case_matches_jax():
    """16 ten-mers at msg_len 6 on a noisy synthetic read of a message."""
    from nanopore_dna_storage_tpu_torch.ops.synthetic import synthetic_post

    rng = np.random.default_rng(21)
    words = ["".join("ACGT"[j] for j in rng.integers(0, 4, 10))
             for _ in range(16)]
    msg = rng.integers(0, 16, 6)
    seq = "".join(words[m] for m in msg)
    post = synthetic_post(np.asarray(["ACGT".index(c) for c in seq]), rng,
                          noise=1.2)
    got, want = _both(post, 6, words)
    assert got == want == msg.tolist()


def test_short_post_raises():
    with pytest.raises(ValueError, match="Too small post matrix"):
        port_vocab.decode_post_vocab(np.zeros((3, 5, 8), np.float32), 5,
                                     ["ACGT"], device="cpu")


def test_vocab_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py runs it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_vocab.decode_post_vocab(np.zeros((9, 5, 8), np.float32), 2,
                                     ["ACGT"])


def test_vocab_file_and_tables_match(tmp_path):
    path = tmp_path / "vocab.txt"
    path.write_text("ACGT\n\n  TTAG \nC\n")
    words = port_vocab.load_vocab_file(str(path))
    assert words == jax_vocab.load_vocab_file(str(path)) == \
        ["ACGT", "TTAG", "C"]
    got, want = port_vocab.VocabTables(words, 3), \
        jax_vocab.VocabTables(words, 3)
    for a in ("nwords", "maxlen", "msg_len", "words"):
        assert getattr(got, a) == getattr(want, a)
    for a in ("wordlen", "base", "valid", "last_idx"):
        g, w = getattr(got, a), getattr(want, a)
        assert g.dtype == w.dtype and np.array_equal(g, w)
