"""The plain reference against the reference C++ binary's decoded lists.

``benchmark/golden`` holds cases of the upstream decoder
(``viterbi_nanopore.out -m decode``: a read's posteriors and the messages of
its valid list entries, best first), copied from the repo's
``tests/golden/decode``. They anchor the reference apart from the program:
its forward step, tables and traceback are held to the C++ decoder's output,
not to the code under test. The m=6 and m=8 cases run on the CPU; the
benchmark's own codes (m=11 r=5/6 L=8 in both orientations, m=8 r=1/2 L=64)
run on the card:

    python3 -m pytest benchmark/tests/test_bench_reference.py -m card -n 0
"""
import json

import numpy as np
import pytest
import torch

from benchmark import reference
from benchmark.frozen.config import ConvCodeConfig
from conftest import BENCH

GOLDEN = BENCH / "golden"
CASES = {c["name"]: c for c in json.loads(
    (GOLDEN / "manifest.json").read_text())}
ON_CARD = ["m11_r5_rc0_l8", "m11_r5_rc1_l8", "m8_r1_rc0_l64"]


def golden_lists(name: str, device: str, tamper=None):
    """(the reference's valid messages as bit strings, best first, and the
    C++ decoder's) for golden case ``name``; ``tamper`` may alter the
    decoder first."""
    c = CASES[name]
    post = np.fromfile(GOLDEN / f"{name}.post", dtype="<f4").reshape(-1, 5, 8)
    dec = reference.ReferenceDecoder(
        ConvCodeConfig(mem=c["mem"], rate=c["rate"], msg_len=c["msg_len"],
                       rc=c["rc"]), c["list_size"], c["max_deviation"],
        device)
    if tamper is not None:
        tamper(dec)
    msgs, scores, valid = dec.decode([post])
    got = ["".join(map(str, m)) for m, v in zip(msgs[0], valid[0]) if v]
    assert np.all(np.diff(scores[0][valid[0]]) <= 0)
    return got, (GOLDEN / f"{name}.lists").read_text().split()


@pytest.mark.parametrize("name", [n for n in CASES if n not in ON_CARD])
def test_reference_is_the_cpp_decoder(name):
    got, want = golden_lists(name, "cpu")
    assert got == want


@pytest.mark.card
@pytest.mark.parametrize("name", ON_CARD)
def test_reference_is_the_cpp_decoder_at_the_cells_codes(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    got, want = golden_lists(name, "cuda")
    assert got == want


def writers_swapped(dec):
    """A walk that takes a move's source from the stay row's writer and a
    stay's from the move row's."""
    walk = dec.traceback
    dec.traceback = lambda sels, src, *a: walk(sels, src[:, [1, 0]], *a)


def bits_swapped(dec):
    """The bits of a two-bit move in the other order."""
    nb = dec.tabs["nbits"]
    nb[1] = ((nb[1] & 1) << 1) | (nb[1] >> 1)


@pytest.mark.parametrize("name,tamper", [
    ("m6_r7_rc1_l2", writers_swapped), ("m6_r5_rc0_l8", bits_swapped)])
def test_a_broken_walk_fails_the_goldens(name, tamper):
    """The anchor can fail: a fault in the walk or its tables reads other
    lists."""
    got, want = golden_lists(name, "cpu", tamper)
    assert got != want
