"""The logsumexp kernel's pop against the scan it replaces, as a property:
the tree over 64 (score, index) pairs of ``test_torch_lse.tree_pop`` picks
the winner of the ascending strict-``>`` scan ``scan_pop`` on any scores.
Needs ``hypothesis``; without it this file alone skips.
"""
import numpy as np
import pytest

pytest.importorskip("hypothesis")
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from test_torch_lse import NEG, scan_pop, tree_pop  # noqa: E402


@settings(max_examples=300, deadline=None)
@given(st.lists(st.sampled_from([NEG, np.float32(-0.0), np.float32(0.0),
                                 np.float32(-1.0), np.float32(-0.25),
                                 np.float32(2.0)])
                | st.floats(-4, 4, width=32), min_size=64, max_size=64))
def test_tree_pop_is_the_scan(scores):
    """The kernel's pop, a tree of adjacent pairs over 64 (score, index)
    pairs that takes the right child only on a strict ``>``, picks the
    winner of the ascending strict-``>`` scan: the lowest index of the
    maximum, ties, -0.0 against +0.0 and -inf included; where every score
    is -inf the scan finds none and the tree's best is -inf."""
    cs = np.array(scores, np.float32)[:, None]
    best, bi = tree_pop(cs)
    sbest, sbi = scan_pop(cs)
    if sbi[0] < 0:
        assert best[0] == NEG
    else:
        assert bi[0] == sbi[0]
        assert best.view(np.int32)[0] == sbest.astype(np.float32).view(
            np.int32)[0]
