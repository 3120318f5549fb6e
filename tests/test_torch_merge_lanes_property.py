"""The cross-lane first argmax of the merge probe's register layout
(``csrc/probes.cu`` ``merge_kernel``, modelled in
``test_torch_merge_lanes.py``) as a property: the lanes' trees and the
butterfly pick numpy's first argmax on any 64 scores. Needs
``hypothesis``; without it this file alone skips.
"""
import numpy as np
import pytest

pytest.importorskip("hypothesis")
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from test_torch_merge_lanes import (LANES, NEG, lane_argmax,  # noqa: E402
                                    lanes_of)

SCORES = st.sampled_from([NEG, np.float32(-0.0), np.float32(0.0),
                          np.float32(-1.0), np.float32(2.0)]) | st.floats(
    -4, 4, width=32)


@settings(max_examples=200, deadline=None)
@given(st.lists(SCORES, min_size=64, max_size=64),
       st.sampled_from(LANES))
def test_cross_lane_argmax_is_numpys(scores, lanes):
    """The lanes' trees and the butterfly pick numpy's first argmax of the
    64 scores (ties, -0.0 against +0.0, all -inf), and its score's bits."""
    x = np.array(scores, np.float32)[:, None]
    best, f = lane_argmax(lanes_of(x, lanes, NEG), lanes)
    i = int(np.argmax(x[:, 0]))
    assert f[0] == i
    assert best.view(np.int32)[0] == x[i].view(np.int32)[0]
