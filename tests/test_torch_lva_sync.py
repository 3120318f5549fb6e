"""The port's ``LVADecoder`` (CPU, plain ACS step) against the reference
binary's golden lists with sync markers (tests/golden/sync), bit for bit:
periodic known bits restrict the valid conv states at each message position
(viterbi_convolutional_code.cpp:388-414, 968-975), also under RC. Every
list must be identical and its top entry the true message. The m=8 cases
run in the slow suite, as in tests/test_lva_sync.py; chip_smoke.py runs all
seven through the CUDA kernel.
"""
import json
import pathlib

import numpy as np
import pytest
import torch

from nanopore_dna_storage_tpu_torch.config import ConvCodeConfig, DecodeConfig
from nanopore_dna_storage_tpu_torch.ops.lva import LVADecoder

torch.set_num_threads(1)

SYNC = pathlib.Path(__file__).parent / "golden" / "sync"
CASES = json.loads((SYNC / "manifest.json").read_text())


def _sync_golden(idx):
    case = CASES[idx]
    cfg = DecodeConfig(
        code=ConvCodeConfig(mem=case["mem"], rate=case["rate"],
                            msg_len=case["msg_len"], rc=case["rc"],
                            sync_marker=case["sync_marker"],
                            sync_period=case["sync_period"]),
        list_size=case["list_size"], max_deviation=case["max_deviation"])
    post = np.fromfile(SYNC / f"{case['name']}.post",
                       dtype="<f4").reshape(-1, 5, 8)
    msgs, _, valid = LVADecoder(cfg, device="cpu").decode(post[None])
    got = ["".join(map(str, m)) for m, v in zip(msgs[0], valid[0]) if v]
    assert got == (SYNC / f"{case['name']}.lists").read_text().split(), \
        case["name"]
    assert got[0] == case["true_msg"]


@pytest.mark.parametrize(
    "idx", [i for i, c in enumerate(CASES) if c["mem"] < 8])
def test_sync_golden_m6(idx):
    _sync_golden(idx)


@pytest.mark.slow
@pytest.mark.parametrize(
    "idx", [i for i, c in enumerate(CASES) if c["mem"] >= 8])
def test_sync_golden_m8(idx):
    _sync_golden(idx)
