"""The port's ``LVADecoder`` (CPU, plain ACS step) against the reference
binary's golden decoded lists (tests/golden/decode), bit for bit; on the
fast m=6 cases also the numpy model of the traceback kernel's walk
(``test_torch_traceback.walk``) against the traceback those decodes ran.
The m=11 and m=14 cases run through the CUDA kernel in chip_smoke.py.
"""
import json
import pathlib

import pytest
import torch

from nanopore_dna_storage_tpu_torch.config import ConvCodeConfig, DecodeConfig
from nanopore_dna_storage_tpu_torch.ops.lva import LVADecoder
from test_lva_decode import _cases, _load_post, _ref_lists
from test_torch_traceback import model_matches, spy_traceback

torch.set_num_threads(1)


def _golden(golden_dir, idx):
    case = _cases(golden_dir)[idx]
    cfg = DecodeConfig(
        code=ConvCodeConfig(mem=case["mem"], rate=case["rate"],
                            msg_len=case["msg_len"], rc=case["rc"]),
        list_size=case["list_size"], max_deviation=case["max_deviation"])
    msgs, _, valid = LVADecoder(cfg, device="cpu").decode(
        _load_post(golden_dir, case["name"])[None])
    got = ["".join(map(str, m)) for m, v in zip(msgs[0], valid[0]) if v]
    assert got == _ref_lists(golden_dir, case["name"]), case["name"]


def _golden_ids(fast):
    """Manifest positions of the m=6 cases with L <= 8 (fast), or of the
    m=8 cases and m=6 L=34 (slow on the CPU)."""
    path = pathlib.Path(__file__).parent / "golden/decode/manifest.json"
    cases = json.loads(path.read_text())
    return [i for i, c in enumerate(cases) if c["mem"] <= 8
            and (c["mem"] == 6 and c["list_size"] <= 8) == fast]


@pytest.mark.parametrize("idx", _golden_ids(fast=True))
def test_golden_m6(golden_dir, idx, monkeypatch):
    seen = spy_traceback(monkeypatch)
    _golden(golden_dir, idx)
    model_matches(seen)


@pytest.mark.slow
@pytest.mark.parametrize("idx", _golden_ids(fast=False))
def test_golden_large(golden_dir, idx):
    _golden(golden_dir, idx)
