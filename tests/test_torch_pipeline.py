"""The port's decode slice as a whole, against the JAX pipeline: encode ->
simulated reads -> list-Viterbi -> CRC/index -> majority vote -> RS.

Same inputs from one numpy seed go through both packages, each with its
own config classes built from the same fields; the lists, the per-read
(index, payload) and the recovered bytes must be identical.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from nanopore_dna_storage_tpu.coding.framing import frame_oligos
from nanopore_dna_storage_tpu.config import ExperimentConfig
from nanopore_dna_storage_tpu.pipeline import decode as jax_decode
from nanopore_dna_storage_tpu.pipeline.encode import encode_bytes
from nanopore_dna_storage_tpu_torch import config as port_config
from nanopore_dna_storage_tpu_torch import pipeline as port_pipeline
from nanopore_dna_storage_tpu_torch.pipeline import decode as port_decode
from nanopore_dna_storage_tpu_torch.pipeline import simulate as port_sim
from test_torch_host import twin

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
# test_pipeline.py's small config: m=6 r=1/2, 4 bytes per oligo
EXP = ExperimentConfig(bytes_per_oligo=4, rs_redundancy=0.5, conv_mem=6,
                       conv_rate=1)
PORT_EXP = twin(EXP, port_config)
DATA = bytes(range(16))


def test_decode_posts_matches_jax():
    enc = encode_bytes(DATA, EXP)
    rng = np.random.default_rng(1)
    posts, rcs, ids = port_sim.simulate_posts(enc.oligos, 6, rng,
                                              sub_prob=0.01, del_prob=0.01,
                                              ins_prob=0.0)
    assert rcs.any() and (~rcs).any()  # both orientations present
    total = enc.num_oligos_data + enc.num_oligos_rs
    out_j = jax_decode.PipelineDecoder(EXP, list_size=2, max_deviation=8) \
        .decode_posts(posts, rcs, total)
    dec = port_decode.PipelineDecoder(PORT_EXP, list_size=2, max_deviation=8,
                                      device="cpu")
    out_p = dec.decode_posts(posts, rcs, total)
    assert np.array_equal(out_p.valid, out_j.valid)
    assert np.array_equal(out_p.msgs, out_j.msgs)
    assert np.array_equal(out_p.index, out_j.index)
    assert np.array_equal(out_p.payload, out_j.payload)
    assert np.array_equal(out_p.best_score, out_j.best_score)
    assert (out_p.index >= 0).sum() >= 4
    assert dec.steps > 0


def test_simulate_and_decode_recovers_file():
    enc = port_pipeline.encode_bytes(DATA, PORT_EXP)
    ok, data, stats = port_sim.simulate_and_decode(
        enc, PORT_EXP, num_reads=10, data_size=len(DATA), list_size=1, seed=3,
        sub_prob=0.0, del_prob=0.0, ins_prob=0.0, max_deviation=8,
        batch=10, device="cpu")
    assert stats.crc_pass == 10
    assert stats.steps > 0
    assert ok
    assert data == DATA


def test_host_stages_match_jax():
    enc = encode_bytes(DATA, EXP)
    total = enc.num_oligos_data + enc.num_oligos_rs
    rng = np.random.default_rng(5)
    # classify: true framed messages, corrupted copies and invalid slots
    truth = frame_oligos(enc.payloads, EXP.framing)  # [6, msg_len]
    msgs = truth[rng.integers(0, total, (12, 3))]
    flip = rng.random(msgs.shape) < 0.02
    msgs = np.where(flip, 1 - msgs, msgs).astype(np.uint8)
    valid = rng.random((12, 3)) < 0.8
    jdec = jax_decode.PipelineDecoder.__new__(jax_decode.PipelineDecoder)
    jdec.exp = EXP
    pdec = port_decode.PipelineDecoder.__new__(port_decode.PipelineDecoder)
    pdec.exp = PORT_EXP
    cj = jdec.classify(msgs, valid, total)
    cp = pdec.classify(msgs, valid, total)
    for a in ("index", "payload", "chosen_msg", "valid", "msgs"):
        assert np.array_equal(getattr(cp, a), getattr(cj, a)), a
    assert (cp.index >= 0).any() and (cp.index < 0).any()

    # majority vote over repeated, conflicting and failed reads
    idx = np.concatenate([cp.index, rng.integers(-1, total, 20)])
    pay = np.concatenate([cp.payload, enc.payloads[np.clip(idx[12:], 0, None)]
                          ^ (rng.random((20, 4)) < 0.1).astype(np.uint8)])
    vj = jax_decode.majority_vote(idx, pay)
    vp = port_decode.majority_vote(idx, pay)
    assert vp == vj

    # RS recovery: all oligos, then with erasures up to the parity count
    full = {i: bytes(enc.payloads[i]) for i in range(total)}
    for voted in (full, {i: full[i] for i in (0, 2, 3, 5)}, vp):
        assert port_decode.recover_file(voted, PORT_EXP, len(DATA)) == \
            jax_decode.recover_file(voted, EXP, len(DATA))
    assert port_decode.recover_file(full, PORT_EXP, len(DATA)) == \
        (True, DATA)

    # error-rate counters
    true_idx = rng.integers(0, total, 12)
    cnt_j, cnt_p = jax_decode.ErrorRateCounters(), \
        port_decode.ErrorRateCounters()
    cnt_j.update(cj, true_idx, enc.payloads[true_idx])
    cnt_p.update(cp, true_idx, enc.payloads[true_idx])
    assert dataclasses.asdict(cnt_p) == dataclasses.asdict(cnt_j)


_NO_JAX = """
import sys
import numpy as np
import torch
torch.set_num_threads(1)
import nanopore_dna_storage_tpu_torch
from nanopore_dna_storage_tpu_torch.coding.conv import (conv_encode_bases,
                                                        make_conv_code)
from nanopore_dna_storage_tpu_torch.ops.synthetic import synthetic_post
from nanopore_dna_storage_tpu_torch.config import ConvCodeConfig, DecodeConfig
from nanopore_dna_storage_tpu_torch.ops.lva import LVADecoder
rng = np.random.default_rng(0)
code = ConvCodeConfig(mem=6, rate=1, msg_len=24)
msg = rng.integers(0, 2, (1, 24), dtype=np.uint8)
post = synthetic_post(conv_encode_bases(make_conv_code(code), msg)[0], rng)
dec = LVADecoder(DecodeConfig(code=code, list_size=2, max_deviation=6),
                 device="cpu")
msgs, scores, valid = dec.decode(post[None])
assert (msgs[0, 0] == msg[0]).all() and valid[0, 0]
assert dec.steps == len(post)
bad = [m for m in sys.modules if m in ("jax", "h5py", "nanopore_dna_storage_tpu")
       or m.startswith(("jax.", "nanopore_dna_storage_tpu."))]
assert not bad, bad
print("ok")
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
    return env


def test_port_runs_without_jax():
    res = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=ROOT,
                         env=_env(), capture_output=True, text=True,
                         timeout=100)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_cli_cuda_without_card_fails(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py runs the CLI")
    f = tmp_path / "data.bin"
    f.write_bytes(DATA)
    res = subprocess.run(
        [sys.executable, "-m", "nanopore_dna_storage_tpu_torch.cli",
         "sim-decode", "-i", str(f), "--mem", "6", "--rate", "1",
         "--bytes-per-oligo", "4", "--rs-redundancy", "0.5",
         "--num-reads", "2", "--device", "cuda"],
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=100)
    assert res.returncode != 0
    assert "CUDA is not available" in res.stderr
    assert res.stdout == ""
