"""The port's ``Basecaller`` (``pipeline/basecall.py``) and its
signal-fidelity simulation (``pipeline/simulate.py``) against the JAX
package on the CPU, on the JAX package's ``init_params`` weights carried
across by ``params_from_numpy``; the tolerances are those of
``test_torch_basecall.py``. Sequences, qualities, block indices, the
written files and the simulation's stats are exact.

The weights are random (no trained basecaller is in the repository), so
the signal loop decodes no read: its stats are held equal, zeros included.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from nanopore_dna_storage_tpu.config import ExperimentConfig
from nanopore_dna_storage_tpu.pipeline import basecall as jax_basecall
from nanopore_dna_storage_tpu.pipeline import simulate as jax_sim
from nanopore_dna_storage_tpu.pipeline.encode import encode_bytes
from nanopore_dna_storage_tpu_torch import config as port_config
from nanopore_dna_storage_tpu_torch import pipeline as port_pipeline
from nanopore_dna_storage_tpu_torch.models import flipflop as port_ff
from nanopore_dna_storage_tpu_torch.pipeline import basecall as port_basecall
from nanopore_dna_storage_tpu_torch.pipeline import simulate as port_sim
from nanopore_dna_storage_tpu_torch.signal.squiggle import \
    simulate_raw_signal
from test_torch_basecall import RTOL, SMALL, close, configs, jax_params
from test_torch_host import twin

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
# test_pipeline.py's small experiment: m=6 r=1/2, 4 bytes per oligo
EXP = ExperimentConfig(bytes_per_oligo=4, rs_redundancy=0.5, conv_mem=6,
                       conv_rate=1)
DATA = bytes(range(16))


@pytest.fixture(scope="module")
def small_net():
    _, cfg = configs(SMALL)
    return port_ff.params_from_numpy(jax_params(SMALL), cfg, device="cpu")


def squiggles(seed, n, length=160):
    rng = np.random.default_rng(seed)
    return [simulate_raw_signal(rng.integers(0, 4, length).astype(np.uint8),
                                rng, kmer=1) * 30 + 400 for _ in range(n)]


def test_basecaller_matches(tmp_path, small_net):
    jcfg, pcfg = configs(SMALL)
    signals = squiggles(15, 3)
    ids = ["r0", "r1", "r2"]
    want = jax_basecall.Basecaller(jax_params(SMALL), jcfg).basecall(
        ids, signals, keep_posterior=True, bucket=256)
    got = port_basecall.Basecaller(small_net, device="cpu").basecall(
        ids, signals, keep_posterior=True, bucket=256)
    for g, w in zip(got, want):
        assert (g.read_id, g.sequence, g.quality, g.nblocks, g.trimmed) == \
            (w.read_id, w.sequence, w.quality, w.nblocks, w.trimmed)
        assert g.trimmed[0] > 0  # the flappie trim took the first samples
        assert np.array_equal(g.block_index, w.block_index)
        assert len(g.sequence) > 10
        np.testing.assert_allclose(g.score, w.score, rtol=RTOL)
        close(g.posterior, w.posterior)
    for write in ("write_fastq", "write_fasta", "write_sam"):
        getattr(port_basecall, write)(str(tmp_path / "port"), got)
        getattr(jax_basecall, write)(str(tmp_path / "jax"), want)
        assert (tmp_path / "port").read_bytes() == \
            (tmp_path / "jax").read_bytes(), write
    q = port_basecall.phred_char(np.asarray([0.0, 0.5, 0.99999, 1.0]))
    assert np.array_equal(q, jax_basecall.phred_char(
        np.asarray([0.0, 0.5, 0.99999, 1.0])))


def test_simulate_posts_signal_matches(small_net):
    jcfg, _ = configs(SMALL)
    enc = encode_bytes(DATA, EXP)
    want = jax_sim.simulate_posts_signal(
        enc.oligos, 4, np.random.default_rng(16), jax_params(SMALL), jcfg,
        kmer=1)
    got = port_sim.simulate_posts_signal(
        enc.oligos, 4, np.random.default_rng(16), small_net, kmer=1,
        device="cpu")
    assert np.array_equal(got[1], want[1]) and np.array_equal(got[2],
                                                              want[2])
    assert len(got[0]) == len(want[0]) == 4
    for g, w in zip(got[0], want[0]):
        assert g.shape == w.shape and g.shape[1:] == (5, 8)
        close(g, w)


def test_simulate_and_decode_signal_matches(small_net):
    """The signal loop's stats equal the JAX package's on the same
    weights, reads and decoder."""
    jcfg, _ = configs(SMALL)
    enc = encode_bytes(DATA, EXP)
    pexp = twin(EXP, port_config)
    want, _ = jax_sim.simulate_and_decode_signal(
        enc, EXP, 3, list_size=1, seed=17, max_deviation=8,
        params=jax_params(SMALL), model_cfg=jcfg, batch=3)
    got, params = port_sim.simulate_and_decode_signal(
        port_pipeline.encode_bytes(DATA, pexp), pexp, 3, list_size=1,
        seed=17, max_deviation=8, params=small_net, batch=3, device="cpu")
    assert params is small_net
    for field in ("num_reads", "top_correct", "list_correct", "crc_pass",
                  "unique_indices"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.num_reads == 3 and got.steps > 0


def test_simulate_and_decode_signal_needs_params():
    pexp = twin(EXP, port_config)
    with pytest.raises(NotImplementedError, match="train"):
        port_sim.simulate_and_decode_signal(
            port_pipeline.encode_bytes(DATA, pexp), pexp, 2, device="cpu")


def test_basecaller_defaults_to_the_card():
    """``Basecaller(params)`` with no device asks for the card, and without
    one it raises at once instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py basecalls on it")
    _, cfg = configs(SMALL)
    with pytest.raises((RuntimeError, AssertionError), match="CUDA"):
        port_basecall.Basecaller(jax_params(SMALL), cfg)


_NO_JAX = """
import sys
import numpy as np
import torch
torch.set_num_threads(1)
from nanopore_dna_storage_tpu_torch.models.flipflop import FlipflopConfig
from nanopore_dna_storage_tpu_torch.pipeline.basecall import Basecaller
from nanopore_dna_storage_tpu_torch.pipeline import simulate
cfg = FlipflopConfig(winlen=5, conv_filters=8, hidden=8, layer_dirs=("b",))
calls = Basecaller(cfg=cfg, device="cpu").basecall(
    ["r"], [np.random.default_rng(0).standard_normal(300)], trim=False)
assert set(calls[0].sequence) <= set("ACGT") and calls[0].nblocks == 150
bad = [m for m in sys.modules if m in ("jax", "nanopore_dna_storage_tpu")
       or m.startswith(("jax.", "nanopore_dna_storage_tpu."))]
assert not bad, bad
print("ok")
"""


def test_basecaller_runs_without_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
    res = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=100)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
