"""The port's signal reports (``reports/basecall_error.py``,
``reports/signal_fidelity.py``) against the repository's JAX report
scripts, on the CPU, on weights carried across between the packages.

No trained basecaller is in the repository, so the weights are the JAX
package's ``init_params``: the basecalls are poor and the signal loop's
reads find no passing candidate, and the records are held equal all the
same (edit distances, counts and zeros exactly). The basecall evaluation
runs at small widths; the fidelity report at its own (winlen 11, 32
filters, hidden 64, layers b/f/b) on ``test_torch_reports.py``'s small
experiment and one read. Network outputs across the packages are compared
within ``test_torch_basecall.py``'s float32 tolerance.
"""
import contextlib
import dataclasses
import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanopore_dna_storage_tpu.models import flipflop as jax_ff
from nanopore_dna_storage_tpu.models import train as jax_train
from nanopore_dna_storage_tpu.ops import crf_decode as jax_crf
from nanopore_dna_storage_tpu.pipeline import experiments as jax_experiments
from nanopore_dna_storage_tpu.signal import squiggle as jax_squiggle
from nanopore_dna_storage_tpu.signal.normalize import \
    medmad_normalize as jax_medmad
from nanopore_dna_storage_tpu_torch.models import flipflop as port_ff
from nanopore_dna_storage_tpu_torch.models import train as port_train
from nanopore_dna_storage_tpu_torch.reports import (basecall_error, corpus,
                                                    signal_fidelity)
from test_torch_basecall import close
from test_torch_reports import EXP, EXP_ID, PORT_EXP, load_script

torch.set_num_threads(1)

# the evaluation at small widths: the script's flags and the config
WIDTHS = ["--hidden", "8", "--filters", "4", "--layers", "bf", "--winlen",
          "5"]
SMALL = dict(winlen=5, stride=2, conv_filters=4, hidden=8,
             layer_dirs=("b", "f"))
EVAL = dict(kmer=6, eval_reads=3, eval_len=40, seed=1)
RECORD_SKIP = {"wall_s", "backend", "device"}


def jax_distances(params, cfg, script, kmer, eval_reads, eval_len, seed):
    """The JAX script's held-out evaluation, step for step, each read's
    edit distance kept."""
    rng = np.random.default_rng(seed + 777)
    T = eval_len * 12
    sig = np.zeros((eval_reads, T), np.float32)
    ns = np.zeros(eval_reads, np.int32)
    seqs = []
    for i in range(eval_reads):
        seq = rng.integers(0, 4, eval_len).astype(np.uint8)
        raw = jax_squiggle.simulate_raw_signal(seq, rng, deepsim_dwell=False,
                                               kmer=kmer)
        raw = jax_medmad(raw)[:T]
        sig[i, : len(raw)] = raw
        ns[i] = len(raw)
        seqs.append(seq)
    trans = jax_ff.flipflop_transitions(params, cfg, jnp.asarray(sig),
                                        jnp.asarray(ns))
    nblk = -(-ns // cfg.stride)
    paths, _ = jax_crf.viterbi_flipflop_batch(
        trans.reshape(eval_reads, -1, 5, 8), jnp.asarray(nblk))
    paths = np.asarray(paths)
    b2i = {b: i for i, b in enumerate("ACGT")}
    return [script.edit_distance(
        [b2i[c] for c in jax_crf.basecall_from_path(paths[i],
                                                    int(nblk[i]))[0]],
        list(map(int, seqs[i]))) for i in range(eval_reads)]


@pytest.fixture(scope="module")
def jax_probe(tmp_path_factory):
    """The JAX basecall-error script at 0 training steps: its record and
    the initial weights it saved."""
    tmp = tmp_path_factory.mktemp("jax_probe")
    script = load_script("basecall_error_probe")
    save = tmp / "jax.npz"
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp / "jax_cache"))
        mp.setattr("sys.argv", [
            "basecall_error_probe", "--steps", "0", *WIDTHS,
            "--eval-reads", str(EVAL["eval_reads"]), "--eval-len",
            str(EVAL["eval_len"]), "--seed", str(EVAL["seed"]),
            "--save", str(save)])
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), pytest.warns(RuntimeWarning):
            script.main()
    return script, json.loads(buf.getvalue().strip().splitlines()[-1]), save


def test_basecall_error_evaluation_matches_jax(jax_probe):
    """The port's evaluation of the weights the JAX script saved (read by
    the port's ``load_npz``): every read's edit distance equal to the JAX
    evaluation's, and the error the JAX script printed."""
    script, want, save = jax_probe
    cfg = port_ff.FlipflopConfig(**SMALL)
    net = port_ff.load_npz(str(save), cfg, device="cpu")
    got = basecall_error.evaluate(net, **EVAL)
    with np.load(save) as z:
        params = {k: jnp.asarray(z[k]) for k in z.files}
    jcfg = jax_ff.FlipflopConfig(**SMALL)
    assert got == jax_distances(params, jcfg, script, **EVAL)
    total = EVAL["eval_reads"] * EVAL["eval_len"]
    assert round(100.0 * sum(got) / total, 2) == want["basecall_err_pct"]
    assert 0 < sum(got)
    assert basecall_error.edit_distance([0, 1, 2], [1, 2, 3]) == \
        script.edit_distance([0, 1, 2], [1, 2, 3]) == 2


def test_basecall_error_record_keys_match_jax(jax_probe, tmp_path):
    """The port's record at 0 steps: the JAX script's keys in its order,
    the widths and the loss of no step alike; its saved weights are the
    net it returns, under the JAX package's names and shapes."""
    _, want, _ = jax_probe
    save = tmp_path / "port.npz"
    with pytest.warns(RuntimeWarning):
        got, net = basecall_error.run(port_ff.FlipflopConfig(**SMALL),
                                      steps=0, device="cpu", save=str(save),
                                      **EVAL)
    assert list(got) == list(want)
    for k in ("steps", "kmer", "hidden", "filters", "layers"):
        assert got[k] == want[k], k
    assert np.isnan(got["final_loss"]) and np.isnan(want["final_loss"])
    shapes = {k: tuple(v.shape) for k, v in jax_ff.init_params(
        jax_ff.FlipflopConfig(**SMALL)).items()}
    with np.load(save) as z:
        assert {k: z[k].shape for k in z.files} == shapes
        for name, p in net.named_parameters():
            assert np.array_equal(z[name], p.detach().numpy()), name


@pytest.fixture(scope="module")
def jax_cache(tmp_path_factory):
    """A fidelity cache as the JAX script writes it: the JAX package's
    ``init_params`` at the report's widths, ``np.asarray`` of each."""
    path = tmp_path_factory.mktemp("cache") / "jax_cache.npz"
    cfg = jax_ff.FlipflopConfig(**dataclasses.asdict(
        signal_fidelity.MODEL_CFG))
    np.savez(path, **{k: np.asarray(v)
                      for k, v in jax_ff.init_params(cfg, 0).items()})
    return path


def test_signal_fidelity_matches_jax_on_a_jax_cache(jax_cache, tmp_path,
                                                    monkeypatch):
    """The JAX script and the port's ``main`` on the same cache, experiment
    and read: the same record but for the time and the device; the cache
    is read, not rewritten, and the record goes to ``--out``."""
    script = load_script("signal_fidelity_report")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jc"))
    monkeypatch.setattr(jax_experiments, "experiment", lambda i: EXP)
    argv = ["--experiment", str(EXP_ID), "--reads", "1", "--batch", "1",
            "--list-size", "2", "--train-steps", "5", "--params-cache",
            str(jax_cache)]
    monkeypatch.setattr("sys.argv", ["signal_fidelity_report", *argv,
                                     "--backend", "xla", "--out",
                                     str(tmp_path / "jax.json")])
    before = jax_cache.read_bytes()
    script.main()
    want = json.loads((tmp_path / "jax.json").read_text())
    monkeypatch.setattr(signal_fidelity, "experiment", lambda i: PORT_EXP)
    assert signal_fidelity.main([*argv, "--device", "cpu", "--out",
                                 str(tmp_path / "port.json")]) == 0
    got = json.loads((tmp_path / "port.json").read_text())
    assert [("backend" if k == "device" else k) for k in got] == list(want)
    for k in want:
        if k not in RECORD_SKIP:
            assert got[k] == want[k], k
    assert got["num_reads"] == 1 and got["device"] == "cpu"
    assert jax_cache.read_bytes() == before


def test_fidelity_caches_are_interchangeable(jax_cache, tmp_path):
    """A JAX-written cache read by the port and written back is the same
    file array for array; a cache the port trains and writes loads the JAX
    script's way and gives the JAX network the port's transitions."""
    net = signal_fidelity.load_cache(str(jax_cache), "cpu")
    back = tmp_path / "back.npz"
    basecall_error.save_params(net, str(back))
    with np.load(jax_cache) as a, np.load(back) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k

    cfg = signal_fidelity.MODEL_CFG
    port = tmp_path / "port.npz"
    _, trained = basecall_error.run(cfg, steps=2, lr=3e-3, schedule=True,
                                    device="cpu", save=str(port), kmer=6,
                                    eval_reads=1, eval_len=10, seed=1)
    with np.load(port) as z:  # the JAX script's own load
        params = {k: jnp.asarray(z[k]) for k in z.files}
    assert sorted(params) == sorted(np.load(jax_cache).files)
    sig = np.random.default_rng(0).standard_normal((2, 96)).astype(
        np.float32)
    want = jax_ff.flipflop_transitions(
        params, jax_ff.FlipflopConfig(**dataclasses.asdict(cfg)),
        jnp.asarray(sig))
    close(trained(torch.from_numpy(sig)).numpy(), np.asarray(want))
    reloaded = signal_fidelity.load_cache(str(port), "cpu")
    for (name, p), (_, q) in zip(trained.named_parameters(),
                                 reloaded.named_parameters()):
        assert torch.equal(p, q), name


def test_signal_fidelity_writes_its_cache_and_keeps_docs_at_reduced_steps(
        tmp_path, monkeypatch):
    """Without a cache the report trains, writes the cache under the JAX
    names, and at fewer than the full 4,000 steps writes no record file
    unless ``--out`` names one."""
    monkeypatch.setattr(signal_fidelity, "experiment", lambda i: PORT_EXP)
    monkeypatch.setattr(corpus, "REPO", tmp_path)
    cache = tmp_path / "cache" / "p.npz"
    assert signal_fidelity.main([
        "--experiment", str(EXP_ID), "--reads", "1", "--batch", "1",
        "--list-size", "2", "--train-steps", "2", "--params-cache",
        str(cache), "--device", "cpu"]) == 0
    assert cache.exists() and not (tmp_path / "docs").exists()
    shapes = {k: tuple(v.shape) for k, v in jax_ff.init_params(
        jax_ff.FlipflopConfig(**dataclasses.asdict(
            signal_fidelity.MODEL_CFG))).items()}
    with np.load(cache) as z:
        assert {k: z[k].shape for k in z.files} == shapes


@pytest.mark.parametrize("name,override", [
    ("clean", None), ("published", None),
    ("published", "burst_rate=0.01,drift=0.15"),
    ("published", "flank_bases=3,junk_frac=0.2")])
def test_channel_profile_matches_jax(name, override):
    """``--profile`` and ``--override`` build the JAX script's profile."""
    got = signal_fidelity.channel_profile(name, override)
    if name == "clean":
        assert got is None
        return
    want = jax_squiggle.PUBLISHED_PROFILE
    if override:
        kv = dict(s.split("=") for s in override.split(","))
        want = dataclasses.replace(
            want, **{k: (int(v) if k == "flank_bases" else float(v))
                     for k, v in kv.items()})
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("kmer", [3, 6])
def test_trainer_kmer_is_the_scripts_patch(kmer, monkeypatch):
    """The JAX script forces its kmer by patching the trainer's simulator
    (``basecall_error_probe.py``); the port passes ``kmer`` to its trainer.
    Both draw the same training batches."""
    orig = jax_train.simulate_raw_signal
    monkeypatch.setattr(
        jax_train, "simulate_raw_signal",
        lambda seq, rng, deepsim_dwell=True:
        orig(seq, rng, deepsim_dwell=deepsim_dwell, kmer=kmer))
    want = next(jax_train.synthetic_batches(np.random.default_rng(4), 2, 20,
                                            240, 22))
    got = next(port_train.synthetic_batches(np.random.default_rng(4), 2, 20,
                                            240, 22, kmer=kmer,
                                            device="cpu"))
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(g), np.asarray(w))
