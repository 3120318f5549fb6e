"""The port's decode reports (``nanopore_dna_storage_tpu_torch/reports/``:
``file_recovery``, ``read_cost`` and their shared ``corpus``) against the
repository's JAX report scripts, on the CPU.

Each JAX script's ``main()`` runs in this process at
``test_torch_parallel.py``'s small config (m=6 r=1/2, 2 bytes an oligo, L=2,
max deviation 4) on an 8-byte file: its ``FILE_SIZE`` and its experiment
lookup are patched, and its ``ShardedDecoder`` is replaced by an adapter
over the JAX ``PipelineDecoder.decode_posts`` and ``check_and_extract``,
which ``tests/test_mesh.py`` holds equal to the JAX ``ShardedDecoder``
(whose CPU decode takes minutes a read). The adapter serves each read from
one ``decode_posts`` call per orientation over every read the scripts draw
(a read's lists do not depend on its batch), so the three JAX runs cost one
decode. Nothing in the JAX package or ``scripts/`` changes. The port's side
runs its real ``ShardedDecoder`` on ``device="cpu"``.

Records are compared on every key but the timings and ``backend`` /
``device``; every compared value is an integer, a flag or a string, so the
comparisons are exact.
"""
import importlib.util
import json
import pathlib
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from nanopore_dna_storage_tpu.coding.framing import \
    check_and_extract as jax_check_and_extract
from nanopore_dna_storage_tpu.config import ExperimentConfig
from nanopore_dna_storage_tpu.parallel import mesh as jax_mesh
from nanopore_dna_storage_tpu.pipeline import decode as jax_decode
from nanopore_dna_storage_tpu.pipeline import encode as jax_encode
from nanopore_dna_storage_tpu.pipeline import experiments as jax_experiments
from nanopore_dna_storage_tpu.pipeline import simulate as jax_simulate
from nanopore_dna_storage_tpu_torch import config as port_config
from nanopore_dna_storage_tpu_torch.reports import (corpus, file_recovery,
                                                    read_cost)
from test_torch_host import _forbidden, _imports, twin

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
REPORTS = ROOT / "nanopore_dna_storage_tpu_torch" / "reports"
EXP = ExperimentConfig(bytes_per_oligo=2, rs_redundancy=0.5, conv_mem=6,
                       conv_rate=1)
PORT_EXP = twin(EXP, port_config)
FILE_SIZE, SEED, EXP_ID = 8, 5, 7
READS, BATCH, HALF = 8, 4, 4
L, DEV = 2, 4
CHANNEL = dict(sub=0.004, dels=0.0085, ins=0.0005)
TIMINGS = {"decode_wall_s", "s_per_read", "rs_recover_s", "backend",
           "device"}
SWEEP = dict(step=4, num_trials=3, trial_seed=99)


def same_record(got: dict, want: dict) -> None:
    """Equal on every key but the timings and the device, the device key in
    the JAX record's ``backend`` slot."""
    assert [("backend" if k == "device" else k) for k in got] == list(want)
    for k in want:
        if k not in TIMINGS:
            assert got[k] == want[k], k


def load_script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_report_{name}", ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def chunk_reads(enc, start):
    """The reads the scripts draw for the chunk that starts at ``start``."""
    n = min(BATCH, READS - start)
    rng = np.random.default_rng((SEED, start))
    return jax_simulate.simulate_posts(
        enc.oligos, n, rng, sub_prob=CHANNEL["sub"],
        del_prob=CHANNEL["dels"], ins_prob=CHANNEL["ins"])


class JaxCorpus:
    """Every read the scripts draw, decoded by the JAX ``PipelineDecoder``
    once per orientation; ``decoder`` gives ``ShardedDecoder``'s interface
    over it."""

    def __init__(self):
        self.dec = jax_decode.PipelineDecoder(EXP, L, DEV)
        self.enc = jax_encode.encode_bytes(self.data(), EXP)
        self.num_oligos = self.enc.num_oligos_data + self.enc.num_oligos_rs
        posts, rcs = [], []
        for start in range(0, READS, BATCH):
            p, r, _ = chunk_reads(self.enc, start)
            posts += p
            rcs += list(r)
        self.out = {}
        for rc in (False, True):
            sel = [p for p, r in zip(posts, rcs) if r == rc]
            res = self.dec.decode_posts(sel, [rc] * len(sel),
                                        self.num_oligos)
            for j, p in enumerate(sel):
                self.out[(rc, p.tobytes())] = (res.msgs[j], res.valid[j])
        self.calls = 0

    @staticmethod
    def data() -> bytes:
        return np.random.default_rng(SEED).integers(
            0, 256, FILE_SIZE, np.uint8).tobytes()

    def decoder(self, exp, list_size, rc, max_deviation=None, mesh=None,
                backend=None):
        assert (exp, list_size, max_deviation) == (EXP, L, DEV)
        corpus_ = self

        class Adapter:
            def decode(self, packed, nblks, num_oligos):
                corpus_.calls += 1
                msgs, valid = zip(*(corpus_.out[(rc, packed[i, :n]
                                                 .tobytes())]
                                    for i, n in enumerate(nblks)))
                msgs, valid = np.stack(msgs), np.stack(valid)
                ok, index = jax_check_and_extract(msgs, EXP.framing,
                                                  num_oligos, pad=EXP.pad)
                return types.SimpleNamespace(msgs=msgs, ok=ok & valid,
                                             index=index)

        return Adapter()


def run_script(jax_corpus, name, argv, tmp, monkeypatch, recovers=True):
    """One JAX report script's ``main`` on the small config; its record.
    ``recovers``: whether the file recovery script's final check passes."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp / "jax_cache"))
    script = load_script(name)
    monkeypatch.setattr(script, "FILE_SIZE", FILE_SIZE)
    monkeypatch.setattr(jax_experiments, "experiment", lambda i: EXP)
    monkeypatch.setattr(jax_mesh, "ShardedDecoder", jax_corpus.decoder)
    monkeypatch.setattr(jax_mesh, "data_mesh", lambda: None)
    out = tmp / f"{name}.json"
    monkeypatch.setattr(sys, "argv", [name, "--experiment", str(EXP_ID),
                                      "--list-size", str(L),
                                      "--max-deviation", str(DEV),
                                      "--batch", str(BATCH),
                                      "--seed", str(SEED), "--out", str(out),
                                      *argv])
    if recovers:
        script.main()
    else:
        with pytest.raises(AssertionError, match="file recovery FAILED"):
            script.main()
    return json.loads(out.read_text())


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX scripts' records and state files: each script over the
    whole corpus, and stopped at its half."""
    tmp = tmp_path_factory.mktemp("jax_reports")
    jc = JaxCorpus()
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        for name, extra in (("file_recovery_report", []),
                            ("read_cost_report", [
                                "--step", str(SWEEP["step"]),
                                "--num-trials", str(SWEEP["num_trials"])])):
            for reads in (READS, HALF):
                state = tmp / f"{name}_{reads}.npz"
                rec = run_script(
                    jc, name, ["--reads", str(reads), "--state", str(state),
                               *extra], tmp, mp,
                    recovers=name != "file_recovery_report" or reads == READS)
                runs[name, reads] = rec, state
    assert jc.calls > 0
    return runs


def port_kw(**kw):
    """``run``'s keywords at the small config, ``kw`` replacing them."""
    return {**dict(experiment_id=EXP_ID, reads=READS, list_size=L,
                   batch=BATCH, max_deviation=DEV, seed=SEED, device="cpu",
                   log=lambda s: None, **CHANNEL), **kw}


@pytest.fixture
def port_main(monkeypatch):
    """A report's ``main`` with the small config in place of the published
    experiment and file size."""
    monkeypatch.setattr(corpus, "FILE_SIZE", FILE_SIZE)

    def run(module, argv):
        monkeypatch.setattr(module, "experiment", lambda i: PORT_EXP)
        return module.main(["--experiment", str(EXP_ID), "--list-size",
                            str(L), "--max-deviation", str(DEV), "--batch",
                            str(BATCH), "--seed", str(SEED), "--device",
                            "cpu", *argv])

    return run


def test_file_recovery_matches_jax(jax_runs, tmp_path, port_main):
    want, _ = jax_runs["file_recovery_report", READS]
    assert want["file_bytes_match"] and want["reads_used"] == READS
    out = tmp_path / "port.json"
    assert port_main(file_recovery, ["--reads", str(READS), "--state",
                                     str(tmp_path / "s.npz"), "--out",
                                     str(out)]) == 0
    got = json.loads(out.read_text())
    same_record(got, want)
    assert got["device"] == "cpu"


def test_file_recovery_resumes_a_jax_state(jax_runs, tmp_path):
    """A state file the JAX script wrote at half its reads resumes in the
    port, which decodes the second half and gives the record of one
    uninterrupted run; the state it leaves has the script's fields."""
    want, _ = jax_runs["file_recovery_report", READS]
    _, half = jax_runs["file_recovery_report", HALF]
    state = tmp_path / "state.npz"
    shutil.copy(half, state)
    got, steps = file_recovery.run(PORT_EXP, FILE_SIZE,
                                   **port_kw(state=str(state)))
    same_record(got, want)
    assert steps > 0
    _, full = jax_runs["file_recovery_report", READS]
    with np.load(state) as mine, np.load(full) as theirs:
        assert sorted(mine.files) == sorted(theirs.files)
        for k in theirs.files:
            if k != "wall":
                assert np.array_equal(mine[k], theirs[k]), k
                assert mine[k].dtype == theirs[k].dtype, k


def test_read_cost_stopped_and_resumed_matches_jax(jax_runs, tmp_path):
    """The port stopped at half its reads and resumed gives the JAX
    script's record of one run, the sweep included."""
    want, _ = jax_runs["read_cost_report", READS]
    state = str(tmp_path / "state.npz")
    half, steps_half = read_cost.run(PORT_EXP, FILE_SIZE, **port_kw(
        reads=HALF, state=state, **SWEEP))
    same_record(half, jax_runs["read_cost_report", HALF][0])
    got, steps = read_cost.run(PORT_EXP, FILE_SIZE,
                               **port_kw(state=state, **SWEEP))
    same_record(got, want)
    assert steps_half > 0 and steps > 0
    assert want["sweep"][-1]["successes"] == SWEEP["num_trials"]
    assert want["min_reads_all_trials"] is not None


@pytest.mark.parametrize("step,trials,trial_seed", [(2, 4, 99), (3, 2, 5)])
def test_read_cost_sweep_only_matches_jax(jax_runs, tmp_path, port_main,
                                          monkeypatch, step, trials,
                                          trial_seed):
    """``--sweep-only`` on the JAX script's corpus: no decode, and the
    sweep of the JAX script's own ``--sweep-only``."""
    _, state = jax_runs["read_cost_report", READS]
    argv = ["--reads", str(READS), "--step", str(step), "--num-trials",
            str(trials), "--trial-seed", str(trial_seed), "--sweep-only"]
    jc = types.SimpleNamespace(decoder=None)  # a decode would fail
    want = run_script(jc, "read_cost_report", [*argv, "--state", str(state)],
                      tmp_path, monkeypatch)
    mine = tmp_path / "mine.npz"
    shutil.copy(state, mine)
    out = tmp_path / "port.json"
    assert port_main(read_cost, [*argv, "--state", str(mine), "--out",
                                 str(out)]) == 0
    got = json.loads(out.read_text())
    same_record(got, want)
    assert len(got["sweep"]) == READS // step


def test_file_recovery_mismatch_exits_nonzero(tmp_path, port_main, capsys):
    """Two reads cannot recover six oligos: the record says so and the run
    exits 1, as the JAX script's final check fails."""
    out = tmp_path / "port.json"
    assert port_main(file_recovery, ["--reads", "2", "--state",
                                     str(tmp_path / "s.npz"), "--out",
                                     str(out)]) == 1
    got = json.loads(out.read_text())
    assert got["reads_used"] == 2 and not got["file_bytes_match"]
    assert "FAILED" in capsys.readouterr().err


MODULES = ("file_recovery", "read_cost", "basecall_error",
           "signal_fidelity")


@pytest.mark.parametrize("name", MODULES)
def test_reports_default_to_the_card(name, tmp_path, monkeypatch):
    """Without ``--device`` a report asks for the card and, with no card,
    raises before it writes anything; nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without CUDA")
    monkeypatch.setattr(corpus, "REPO", tmp_path)
    module = importlib.import_module(
        f"nanopore_dna_storage_tpu_torch.reports.{name}")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.main(["--out", str(tmp_path / "o.json")]
                    if name != "basecall_error" else [])
    assert not list(tmp_path.iterdir())


def test_reports_run_as_modules_without_jax():
    """Each report runs with ``python -m`` (here its ``--help``) in a
    process that never imports JAX or the JAX package."""
    code = (
        "import runpy, sys\n"
        f"for name in {MODULES!r}:\n"
        "    sys.argv = [name, '--help']\n"
        "    try:\n"
        "        runpy.run_module('nanopore_dna_storage_tpu_torch.reports.'"
        " + name, run_name='__main__')\n"
        "    except SystemExit as e:\n"
        "        assert e.code == 0, (name, e.code)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'nanopore_dna_storage_tpu.')) or m == "
        "'nanopore_dna_storage_tpu']\n"
        "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    for flag in ("--device", "--experiment", "--steps", "--params-cache"):
        assert flag in res.stdout


@pytest.mark.parametrize("name", ("__init__", "corpus") + MODULES)
def test_report_module_imports_nothing_of_jax(name):
    path = REPORTS / f"{name}.py"
    bad = [f"{path.name}:{line} imports {mod}"
           for mod, line in _imports(path) if _forbidden(mod)]
    assert not bad, bad
