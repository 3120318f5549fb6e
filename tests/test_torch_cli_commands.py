"""The port's ``encode``, ``simulate``, ``decode-posts`` and
``simulate-signal`` commands against the JAX package's.

Each command runs in both packages on the same arguments (the port's
decoding ones with ``--device cpu``): the JSON lines must be equal, and
the files written (oligos, FASTA, the ``list_<i>`` files and ``info.txt``)
equal byte for byte. ``decode-posts`` reads flappie-style ``.post``,
``.fastq`` and ``.trans`` files of ``test_torch_real_data.py``'s barcoded
reads (m=6 r=1/2, experiment 7's barcodes: one forward, one reverse
complement, one broken inside its barcodes, one with its payload cut),
whole with ``--with-barcodes`` and cut to their payload windows without.
A subprocess with ``h5py`` blocked runs ``decode-posts`` on them too.
``simulate-signal`` trains a basecaller, which the JAX command does for
minutes on the CPU: the port's runs at a tiny size, and its JSON keys are
held to the JAX command's.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from nanopore_dna_storage_tpu import cli as jax_cli
from nanopore_dna_storage_tpu_torch import cli as port_cli
from nanopore_dna_storage_tpu_torch.io.post import write_post
from nanopore_dna_storage_tpu_torch.pipeline import real_data as port_real
from test_torch_lists_cli import _printed
from test_torch_pipeline import ROOT, _env
from test_torch_real_data import LIST_SIZE, MAX_DEV, PORT_EXP, make_reads

torch.set_num_threads(1)

EXP_ARGS = ["--bytes-per-oligo", "4", "--rs-redundancy", "0.5", "--mem", "6",
            "--rate", "1"]


@pytest.fixture(scope="module")
def post_dirs(tmp_path_factory):
    """Two directories of the same reads: whole reads with their basecalls
    and block indices, and the payload windows of the reads whose barcodes
    are found, cut as ``locate_payload`` says."""
    ids, posts, calls, trans, _ = make_reads(("fwd", "rc", "cut", "short"))
    root = tmp_path_factory.mktemp("posts")
    whole, windows = root / "whole", root / "windows"
    whole.mkdir()
    windows.mkdir()
    for rid, post, call, tr in zip(ids, posts, calls, trans):
        write_post(str(whole / f"{rid}.post"), post)
        (whole / f"{rid}.fastq").write_text(
            f"@{rid}\n{call}\n+\n{'5' * len(call)}\n")
        np.savetxt(whole / f"{rid}.trans", tr, fmt="%d")
        _, s, e, _ = port_real.locate_payload(call, tr, PORT_EXP)
        if s >= 0 and e - s + 1 >= 60:  # the trellis's nstate_pos + 1
            write_post(str(windows / f"{rid}.post"), post[s:e + 1])
    return whole, windows


def _dir(path) -> dict:
    return {p.name: p.read_bytes() for p in path.iterdir()}


@pytest.mark.parametrize("exp_args", [EXP_ARGS, ["--experiment", "7"]])
def test_encode_matches_jax(tmp_path, capsys, exp_args):
    data = tmp_path / "data.bin"
    data.write_bytes(bytes(np.random.default_rng(4).integers(
        0, 256, 61, dtype=np.uint8)))
    out = {}
    for name, main in (("port", port_cli.main), ("jax", jax_cli.main)):
        d = tmp_path / name
        d.mkdir()
        rec = _printed(main, ["encode", *exp_args, "-i", str(data), "-o",
                              str(d / "oligos.txt"), "--fasta",
                              str(d / "oligos.fasta")], capsys)
        out[name] = (rec, _dir(d))
    assert out["port"] == out["jax"]
    assert out["port"][0]["num_oligos_data"] > 0


def test_simulate_matches_jax(capsys):
    argv = ["simulate", "--mem", "6", "--rate", "1", "--msg-len", "40",
            "--list-size", "2", "--num-trials", "3", "--batch", "3",
            "--max-deviation", "8", "--sub", "0.01", "--del-p", "0.01",
            "--seed", "2"]
    got = _printed(port_cli.main, argv + ["--device", "cpu"], capsys)
    want = _printed(jax_cli.main, argv, capsys)
    assert got == want
    assert got["num_trials"] == 3 and got["list_correct"] > 0


def test_simulate_signal_prints_jax_keys(capsys, monkeypatch):
    """``simulate-signal --device cpu`` at a tiny size trains a basecaller
    and decodes its reads; its JSON line has the JAX command's keys (read
    from the JAX command run on stubbed stats: its own run trains and
    decodes for minutes on the CPU) and counts every read."""
    from nanopore_dna_storage_tpu.pipeline import simulate as jax_sim

    argv = ["simulate-signal", *EXP_ARGS, "--data-size", "8",
            "--num-reads", "2", "--list-size", "2", "--max-deviation", "8",
            "--train-steps", "2", "--seed", "1"]
    got = _printed(port_cli.main, argv + ["--device", "cpu"], capsys)
    seen = {}

    def stub(enc, exp, **kw):
        seen.update(kw)
        return jax_sim.SimStats(num_reads=kw["num_reads"]), None

    monkeypatch.setattr(jax_sim, "simulate_and_decode_signal", stub)
    want = _printed(jax_cli.main, argv, capsys)
    assert list(got) == list(want)
    assert got["num_reads"] == 2 and seen["train_steps"] == 2
    assert 0 <= got["list_correct"] <= got["crc_pass"] <= 2


@pytest.mark.parametrize("barcodes", [True, False])
def test_decode_posts_matches_jax(post_dirs, tmp_path, capsys, barcodes):
    whole, windows = post_dirs
    src = whole if barcodes else windows
    argv = ["decode-posts", *EXP_ARGS, "--post-dir", str(src),
            "--list-size", str(LIST_SIZE), "--max-deviation", str(MAX_DEV)]
    argv += ["--with-barcodes"] if barcodes else []
    got = _printed(port_cli.main, argv + [
        "--outdir", str(tmp_path / "port"), "--device", "cpu",
        "--batch", "1"], capsys)
    want = _printed(jax_cli.main, argv + ["--outdir", str(tmp_path / "jax")],
                    capsys)
    assert got == want
    assert _dir(tmp_path / "port") == _dir(tmp_path / "jax")
    n = len(list(src.glob("*.post")))
    assert got["reads"] == n and 0 < got["decoded"] <= n
    if not barcodes:
        assert got["decoded"] == n


@pytest.mark.parametrize("command", ["simulate", "decode-posts",
                                     "simulate-signal"])
def test_decoding_commands_default_to_the_card(post_dirs, tmp_path,
                                               command):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py runs the CLI")
    argv = {"simulate": ["simulate", "--mem", "6", "--rate", "1",
                         "--msg-len", "40", "--num-trials", "2"],
            "simulate-signal": ["simulate-signal", *EXP_ARGS,
                                "--train-steps", "1"],
            "decode-posts": ["decode-posts", *EXP_ARGS, "--post-dir",
                             str(post_dirs[1]), "--outdir",
                             str(tmp_path)]}[command]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_cli.main(argv)


_NO_H5PY = """
import sys
import torch
torch.set_num_threads(1)  # as in this process: the suite runs in parallel
sys.modules["h5py"] = None  # import h5py now raises ImportError
from nanopore_dna_storage_tpu_torch.pipeline import real_data
from nanopore_dna_storage_tpu_torch.io import fast5
from nanopore_dna_storage_tpu_torch import cli
try:
    fast5.read_fast5_raw("missing.fast5")
except ImportError:
    pass
else:
    raise SystemExit("read_fast5_raw ran without h5py")
rec, steps = cli.main(sys.argv[1:])
assert steps > 0
"""


def test_decode_posts_runs_without_h5py(post_dirs, tmp_path):
    argv = ["decode-posts", *EXP_ARGS, "--post-dir", str(post_dirs[0]),
            "--outdir", str(tmp_path / "out"), "--list-size",
            str(LIST_SIZE), "--max-deviation", str(MAX_DEV),
            "--with-barcodes", "--device", "cpu", "--batch", "8"]
    res = subprocess.run([sys.executable, "-c", _NO_H5PY, *argv], cwd=ROOT,
                         env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    rec = json.loads(res.stdout.strip().splitlines()[-1])
    assert rec["reads"] == len(list(post_dirs[0].glob("*.post")))
    assert (tmp_path / "out" / "info.txt").exists()
    assert os.path.getsize(tmp_path / "out" / "info.txt") > 0
