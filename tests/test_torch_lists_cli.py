"""The port's list files (``io/lists.py``) and its list-reading CLI commands
(``error-rate``, ``rs-recover``, ``read-cost``) against the JAX package's.

The list files are the decode job's output and the reference's
generate_decoded_lists.py format: one ``list_<i>`` per read, one message
bit string a line. One package writes, the other reads; each CLI command
runs in both packages on the same directory and must print the same JSON.
The lists here are built from framed messages without a decode: true
messages, copies with flipped bits, and wrong payloads framed under a true
index (which pass the CRC), so every counter of the commands moves.
"""
import json

import numpy as np
import pytest

from nanopore_dna_storage_tpu import cli as jax_cli
from nanopore_dna_storage_tpu.io import lists as jax_lists
from nanopore_dna_storage_tpu_torch import cli as port_cli
from nanopore_dna_storage_tpu_torch.config import ExperimentConfig
from nanopore_dna_storage_tpu_torch.coding.framing import frame_oligos
from nanopore_dna_storage_tpu_torch.io import lists as port_lists
from nanopore_dna_storage_tpu_torch.pipeline import encode_bytes

EXP = ExperimentConfig(bytes_per_oligo=2, rs_redundancy=0.5, conv_mem=6,
                       conv_rate=1)
EXP_ARGS = ["--bytes-per-oligo", "2", "--rs-redundancy", "0.5", "--mem", "6",
            "--rate", "1"]
DATA = bytes(range(7, 23))  # 16 bytes: 8 data oligos, 4 RS oligos
PACKAGES = {"jax": jax_lists, "port": port_lists}


def _bits(m) -> str:
    return "".join(map(str, m))


@pytest.fixture(scope="module")
def listdir(tmp_path_factory):
    """40 reads' lists of ``DATA``'s oligos, the oligos' true messages and
    the file itself."""
    enc = encode_bytes(DATA, EXP)
    truth = frame_oligos(enc.payloads, EXP.framing)
    total = len(truth)
    rng = np.random.default_rng(3)
    root = tmp_path_factory.mktemp("lists")
    lists_dir = root / "lists"
    lists_dir.mkdir()
    for i in range(40):
        oid = int(rng.integers(total))
        kind = i % 5
        flipped = truth[oid] ^ (rng.random(truth.shape[1]) < 0.05)
        wrong = frame_oligos(rng.integers(0, 256, (total, 2), np.uint8),
                             EXP.framing)[oid]
        entries = {0: [truth[oid], flipped], 1: [flipped, truth[oid]],
                   2: [flipped, flipped ^ 1], 3: [wrong, truth[oid]],
                   4: [truth[oid]]}[kind]
        port_lists.write_list_file(str(lists_dir), i,
                                   [_bits(m) for m in entries])
    (lists_dir / "info.txt").write_text("")
    oligos = root / "oligos.txt"
    oligos.write_text("".join(_bits(m) + "\n" for m in truth))
    infile = root / "data.bin"
    infile.write_bytes(DATA)
    return lists_dir, oligos, infile


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_list_files_cross_read(tmp_path, writer):
    reader = PACKAGES["port" if writer == "jax" else "jax"]
    w = PACKAGES[writer]
    rng = np.random.default_rng(0)
    msgs = {i: [_bits(rng.integers(0, 2, 36)) for _ in range(i % 4)]
            for i in (0, 3, 7, 12)}
    for i, lst in msgs.items():
        w.write_list_file(str(tmp_path), i, lst)
    (tmp_path / "list_notanindex").write_text("")
    w.write_info(str(tmp_path), ["r0 ok", "r3 fail"])
    assert reader.decoded_indices(str(tmp_path)) == sorted(msgs)
    for i, lst in msgs.items():
        assert reader.read_list_file(str(tmp_path), i) == lst
        assert reader.read_list_file(str(tmp_path), i, 2) == lst[:2]
    assert (tmp_path / "info.txt").read_text() == "r0 ok\nr3 fail\n"


def test_merge_shards_matches_jax(tmp_path):
    shards = []
    for s, ids in enumerate(([0, 2, 5], [1, 4], [])):
        d = tmp_path / f"shard{s}"
        d.mkdir()
        for i in ids:
            jax_lists.write_list_file(str(d), i, [f"{s}{i}", "01"])
        if ids:
            jax_lists.write_info(str(d), [f"s{s} line{j}"
                                          for j in range(max(ids) - 1)])
        shards.append(str(d))
    outs = {}
    for name, mod in PACKAGES.items():
        out = tmp_path / f"merged_{name}"
        n = mod.merge_shards(shards, str(out))
        assert n == 5
        outs[name] = {p.name: p.read_text() for p in out.iterdir()}
    assert outs["port"] == outs["jax"]
    assert len(outs["port"]) == 6  # five lists and info.txt


def test_shard_manifest_matches_jax(tmp_path):
    paths = {name: tmp_path / f"{name}.jsonl" for name in PACKAGES}
    for name, mod in PACKAGES.items():
        m = mod.ShardManifest(str(paths[name]))
        assert m.done_ids() == set()
        m.record("read_a", status="ok", rc=False)
        m.record("read_b")
        with open(paths[name], "a") as f:
            f.write("not json\n" + json.dumps({"other": 1}) + "\n")
        m.record("read_c", shard=3)
    assert paths["port"].read_text() == paths["jax"].read_text()
    for name, mod in PACKAGES.items():
        for path in paths.values():
            assert mod.ShardManifest(str(path)).done_ids() == {
                "read_a", "read_b", "read_c"}


def test_error_rate_counts_an_empty_list_as_an_erasure(listdir, tmp_path,
                                                     capsys):
    """The decode job writes an empty list for a read with no valid path;
    the JAX CLI's check raises on one, the port counts an erasure."""
    lists_dir, oligos, _ = listdir
    for i in range(5):
        (tmp_path / f"list_{i}").write_text((lists_dir / f"list_{i}")
                                            .read_text())
    port_lists.write_list_file(str(tmp_path), 5, [])
    argv = ["error-rate", *EXP_ARGS, "--lists-dir", str(tmp_path),
            "--oligos", str(oligos)]
    with pytest.raises(IndexError):
        jax_cli.main(argv)
    got = _printed(port_cli.main, argv, capsys)
    port_lists.write_list_file(str(tmp_path), 5, ["0" * 36])
    want = _printed(jax_cli.main, argv, capsys)
    assert got == want and got["num_reads"] == 6
    assert got["num_erasure_CRC"] >= 1


def _printed(main, argv, capsys) -> dict:
    capsys.readouterr()
    main(argv)
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1, out
    return json.loads(out[0])


@pytest.mark.parametrize("list_size", [1, 8])
@pytest.mark.parametrize("command", ["error-rate", "rs-recover",
                                     "read-cost"])
def test_list_commands_print_the_jax_json(listdir, capsys, command,
                                          list_size):
    lists_dir, oligos, infile = listdir
    argv = [command, *EXP_ARGS, "--lists-dir", str(lists_dir),
            "--list-size", str(list_size)]
    if command == "error-rate":
        argv += ["--oligos", str(oligos)]
    elif command == "rs-recover":
        argv += ["--data-size", str(len(DATA)), "--infile", str(infile),
                 "--num-reads", "30", "--num-trials", "4", "--seed", "5"]
    else:
        argv += ["--data-size", str(len(DATA)), "--infile", str(infile),
                 "--step", "4", "--num-trials", "3", "--oligo-len", "84"]
    got = _printed(port_cli.main, argv, capsys)
    want = _printed(jax_cli.main, argv, capsys)
    assert got == want
    if list_size == 1:  # the wrong payloads out-vote some true ones
        return
    if command == "error-rate":
        assert got["num_reads"] == 40
        assert min(got["num_correct"], got["num_erasure_CRC"],
                   got["num_error_CRC"]) > 0
    elif command == "rs-recover":
        assert got["successes"] > 0
    else:
        assert got["min_reads"] is not None
