"""The port's N-rank decode job (``parallel/multihost.py`` through
``parallel/launch.py``) on the CPU: 2 and 3 ranks on gloo over a free
localhost port, each a process of its own.

Seven reads of a small file, in both orientations, are written as
``.post`` files; a job over three, five or seven of them leaves uneven
shards and a short last batch on some rank. Every job's list files must equal the
1-rank job's (run in this process, with no process group) and, for the
gated orientation pick, the lists of the JAX package's
``decode_posts_auto_orientation(gated=True)``; the ``info_*`` shards must
name every read once, and every rank must report the same global CRC-pass
count, the sum of their own. Each subprocess has a timeout below the
test's, and the job's collectives one below that.
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from nanopore_dna_storage_tpu.config import ExperimentConfig
from nanopore_dna_storage_tpu.pipeline import decode as jax_decode
from nanopore_dna_storage_tpu_torch import config as port_config
from nanopore_dna_storage_tpu_torch.io.post import pack_posts, write_post
from nanopore_dna_storage_tpu_torch.parallel import launch, multihost
from nanopore_dna_storage_tpu_torch.parallel.mesh import ShardedDecoder
from nanopore_dna_storage_tpu_torch.pipeline import encode_bytes
from nanopore_dna_storage_tpu_torch.pipeline.simulate import simulate_posts
from test_torch_host import twin

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
EXP = ExperimentConfig(bytes_per_oligo=2, rs_redundancy=0.5, conv_mem=6,
                       conv_rate=1)
PORT_EXP = twin(EXP, port_config)
DATA = bytes(range(8))
L, DEV, BATCH = 2, 3, 2
JOB_ARGS = ["--device", "cpu", "--experiment", "-1", "--bytes-per-oligo",
            "2", "--mem", "6", "--rate", "1", "--rs-redundancy", "0.5",
            "--list-size", str(L), "--max-deviation", str(DEV),
            "--local-batch", str(BATCH), "--timeout", "60"]
ORIENTATION = {"gated": "gated", "both": True, "fwd": False}
# seconds the test waits for a launcher or a rank; the job's collectives
# give up after its --timeout, below it
RUN_TIMEOUT = 120


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
    return env


def _bits(m) -> str:
    return "".join(map(str, m))


def launch_job(nproc, post_dir, outdir, orientation="gated"):
    """Run the job over ``nproc`` ranks through the launcher; returns each
    rank's result record, by rank."""
    res = subprocess.run(
        [sys.executable, "-m", "nanopore_dna_storage_tpu_torch.parallel."
         "launch", "--num-processes", str(nproc), *JOB_ARGS,
         "--post-dir", str(post_dir),
         "--outdir", str(outdir), "--orientation", orientation],
        cwd=ROOT, env=_env(), capture_output=True, text=True,
        timeout=RUN_TIMEOUT)
    assert res.returncode == 0, res.stdout + res.stderr
    recs = sorted((json.loads(line) for line in res.stdout.splitlines()
                   if line.startswith('{"rank"')), key=lambda r: r["rank"])
    assert [r["rank"] for r in recs] == list(range(nproc)), res.stdout
    assert all(r["world"] == nproc and r["backend"] == "gloo"
               for r in recs)
    return recs


def read_lists(outdir) -> dict:
    out = {}
    for p in pathlib.Path(outdir).glob("list_*"):
        out[int(p.name.split("_")[1])] = p.read_text().splitlines()
    return out


def read_info(outdir, nproc) -> dict:
    """stem -> "rc=..." over the ranks' info shards; every stem once."""
    lines = [line for pid in range(nproc) for line in pathlib.Path(
        outdir, f"info_{pid}.txt").read_text().splitlines()]
    info = dict(line.split(" ") for line in lines)
    assert len(info) == len(lines)
    return info


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """The .post directories of three, five and seven reads, the JAX
    package's gated lists of the seven, and the 1-rank job of each
    orientation."""
    enc = encode_bytes(DATA, PORT_EXP)
    posts, rcs, _ = simulate_posts(enc.oligos, 7, np.random.default_rng(1),
                                   sub_prob=0.01, del_prob=0.01,
                                   ins_prob=0.0)
    assert rcs.any() and (~rcs).any()
    root = tmp_path_factory.mktemp("job")
    dirs = {}
    for n in (3, 5, 7):
        dirs[n] = root / f"posts{n}"
        dirs[n].mkdir()
        for i in range(n):
            write_post(str(dirs[n] / f"read_{i}.post"), posts[i])
    out, rc_used = jax_decode.PipelineDecoder(
        EXP, L, DEV).decode_posts_auto_orientation(
            posts, 1 << EXP.framing.index_len, gated=True)
    jax_lists = {i: [_bits(m) for m, v in zip(out.msgs[i], out.valid[i])
                     if v] for i in range(7)}
    one = {}
    for orientation, n in (("gated", 7), ("both", 3), ("fwd", 3)):
        d = root / f"one_{orientation}"
        # one batch of every read: a read's lists do not depend on the
        # batch it is decoded in
        res = multihost.run_decode_job(
            str(dirs[n]), str(d), PORT_EXP, L, DEV, 8,
            auto_orientation=ORIENTATION[orientation], device="cpu")
        assert res.reads == n
        one[orientation] = (d, res)
    return dict(posts=posts, dirs=dirs, jax_lists=jax_lists,
                jax_rc=rc_used, jax_crc=(out.index >= 0), one=one)


def test_one_rank_job_matches_jax(job):
    d, res = job["one"]["gated"]
    assert read_lists(d) == job["jax_lists"]
    assert read_info(d, 1) == {f"read_{i}": f"rc={bool(rc)}"
                               for i, rc in enumerate(job["jax_rc"])}
    assert res.crc_pass == res.local_crc_pass == int(job["jax_crc"].sum())
    assert job["jax_rc"].any() and not job["jax_rc"].all()


@pytest.mark.parametrize("nproc, nfiles", [(2, 5), (3, 7)])
def test_gated_job_matches_one_rank_and_jax(job, tmp_path, nproc, nfiles):
    recs = launch_job(nproc, job["dirs"][nfiles], tmp_path)
    lists = read_lists(tmp_path)
    one = read_lists(job["one"]["gated"][0])
    assert sorted(lists) == list(range(nfiles))
    for i in range(nfiles):
        assert lists[i] == one[i] == job["jax_lists"][i], i
    assert read_info(tmp_path, nproc) == {
        f"read_{i}": f"rc={bool(job['jax_rc'][i])}" for i in range(nfiles)}
    assert [r["reads"] for r in recs] == [len(range(p, nfiles, nproc))
                                          for p in range(nproc)]
    crc = int(job["jax_crc"][:nfiles].sum())
    assert {r["crc_pass"] for r in recs} == {crc}
    assert sum(r["local_crc_pass"] for r in recs) == crc
    assert all(r["steps"] > 0 and r["k1_launches"] == 0 for r in recs)


@pytest.mark.parametrize("orientation", ["both", "fwd"])
def test_orientation_job_matches_one_rank(job, tmp_path, orientation):
    nproc = 2
    recs = launch_job(nproc, job["dirs"][3], tmp_path, orientation)
    one_dir, one = job["one"][orientation]
    assert read_lists(tmp_path) == read_lists(one_dir)
    info = read_info(tmp_path, nproc)
    assert info == read_info(one_dir, 1)
    assert ("rc=True" in info.values()) == (orientation == "both")
    assert {r["crc_pass"] for r in recs} == {one.crc_pass}
    assert sum(r["local_crc_pass"] for r in recs) == one.crc_pass


def test_stems_without_number_get_their_own_list(job, tmp_path):
    """The reference names such a list by the rank's local position, so
    rank 0's and rank 1's first reads would both write list_0; the port
    takes the position in the sorted list of every rank's files."""
    post_dir = tmp_path / "posts"
    post_dir.mkdir()
    for i, stem in enumerate(("alpha", "bravo", "charlie")):
        write_post(str(post_dir / f"{stem}.post"), job["posts"][i])
    launch_job(2, post_dir, tmp_path / "out")
    assert read_lists(tmp_path / "out") == {
        i: job["jax_lists"][i] for i in range(3)}
    assert [pathlib.Path(tmp_path, "out", f"info_{p}.txt").read_text()
            .split() for p in (0, 1)] == [
        ["alpha", f"rc={bool(job['jax_rc'][0])}", "charlie",
         f"rc={bool(job['jax_rc'][2])}"],
        ["bravo", f"rc={bool(job['jax_rc'][1])}"]]


def test_a_failing_rank_ends_the_job(job, tmp_path):
    """Rank 1 has no post directory: it raises, rank 0 (with no reads of
    its own) finds its peer gone in the final collective, and both exit
    non-zero well inside the timeout."""
    cmds = launch.rank_commands(
        2, JOB_ARGS + ["--outdir", str(tmp_path / "out")],
        f"127.0.0.1:{launch.free_port()}")
    post_dirs = (tmp_path, tmp_path / "missing")
    procs = [subprocess.Popen(
        cmd + ["--post-dir", str(d)], cwd=ROOT, env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for cmd, d in zip(cmds, post_dirs)]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=RUN_TIMEOUT)
        outs.append(out)
    assert all(p.returncode != 0 for p in procs), outs
    assert "no directory" in outs[1]


_SHARDED = """
import sys
import numpy as np
import torch
import torch.distributed as dist
sys.path.insert(0, {root!r})
from nanopore_dna_storage_tpu_torch.config import ExperimentConfig
from nanopore_dna_storage_tpu_torch.parallel.mesh import ShardedDecoder
torch.set_num_threads(1)
rank, world = int(sys.argv[1]), int(sys.argv[2])
dist.init_process_group("gloo", init_method=sys.argv[3], rank=rank,
                        world_size=world)
data = np.load(sys.argv[4])
exp = ExperimentConfig(bytes_per_oligo=2, rs_redundancy=0.5, conv_mem=6,
                       conv_rate=1)
dec = ShardedDecoder(exp, {L}, rc=False, max_deviation={DEV}, device="cpu")
res = dec.decode(data["batch"], data["nblks"], int(data["num_oligos"]))
np.savez(sys.argv[5], msgs=res.msgs, scores=res.scores, ok=res.ok,
         index=res.index, crc=res.crc_pass_total)
dist.destroy_process_group()
"""


def test_sharded_decoder_over_ranks(job, tmp_path):
    """ShardedDecoder.decode over 2 gloo ranks on a batch of 3 (padded to
    4 by the last read): every rank returns the world-1 result."""
    posts = job["posts"][:3]
    batch, nblks = pack_posts(posts)
    num_oligos = 12
    np.savez(tmp_path / "in.npz", batch=batch, nblks=nblks,
             num_oligos=num_oligos)
    want = ShardedDecoder(PORT_EXP, L, rc=False, max_deviation=DEV,
                          device="cpu").decode(batch, nblks, num_oligos)
    script = _SHARDED.format(root=str(ROOT), L=L, DEV=DEV)
    init = f"tcp://127.0.0.1:{launch.free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, str(r), "2", init,
         str(tmp_path / "in.npz"), str(tmp_path / f"out{r}.npz")],
        cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    for p in procs:
        out, _ = p.communicate(timeout=RUN_TIMEOUT)
        assert p.returncode == 0, out
    for r in range(2):
        got = np.load(tmp_path / f"out{r}.npz")
        for a in ("msgs", "scores", "ok", "index"):
            assert np.array_equal(got[a], getattr(want, a)), (r, a)
        assert int(got["crc"]) == want.crc_pass_total
    assert 0 < want.crc_pass_total < 3


def test_launcher_prints_the_per_host_commands(capsys):
    assert launch.main(["--num-processes", "3", "--coordinator",
                        "host0:1234", "--print-only", "--post-dir", "P",
                        "--outdir", "O"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 3
    for pid, line in enumerate(lines):
        assert line.split()[1:] == [
            "-m", launch.MODULE, "--coordinator", "host0:1234",
            "--num-processes", "3", "--process-id", str(pid),
            "--post-dir", "P", "--outdir", "O"]


def test_job_without_card_fails(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py runs the job")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        multihost.main(["--post-dir", str(tmp_path), "--outdir",
                        str(tmp_path)])
