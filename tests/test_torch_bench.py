"""The port's decode benchmark (``nanopore_dna_storage_tpu_torch/bench.py``)
on the CPU: its configs and posts against the root ``bench.py``, its smoke
run's lists against the JAX package's XLA decoder, its JSON line, its
gates and its refusals.

The smoke run decodes one read of 369 blocks through the plain ACS step
three times over (the warm-up, the timed loop, gate (b)); the JAX
package's XLA decoder takes about a minute a read there, so one module
fixture runs both, the JAX read in a thread of its own.
"""
import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import pathlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from nanopore_dna_storage_tpu.config import ConvCodeConfig as JaxCodeConfig
from nanopore_dna_storage_tpu.config import DecodeConfig as JaxDecodeConfig
from nanopore_dna_storage_tpu.io.post import pack_posts as jax_pack_posts
from nanopore_dna_storage_tpu.ops.lva import LVADecoder as JaxLVADecoder
from nanopore_dna_storage_tpu_torch import bench
from nanopore_dna_storage_tpu_torch.config import ConvCodeConfig, DecodeConfig
from nanopore_dna_storage_tpu_torch.io.post import pack_posts
from nanopore_dna_storage_tpu_torch.ops import lva_acs
from nanopore_dna_storage_tpu_torch.ops.lva import LVADecoder

ROOT = pathlib.Path(__file__).resolve().parents[1]
# the root bench.py's configs (bench.py:264-306): mem, rate, msg_len, list
# size, max deviation, metric
ROOT_CONFIGS = {
    "smoke": (6, 1, 100, 4, 16, "reads_per_s_m6_r1_l4_smoke"),
    "m11": (11, 5, 180, 8, 20, "reads_per_s_m11_r5l6_l8"),
    "m14": (14, 5, 181, 4, 20, "reads_per_s_m14_r5l6_l4"),
    "m14best": (14, 1, 100, 4, 20, "reads_per_s_m14_r1l2_l4"),
    "m8": (8, 1, 100, 64, 20, "reads_per_s_m8_r1l2_l64"),
}
# the goldens each config's gate (a) decodes
GOLDENS = {
    "smoke": ["m6_r1_rc0_l1", "m6_r1_rc0_l4", "m6_r1_rc1_l4", "m6_r3_rc0_l4",
              "m6_r5_rc0_l8", "m6_r5_rc1_l8", "m6_r2_rc0_l2", "m6_r4_rc0_l2",
              "m6_r7_rc1_l2", "m6_r1_rc0_l34"],
    "m11": ["m11_r5_rc0_l8", "m11_r5_rc1_l8"],
    "m14": ["m14_r5_rc0_l4_prod", "m14_r5_rc1_l4_prod"],
    "m14best": ["m14_r1_rc0_l2"],
    "m8": ["m8_r1_rc0_l64"],
}
JAX_KEYS = {"metric", "value", "unit", "vs_baseline", "backend", "batch",
            "s_per_read", "cpp_s_per_read", "lists_match"}
# the smoke run's gate (a) on the CPU: one of the m=6 goldens (all of them
# take ~50 s there; tests/test_torch_lva_golden.py holds every one)
CPU_GOLDENS = ("decode/m6_r1_rc0_l1",)
# one read in a batch of one: the defaults off the card
SMOKE_ARGV = ["--smoke", "--device", "cpu", "--verify"]
# gate (b)'s own tests: three short m=6 reads of different lengths
GATE_CODE = ConvCodeConfig(mem=6, rate=1, msg_len=20)


def _root_bench(monkeypatch, tmp_path):
    """The root bench.py, loaded by path; its compile-cache default is set
    first, so that its ``os.environ.setdefault`` changes nothing."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    spec = importlib.util.spec_from_file_location("root_bench",
                                                  ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", sorted(ROOT_CONFIGS))
def test_configs_and_posts_match_the_root_bench(name, monkeypatch, tmp_path):
    conf = bench.CONFIGS[name]
    assert (conf.mem, conf.rate, conf.msg_len, conf.list_size,
            conf.max_deviation, conf.metric) == ROOT_CONFIGS[name]
    root = _root_bench(monkeypatch, tmp_path)
    mem, rate, msg_len = ROOT_CONFIGS[name][:3]
    want, want_msgs = root.gen_posts(
        JaxCodeConfig(mem=mem, rate=rate, msg_len=msg_len), 3, 42)
    got, got_msgs = bench.gen_posts(conf.code(), 3, bench.SEED)
    assert got_msgs.tobytes() == want_msgs.tobytes()
    assert [p.dtype for p in got] == [p.dtype for p in want]
    assert [p.tobytes() for p in got] == [p.tobytes() for p in want]
    for a, b in zip(pack_posts(got), jax_pack_posts(want)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("name", sorted(GOLDENS))
def test_each_config_gates_on_its_goldens(name):
    cases = list(bench.golden_cases(bench.CONFIGS[name]))
    assert [c["name"] for _, c in cases] == GOLDENS[name]
    conf = bench.CONFIGS[name]
    for root, case in cases:
        assert case["mem"] == conf.mem
        assert (root / f"{case['name']}.post").exists()


@pytest.mark.parametrize("name", ["m11", "m14", "m8"])
def test_sharded_metric_and_defaults(name):
    args = bench.parse_args(["--config", name, "--sharded"])
    assert args.metric == ROOT_CONFIGS[name][5] + "_sharded"
    assert args.verify and args.device == "cuda"
    assert bench.experiment(bench.CONFIGS[name].experiment).msg_len() == \
        bench.CONFIGS[name].msg_len
    assert not bench.parse_args(["--smoke"]).verify


@pytest.mark.parametrize("argv", [["--smoke", "--sharded"],
                                  ["--config", "m14best", "--sharded"]])
def test_sharded_refuses_smoke_and_m14best(argv):
    with pytest.raises(SystemExit) as e:
        bench.main([*argv, "--device", "cpu"])
    assert e.value.code == 2


@pytest.fixture(scope="module")
def smoke_run():
    """``main(SMOKE_ARGV)`` with gate (a) on ``CPU_GOLDENS``: its exit code,
    its standard output, what ``run`` returned, the baseline cache before
    it; beside it the JAX package's XLA decode of the same read."""
    conf = bench.CONFIGS["smoke"]
    posts, _ = bench.gen_posts(conf.code(), 1, bench.SEED)
    packed, nblks = jax_pack_posts(posts)
    jax_dec = JaxLVADecoder(JaxDecodeConfig(
        code=JaxCodeConfig(mem=conf.mem, rate=conf.rate,
                           msg_len=conf.msg_len),
        list_size=conf.list_size, max_deviation=conf.max_deviation,
        backend="xla"))
    cache = bench.BASELINE_CACHE.read_bytes()
    runs, buf = [], io.StringIO()
    threads = torch.get_num_threads()
    with pytest.MonkeyPatch.context() as mp, ThreadPoolExecutor(1) as ex:
        jax_run = ex.submit(jax_dec.decode, packed, nblks)
        mp.setitem(bench.CONFIGS, "smoke",
                   dataclasses.replace(conf, goldens=CPU_GOLDENS))
        run = bench.run
        mp.setattr(bench, "run", lambda args: runs.append(run(args))
                   or runs[-1])
        torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
        try:
            with contextlib.redirect_stdout(buf):
                rc = bench.main(SMOKE_ARGV)
        finally:
            torch.set_num_threads(threads)
        jax = jax_run.result()
    return {"rc": rc, "stdout": buf.getvalue(), "line": runs[0][0],
            "timed": runs[0][1], "jax": jax, "nblks": nblks,
            "cache": cache}


def test_smoke_lists_equal_the_jax_package(smoke_run):
    msgs, scores, valid = smoke_run["timed"]
    mj, sj, vj = smoke_run["jax"]
    assert msgs.shape[0] == 1
    assert np.array_equal(valid, vj)
    assert np.array_equal(scores, sj)
    assert np.array_equal(msgs, mj)
    assert valid.any()


def test_smoke_prints_one_line_with_the_jax_keys(smoke_run):
    assert smoke_run["rc"] == 0
    lines = smoke_run["stdout"].splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line == smoke_run["line"]
    assert JAX_KEYS | {"device", "power_limit_w"} <= set(line)
    assert line["metric"] == "reads_per_s_m6_r1_l4_smoke"
    assert line["unit"] == "reads/s" and line["value"] > 0
    assert line["s_per_read"] == 1.0 / line["value"]
    assert (line["backend"], line["device"], line["power_limit_w"]) == \
        ("cpu", "cpu", None)
    assert line["batch"] == 1 and line["reads"] == 1
    assert line["lists_match"] is True
    T = int(smoke_run["nblks"].max())
    # the warm-up and the timed loop, one batch each; no kernel on the CPU
    assert (line["block_steps"], line["k1_launches"]) == (2 * T, 0)
    gate = line["gate"]
    assert (gate["goldens"], gate["goldens_equal"]) == (1, 1)
    every = -(-T // bench.GATE_BLOCKS)
    reads = dict(gate["bench_reads"])
    # m=6's intermediates are small: the plain step takes ~100 reads at once
    assert reads.pop("plain_chunk") >= 64
    assert reads == {
        "reads": 1, "batch": 1, "blocks": T, "every": every,
        "checked": len(range(0, T, every)), "mixed_block": None,
        "blocks_differ": 0, "blocks_unsorted": 0, "first_bad_block": None,
        "lists_equal": True, "ok": True}


def test_vs_baseline_reads_the_cache_and_leaves_it(smoke_run):
    cpp = json.loads(smoke_run["cache"])["reads_per_s_m6_r1_l4_smoke_cpp"]
    line = smoke_run["line"]
    assert line["vs_baseline"] == line["value"] / cpp
    assert line["cpp_s_per_read"] == 1.0 / cpp
    assert bench.BASELINE_CACHE.read_bytes() == smoke_run["cache"]


def _golden_copy(tmp_path, name: str, tamper: bool) -> pathlib.Path:
    """A golden set under ``tmp_path`` holding case ``name`` of
    ``tests/golden/decode`` alone, its first list's first bit flipped under
    ``tamper``."""
    src, dst = ROOT / "tests" / "golden" / "decode", tmp_path / "decode"
    dst.mkdir(parents=True)
    case = next(c for c in json.loads((src / "manifest.json").read_text())
                if c["name"] == name)
    (dst / "manifest.json").write_text(json.dumps([case]))
    (dst / f"{name}.post").write_bytes((src / f"{name}.post").read_bytes())
    text = (src / f"{name}.lists").read_text()
    if tamper:
        text = ("1" if text[0] == "0" else "0") + text[1:]
    (dst / f"{name}.lists").write_text(text)
    return tmp_path


def test_a_tampered_golden_fails_the_gate(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(bench, "GOLDEN",
                        _golden_copy(tmp_path, "m6_r1_rc0_l1", tamper=True))
    rc = bench.main(["--smoke", "--device", "cpu", "--reads", "1",
                     "--batch", "1", "--verify"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc != 0
    assert line["value"] is None and line["vs_baseline"] is None
    assert line["lists_match"] is False
    assert line["gate"] == {"goldens": 1, "goldens_equal": 0,
                            "bench_reads": None}
    # a decoder that fails its goldens is not timed
    assert "block_steps" not in line


def test_gate_b_names_the_first_block_that_differs(monkeypatch):
    """Gate (b) against a step that moves one score at block 5: the block
    is named, and the gate fails though every list may still agree."""
    root = ROOT / "tests" / "golden" / "decode"
    case = next(c for c in json.loads((root / "manifest.json").read_text())
                if c["name"] == "m6_r1_rc0_l1")
    post = np.fromfile(root / "m6_r1_rc0_l1.post",
                       dtype="<f4").reshape(1, -1, 5, 8)
    dec = LVADecoder(DecodeConfig(
        code=ConvCodeConfig(mem=6, rate=1, msg_len=case["msg_len"]),
        list_size=1, max_deviation=case["max_deviation"]), device="cpu")
    nblks = np.array([post.shape[1]])
    timed = dec.decode(post, nblks)
    good = bench.bench_reads_gate(dec, post, nblks, 1, 1, timed, every=1)
    assert good["ok"] and good["blocks"] == good["checked"] == post.shape[1]

    kernel, calls = lva_acs.acs_block, []

    def faulty(tabs, prev, stale, *args):
        out = kernel(tabs, prev, stale, *args)
        if len(calls) == 5:
            sc = stale[0]
            sc[torch.isfinite(sc)] += 1.0
        calls.append(1)
        return out

    monkeypatch.setattr(lva_acs, "acs_block", faulty)
    bad = bench.bench_reads_gate(dec, post, nblks, 1, 1, timed, every=1)
    assert not bad["ok"]
    assert bad["first_bad_block"] == 5 and bad["blocks_differ"] >= 1


@pytest.fixture(scope="module")
def gate_batch():
    """Three short reads of ``GATE_CODE`` (97, 80 and 93 blocks), a decoder
    at L=2, and its decode of the first two in a batch of three padded
    with read 0, as the timed loop runs two reads at ``--batch 3``."""
    posts, _ = bench.gen_posts(GATE_CODE, 3, 7)
    packed, nblks = pack_posts(posts)
    dec = LVADecoder(DecodeConfig(code=GATE_CODE, list_size=2,
                                  max_deviation=8), device="cpu")
    idx = bench.first_batch(2, 3)
    timed = dec.decode(packed[idx], nblks[idx])
    return dec, packed, nblks, timed


def _fault_in_slot(monkeypatch, block: int, slot: int) -> None:
    """Make the default step move the finite scores of batch slot ``slot``
    after block step ``block`` (the step runs once a block in gate (b))."""
    kernel, calls = lva_acs.acs_block, []

    def faulty(tabs, prev, stale, *args):
        out = kernel(tabs, prev, stale, *args)
        if len(calls) == block:
            sc = stale[0][slot]
            sc[torch.isfinite(sc)] += 1.0
        calls.append(1)
        return out

    monkeypatch.setattr(lva_acs, "acs_block", faulty)


def test_gate_b_decodes_the_timed_loops_first_batch(gate_batch,
                                                    monkeypatch):
    """Gate (b) decodes the timed loop's whole first batch, padding
    included, and checks every k-th block of it: a fault in the second
    read's slot at a checked block is named."""
    dec, packed, nblks, timed = gate_batch
    assert bench.first_batch(2, 3) == [0, 1, 0]
    assert bench.first_batch(5, 3) == [0, 1, 2]
    good = bench.bench_reads_gate(dec, packed, nblks, 2, 3, timed)
    every = -(-97 // bench.GATE_BLOCKS)
    assert good.pop("plain_chunk") >= 3
    assert good == {
        "reads": 2, "batch": 3, "blocks": 97, "every": every,
        "checked": len(range(0, 97, every)), "mixed_block": 80,
        "blocks_differ": 0, "blocks_unsorted": 0, "first_bad_block": None,
        "lists_equal": True, "ok": True}
    _fault_in_slot(monkeypatch, 2 * every, slot=1)
    bad = bench.bench_reads_gate(dec, packed, nblks, 2, 3, timed)
    assert not bad["ok"] and bad["blocks_differ"] >= 1
    assert bad["first_bad_block"] == 2 * every


def test_gate_b_checks_the_first_mixed_block(gate_batch, monkeypatch):
    """Off the stride, gate (b) still checks the first block that mixes
    active and inactive reads (where the second read has ended)."""
    dec, packed, nblks, timed = gate_batch
    good = bench.bench_reads_gate(dec, packed, nblks, 2, 3, timed,
                                  every=1000)
    assert good["ok"] and (good["checked"], good["mixed_block"]) == (2, 80)
    _fault_in_slot(monkeypatch, 80, slot=2)
    bad = bench.bench_reads_gate(dec, packed, nblks, 2, 3, timed,
                                 every=1000)
    assert not bad["ok"] and bad["blocks_differ"] == 1
    assert bad["first_bad_block"] == 80


def test_out_of_memory_prints_a_null_line_and_no_retry(monkeypatch, capsys):
    batches = []

    def oom(dec, packed, nblks, n_reads, b, dev):
        batches.append(b)
        raise torch.cuda.OutOfMemoryError("out of memory at this batch")

    monkeypatch.setattr(bench, "run_with_batch", oom)
    rc = bench.main(["--smoke", "--device", "cpu", "--reads", "4",
                     "--batch", "4"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc != 0 and batches == [4]
    assert line["value"] is None and line["batch"] == 4


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py runs the bench "
                    "on it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main(["--smoke"])


def test_profile_on_the_cpu_raises():
    with pytest.raises(RuntimeError, match="--profile"):
        bench.main(["--smoke", "--device", "cpu", "--profile"])


def test_bench_record_runs_in_turns_and_sums_up(tmp_path, monkeypatch,
                                                capsys):
    """``bench_record`` runs the command lines A B, then B A, appends one
    entry a run, and sums up each command line's reads/s."""
    from nanopore_dna_storage_tpu_torch import bench_record

    order = []
    values = iter([10.0, 20.0, 22.0, 14.0, 12.0, 18.0] + [1.0] * 10)

    def fake(args, timeout):
        order.append(args)
        return {"cmd": args, "rc": 0, "wall_s": 1.0, "gpu": "card, 700 W",
                "line": {"value": next(values), "batch": 1,
                         "lists_match": True, "peak_gib": 1.5}}

    monkeypatch.setattr(bench_record, "run_once", fake)
    out, record = tmp_path / "runs.jsonl", tmp_path / "record.json"
    rc = bench_record.main(["--out", str(out), "--record", str(record),
                            "--turns", "3", "--", "A", "B"])
    assert rc == 0 and order == ["A", "B", "B", "A", "A", "B"]
    assert [json.loads(x)["cmd"] for x in out.read_text().splitlines()] == \
        order
    summary = json.loads(capsys.readouterr().out.splitlines()[-1])["summary"]
    assert summary["A"]["values"] == [10.0, 14.0, 12.0]
    assert (summary["A"]["median"], summary["A"]["min"],
            summary["A"]["max"]) == (12.0, 10.0, 14.0)
    assert summary["B"]["median"] == 20.0 and summary["B"]["runs"] == 3
    assert len(json.loads(record.read_text())["entries"]) == 6
    assert bench_record.main(["--out", str(out), "--preset", "record"]) == 0
    assert order[6:] == list(bench_record.RECORD_RUNS)


def test_gate_b_runs_the_plain_step_a_read_at_a_time(gate_batch,
                                                     monkeypatch):
    """Where the plain step's intermediates would not fit beside the
    decode, gate (b) runs it on fewer reads at once: a read at a time here,
    the same verdicts, a fault in the third slot still named."""
    dec, packed, nblks, timed = gate_batch
    monkeypatch.setattr(bench, "GATE_PLAIN_BYTES", 1)
    good = bench.bench_reads_gate(dec, packed, nblks, 2, 3, timed)
    assert good["ok"] and good["plain_chunk"] == 1
    _fault_in_slot(monkeypatch, 0, slot=2)
    bad = bench.bench_reads_gate(dec, packed, nblks, 2, 3, timed)
    assert not bad["ok"] and bad["first_bad_block"] == 0
