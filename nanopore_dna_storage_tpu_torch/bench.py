"""Decode benchmark: reads/s list-Viterbi-decoded on one CUDA device against
the single-core reference C++.

    python -m nanopore_dna_storage_tpu_torch.bench [--smoke | --config
        m11|m14|m14best|m8] [--batch B] [--reads N] [--sharded] [--profile]
        [--verify | --no-verify] [--device cuda|cpu]

Counterpart of the repository's root ``bench.py``, the JAX package's decode
benchmark, with its configs, metric names and JSON keys (``CONFIGS``). The
headline config is ``m11``: m=11, r=5/6, msg_len 180, L=8, max deviation 20,
the production decode of experiment 7. The reads are synthetic posts from
seed 42 (``gen_posts``, byte-identical to the root script's). One warm-up
decode of the first batch builds and loads the kernel; then every read is
decoded ``--batch`` at a time, the last batch padded with read 0 and only
its real reads counted, and the clock stops after ``torch.cuda.synchronize``.

``--verify`` (on for every config but ``--smoke``) gates the result, and
``lists_match`` is true only when both parts hold: (a) before the timing,
the config's golden vectors (``tests/golden``) decoded on the same device
in this process equal the reference binary's lists (a run that fails them
is not timed); (b) after it, the timed loop's first batch, at its batch
size and with its padding, decoded again with the plain ``acs_block_ref``
(a few reads at a time) run beside the default step (the CUDA kernel on a card) on the same state
at every k-th block step (about ``GATE_BLOCKS`` of them) and at the first
that mixes active and inactive reads: buffers and selections bit-equal at
each of them, every buffer row sorted in slot after every block step, and
each real read's valid entries, their messages and scores equal to what
the timed loop gave.

``--sharded`` decodes through ``parallel/mesh.py`` ``ShardedDecoder`` at
the config's experiment, on one rank without a process group. ``--profile``
(a card only) traces one decode of the first batch with ``torch.profiler``:
device and K1 seconds, K1's share, the device's idle share, the busiest
device operations, and K1's share of its bound, the bytes the decode's
block steps need (``probes/merge_roofline.py`` ``acs_needed_bytes``) over
the card's memory rate.

Prints ONE JSON line: ``metric``, ``value`` (reads/s), ``unit``,
``vs_baseline`` (reads/s over ``.bench_baseline.json``'s single-core C++
rate for the config, a file this module reads and never writes),
``backend`` (the device type), ``batch``, ``s_per_read``,
``cpp_s_per_read``, ``lists_match`` (null without ``--verify``), ``device``
(the card's name, or ``cpu``), ``power_limit_w`` (from ``nvidia-smi``), and
``reads``, ``k1_launches`` and ``block_steps`` (of the warm-up and the
timed loop), ``peak_gib``, ``gate`` and ``profile``. An out-of-memory error
or a failed build or launch, or a gate that fails, prints the line with
``value`` null and exits non-zero; nothing retries at a smaller batch.
``--device cpu`` runs the plain ACS step, for tests at ``--smoke`` size,
on ``CPU_READS`` read in a batch of one by default.
"""
from __future__ import annotations

import argparse
import dataclasses
import fnmatch
import json
import pathlib
import subprocess
import sys
import time
import traceback
from typing import Optional, Tuple

import numpy as np
import torch

from .coding.conv import conv_encode_bases, make_conv_code
from .config import ConvCodeConfig, DecodeConfig
from .io.post import pack_posts
from .ops import lva_acs
from .ops.lva import LVADecoder
from .ops.lva_consts import NCRF, NQ_MAX
from .ops.synthetic import synthetic_post
from .parallel.mesh import ShardedDecoder
from .pipeline.experiments import experiment
from .probes.merge_roofline import HBM_BYTES_PER_S, acs_needed_bytes
from .utils import profiling

ROOT = pathlib.Path(__file__).resolve().parents[1]
BASELINE_CACHE = ROOT / ".bench_baseline.json"
GOLDEN = ROOT / "tests" / "golden"
SEED = 42
# gate (b) holds the kernel against the plain step on every
# ceil(T / GATE_BLOCKS)-th block step of a batch of T (the plain step takes
# ~0.1 s a block a read at m=14 on an H100)
GATE_BLOCKS = 24
# and runs the plain step on as many reads at once as keep its largest
# intermediate, the int64 move hashes [reads, W, 8, C, 8, L], within this:
# at a whole default batch its intermediates (~15 GiB at m11's 24) do not
# fit beside the decode's ~61 GiB on an H100 80GB
GATE_PLAIN_BYTES = 2**29


@dataclasses.dataclass(frozen=True)
class BenchConfig:
    """One config of the root ``bench.py`` (``:264-306``), with the card's
    default batch and read count, its goldens (``set/name`` patterns under
    ``tests/golden``) and its experiment for ``--sharded``."""

    mem: int
    rate: int
    msg_len: int
    list_size: int
    max_deviation: int
    batch: int
    reads: int
    metric: str
    goldens: Tuple[str, ...]
    experiment: Optional[int] = None

    def code(self) -> ConvCodeConfig:
        return ConvCodeConfig(mem=self.mem, rate=self.rate,
                              msg_len=self.msg_len)


# Each read keeps its selections on the card for its whole decode (~2.1 GB
# at m11, ~3.9 GB at m8 L=64, ~9 GB at m=14), which bounds the batches:
# the defaults are the largest that fit an H100 80GB (m=14 at batch 8 runs
# out of memory, m11 at 32), each faster than the next smaller one in
# every run of a sweep in turns (``bench_record --turns``, PERF.md §6),
# with reads for a timed window of about 12 s at the rate there.
CONFIGS = {
    # the smoke config of CI: m=6 r=1/2 L=4
    "smoke": BenchConfig(6, 1, 100, 4, 16, 256, 5632,
                         "reads_per_s_m6_r1_l4_smoke", ("decode/m6_*",)),
    # the headline production decode: experiment 7
    "m11": BenchConfig(11, 5, 180, 8, 20, 24, 240, "reads_per_s_m11_r5l6_l8",
                       ("decode/m11_r5_rc0_l8", "decode/m11_r5_rc1_l8"), 7),
    # the largest trellis (C=16384): experiment 8, msg_len 181 with the pad
    "m14": BenchConfig(14, 5, 181, 4, 20, 6, 54, "reads_per_s_m14_r5l6_l4",
                       ("decode14/m14_r5_rc0_l4_prod",
                        "decode14/m14_r5_rc1_l4_prod"), 8),
    # the best reading cost (supplementary Table 2): experiment 2; its
    # golden is the one m=14 r=1/2 case
    "m14best": BenchConfig(14, 1, 100, 4, 20, 6, 54,
                           "reads_per_s_m14_r1l2_l4",
                           ("decode/m14_r1_rc0_l2",)),
    # the large-list config: experiment 0, L=64
    "m8": BenchConfig(8, 1, 100, 64, 20, 16, 112, "reads_per_s_m8_r1l2_l64",
                      ("decode/m8_r1_rc0_l64",), 0),
}
# off the card (the plain ACS step, ~6 s a read at the smoke size on eight
# CPU cores): one read unless asked
CPU_BATCH = CPU_READS = 1


def gen_posts(cfg: ConvCodeConfig, n_reads: int, seed: int):
    """``n_reads`` random messages of ``cfg`` encoded and turned into
    synthetic posts at noise 1.0, all from one generator of ``seed``:
    (posts [T_i, 5, 8] each, messages [n_reads, msg_len])."""
    rng = np.random.default_rng(seed)
    code = make_conv_code(cfg)
    msgs = rng.integers(0, 2, (n_reads, cfg.msg_len), dtype=np.uint8)
    bases = conv_encode_bases(code, msgs)
    posts = [synthetic_post(b, rng, noise=1.0) for b in bases]
    return posts, msgs


def device_line(dev: torch.device) -> Tuple[str, Optional[float]]:
    """(the device's name, its power limit in W): ``nvidia-smi``'s for a
    card, (``cpu``, None) on the host."""
    if dev.type != "cuda":
        return dev.type, None
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    out = subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    name, limit = out.strip().rsplit(",", 1)
    return name.strip(), float(limit.split()[0])


def golden_cases(conf: BenchConfig):
    """(set directory, manifest case) of every golden ``conf`` names."""
    for pattern in conf.goldens:
        set_name, case_pattern = pattern.split("/")
        root = GOLDEN / set_name
        cases = [c for c in json.loads((root / "manifest.json").read_text())
                 if fnmatch.fnmatchcase(c["name"], case_pattern)]
        if not cases:
            raise FileNotFoundError(f"no golden matches {pattern}")
        yield from ((root, c) for c in cases)


def golden_gate(conf: BenchConfig, device) -> Tuple[int, int]:
    """Gate (a): every golden of ``conf`` decoded on ``device``, its lists
    against the reference binary's. Returns (cases equal, cases)."""
    same = n = 0
    for root, case in golden_cases(conf):
        cfg = DecodeConfig(
            code=ConvCodeConfig(mem=case["mem"], rate=case["rate"],
                                msg_len=case["msg_len"], rc=case["rc"],
                                sync_marker=case.get("sync_marker", ""),
                                sync_period=case.get("sync_period", 0)),
            list_size=case["list_size"],
            max_deviation=case["max_deviation"])
        post = np.fromfile(root / f"{case['name']}.post",
                           dtype="<f4").reshape(-1, 5, 8)
        msgs, _, valid = LVADecoder(cfg, device=device).decode(post[None])
        want = (root / f"{case['name']}.lists").read_text().split()
        ok = want == ["".join(map(str, m))
                      for m, v in zip(msgs[0], valid[0]) if v]
        print(f"# golden {root.name}/{case['name']}: "
              f"{'identical' if ok else 'DIFFERENT'}", file=sys.stderr)
        same += ok
        n += 1
    return same, n


class CheckedStep:
    """ACS step for gate (b). At every ``every``-th block step and at the
    first that mixes active and inactive reads, the plain ``acs_block_ref``
    on copies of the stale buffers, then the default ``acs_block`` (the
    kernel on a card) on the buffers themselves, and counts the blocks
    whose buffers or selections differ; at the other block steps the
    default step alone. After every block step, counts the blocks that
    leave a buffer row unsorted in slot. The plain step runs ``chunk``
    reads at a time (each read's step is its own). The package's one
    checked step (``chip_smoke.py``'s ``CheckedACS`` adds timing and the
    lse kernel)."""

    def __init__(self, every: int = 1):
        self.every = every
        self.blocks = self.checked = self.differ = self.unsorted = 0
        self.mixed_block = self.first_bad = self.chunk = None

    def plain(self, tabs, prev, stale, rest, sel):
        """``acs_block_ref`` on copies of ``stale``, ``self.chunk`` reads
        at a time: (the buffers, the selections)."""
        _, W, _, C = sel.shape
        L = prev[0].shape[3]
        if self.chunk is None:
            per_read = W * NCRF * C * NQ_MAX * L * 8
            self.chunk = max(1, GATE_PLAIN_BYTES // per_read)
        ref = [x.clone() for x in stale]
        ref_sel = torch.empty_like(sel)
        for i in range(0, sel.shape[0], self.chunk):
            r = slice(i, i + self.chunk)
            lva_acs.acs_block_ref(tabs, [x[r] for x in prev],
                                  [x[r] for x in ref],
                                  *(a[r] for a in rest), ref_sel[r])
        return ref, ref_sel

    def __call__(self, tabs, prev, stale, *args):
        *rest, sel = args
        active = rest[-1]
        mixed = 0 < int(active.sum()) < active.numel()
        if mixed and self.mixed_block is None:
            self.mixed_block = self.blocks
        bad = False
        if self.blocks % self.every == 0 or self.mixed_block == self.blocks:
            ref, ref_sel = self.plain(tabs, prev, stale, rest, sel)
            lva_acs.acs_block(tabs, prev, stale, *args)
            bad = not (torch.equal(sel, ref_sel)
                       and all(torch.equal(a, b) for a, b in zip(stale, ref)))
            self.differ += bad
            self.checked += 1
        else:
            lva_acs.acs_block(tabs, prev, stale, *args)
        sc = stale[0]
        unsorted = not bool((sc[:, :, :, 1:] <= sc[:, :, :, :-1]).all())
        self.unsorted += unsorted
        if (bad or unsorted) and self.first_bad is None:
            self.first_bad = self.blocks
        self.blocks += 1
        return sel


def first_batch(n_reads: int, b: int) -> list:
    """The read indices of the timed loop's first batch: reads 0 to
    min(b, n_reads) - 1, padded with read 0 to ``b``."""
    nsel = min(b, n_reads)
    return list(range(nsel)) + [0] * (b - nsel)


def bench_reads_gate(dec: LVADecoder, packed, nblks, n_reads: int, b: int,
                     timed, every: Optional[int] = None) -> dict:
    """Gate (b): the timed loop's first batch (``first_batch``) decoded
    again through ``CheckedStep`` (``every`` by default ceil(T /
    ``GATE_BLOCKS``) for the batch's T blocks), and each real read's valid
    entries, their messages and scores against what the timed loop gave
    for it (``timed``: (msgs, scores, valid), by the default step alone;
    the sharded decoder's scores are -inf at invalid entries)."""
    idx = first_batch(n_reads, b)
    nsel = min(b, n_reads)
    if every is None:
        every = max(1, -(-int(nblks[idx].max()) // GATE_BLOCKS))
    check = CheckedStep(every)
    msgs, scores, valid = (x[:nsel] for x in
                           dec.decode(packed[idx], nblks[idx], acs=check))
    t_msgs, t_scores, t_valid = (x[:nsel] for x in timed)
    same_lists = (np.array_equal(valid, t_valid)
                  and np.array_equal(msgs[valid], t_msgs[valid])
                  and np.array_equal(scores[valid], t_scores[valid]))
    return {"reads": nsel, "batch": b, "blocks": check.blocks,
            "every": every, "checked": check.checked,
            "plain_chunk": check.chunk,
            "mixed_block": check.mixed_block,
            "blocks_differ": check.differ, "blocks_unsorted": check.unsorted,
            "first_bad_block": check.first_bad, "lists_equal": same_lists,
            "ok": same_lists and check.checked > 0 and not check.differ
            and not check.unsorted}


class NeededBytes:
    """ACS step that runs the default ``acs_block`` and adds up the bytes
    each block step must move on its inputs (``acs_needed_bytes``)."""

    def __init__(self):
        self.blocks = self.bytes = 0

    def __call__(self, tabs, prev, stale, *args):
        *rest, sel = args
        lva_acs.acs_block(tabs, prev, stale, *args)
        self.bytes += acs_needed_bytes(tabs, prev[0], stale[0], sel, *rest)
        self.blocks += 1
        return sel


def busy_seconds(intervals) -> float:
    """Seconds covered by the union of [start, end] intervals."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def trace_device(fn, top: int = 8) -> dict:
    """``fn()`` once under ``torch.profiler`` on a card: its wall seconds,
    the device seconds summed over the device's kernels and copies, the
    device's idle share (1 - the union of the device operations' intervals
    over the wall, right on any number of streams), and the ``top``
    busiest device operations (name, seconds, calls); ``ops`` holds every
    device operation's seconds."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    on_dev = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    dev_s = sum(e.self_device_time_total for e in on_dev) / 1e6
    busy_s = busy_seconds(
        (e.time_range.start / 1e6, e.time_range.end / 1e6)
        for e in prof.events() if e.device_type == DeviceType.CUDA
        and not getattr(e, "is_user_annotation", False))
    busiest = sorted(on_dev, key=lambda e: -e.self_device_time_total)
    return {"wall_s": wall, "device_total_s": dev_s, "busy_s": busy_s,
            "idle_share": 1 - busy_s / wall,
            "top_ops": [{"name": e.key[:120],
                         "s": e.self_device_time_total / 1e6,
                         "calls": e.count} for e in busiest[:top]],
            "ops": {e.key: e.self_device_time_total / 1e6 for e in on_dev}}


def profile_breakdown(dec, inner: LVADecoder, packed, nblks) -> dict:
    """One decode of ``packed`` by ``dec`` through ``trace_device``, with
    K1's seconds and share of the device time; then K1's bound, the bytes
    the same decode's block steps need (through ``inner``) over the memory
    rate, and K1's share of it."""
    trace = trace_device(lambda: dec.decode(packed, nblks))
    ops = trace.pop("ops")
    k1_s = sum(v for k, v in ops.items() if "lva_acs" in k)
    dev_s = trace["device_total_s"]
    need = NeededBytes()
    inner.decode(packed, nblks, acs=need)
    bound_s = need.bytes / HBM_BYTES_PER_S
    return {"reads": len(nblks), **trace, "k1_s": k1_s,
            "k1_share": k1_s / dev_s if dev_s else None,
            "k1_blocks": need.blocks, "k1_needed_bytes": need.bytes,
            "k1_bound_s": bound_s,
            "k1_share_of_bound": bound_s / k1_s if k1_s else None}


def make_decoder(conf: BenchConfig, sharded: bool, device):
    """(the decoder the timed loop calls, the ``LVADecoder`` under it)."""
    if not sharded:
        dec = LVADecoder(DecodeConfig(code=conf.code(),
                                      list_size=conf.list_size,
                                      max_deviation=conf.max_deviation),
                         device=device)
        return dec, dec
    exp = experiment(conf.experiment)
    if exp.msg_len() != conf.msg_len:
        raise ValueError(f"experiment {conf.experiment} has msg_len "
                         f"{exp.msg_len()}, the config {conf.msg_len}")
    sd = ShardedDecoder(exp, conf.list_size, rc=False,
                        max_deviation=conf.max_deviation, device=device)
    num_oligos = 1 << exp.framing.index_len

    class Sharded:
        def decode(self, posts, nblks):
            res = sd.decode(posts, nblks, num_oligos)
            return res.msgs, res.scores, res.scores > -np.inf

    return Sharded(), sd.inner


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_with_batch(dec, packed, nblks, n_reads: int, b: int,
                   dev: torch.device):
    """One warm-up decode of the first batch (``first_batch``), then every
    read ``b`` at a time, a partial last batch padded with read 0 and only
    its real reads counted. Returns (reads/s of the timed loop, its (msgs,
    scores, valid) of every read)."""
    warm = first_batch(n_reads, b)
    dec.decode(packed[warm], nblks[warm])
    sync(dev)
    parts = []
    t0 = time.perf_counter()
    done = 0
    while done < n_reads:
        nsel = min(b, n_reads - done)
        idx = list(range(done, done + nsel)) + [0] * (b - nsel)
        parts.append([x[:nsel] for x in dec.decode(packed[idx], nblks[idx])])
        done += nsel
    sync(dev)
    rps = n_reads / (time.perf_counter() - t0)
    return rps, tuple(np.concatenate(x) for x in zip(*parts))


def parse_args(argv):
    """The command line; adds ``name`` (the config's key in ``CONFIGS``) and
    ``metric`` (its metric name, ``_sharded`` appended under
    ``--sharded``)."""
    ap = argparse.ArgumentParser(prog="nanopore_dna_storage_tpu_torch.bench")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny m=6 config for CI")
    ap.add_argument("--config", default="m11",
                    choices=["m11", "m14", "m14best", "m8"],
                    help="m11 = headline production decode; m14 = the "
                         "largest-trellis config (m=14 r=5/6 L=4, C=16384); "
                         "m14best = the best-reading-cost config (m=14 "
                         "r=1/2 L=4, supplementary Table 2); m8 = the "
                         "large-list config (m=8 r=1/2 L=64, experiment 0)")
    ap.add_argument("--batch", type=int, default=0,
                    help="reads a decode (default: the config's on a card, "
                         "1 on the CPU)")
    ap.add_argument("--reads", type=int, default=0,
                    help="reads timed (default: the config's on a card, 1 "
                         "on the CPU)")
    ap.add_argument("--profile", action="store_true",
                    help="also trace one decode of the first batch (a card "
                         "only)")
    ap.add_argument("--sharded", action="store_true",
                    help="decode through ShardedDecoder on one rank; "
                         "m11/m14/m8 configs only")
    ap.add_argument("--verify", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="gate on the config's goldens and on the plain ACS "
                         "step on the timed loop's first batch (adds "
                         "lists_match to the JSON). Default: on except for "
                         "--smoke")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain ACS step)")
    args = ap.parse_args(argv)
    args.name = "smoke" if args.smoke else args.config
    conf = CONFIGS[args.name]
    if args.sharded and conf.experiment is None:
        ap.error("--sharded supports configs m11/m14/m8 only")
    if args.batch < 0 or args.reads < 0:
        ap.error("--batch and --reads must not be negative")
    if args.verify is None:
        args.verify = not args.smoke
    args.metric = conf.metric + ("_sharded" if args.sharded else "")
    return args


def run(args):
    """The benchmark of ``parse_args``'s ``args``. Returns (the JSON line,
    the timed loop's (msgs, scores, valid) of every read, or None where it
    did not finish); the line's ``value`` is null where the run failed."""
    conf = CONFIGS[args.name]
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda requested but CUDA is not available")
    if args.profile and dev.type != "cuda":
        raise RuntimeError("--profile traces a CUDA device")
    on_card = dev.type == "cuda"
    b = args.batch or (conf.batch if on_card else CPU_BATCH)
    n_reads = args.reads or (conf.reads if on_card else CPU_READS)
    device_name, power_limit = device_line(dev)
    baseline = (json.loads(BASELINE_CACHE.read_text())
                if BASELINE_CACHE.exists() else {})
    cpp_rps = baseline.get(f"{conf.metric}_cpp")
    out = {"metric": args.metric, "value": None, "unit": "reads/s",
           "vs_baseline": None, "backend": dev.type, "batch": b,
           "s_per_read": None,
           "cpp_s_per_read": 1.0 / cpp_rps if cpp_rps else None,
           "lists_match": None, "device": device_name,
           "power_limit_w": power_limit, "reads": n_reads}

    posts, _ = gen_posts(conf.code(), n_reads, SEED)
    packed, nblks = pack_posts(posts)
    try:
        dec, inner = make_decoder(conf, args.sharded, dev)
        if args.verify:
            same, n = golden_gate(conf, dev)
            out["gate"] = {"goldens": n, "goldens_equal": same,
                           "bench_reads": None}
            if same != n:
                out["lists_match"] = False
                return out, None
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        launches, steps = profiling.counter("acs.launches"), inner.steps
        rps, timed = run_with_batch(dec, packed, nblks, n_reads, b, dev)
        out.update(k1_launches=profiling.counter("acs.launches") - launches,
                   block_steps=inner.steps - steps)
        if dev.type == "cuda":
            out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
        print(f"# {n_reads} reads at batch {b}: {rps:.4f} reads/s",
              file=sys.stderr)
        if args.profile:
            warm = first_batch(n_reads, b)
            out["profile"] = profile_breakdown(dec, inner, packed[warm],
                                               nblks[warm])
        if args.verify:
            reads = bench_reads_gate(inner, packed, nblks, n_reads, b, timed)
            out["gate"]["bench_reads"] = reads
            out["lists_match"] = reads["ok"]
            if not reads["ok"]:
                return out, timed
    except RuntimeError:
        # out of memory at this batch, a kernel build or launch that failed
        traceback.print_exc()
        return out, None
    out.update(value=rps, s_per_read=1.0 / rps,
               vs_baseline=rps / cpp_rps if cpp_rps else None)
    return out, timed


def main(argv=None) -> int:
    out, _ = run(parse_args(argv))
    print(json.dumps(out))
    return 0 if out["value"] is not None else 1


if __name__ == "__main__":
    raise SystemExit(main())
