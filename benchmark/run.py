"""Run one cell of the benchmark of ``nanopore_dna_storage_tpu_torch`` once.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout. The cell (``BENCHMARK.json``'s ``workloads``)
names a configuration and a traffic mix (``manifest.py``). Set-up makes the
cell's file from ``--seed``, encodes it, simulates the pool of reads
(``traffic.py``), builds the program's ``PipelineDecoder`` on the card and
makes one warm-up call for each orientation at the cell's batch; every
kernel is built and loaded there. The window then calls
``PipelineDecoder.decode_posts`` in a closed loop, one caller, each call on
the next batch of the pool, until the clock passes ``--seconds``; the rate
is all the reads of all its calls over the time from its start to the end
of its last call.

After the window, the plain reference (``reference.py``) decodes a sample of
the window's reads drawn from the seed, the longest among them, and the
run is ``correct`` when every number compared is within its limit: the
sampled reads' lists (validity, messages and scores) and their CRC/index
classification equal the reference's, and every read decoded more than once
in the window gave the same result each time.

``--trace 1`` runs the same set-up and window with spans around the calls
into the program's layers (``tracing.py``), profiles two calls with
``torch.profiler``, lets each per-layer metric collect what it reads, then
makes the same check. The last line of standard output is one JSON object;
the numbers compared, each beside its limit, are the last lines of standard
error. Without a card, or with fewer than the cell's chips, or when a JAX
module is loaded once the window has closed, it exits non-zero and prints
no result.
"""
from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from typing import Callable, Dict, List, Optional, Tuple  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
# every build and kernel cache inside the checkout, at fixed paths (the
# program's own nvcc builds go to build/kernels there)
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from . import manifest, tracing  # noqa: E402
from .check import check, check_lines, passed  # noqa: E402
from .traffic import Pool, make_pool  # noqa: E402

# top-level module names that may not be loaded in a run: JAX and the JAX
# package the program was ported from
FORBIDDEN = ("jax", "jaxlib", "flax", "nanopore_dna_storage_tpu")


def forbidden_modules(modules=None) -> List[str]:
    """The loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)


def run_window(call: Callable[[int], int], ncalls: int, seconds: float,
               clock: Callable[[], float]) -> Dict[str, float]:
    """Whole calls ``call(i % ncalls)``, each returning the reads it did,
    until ``clock`` has passed ``seconds`` since the start; the rate is every
    read over the time from the start to the end of the last call."""
    t0 = clock()
    reads = calls = 0
    while True:
        reads += call(calls % ncalls)
        calls += 1
        t1 = clock()
        if t1 - t0 >= seconds:
            return {"reads": reads, "calls": calls, "seconds": t1 - t0}


class Capture:
    """What the timed path produced: each ``decode_posts`` call's reads and
    outcome, and each decoder call's input rows and lists."""

    def __init__(self):
        self.outcomes: List[Tuple[np.ndarray, object]] = []
        self.lists: List[Tuple[np.ndarray, np.ndarray, tuple]] = []
        self.on = False

    def decoder(self, fn: Callable) -> Callable:
        def decode(posts, nblks=None, acs=None):
            out = fn(posts, nblks, acs=acs)
            if self.on:
                self.lists.append((posts, nblks, out))
            return out
        return decode


class Program:
    """The system under test: the program's ``PipelineDecoder`` for a cell,
    with the benchmark's wrappers around the calls into its layers."""

    def __init__(self, config: dict, device: torch.device):
        from nanopore_dna_storage_tpu_torch.config import (ExperimentConfig,
                                                           FramingConfig)
        from nanopore_dna_storage_tpu_torch.pipeline.decode import \
            PipelineDecoder
        exp = ExperimentConfig(
            bytes_per_oligo=config["bytes_per_oligo"],
            rs_redundancy=config["rs_redundancy"],
            conv_mem=config["conv_mem"], conv_rate=config["conv_rate"],
            pad=config["pad"], framing=FramingConfig(**config["framing"]))
        self.device = device
        self.pd = PipelineDecoder(exp, config["list_size"],
                                  config["max_deviation"],
                                  path_combine=config["path_combine"],
                                  device=device)
        self.capture = Capture()
        for dec in (self.pd.fwd, self.pd.rc):
            dec.decode = self.capture.decoder(dec.decode)
        self._restore: List[Tuple[object, str, object]] = []

    def call(self, pool: Pool, idx: np.ndarray, acs=None) -> int:
        """One ``decode_posts`` call on reads ``idx`` of the pool."""
        kw = {} if acs is None else {"acs": acs}
        out = self.pd.decode_posts([pool.posts[i] for i in idx],
                                   pool.rc[idx], pool.num_oligos, **kw)
        if self.capture.on:
            self.capture.outcomes.append((idx, out))
        return len(idx)

    def instrument(self, spans: tracing.Spans, sync_traceback: bool) -> None:
        """Spans around the calls into each layer, ``spans`` recording: the
        pipeline (``decode_posts``, ``pack_posts``, ``classify``), the
        decoder (``decode``, ``schedule``) and its loops (``forward``,
        ``traceback``, ``order`` of ``ops/lva_decode.py``); the traceback
        synchronised at both ends with ``sync_traceback``."""
        self.uninstrument()
        from nanopore_dna_storage_tpu_torch.ops import lva_decode
        from nanopore_dna_storage_tpu_torch.pipeline import decode as pmod

        def patch(obj, attr, name, sync=None):
            if hasattr(obj, attr):
                fn = getattr(obj, attr)
                self._restore.append((obj, attr, fn))
                setattr(obj, attr, spans.wrap(name, fn, sync))

        patch(self.pd, "decode_posts", "pipeline.decode_posts")
        patch(self.pd, "classify", "pipeline.classify")
        patch(pmod, "pack_posts", "pipeline.pack_posts")
        for dec in (self.pd.fwd, self.pd.rc):
            patch(dec, "decode", "decoder.decode")
            patch(dec, "schedule", "decoder.schedule")
        patch(lva_decode, "forward", "decoder.forward")
        patch(lva_decode, "traceback", "decoder.traceback",
              self.device if sync_traceback else None)
        patch(lva_decode, "order", "decoder.order")

    def uninstrument(self) -> None:
        for obj, attr, fn in reversed(self._restore):
            setattr(obj, attr, fn)
        self._restore = []

    def default_acs(self) -> Optional[Callable]:
        """The ACS step the decoder calls by default under max combining,
        or None where the program no longer exposes one."""
        try:
            from nanopore_dna_storage_tpu_torch.ops import lva
            return lva.acs_block
        except (ImportError, AttributeError):
            return None


class Context:
    """What a per-layer metric's ``collect`` may use after the window."""

    def __init__(self, program: Program, pool: Pool, config: dict,
                 traffic: dict):
        self.program, self.pool = program, pool
        self.config, self.traffic = config, traffic
        self.device = program.device

    def batch_of(self, rc: bool) -> np.ndarray:
        """The pool's first ``batch`` reads of one orientation."""
        return np.nonzero(self.pool.rc == rc)[0][:self.traffic["batch"]]

    def call(self, idx: np.ndarray, acs=None) -> None:
        self.program.call(self.pool, idx, acs)
        torch.cuda.synchronize(self.device)


def power_limit() -> Optional[float]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", "0", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             root: pathlib.Path = ROOT, here: pathlib.Path = manifest.HERE,
             device="cuda",
             clock: Callable[[], float] = time.perf_counter,
             started: float = STARTED) -> dict:
    """One run of cell ``name``: its result line, as a dict."""
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    man = manifest.load(root)
    cell = manifest.cell(man, name)
    config = manifest.config(root, man, cell)
    traffic = manifest.traffic(cell["traffic"], here)
    kind = "per_layer" if trace else "end_to_end"
    readers = {m["name"]: manifest.metric_module(m["name"], here)
               for m in manifest.metrics(man, name, kind)}

    pool = make_pool(config, traffic, seed)
    prog = Program(config, dev)
    # the first call holding each orientation
    warm = list(dict.fromkeys(
        next(i for i, c in enumerate(pool.calls) if (pool.rc[c] == f).any())
        for f in (False, True) if (pool.rc == f).any()))
    for i in warm:
        prog.call(pool, pool.calls[i])
    if on_card:
        torch.cuda.synchronize(dev)
    rec: dict = {"setup_s": clock() - started}

    spans = tracing.Spans(clock)
    if trace:
        prog.instrument(spans, sync_traceback=on_card)
    prog.capture.on = True
    rec["window"] = run_window(lambda i: prog.call(pool, pool.calls[i]),
                               len(pool.calls), seconds, clock)
    prog.capture.on = False
    prog.uninstrument()
    rec["spans"] = spans.spans
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    if trace:
        if on_card:
            profiled = tracing.Spans(clock)
            prog.instrument(profiled, sync_traceback=False)
            try:
                rec["profile"] = tracing.profile(
                    lambda: [prog.call(pool, pool.calls[i]) for i in warm],
                    profiled, dev)
            finally:
                prog.uninstrument()
        ctx = Context(prog, pool, config, traffic)
        for mod in readers.values():
            if hasattr(mod, "collect"):
                rec.update(mod.collect(ctx))
    capture = prog.capture
    ctx = prog = None  # the program's state freed before the reference runs
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_check = clock()
    checks = check(pool, capture, config, traffic, seed, dev)
    print(f"benchmark: setup {rec['setup_s']:.3f} s, window "
          f"{rec['window']['seconds']:.3f} s ({rec['window']['calls']} calls),"
          f" check {clock() - t_check:.3f} s", file=sys.stderr)
    values = {}
    for m in manifest.metrics(man, name, kind):
        v = readers[m["name"]].read(rec)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    window = rec["window"]
    device_info = {"platform": "gpu" if on_card else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if on_card
                   else dev.type,
                   "count": 1, "memory_peak_bytes": peak}
    if on_card:
        device_info["power_limit_w"] = power_limit()
    out = {"correct": passed(checks), "attempted": window["reads"],
           "failed": sum(c["value"] for n, c in checks.items()
                         if n != "reads_checked"),
           "metrics": values, "device": device_info}
    if trace and rec.get("profile"):
        p = rec["profile"]
        device_info.update(busy_s=p["busy_s"], window_s=p["window_s"])
        out["breakdown"] = {"device_ops": p["device_ops"],
                            "idle_gaps": p["idle_gaps"]}
    out["checks"] = checks
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    cell = manifest.cell(manifest.load(ROOT), args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print("benchmark: forbidden modules loaded: " + ", ".join(found),
              file=sys.stderr)
        return 3
    sys.stdout.flush()
    for line in check_lines(out["checks"]):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
