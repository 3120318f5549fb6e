"""The control of the benchmark's check: the plain reference put in the
program's place, its scores in the precision below the configuration's
(bfloat16 for float32), judged by the same comparison as a run.

    python3 -m benchmark.control --workload <name> --seeds <n> [<n> ...]

For each seed it makes the cell's pool as a run does, draws the sample a
run draws from a window that reached every read of the pool, decodes those
reads with the reference in bfloat16 and in float32, and prints one JSON
line: the numbers compared beside their limits, and ``correct``, which has
to come out false. The benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import time

import numpy as np
import torch

from . import manifest
from .check import compare, passed, reference_results, sample
from .traffic import make_pool

ROOT = pathlib.Path(__file__).resolve().parents[1]


def control(name: str, seed: int, *, root: pathlib.Path = ROOT,
            here: pathlib.Path = manifest.HERE, device="cuda",
            dtype=torch.bfloat16) -> dict:
    """The checks of cell ``name`` at ``seed`` with the reference in
    ``dtype`` in the program's place."""
    man = manifest.load(root)
    cell = manifest.cell(man, name)
    config = manifest.config(root, man, cell)
    traffic = manifest.traffic(cell["traffic"], here)
    pool = make_pool(config, traffic, seed)
    reads = sample(range(len(pool.posts)), pool, traffic["check_reads"],
                   seed)
    t0 = time.perf_counter()
    chunk = traffic["reference_chunk"]
    got_lists, got_outcomes = reference_results(pool, reads, config, chunk,
                                                device, dtype)
    ref_lists, ref_outcomes = reference_results(pool, reads, config, chunk,
                                                device)
    checks = compare(reads, got_lists, got_outcomes, ref_lists,
                     ref_outcomes, 0)
    gap = max((float(np.max(np.abs(ref_lists[r][1] - got_lists[r][1])
                            [ref_lists[r][2] & got_lists[r][2]], initial=0))
               for r in reads), default=0.0)
    return {"workload": name, "seed": seed, "dtype": str(dtype),
            "correct": passed(checks), "checks": checks,
            "max_score_gap": gap, "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA device")
        return 2
    for seed in args.seeds:
        print(json.dumps(control(args.workload, seed)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
