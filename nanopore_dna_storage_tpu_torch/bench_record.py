"""Runs of the decode benchmark (``bench.py``), each in a process of its
own, and the record they make.

    python -m nanopore_dna_storage_tpu_torch.bench_record --out RUNS.jsonl
        [--turns N] [--record FILE.json] (--preset record | -- ARGS ...)

Each ARGS is one command line of ``python -m
nanopore_dna_storage_tpu_torch.bench`` in one string (``"--config m11
--batch 16"``); ``--preset record`` runs ``RECORD_RUNS``, the record the
repository keeps (``docs/BENCH_H100.json``). Under ``--turns N`` the list
runs N times, every second time in reverse order (A B, B A, A B, ...), so
that two command lines compared meet the card in the same states. Each
run appends one line to ``--out``: its command, exit code, wall seconds,
the card's name and power limit (``nvidia-smi``) and the benchmark's JSON
line. At the end it prints, for each command line, the runs' reads/s
(median, least, most) and peak GiB, and under ``--record`` writes every
entry to that file. Exits non-zero if any run did.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import shlex
import statistics
import subprocess
import sys
import time

# the record: the five configs, m11 / m14 / m8 through ShardedDecoder, and
# the device breakdown at m11 and m14best, each at the config's default
# batch and reads with --verify
RECORD_RUNS = ("--smoke --verify", "--config m11", "--config m14",
               "--config m14best", "--config m8", "--config m11 --sharded",
               "--config m14 --sharded", "--config m8 --sharded",
               "--config m11 --profile", "--config m14best --profile")


def gpu_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()


def run_once(args: str, timeout: float) -> dict:
    """One benchmark process on ``args``: its entry."""
    cmd = [sys.executable, "-m", "nanopore_dna_storage_tpu_torch.bench",
           *shlex.split(args)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout)
        rc, stdout, stderr = proc.returncode, proc.stdout, proc.stderr
    except subprocess.TimeoutExpired as e:
        rc, stdout, stderr = 124, e.stdout or "", str(e)
        stdout = stdout.decode() if isinstance(stdout, bytes) else stdout
    wall = time.perf_counter() - t0
    lines = stdout.strip().splitlines()
    try:
        line = json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        line = None
    entry = {"cmd": "python -m nanopore_dna_storage_tpu_torch.bench "
                    + args, "rc": rc, "wall_s": wall, "gpu": gpu_line(),
             "line": line}
    if rc != 0:
        entry["stderr_tail"] = stderr[-2000:]
    return entry


def summary(entries) -> dict:
    """reads/s and peak GiB of each command line's runs."""
    by_cmd = {}
    for e in entries:
        by_cmd.setdefault(e["cmd"], []).append(e["line"] or {})
    out = {}
    for cmd, lines in by_cmd.items():
        values = [x["value"] for x in lines if x.get("value")]
        out[cmd] = {"runs": len(lines), "values": values,
                    "median": statistics.median(values) if values else None,
                    "min": min(values, default=None),
                    "max": max(values, default=None),
                    "peak_gib": [x.get("peak_gib") for x in lines]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="nanopore_dna_storage_tpu_torch.bench_record")
    ap.add_argument("--out", required=True,
                    help="JSON-lines file each run's entry is appended to")
    ap.add_argument("--record", default=None,
                    help="also write every entry to this JSON file")
    ap.add_argument("--turns", type=int, default=1)
    ap.add_argument("--preset", choices=["record"], default=None)
    ap.add_argument("--run-timeout", type=float, default=900.0,
                    help="seconds a run may take before it is ended")
    ap.add_argument("runs", nargs="*",
                    help="benchmark command lines, one string each")
    args = ap.parse_args(argv)
    runs = list(RECORD_RUNS if args.preset == "record" else args.runs)
    if not runs:
        ap.error("give command lines or --preset record")
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    entries = []
    for turn in range(args.turns):
        for run_args in (runs if turn % 2 == 0 else runs[::-1]):
            entry = run_once(run_args, args.run_timeout)
            entries.append(entry)
            with out.open("a") as f:
                f.write(json.dumps(entry) + "\n")
            line = entry["line"] or {}
            print(f"# rc {entry['rc']} {entry['wall_s']:.1f} s "
                  f"{entry['cmd']}: {line.get('value')} reads/s at batch "
                  f"{line.get('batch')}, lists_match "
                  f"{line.get('lists_match')}", flush=True)
    print(json.dumps({"summary": summary(entries)}))
    if args.record:
        pathlib.Path(args.record).write_text(json.dumps({
            "what": "python -m nanopore_dna_storage_tpu_torch.bench_record"
                    f" {'--preset record' if args.preset else ''}: each "
                    "run of python -m nanopore_dna_storage_tpu_torch.bench "
                    "in a process of its own on one card",
            "gpu": entries[0]["gpu"], "entries": entries}, indent=1) + "\n")
    return 0 if all(e["rc"] == 0 for e in entries) else 1


if __name__ == "__main__":
    raise SystemExit(main())
