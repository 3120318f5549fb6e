"""Launch an N-rank decode job on one machine, or print the per-host
commands for a cluster (``scripts/launch_multihost.py``'s counterpart).

    python -m nanopore_dna_storage_tpu_torch.parallel.launch \\
        --num-processes 2 --device cpu --post-dir DIR --outdir OUT \\
        --experiment 7

Each rank runs ``python -m nanopore_dna_storage_tpu_torch.parallel.multihost``
with ``--coordinator 127.0.0.1:<a free port>``, its ``--process-id`` and
``LOCAL_RANK``, and every argument the launcher does not take itself (the
job's: ``--post-dir``, ``--device``, ``--dist-backend``, ...). Two ranks on
one card need ``--dist-backend gloo``. The launcher prints each rank's
output and exits with the first non-zero exit code of a rank. A rank that
fails ends its peers through their collectives, each bounded by the job's
``--timeout``; a rank still running after ``WAIT`` seconds is stopped.
"""
from __future__ import annotations

import argparse
import os
import pathlib
import socket
import subprocess
import sys
import tempfile
import time
from typing import List, Optional, Sequence, Tuple

MODULE = "nanopore_dna_storage_tpu_torch.parallel.multihost"
ROOT = pathlib.Path(__file__).resolve().parents[2]
WAIT = 1800.0  # seconds before every rank still running is stopped


def free_port() -> int:
    """A TCP port of this machine that no one listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_commands(num_processes: int, job_args: Sequence[str],
                  coordinator: str) -> List[List[str]]:
    """The command line of every rank."""
    return [[sys.executable, "-m", MODULE, "--coordinator", coordinator,
             "--num-processes", str(num_processes), "--process-id", str(i),
             *job_args] for i in range(num_processes)]


def run_local(num_processes: int, job_args: Sequence[str],
              env: Optional[dict] = None,
              timeout: float = WAIT) -> List[Tuple[int, str]]:
    """Run the ranks as processes of this machine on a free port and wait
    for them. Returns each rank's (exit code, output with errors); every
    rank still running ``timeout`` seconds after the start is stopped and
    gets -9."""
    cmds = rank_commands(num_processes, job_args,
                         f"127.0.0.1:{free_port()}")
    base = dict(os.environ if env is None else env)
    base["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in [base.get("PYTHONPATH")] if p])
    with tempfile.TemporaryDirectory() as tmp:
        logs = [open(pathlib.Path(tmp) / f"rank{i}.log", "w+")
                for i in range(num_processes)]
        try:
            procs = [subprocess.Popen(cmd, stdout=log,
                                      stderr=subprocess.STDOUT,
                                      env=dict(base, LOCAL_RANK=str(i)))
                     for i, (cmd, log) in enumerate(zip(cmds, logs))]
            deadline = time.monotonic() + timeout
            try:
                for p in procs:
                    p.wait(max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                for p in procs:
                    p.kill()
                for p in procs:
                    p.wait()
            out = []
            for p, log in zip(procs, logs):
                log.seek(0)
                out.append((p.returncode, log.read()))
            return out
        finally:
            for log in logs:
                log.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="nanopore_dna_storage_tpu_torch.parallel.launch")
    ap.add_argument("--num-processes", type=int, default=2)
    ap.add_argument("--coordinator",
                    help="host:port of rank 0 for --print-only (default "
                         "127.0.0.1 on a free port)")
    ap.add_argument("--print-only", action="store_true",
                    help="print the per-host commands for a cluster")
    args, job_args = ap.parse_known_args(argv)
    if args.print_only:
        coordinator = args.coordinator or f"127.0.0.1:{free_port()}"
        for cmd in rank_commands(args.num_processes, job_args, coordinator):
            print(" ".join(cmd))
        return 0
    rc = 0
    for i, (code, out) in enumerate(run_local(args.num_processes,
                                              job_args)):
        print(f"--- process {i} (rc={code}) ---")
        print(out[-4000:], end="" if out.endswith("\n") else "\n")
        if code and not rc:
            rc = code if code > 0 else 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
