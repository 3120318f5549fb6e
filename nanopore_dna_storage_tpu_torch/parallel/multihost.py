"""N-process scale-out of the decode: a directory of ``.post`` files in,
``list_<i>`` files out, sharded over the ranks of a ``torch.distributed``
process group.

Counterpart of ``nanopore_dna_storage_tpu/parallel/multihost.py``
(``initialize``, ``MultiHostDecoder``, ``run_decode_job``, ``main``), and
of the reference's production loop (generate_decoded_lists.py) sharded as
util/extra/generate_read_id_files.py shards it. The JAX package runs one
global program in which every decode step is a collective, so every host
runs as many steps as the busiest one, with ghost batches, and gathers the
gated phase's step count. Here each rank decodes its own reads with no
collective (``ShardedDecoder.decode_shard``), so ranks may run different
numbers of steps; the job's one collective is the ``all_reduce`` of the
CRC-pass count at its end. The files and the count are the reference's.

A list file takes the numeric suffix of its read's stem, as in the
reference; a stem without one takes the read's position in the sorted list
of every rank's ``.post`` files, ``pid + lo * nproc``. The reference takes
the rank's local position ``lo`` there (multihost.py:243-246), so with two
or more processes rank 0's and rank 1's first reads both write ``list_0``;
at one process, or with numeric stems, the two name every list alike.

Launch one command per rank, or ``parallel/launch.py`` on one machine:

    python -m nanopore_dna_storage_tpu_torch.parallel.multihost \\
        --coordinator HOST0:1234 --num-processes N --process-id I \\
        --post-dir DIR --outdir OUT --experiment 7 --list-size 8
    torchrun --nproc-per-node N \\
        -m nanopore_dna_storage_tpu_torch.parallel.multihost \\
        --post-dir DIR --outdir OUT

Each rank runs on ``cuda:{LOCAL_RANK % device count}`` unless ``--device``
names another; nothing falls back to the CPU. The group's backend is nccl
on a CUDA device, gloo on the CPU; ranks that share one card need
``--dist-backend gloo``, since nccl takes one rank a card.
"""
from __future__ import annotations

import argparse
import dataclasses
import datetime
import glob
import json
import os
import time
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import ExperimentConfig
from ..io.lists import write_list_file
from ..io.post import pack_posts, read_post
from ..utils import profiling
from .mesh import ShardedDecoder, all_reduce_sum, default_device


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None, device=None,
               timeout: float = 600.0) -> Tuple[int, int]:
    """Start this process's default process group.

    With ``coordinator_address`` (host:port) the world size and rank are
    the caller's (``tcp://``); without, ``env://`` reads torchrun's
    ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``. The
    backend is nccl for a CUDA ``device`` (the default device,
    ``cuda:{LOCAL_RANK}``) and gloo for the CPU unless the caller names
    one. The start and every collective wait at most ``timeout`` seconds.
    Returns (rank, world size).
    """
    device = torch.device(device) if device is not None else default_device()
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if coordinator_address:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator needs --num-processes and "
                             "--process-id")
        kw = dict(init_method=f"tcp://{coordinator_address}",
                  world_size=num_processes, rank=process_id)
    else:
        kw = dict(init_method="env://")
    dist.init_process_group(
        backend=backend, timeout=datetime.timedelta(seconds=timeout), **kw)
    return dist.get_rank(), dist.get_world_size()


def _host(shard) -> list:
    return [t.cpu().numpy() for t in shard]


class MultiHostDecoder:
    """This rank's part of a sharded decode: its reads, decoded and
    classified on its device by ``ShardedDecoder.decode_shard``. With
    ``auto_orientation`` every batch decodes in both orientations and each
    read keeps the one with the higher top score, a tie going to the first
    (generate_decoded_lists.py:68-74 without the barcode)."""

    def __init__(self, exp: ExperimentConfig, list_size: int,
                 rc: bool = False, max_deviation: Optional[int] = 20,
                 auto_orientation: bool = False, device=None):
        mk = lambda flag: ShardedDecoder(  # noqa: E731
            exp, list_size, flag, max_deviation=max_deviation, device=device)
        self.sharded = mk(rc)
        self.sharded_rc = mk(not rc) if auto_orientation else None
        self.num_processes = self.sharded.world
        self.process_id = self.sharded.rank

    @property
    def steps(self) -> int:
        """Forward block steps run by this rank's decoders so far."""
        return self.sharded.inner.steps + (
            self.sharded_rc.inner.steps if self.sharded_rc else 0)

    def decode_local(self, posts: np.ndarray, nblks: np.ndarray,
                     num_oligos: int):
        """Decode this rank's reads [b, T, 5, 8]. Returns numpy (msgs,
        scores, ok, index, rc_used) for them."""
        out = _host(self.sharded.decode_shard(posts, nblks, num_oligos))
        rc_used = np.zeros(len(posts), bool)
        if self.sharded_rc is not None:
            out_r = _host(self.sharded_rc.decode_shard(posts, nblks,
                                                       num_oligos))
            # per read, the orientation with the higher top path score
            # (lists are score-sorted; a tie keeps the first)
            rc_used = out_r[1][:, 0] > out[1][:, 0]
            out = [np.where(rc_used.reshape((-1,) + (1,) * (a.ndim - 1)),
                            a_r, a) for a, a_r in zip(out, out_r)]
        return (*out, rc_used)


@dataclasses.dataclass
class JobResult:
    """What one rank's ``run_decode_job`` did."""

    crc_pass: int  # reads with a CRC-passing candidate, over every rank
    local_crc_pass: int  # the same over this rank's reads
    reads: int  # this rank's reads
    steps: int  # forward block steps this rank's decoders ran


def run_decode_job(post_dir: str, outdir: str, exp: ExperimentConfig,
                   list_size: int, max_deviation: Optional[int] = 20,
                   local_batch: int = 8, auto_orientation="gated",
                   device=None) -> JobResult:
    """Decode every ``.post`` in ``post_dir``, sharded over the ranks by
    stride: rank i takes files i, i+N, i+2N, ... of the sorted list
    (generate_read_id_files.py), decodes them ``local_batch`` at a time and
    writes their ``list_<idx>`` files (the entries with a score above -inf,
    at most ``list_size``) and its ``info_<i>.txt`` (``"{stem} rc={bool}"``
    a line) into ``outdir``, which then looks like merge_lists.py's output.

    ``auto_orientation``: "gated" (the default) decodes forward, then
    re-decodes in RC only the reads with no CRC-passing candidate; RC wins
    where it passes, or where neither passes and its top score is higher.
    ``"both"`` (or True) decodes every read both ways and keeps the higher
    top score; False decodes forward only. Every rank of the group calls it;
    it runs one ``all_reduce``.
    """
    dec = MultiHostDecoder(exp, list_size, rc=False,
                           max_deviation=max_deviation,
                           auto_orientation=bool(auto_orientation),
                           device=device)
    if not os.path.isdir(post_dir):
        raise FileNotFoundError(f"no directory {post_dir}")
    pid, nproc = dec.process_id, dec.num_processes
    post_files = sorted(glob.glob(os.path.join(post_dir, "*.post")))
    mine = post_files[pid::nproc]
    os.makedirs(outdir, exist_ok=True)
    gated = auto_orientation == "gated"
    num_oligos = 1 << exp.framing.index_len

    def batches(files):
        for lo in range(0, len(files), local_batch):
            part = files[lo:lo + local_batch]
            yield (part,) + pack_posts([read_post(f) for f in part])

    results = {}  # file -> [msgs, scores, ok, index, rc_used]
    for files, packed, nblks in batches(mine):
        if gated:
            out = _host(dec.sharded.decode_shard(packed, nblks, num_oligos))
            out.append(np.zeros(len(files), bool))
        else:
            out = dec.decode_local(packed, nblks, num_oligos)
        for j, f in enumerate(files):
            results[f] = [a[j] for a in out]

    if gated:
        # phase 2: only this rank's CRC-failed reads, in RC
        need = [f for f in mine if not results[f][2].any()]
        for files, packed, nblks in batches(need):
            msgs, sc, ok, index = _host(dec.sharded_rc.decode_shard(
                packed, nblks, num_oligos))
            for j, f in enumerate(files):
                # RC wins where it CRC-passes, or neither passes and RC's
                # top path score is higher (tie -> fwd)
                if ok[j].any() or sc[j, 0] > results[f][1][0]:
                    results[f] = [msgs[j], sc[j], ok[j], index[j], True]

    local_crc = 0
    info_lines = []
    for lo, f in enumerate(mine):
        msgs, sc, ok, index, rc_used = results[f]
        local_crc += int(ok.any())
        stem = os.path.basename(f)[: -len(".post")]
        suffix = stem.split("_")[-1]
        idx = int(suffix) if suffix.isdigit() else pid + lo * nproc
        lst = ["".join(map(str, m)) for m, v in zip(msgs, sc > -np.inf)
               if v]
        write_list_file(outdir, idx, lst[:list_size])
        info_lines.append(f"{stem} rc={bool(rc_used)}")
    # this rank's info shard (the reference's info_<i> files)
    with open(os.path.join(outdir, f"info_{pid}.txt"), "w") as fh:
        fh.write("".join(ln + "\n" for ln in info_lines))
    total = all_reduce_sum(torch.tensor(local_crc), dec.sharded.device)
    return JobResult(crc_pass=total, local_crc_pass=local_crc,
                     reads=len(mine), steps=dec.steps)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="nanopore_dna_storage_tpu_torch.parallel.multihost")
    ap.add_argument("--coordinator", required=False,
                    help="host:port of rank 0; without it torchrun's "
                         "environment (env://)")
    ap.add_argument("--num-processes", type=int)
    ap.add_argument("--process-id", type=int)
    ap.add_argument("--post-dir", required=True)
    ap.add_argument("--outdir", required=True)
    ap.add_argument("--experiment", type=int, default=7,
                    help="published experiment id 0..12; < 0 = custom via "
                         "--bytes-per-oligo/--mem/--rate")
    ap.add_argument("--bytes-per-oligo", type=int, default=18)
    ap.add_argument("--mem", type=int, default=11)
    ap.add_argument("--rate", type=int, default=5)
    ap.add_argument("--rs-redundancy", type=float, default=0.3)
    ap.add_argument("--pad", action="store_true")
    ap.add_argument("--list-size", type=int, default=8)
    ap.add_argument("--max-deviation", type=int, default=20)
    ap.add_argument("--local-batch", type=int, default=8)
    ap.add_argument("--orientation", default="gated",
                    choices=["gated", "both", "fwd"],
                    help="gated = decode fwd, re-decode CRC failures in RC "
                         "(default); both = decode every read both ways; "
                         "fwd = forward only")
    ap.add_argument("--no-auto-orientation", dest="orientation",
                    action="store_const", const="fwd",
                    help="alias for --orientation fwd")
    ap.add_argument("--device",
                    help="torch device of this rank (default "
                         "cuda:{LOCAL_RANK %% device count}; no fallback "
                         "to the CPU)")
    ap.add_argument("--dist-backend", choices=["nccl", "gloo"],
                    help="default nccl on a CUDA device, gloo on the CPU; "
                         "ranks sharing one card need gloo")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds the group's start and each collective "
                         "may wait")
    return ap


def main(argv=None) -> JobResult:
    from ..pipeline.experiments import experiment

    t_main = time.time()
    args = build_parser().parse_args(argv)
    device = torch.device(args.device) if args.device else default_device()
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda requested but CUDA is not available")
    t0 = time.perf_counter()
    rank, world = initialize(args.coordinator, args.num_processes,
                             args.process_id, backend=args.dist_backend,
                             device=device, timeout=args.timeout)
    init_s = time.perf_counter() - t0
    if args.experiment >= 0:
        exp = experiment(args.experiment)
    else:
        exp = ExperimentConfig(
            bytes_per_oligo=args.bytes_per_oligo,
            rs_redundancy=args.rs_redundancy,
            conv_mem=args.mem, conv_rate=args.rate, pad=args.pad)
    launches = profiling.counter("acs.launches")
    t0 = time.perf_counter()
    res = run_decode_job(args.post_dir, args.outdir, exp, args.list_size,
                         args.max_deviation, args.local_batch,
                         auto_orientation={"gated": "gated", "both": True,
                                           "fwd": False}[args.orientation],
                         device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    job_s = time.perf_counter() - t0
    backend = dist.get_backend()
    dist.destroy_process_group()
    print(f"process {rank}/{world} done; global crc_pass={res.crc_pass}")
    print(json.dumps({"rank": rank, "world": world, "backend": backend,
                      "device": str(device), **dataclasses.asdict(res),
                      "k1_launches": profiling.counter("acs.launches")
                      - launches,
                      "t_main": t_main, "init_s": init_s, "job_s": job_s,
                      "peak_gib": torch.cuda.max_memory_allocated(device)
                      / 2**30 if device.type == "cuda" else None}),
          flush=True)
    return res


if __name__ == "__main__":
    main()
