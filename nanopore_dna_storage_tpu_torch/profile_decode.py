"""Where a decode's time goes on one CUDA device, at the headline config.

    python -m nanopore_dna_storage_tpu_torch.profile_decode [--reads 24]

Simulates reads of experiment 7 (m=11, r=5/6, msg_len 180, L=8, max
deviation 20) from ``--seed`` and prints:

1. forward versus the rest of a decode (traceback, final ordering, the copy
   to the host): for each B of ``--batches``, two decodes of the first B
   forward-orientation reads, split where the last ACS launch finishes;
2. the ACS kernel alone: ms per block step at B=1 and at the largest B, by
   CUDA events over ``--launches`` launches on the state of a block in the
   middle of the reads, three repeats;
3. one ``PipelineDecoder.decode_posts`` of the first B simulated reads,
   whatever their orientations, under ``torch.profiler``: wall time, device
   time summed over the device's kernels and copies, the device's idle
   share, and the busiest device operations.
"""
from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from nanopore_dna_storage_tpu.io.post import pack_posts

from .config import ConvCodeConfig, DecodeConfig
from .ops.lva import LVADecoder
from .ops.lva_acs import acs_block
from .pipeline import encode_bytes, experiment
from .pipeline.decode import PipelineDecoder
from .pipeline.simulate import simulate_posts


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` in ms, by CUDA events over ``reps``."""
    fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


class Probe:
    """ACS step that runs the kernel, notes when the forward's last launch
    has finished, and times the kernel alone at block ``timed``."""

    def __init__(self, nblocks: int, timed: int = -1, launches: int = 0):
        self.nblocks, self.timed, self.launches = nblocks, timed, launches
        self.n = 0
        self.t_fwd = None
        self.ms = []

    def __call__(self, tabs, prev, stale, *args):
        if self.n == self.timed:
            scratch = [x.clone() for x in stale]
            self.ms = [cuda_ms(lambda: acs_block(tabs, prev, scratch, *args),
                               self.launches) for _ in range(3)]
        acs_block(tabs, prev, stale, *args)
        self.n += 1
        if self.n == self.nblocks:
            torch.cuda.synchronize()
            self.t_fwd = time.perf_counter()
        return args[-1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="nanopore_dna_storage_tpu_torch.profile_decode")
    ap.add_argument("--reads", type=int, default=24,
                    help="reads simulated; the forward-orientation ones "
                         "must number at least the largest batch")
    ap.add_argument("--batches", default="1,2,4,8")
    ap.add_argument("--launches", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_decode needs a CUDA device")
    batches = [int(b) for b in args.batches.split(",")]
    gpu = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"gpu: {gpu}; torch {torch.__version__} cuda {torch.version.cuda}")

    exp = experiment(7)
    data = np.random.default_rng(args.seed).integers(
        0, 256, 100, dtype=np.uint8).tobytes()
    enc = encode_bytes(data, exp)
    posts, rcs, _ = simulate_posts(enc.oligos, args.reads,
                                   np.random.default_rng(args.seed + 1))
    fwd = [p for p, rc in zip(posts, rcs) if not rc]
    if len(fwd) < max(batches):
        raise SystemExit(f"{len(fwd)} forward reads for a batch of "
                         f"{max(batches)}: raise --reads")
    dec = LVADecoder(DecodeConfig(
        code=ConvCodeConfig(mem=exp.conv_mem, rate=exp.conv_rate,
                            msg_len=exp.msg_len()),
        list_size=8, max_deviation=20), device="cuda")
    print(f"forward reads {len(fwd)}: nblk {[len(p) for p in fwd]}")

    def decode(B, probe_args=()):
        batch, nblks = pack_posts(fwd[:B])
        probe = Probe(int(nblks.max()), *probe_args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dec.decode(batch, nblks, acs=probe)
        return probe, t0, time.perf_counter(), int(nblks.max())

    decode(1)  # build and load the kernel, warm the allocator
    for B in batches:
        for _ in range(2):
            probe, t0, t1, T = decode(B)
            f = probe.t_fwd - t0
            print(f"B={B} T={T}: forward {f:.4f} s ({1e3 * f / T:.4f} "
                  f"ms/block), traceback and ordering {t1 - probe.t_fwd:.4f} "
                  f"s, whole decode {t1 - t0:.4f} s = {(t1 - t0) / B:.4f} "
                  f"s/read")
    for B in sorted({1, max(batches)}):
        probe = decode(B, (min(map(len, fwd[:B])) // 2, args.launches))[0]
        for ms in probe.ms:
            print(f"kernel B={B}: {ms:.4f} ms/block ({ms / B:.4f} ms per "
                  f"read-block), {args.launches} launches at block "
                  f"{probe.timed}")

    B = max(batches)
    pdec = PipelineDecoder(exp, 8, 20, device="cuda")
    num_oligos = enc.num_oligos_data + enc.num_oligos_rs
    pdec.decode_posts(posts[:B], rcs[:B], num_oligos)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pdec.decode_posts(posts[:B], rcs[:B], num_oligos)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ka = prof.key_averages()
    on_dev = [e for e in ka if e.device_type == DeviceType.CUDA]
    dev_s = sum(e.self_device_time_total for e in on_dev) / 1e6
    print(f"profiled decode_posts of {B} reads ({int(rcs[:B].sum())} rc): "
          f"wall {wall:.4f} s, device time {dev_s:.4f} s, device idle share "
          f"{1 - dev_s / wall:.4f}")
    for e in sorted(on_dev, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e6:.4f} s "
              f"({100 * e.self_device_time_total / 1e6 / dev_s:.2f}%) "
              f"{e.count} calls: {e.key[:90]}")
    print(f"gpu: {gpu}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
