"""The logsumexp ACS step, the reshape copy, the merge and stream probes,
the tree pop and the fori probe of several trees of this repository, timed
in turns on one CUDA card.

    python -m nanopore_dna_storage_tpu_torch.probes.turns \\
        --roots build/parent . . build/parent [--points treepop fori ...]

For each root in order this runs one process with that root on
``PYTHONPATH``, so that it imports, builds and launches that root's kernels
through APIs every tree since the lse kernel was ported shares
(``LVADecoder``, ``acs_block_lse``, ``lse_kernel_info``; ``reshape``,
``graph_us``; ``merge_roofline.merge``, ``stream`` and their plain
versions; ``treepop.treepop``, ``treepop_ref``; ``lowering.fori``,
``fori_ref``), and prints one JSON line; then this prints every root's
numbers side by side, and each root's stream kernel's SASS mix per element
and round (this tree's ``merge_roofline.stream_mix`` on the library that
root built). Two trees compare only inside one run: the order parent,
this, this, parent spreads the card's drift over both. ``--points`` picks
some of the points below (``POINTS``; all by default).

Points, each output held bit-equal to its plain version before it is
timed:

* the lse step (``acs_block_lse``) at the headline config (experiment 7,
  L=8, max deviation 20) at B=1 and B=4: the first B forward reads of
  ``--reads`` simulated from ``--seed`` decoded with ``path_combine=
  "logsumexp"``, the step timed on the state of the block in the middle of
  the shortest read, as ``profile_decode.py`` times K1: ``LAUNCHES``
  launches by CUDA events, ``REPEATS`` times; with the kernel's registers,
  local bytes and threads per SM at L = 8;
* the reshape copy (``lowering.reshape``) at the script's [8, 8, 1024]
  from CUDA graphs (``graph_us``) and at ``RESHAPE_LARGE`` by CUDA events
  over ``REPS`` calls after ``WARMUP``, each beside ``clone`` of the same
  tensor;
* the merge and stream probes at [64, 8, 512] x 256 copies and 8 rounds,
  every copy held bit-equal to the plain version of one, then ``REPS``
  calls after ``WARMUP`` by CUDA events, ``REPEATS`` times;
* the tree pop, every variant, at [64, 8, 128] from CUDA graphs and at
  ``TREEPOP_LARGE`` by CUDA events (``REPS`` calls after ``WARMUP``,
  ``REPEATS`` times), each held bit-equal to ``treepop_ref`` first;
* the fori probe in its regs placement at both ``FORI_POINTS`` from CUDA
  graphs, and regs and local over ``FORI_COPIES`` copies by CUDA events,
  each held bit-equal to ``fori_ref`` first; and, where the tree has it,
  the launch floor (``launch_floor_us``).
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys

# the lse step: launches per timing, timings per point
LAUNCHES, REPEATS = 50, 3
# the large copy: warm-up calls, then calls timed
WARMUP, REPS = 2, 20
RESHAPE_SMALL = (8, 8, 1024)
RESHAPE_LARGE = (8, 8, 1 << 20)
# the merge and stream probes: rounds and copies
PROBE_ROUNDS, PROBE_COPIES = 8, 256
# the tree pop past launch latency: 128 MiB of inputs
TREEPOP_LARGE = (64, 8, 32768)
POINTS = ("reshape", "lse", "probes", "treepop", "fori")


def _events_ms(torch, fn, warmup: int, reps: int) -> float:
    for _ in range(warmup):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def lse_points(torch, reads: int, seed: int, batches=(1, 4)) -> dict:
    """The lse step's times (ms per block step) at each B of ``batches``,
    after the kernel's output at the timed block is held bit-equal to
    ``acs_block_lse_ref``."""
    import numpy as np

    from nanopore_dna_storage_tpu_torch.config import (ConvCodeConfig,
                                                       DecodeConfig)
    from nanopore_dna_storage_tpu_torch.io.post import pack_posts
    from nanopore_dna_storage_tpu_torch.ops import lva_acs
    from nanopore_dna_storage_tpu_torch.ops.lva import LVADecoder
    from nanopore_dna_storage_tpu_torch.pipeline import (encode_bytes,
                                                         experiment)
    from nanopore_dna_storage_tpu_torch.pipeline.simulate import \
        simulate_posts

    exp = experiment(7)
    data = np.random.default_rng(seed).integers(
        0, 256, 100, dtype=np.uint8).tobytes()
    enc = encode_bytes(data, exp)
    posts, rcs, _ = simulate_posts(enc.oligos, reads,
                                   np.random.default_rng(seed + 1))
    fwd = [p for p, rc in zip(posts, rcs) if not rc]
    if len(fwd) < max(batches):
        raise SystemExit(f"turns: {len(fwd)} forward reads for a batch of "
                         f"{max(batches)}: raise --reads")
    dec = LVADecoder(DecodeConfig(
        code=ConvCodeConfig(mem=exp.conv_mem, rate=exp.conv_rate,
                            msg_len=exp.msg_len()),
        list_size=8, max_deviation=20, path_combine="logsumexp"),
        device="cuda")
    out = {}
    for B in batches:
        timed = min(map(len, fwd[:B])) // 2
        ms, done = [], [0]

        def step(tabs, prev, stale, *args):
            if done[0] == timed:
                scratch = [x.clone() for x in stale]
                want = [x.clone() for x in stale]
                sel = torch.empty_like(args[-1])
                want_sel = torch.empty_like(sel)
                lva_acs.acs_block_lse(tabs, prev, scratch, *args[:-1], sel)
                lva_acs.acs_block_lse_ref(tabs, prev, want, *args[:-1],
                                          want_sel)
                if not (all(torch.equal(x.view(torch.int32),
                                        y.view(torch.int32))
                            for x, y in zip(scratch, want))
                        and torch.equal(sel, want_sel)):
                    raise SystemExit(f"turns: the lse kernel differs from "
                                     f"acs_block_lse_ref at B={B}")
                ms.extend(_events_ms(torch, lambda: lva_acs.acs_block_lse(
                    tabs, prev, scratch, *args[:-1], sel), 1, LAUNCHES)
                    for _ in range(REPEATS))
            done[0] += 1
            return lva_acs.acs_block_lse(tabs, prev, stale, *args)

        batch, nblks = pack_posts(fwd[:B])
        dec.decode(batch, nblks, acs=step)
        out[f"lse_B{B}_ms"] = ms
    out["lse_L8"] = lva_acs.lse_kernel_info(8)
    return out


def reshape_points(torch) -> dict:
    """The reshape copy and ``clone`` at both shapes, ms, after the copy is
    held bit-equal to ``reshape_ref``."""
    from nanopore_dna_storage_tpu_torch.probes import expand, lowering

    out = {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, shape in (("small", RESHAPE_SMALL), ("large", RESHAPE_LARGE)):
        x = torch.randn(shape, device="cuda", generator=gen)
        if not torch.equal(lowering.reshape(x).view(torch.int32),
                           lowering.reshape_ref(x).view(torch.int32)):
            raise SystemExit(f"turns: the reshape copy differs from "
                             f"reshape_ref at {list(shape)}")

        def kernel():
            return lowering.reshape(x)

        def clone():
            return x.view(-1, shape[-1]).clone()

        if name == "small":
            out["reshape_small_ms"] = expand.graph_us(kernel) / 1e3
            out["clone_small_ms"] = expand.graph_us(clone) / 1e3
        else:
            out["reshape_large_ms"] = _events_ms(torch, kernel, WARMUP, REPS)
            out["clone_large_ms"] = _events_ms(torch, clone, WARMUP, REPS)
        del x
        torch.cuda.empty_cache()
    return out


def probe_points(torch, seed: int) -> dict:
    """The merge and stream probes' times (ms a call), after every copy is
    held bit-equal to the plain version, and the library they came from."""
    import numpy as np

    from nanopore_dna_storage_tpu_torch.ops import _build
    from nanopore_dna_storage_tpu_torch.probes import merge_roofline as mr

    rng = np.random.default_rng(seed)
    shape = (mr.NC, mr.F, mr.CT)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).cuda()
    h1, h2 = (torch.from_numpy(rng.integers(0, 1 << 30, shape, dtype=np.int64)
                               .astype(np.int32)).cuda() for _ in range(2))
    out = {}
    for kind in ("merge", "stream"):
        fn, ref = getattr(mr, kind), getattr(mr, f"{kind}_ref")
        got = fn(x, h1, h2, PROBE_ROUNDS, PROBE_COPIES)
        want = ref(x, h1, h2, PROBE_ROUNDS).expand_as(got)
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise SystemExit(f"turns: the {kind} probe differs from its "
                             f"plain version")
        out[f"{kind}_ms"] = [_events_ms(torch, lambda: fn(
            x, h1, h2, PROBE_ROUNDS, PROBE_COPIES), WARMUP, REPS)
            for _ in range(REPEATS)]
    out["probes_lib"] = str(_build.build("probes", ["probes.cu"]))
    return out


def _bits_equal(torch, a, b) -> bool:
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


def treepop_points(torch, seed: int) -> dict:
    """Every tree-pop variant's time (ms a call) at [64, 8, 128] from CUDA
    graphs and at ``TREEPOP_LARGE`` by CUDA events, each after the kernel's
    value and payload are held bit-equal to ``treepop_ref``."""
    import numpy as np

    from nanopore_dna_storage_tpu_torch.probes import expand, treepop

    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in (("small", (64, 8, 128)), ("large", TREEPOP_LARGE)):
        x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).cuda()
        h = torch.from_numpy(rng.permutation(x.numel()).astype(np.int32)
                             .reshape(shape)).cuda()
        for v in treepop.VARIANTS:
            got = treepop.treepop(x, h, v)
            want = treepop.treepop_ref(x, h, v)
            if not all(_bits_equal(torch, a, b) for a, b in zip(got, want)):
                raise SystemExit(f"turns: the tree pop {v} differs from "
                                 f"treepop_ref at {list(shape)}")

            def call():
                return treepop.treepop(x, h, v)

            out[f"treepop_{v}_{name}_ms"] = (
                expand.graph_us(call) / 1e3 if name == "small"
                else [_events_ms(torch, call, WARMUP, REPS)
                      for _ in range(REPEATS)])
        del x, h
        torch.cuda.empty_cache()
    return out


def fori_points(torch, seed: int) -> dict:
    """fori regs at both ``FORI_POINTS`` (ms a call, CUDA graphs), regs and
    local over ``FORI_COPIES`` copies (CUDA events), each after the result
    is held bit-equal to ``fori_ref``; and the launch floor, where the tree
    has it."""
    import numpy as np

    from nanopore_dna_storage_tpu_torch.probes import expand
    from nanopore_dna_storage_tpu_torch.probes import lowering as lo

    rng = np.random.default_rng(seed)
    out = {}
    for nq, rounds in lo.FORI_POINTS:
        x = torch.from_numpy(rng.standard_normal((nq, 1024)).astype(
            np.float32)).cuda()
        h = torch.full((nq, 1024), 3, dtype=torch.int32, device="cuda")
        want = lo.fori_ref(x, h, rounds)
        for placement, copies in (("regs", 1), ("regs", lo.FORI_COPIES),
                                  ("local", lo.FORI_COPIES)):
            def call():
                return lo.fori(x, h, rounds, placement, copies)

            got = call()
            if not _bits_equal(torch, got, want.expand_as(got)):
                raise SystemExit(f"turns: fori {placement} differs from "
                                 f"fori_ref at NQ={nq}")
            key = f"fori_{placement}_{nq}x{rounds}"
            if copies == 1:
                out[f"{key}_ms"] = expand.graph_us(call) / 1e3
            else:
                out[f"{key}_copies_ms"] = _events_ms(torch, call, WARMUP,
                                                     REPS)
    if hasattr(lo, "launch_floor_us"):
        out["launch_floor_ms"] = lo.launch_floor_us() / 1e3
    return out


def measure(reads: int, seed: int, points) -> dict:
    """This process's tree: the times of ``points``, ms."""
    import torch

    out = {"gpu": torch.cuda.get_device_name(0)}
    if "reshape" in points:
        out.update(reshape_points(torch))
    if "lse" in points:
        out.update(lse_points(torch, reads, seed))
    if "probes" in points:
        out.update(probe_points(torch, seed))
    if "treepop" in points:
        out.update(treepop_points(torch, seed))
    if "fori" in points:
        out.update(fori_points(torch, seed))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--roots", nargs="+", default=["."],
                    help="checkouts of this repository, timed in this order")
    ap.add_argument("--reads", type=int, default=24,
                    help="reads simulated; the forward-orientation ones "
                         "must number at least 4")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--points", nargs="+", choices=POINTS, default=POINTS,
                    help="the points timed (default all)")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        import torch
        if not torch.cuda.is_available():
            raise SystemExit("turns: needs a CUDA device")
        print(json.dumps(measure(args.reads, args.seed, args.points)),
              flush=True)
        return 0
    rows = []
    for root in args.roots:
        root = pathlib.Path(root).resolve()
        env = dict(os.environ, PYTHONPATH=str(root))
        res = subprocess.run([sys.executable, __file__, "--child",
                              "--reads", str(args.reads), "--seed",
                              str(args.seed), "--points", *args.points],
                             cwd=root, env=env, capture_output=True,
                             text=True, timeout=900)
        sys.stderr.write(res.stderr)
        if res.returncode != 0:
            print(f"turns: {root} failed (exit {res.returncode})",
                  file=sys.stderr)
            return 1
        rows.append((str(root), json.loads(res.stdout.strip().splitlines()
                                           [-1])))
        print(json.dumps({"root": rows[-1][0], **rows[-1][1]}), flush=True)
    keys = dict.fromkeys(k for _, r in rows for k in r if k.endswith("_ms"))
    for k in keys:
        cells = []
        for _, r in rows:
            v = r.get(k, float("nan"))
            cells.append("/".join(f"{x:.4f}" for x in v)
                         if isinstance(v, list) else f"{v:.6f}")
        print(f"{k:30s} " + "  ".join(cells))
    if "lse" in args.points:
        print(f"{'lse_L8':18s} " + "  ".join(json.dumps(r["lse_L8"])
                                               for _, r in rows))
    if "probes" in args.points:
        from nanopore_dna_storage_tpu_torch.probes import merge_roofline
        for root, r in rows:
            mix = merge_roofline.stream_mix(merge_roofline.sass(
                r["probes_lib"]))
            print(json.dumps({"root": root,
                              "stream_sass_per_element_round": mix}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
