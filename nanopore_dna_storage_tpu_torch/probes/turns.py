"""The logsumexp ACS step, the reshape copy and the merge and stream probes
of several trees of this repository, timed in turns on one CUDA card.

    python -m nanopore_dna_storage_tpu_torch.probes.turns \\
        --roots build/parent . . build/parent

For each root in order this runs one process with that root on
``PYTHONPATH``, so that it imports, builds and launches that root's kernels
through APIs every tree since the lse kernel was ported shares
(``LVADecoder``, ``acs_block_lse``, ``lse_kernel_info``; ``reshape``,
``graph_us``; ``merge_roofline.merge``, ``stream`` and their plain
versions), and prints one JSON line; then this prints every root's numbers
side by side, and each root's stream kernel's SASS mix per element and
round (this tree's ``merge_roofline.stream_mix`` on the library that root
built). Two trees compare only inside one run: the order parent, this,
this, parent spreads the card's drift over both.

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
  calls after ``WARMUP`` by CUDA events, ``REPEATS`` times.
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


def measure(reads: int, seed: int) -> dict:
    """This process's tree: every point's times, ms."""
    import torch

    return {"gpu": torch.cuda.get_device_name(0),
            **reshape_points(torch), **lse_points(torch, reads, seed),
            **probe_points(torch, seed)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--roots", nargs="+", default=["."],
                    help="checkouts of this repository, timed in this order")
    ap.add_argument("--reads", type=int, default=24,
                    help="reads simulated; the forward-orientation ones "
                         "must number at least 4")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        import torch
        if not torch.cuda.is_available():
            raise SystemExit("turns: needs a CUDA device")
        print(json.dumps(measure(args.reads, args.seed)), flush=True)
        return 0
    rows = []
    for root in args.roots:
        root = pathlib.Path(root).resolve()
        env = dict(os.environ, PYTHONPATH=str(root))
        res = subprocess.run([sys.executable, __file__, "--child",
                              "--reads", str(args.reads), "--seed",
                              str(args.seed)], cwd=root, env=env,
                             capture_output=True, text=True, timeout=900)
        sys.stderr.write(res.stderr)
        if res.returncode != 0:
            print(f"turns: {root} failed (exit {res.returncode})",
                  file=sys.stderr)
            return 1
        rows.append((str(root), json.loads(res.stdout.strip().splitlines()
                                           [-1])))
        print(json.dumps({"root": rows[-1][0], **rows[-1][1]}), flush=True)
    for k in [k for k in rows[0][1] if k.endswith("_ms")]:
        cells = []
        for _, r in rows:
            v = r.get(k, float("nan"))
            cells.append("/".join(f"{x:.4f}" for x in v)
                         if isinstance(v, list) else f"{v:.6f}")
        print(f"{k:18s} " + "  ".join(cells))
    print(f"{'lse_L8':18s} " + "  ".join(json.dumps(r["lse_L8"])
                                           for _, r in rows))
    from nanopore_dna_storage_tpu_torch.probes import merge_roofline
    for root, r in rows:
        mix = merge_roofline.stream_mix(merge_roofline.sass(r["probes_lib"]))
        print(json.dumps({"root": root, "stream_sass_per_element_round": mix}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
