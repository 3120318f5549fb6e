"""The lane map's shuffle and gather forms and the transpose of several
trees of this repository, timed in turns on one CUDA card.

    python -m nanopore_dna_storage_tpu_torch.probes.expand_turns \\
        --roots build/parent . . build/parent

For each root in order this runs one process with that root on
``PYTHONPATH``, so that it imports, builds and launches that root's
``probes/expand.py`` (whose ``lane_map``, ``transpose`` and ``graph_us``
every tree since the expansion probes were ported shares). The process
holds each kernel's output bit-equal to one PyTorch call computing the
same copies, times kernel and library call at one copy (CUDA graphs of
``GRAPH_CALLS`` calls) and at many (CUDA events), and prints one JSON line;
then this prints every root's numbers side by side. Two trees compare only
inside one run: the order parent, this, this, parent spreads the card's
drift over both.

Points: the element map at [8, 2048] k = 4 (P3, P4) by ``shfl`` and
``gather``, one copy and ``LANE_COPIES``; ``shfl`` at [8, 1024] k = 2 (P2),
one copy; the transpose at [16, 128] (P2's ``p_transpose``), one copy and
``TRANSPOSE_COPIES``. Library calls: ``repeat_interleave`` of the sources
and ``t().contiguous()`` at one copy; one copy kernel of a broadcast view
(``expand(...).reshape`` / ``expand(...).contiguous()``) at many.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys

LANE_COPIES = 4096
TRANSPOSE_COPIES = 32768
# CUDA-event timing of the many-copy points: warm-up calls, then calls timed
WARMUP, REPS = 2, 20


def _events_ms(torch, fn) -> float:
    for _ in range(WARMUP):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(REPS):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / REPS


def measure() -> dict:
    """This process's tree: every point's kernel and library times, ms,
    after its bit-for-bit check against the library call."""
    import numpy as np
    import torch

    from nanopore_dna_storage_tpu_torch.probes import expand

    def same(name, a, b):
        if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            raise SystemExit(f"expand_turns: {name} differs from the "
                             f"library call")

    rng = np.random.default_rng(0)
    out = {"gpu": torch.cuda.get_device_name(0)}
    for k, cols, many in ((4, 2048, LANE_COPIES), (2, 1024, 0)):
        x = torch.from_numpy(rng.standard_normal((8, cols)).astype(
            np.float32)).cuda()
        n = cols // k

        def one():
            return torch.repeat_interleave(x[:, :n], k, dim=1,
                                           output_size=cols)

        def copies():
            return x[:, :n, None].expand(8, n, k)[None].expand(
                many, 8, n, k).reshape(many, 8, cols)

        for form in ("shfl", "gather") if many else ("shfl",):
            def kernel(G=1):
                return expand.lane_map(x, "element", k, form, G)
            same(f"{form} k={k}", kernel()[0], one())
            out[f"{form}_k{k}_x1_ms"] = expand.graph_us(kernel) / 1e3
            if many:
                same(f"{form} k={k} x {many}", kernel(many), copies())
                out[f"{form}_k{k}_x{many}_ms"] = _events_ms(
                    torch, lambda: kernel(many))
        out[f"library_k{k}_x1_ms"] = expand.graph_us(one) / 1e3
        if many:
            out[f"library_k{k}_x{many}_ms"] = _events_ms(torch, copies)
        torch.cuda.empty_cache()
    x = torch.from_numpy(rng.standard_normal((16, 128)).astype(
        np.float32)).cuda()
    G = TRANSPOSE_COPIES

    def transposed():
        return x.t()[None].expand(G, 128, 16).contiguous()

    same("transpose", expand.transpose(x)[0], x.t().contiguous())
    same(f"transpose x {G}", expand.transpose(x, G), transposed())
    out["transpose_x1_ms"] = expand.graph_us(
        lambda: expand.transpose(x)) / 1e3
    out["library_transpose_x1_ms"] = expand.graph_us(
        lambda: x.t().contiguous()) / 1e3
    out[f"transpose_x{G}_ms"] = _events_ms(
        torch, lambda: expand.transpose(x, G))
    out[f"library_transpose_x{G}_ms"] = _events_ms(torch, transposed)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--roots", nargs="+", default=["."],
                    help="checkouts of this repository, timed in this order")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        import torch
        if not torch.cuda.is_available():
            raise SystemExit("expand_turns: needs a CUDA device")
        print(json.dumps(measure()), flush=True)
        return 0
    rows = []
    for root in args.roots:
        root = pathlib.Path(root).resolve()
        env = dict(os.environ, PYTHONPATH=str(root))
        res = subprocess.run([sys.executable, __file__, "--child"], cwd=root,
                             env=env, capture_output=True, text=True,
                             timeout=600)
        sys.stderr.write(res.stderr)
        if res.returncode != 0:
            print(f"expand_turns: {root} failed (exit {res.returncode})",
                  file=sys.stderr)
            return 1
        rows.append((str(root), json.loads(res.stdout.strip().splitlines()
                                           [-1])))
        print(json.dumps({"root": rows[-1][0], **rows[-1][1]}), flush=True)
    keys = [k for k in rows[0][1] if k.endswith("_ms")]
    for k in keys:
        print(f"{k:28s}" + "".join(f" {r[1].get(k, float('nan')):.6f}"
                                   for r in rows))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
