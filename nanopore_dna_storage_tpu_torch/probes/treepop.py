"""Max plus the winner's payload over the candidate axis, in four index
orders, on a CUDA card.

Counterpart of ``scripts/tpu_treepop_probe.py``, which probed which
construct of a tree-pop merge the TPU compiler took. Over scores f32
[NC, F, CT] and int32 payloads of the same shape, each variant returns the
maximal score of every (f, ct) column and the payload of the candidate it
picked:

* ``argmax``: the first maximum in index order;
* ``reshape_pair``: a tree of adjacent pairs (2i, 2i+1);
* ``halves``: a tree pairing i with i + n/2 (so on ties it may pick
  another candidate than the first maximum: "index order differs");
* ``concat``: the adjacent-pair tree over the first 60 candidates, an odd
  level carrying its last entry.

In every pair the second candidate wins only if strictly greater.
``run_when`` runs the pair tree behind a guard on the data
(``x[0, 0, 0] < 1e9``), the structure of the production kernel; when the
guard fails the outputs are zero.

On the card a column's 64 candidates lie in registers over 1, 2, 4 or 8
lanes (``LANES``): each lane runs its part of the variant's tree, shuffles
finish it; by default the kernel takes the fewest lanes that give every SM
a block (``auto_lanes``).

    python -m nanopore_dna_storage_tpu_torch.probes.treepop \\
        [variant ...] [--when CT ...]
"""
from __future__ import annotations

import argparse
import ctypes
from typing import Tuple

import numpy as np
import torch

from ..ops._build import check_tensor, load_probes

NC, F, CT = 64, 8, 128
VARIANTS = ("argmax", "reshape_pair", "halves", "concat")
CONCAT_N = 60  # the concat variant's odd-length start
GUARD = 1e9
LANES = (1, 2, 4, 8)  # lanes a column, the kernels built

# Kernel launches made through ``treepop`` (CUDA tensors only).
LAUNCHES = 0

Pair = Tuple[torch.Tensor, torch.Tensor]


def treepop_ref(x: torch.Tensor, h: torch.Tensor, variant: str,
                guarded: bool = False) -> Pair:
    """Plain PyTorch tree pop: scores f32 [N, F, CT], payloads int32 of the
    same shape -> (value f32 [F, CT], payload int32 [F, CT])."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    if guarded and not bool(x[0, 0, 0] < GUARD):
        return torch.zeros_like(x[0]), torch.zeros_like(h[0])
    if variant == "argmax":
        bq = x.argmax(0, keepdim=True)  # the first maximum
        return x.amax(0), h.gather(0, bq)[0]
    if variant == "concat":
        x, h = x[:CONCAT_N], h[:CONCAT_N]
    while x.shape[0] > 1:
        n = x.shape[0]
        m = n // 2
        if variant == "halves":  # an odd last entry drops
            a, b, ha, hb = x[:m], x[m:2 * m], h[:m], h[m:2 * m]
        else:
            a, b, ha, hb = x[0:2 * m:2], x[1:2 * m:2], h[0:2 * m:2], \
                h[1:2 * m:2]
        tk = b > a
        y, z = torch.where(tk, b, a), torch.where(tk, hb, ha)
        if variant == "concat" and 2 * m < n:  # carry the odd one out
            y, z = torch.cat([y, x[2 * m:]]), torch.cat([z, h[2 * m:]])
        x, h = y, z
    return x[0], h[0]


def treepop(x: torch.Tensor, h: torch.Tensor, variant: str,
            guarded: bool = False, lanes: int = 0) -> Pair:
    """The tree pop of ``variant`` over scores f32 [NC <= 64, F, CT] and
    payloads int32 of the same shape. CPU tensors run ``treepop_ref``; CUDA
    tensors launch the kernel of ``csrc/probes.cu`` at ``lanes`` lanes a
    column (one of ``LANES``, or 0 for ``auto_lanes``); anything else
    raises."""
    global LAUNCHES
    dev = x.device
    if lanes not in (0, *LANES):
        raise ValueError(f"lanes must be 0 or one of {LANES}, not {lanes}")
    if dev.type == "cpu":
        return treepop_ref(x, h, variant, guarded)
    if dev.type != "cuda":
        raise ValueError(f"treepop runs on cpu or cuda, not {dev}")
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    if x.dim() != 3 or not 1 <= x.shape[0] <= 64:
        raise ValueError(f"treepop takes [NC <= 64, F, CT] scores, "
                         f"not {tuple(x.shape)}")
    nc, f, ct = x.shape
    check_tensor("x", x, torch.float32, x.shape, dev)
    check_tensor("h", h, torch.int32, x.shape, dev)
    out = torch.empty((f, ct), dtype=torch.float32, device=dev)
    out_h = torch.empty((f, ct), dtype=torch.int32, device=dev)
    lib = load_probes()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.probe_treepop_launch(
            x.data_ptr(), h.data_ptr(), out.data_ptr(), out_h.data_ptr(), nc,
            f * ct, VARIANTS.index(variant), int(guarded), lanes, stream)
    if err != 0:
        raise RuntimeError("probe treepop launch failed: "
                           + lib.probe_error_string(err).decode())
    LAUNCHES += 1
    return out, out_h


def auto_lanes(ncol: int) -> int:
    """The lanes a column ``treepop`` takes by default over ``ncol`` (F x
    CT) columns on the current CUDA device: the fewest that give every SM a
    block, at most 8."""
    g = load_probes().probe_treepop_lanes(ncol)
    if g == 0:
        raise RuntimeError("treepop: the device query failed")
    return g


def treepop_info(variant: str, lanes: int) -> dict:
    """Registers, local memory in bytes (stack frame and spills) and
    resident threads per SM of the tree-pop kernel of ``variant`` at
    ``lanes`` lanes a column, on the current CUDA device."""
    if variant not in VARIANTS or lanes not in LANES:
        raise ValueError(f"no tree-pop kernel for {variant!r} at {lanes} "
                         f"lanes")
    lib = load_probes()
    out = (ctypes.c_int * 3)()
    err = lib.probe_treepop_info(VARIANTS.index(variant), lanes, out)
    if err != 0:
        raise RuntimeError("treepop info failed: "
                           + lib.probe_error_string(err).decode())
    return {"registers": out[0], "local_bytes": out[1],
            "threads_per_sm": out[2]}


def _inputs(ct: int, device: str):
    x = np.random.default_rng(0).normal(size=(NC, F, ct)).astype(np.float32)
    h = np.arange(NC * F * ct, dtype=np.int32).reshape(NC, F, ct)
    return x, h, torch.from_numpy(x).to(device), torch.from_numpy(h).to(device)


def _check(name: str, x, h, n: int, o: torch.Tensor,
           oh: torch.Tensor) -> bool:
    """The script's check against numpy, with the value held exactly."""
    arg = x[:n].argmax(0)
    ok_v = np.array_equal(o.cpu().numpy(), x[:n].max(0))
    ok_h = np.array_equal(oh.cpu().numpy(),
                          np.take_along_axis(h[:n], arg[None], 0)[0])
    print(f"{name}: value_ok={ok_v} payload_ok={ok_h}", flush=True)
    return ok_v and ok_h


def run(variant: str, device: str = "cuda") -> bool:
    """One variant at [NC, F, CT] on random normal scores and payloads
    0, 1, 2, ...; True if value and payload match numpy's first argmax."""
    x, h, xt, ht = _inputs(CT, device)
    o, oh = treepop(xt, ht, variant)
    return _check(variant, x, h, CONCAT_N if variant == "concat" else NC,
                  o, oh)


def run_when(ct: int, device: str = "cuda") -> bool:
    """The guarded adjacent-pair tree at [NC, F, ct]."""
    x, h, xt, ht = _inputs(ct, device)
    o, oh = treepop(xt, ht, "reshape_pair", guarded=True)
    return _check(f"when ct={ct}", x, h, NC, o, oh)


def main(argv=None) -> bool:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", metavar="variant",
                    help=f"any of {', '.join(VARIANTS)} (default "
                    f"reshape_pair)")
    ap.add_argument("--when", type=int, action="append", default=[],
                    metavar="CT", help="also run the guarded pair tree at "
                    "this CT (repeatable)")
    args = ap.parse_args(argv)
    variants = args.variants or ["reshape_pair"]
    bad = sorted(set(variants) - set(VARIANTS))
    if bad:
        ap.error(f"unknown variants {bad}")
    if not torch.cuda.is_available():
        raise SystemExit("treepop: needs a CUDA device")
    ok = [run(v) for v in variants]
    ok += [run_when(ct) for ct in args.when]
    return all(ok)


if __name__ == "__main__":
    raise SystemExit(0 if main() else 1)
