"""Empirical lane roofline of the suppression-merge op pattern on a CUDA card.

Counterpart of ``scripts/tpu_vpu_roofline.py``. It measures which rate the
card sustains, in element-ops per second, on two kernels over the merge's
array shape [NC, F, CT]:

1. ``stream``: 12 independent elementwise max / add / select ops per
   element and round, the best case for that op count;
2. ``merge``: the exact round of the production suppression merge (max,
   first argmax, the winner's two hashes, dual-hash knockout), its
   dependency chain included, with a column's 64 candidates held in
   registers over ``MERGE_LANES`` threads.

Each rate has two shares. ``pct_of_lane_peak`` reads it against
``lane_peak()``, the card's FP32 lanes times its clock, as the TPU probe
read its VPU peak: every op counted at the FP32 rate. ``pct_of_pipe_floor``
reads the kernel's time against ``pipe_floor``: its SASS instructions
(``cuobjdump``) at the issue rate measured for each kind on the card
(``issue_rates``), compares, selects and min / max on the ALU pipe.
``acs_work_ops``, ``acs_executed_ops`` and ``acs_needed_ops`` count an ACS
block step's work in the element-op unit: as ``bench.py`` counted it, as a
flat scan over every candidate executes it, and as the K-way merge needs
it; ``acs_needed_bytes`` counts the bytes the K-way merge must move, and
``acs_lse_needed`` the operations and exp/log calls of a logsumexp step.
With ``--write`` the result goes to ``docs/GPU_ROOFLINE.json``.

    python -m nanopore_dna_storage_tpu_torch.probes.merge_roofline \\
        [--rounds 8] [--grid 256] [--write]
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import json
import pathlib
import re
import subprocess

import numpy as np
import torch

from ..ops import _build
from ..ops._build import check_tensor, load_probes
from ..ops.lva_acs import candidates
from ..ops.lva_consts import NCRF, NQ_MAX, sel_format

NC, F, CT = 64, 8, 512
NEG = float("-inf")
# element-ops per merge round over the [NC, F, CT] candidate array, one op
# per element per arithmetic / compare / select pass: max 1 + argmax 2 +
# one-hot 1 + 2 x (select + add) extraction 4 + hash equality 3 + knockout
# 1 = 12 sweeps; the stream does 12 elementwise ops per element and round
MERGE_SWEEPS = 12
STREAM_SWEEPS = 12
# FP32 lanes of one Hopper SM (4 sub-partitions x 32). The lane peak counts
# every op at this rate, as the TPU probe counted its VPU's lanes, whatever
# mix of ops the kernels run: that is the bound (pct_of_lane_peak). The pipe
# floor (pct_of_pipe_floor) counts each SASS instruction at its own kind's
# measured rate instead: compares, selects and min / max issue on the ALU
# pipe, 64 lanes an SM, half this.
FP32_LANES_PER_SM = 128

# the lanes a merge column is split over (csrc/probes.cu kMergeLanes); the
# columns a stream thread runs, over 8 rounds unrolled (any other shape
# runs the generic kernel)
MERGE_LANES = 2
STREAM_VEC, STREAM_ROUNDS = 2, 8

# Kernel launches made through ``merge`` and ``stream`` (CUDA tensors only).
LAUNCHES = {"merge": 0, "stream": 0}

def merge_ref(x: torch.Tensor, h1: torch.Tensor, h2: torch.Tensor,
              rounds: int) -> torch.Tensor:
    """Plain PyTorch merge probe over the candidate axis -3: scores f32
    [..., NC, F, CT], hashes int32 of the same shape, -> f32 [..., F, CT].
    The arithmetic and its order are those of ``make_merge_kernel``."""
    csc = x
    outs = []
    for _ in range(rounds):
        best = csc.amax(-3)
        bq = csc.argmax(-3, keepdim=True)  # the first maximum
        ch1, ch2 = h1.gather(-3, bq), h2.gather(-3, bq)
        csc = torch.where((h1 == ch1) & (h2 == ch2), NEG, csc)
        outs.append(best + (ch1 + ch2).squeeze(-3).float())
    return sum(outs)  # ((0 + o0) + o1) + ...


def stream_ref(x: torch.Tensor, h1: torch.Tensor, h2: torch.Tensor,
               rounds: int) -> torch.Tensor:
    """Plain PyTorch stream probe: shapes as in ``merge_ref``; the hashes
    enter bitcast to f32, as in ``make_stream_kernel``."""
    b, c = h1.view(torch.float32), h2.view(torch.float32)
    acc = x
    for _ in range(rounds):
        t1 = torch.maximum(acc, b)
        t2 = acc + c
        t3 = torch.where(acc > b, c, acc)
        t4 = torch.maximum(t1, t2)
        t5 = t3 + t1
        t6 = torch.where(t2 > t3, t4, t5)
        t7 = t4 + t6
        t8 = torch.maximum(t5, t7)
        t9 = torch.where(t6 > t7, t8, t1)
        t10 = t8 + t9
        t11 = torch.maximum(t9, t10)
        acc = torch.where(t10 > t11, acc, t11)
    return acc.amax(-3)


def _launch(kind: str, x: torch.Tensor, h1: torch.Tensor, h2: torch.Tensor,
            rounds: int, copies: int) -> torch.Tensor:
    dev = x.device
    if dev.type == "cpu":
        ref = merge_ref if kind == "merge" else stream_ref
        return ref(*(t.expand(copies, *t.shape) for t in (x, h1, h2)),
                   rounds)
    if dev.type != "cuda":
        raise ValueError(f"{kind} runs on cpu or cuda, not {dev}")
    if x.dim() != 3 or not 1 <= x.shape[0] <= 64:
        raise ValueError(f"{kind} takes [NC <= 64, F, CT] scores, "
                         f"not {tuple(x.shape)}")
    if rounds < 0 or copies < 1:
        raise ValueError("rounds must be >= 0 and copies >= 1")
    nc, f, ct = x.shape
    check_tensor("x", x, torch.float32, x.shape, dev)
    check_tensor("h1", h1, torch.int32, x.shape, dev)
    check_tensor("h2", h2, torch.int32, x.shape, dev)
    out = torch.empty((copies, f, ct), dtype=torch.float32, device=dev)
    lib = load_probes()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, f"probe_{kind}_launch")(
            x.data_ptr(), h1.data_ptr(), h2.data_ptr(), out.data_ptr(), nc,
            f * ct, rounds, copies, stream)
    if err != 0:
        raise RuntimeError(f"probe {kind} launch failed: "
                           + lib.probe_error_string(err).decode())
    LAUNCHES[kind] += 1
    return out


def merge(x: torch.Tensor, h1: torch.Tensor, h2: torch.Tensor, rounds: int,
          copies: int = 1) -> torch.Tensor:
    """``copies`` copies of the merge probe over one input: scores f32
    [NC, F, CT], hashes int32 [NC, F, CT] -> f32 [copies, F, CT], every copy
    the same. CPU tensors run ``merge_ref`` on the copies; CUDA tensors
    launch the kernel of ``csrc/probes.cu`` (a column's candidates in
    registers over ``MERGE_LANES`` threads), which computes every copy and
    writes each to its own slot; anything else raises. The scores are
    finite or -inf: the kernel never picks a NaN, where ``merge_ref``'s
    argmax would."""
    return _launch("merge", x, h1, h2, rounds, copies)


def stream(x: torch.Tensor, h1: torch.Tensor, h2: torch.Tensor, rounds: int,
           copies: int = 1) -> torch.Tensor:
    """The stream probe, with the contract of ``merge``."""
    return _launch("stream", x, h1, h2, rounds, copies)


def _info(fn, *args) -> dict:
    out = (ctypes.c_int * 3)()
    lib = load_probes()
    err = getattr(lib, fn)(*args, out)
    if err != 0:
        raise RuntimeError(f"{fn} failed: "
                           + lib.probe_error_string(err).decode())
    return {"registers": out[0], "local_bytes": out[1],
            "threads_per_sm": out[2]}


def merge_info() -> dict:
    """Registers, local memory in bytes (stack frame and spills) and
    resident threads per SM (the occupancy calculator) of the merge kernel
    on the current CUDA device."""
    return _info("probe_merge_info")


def stream_info(unrolled: bool = True) -> dict:
    """``merge_info`` of the stream kernel: the one of ``STREAM_VEC``
    columns a thread with its rounds unrolled, or the generic one."""
    return _info("probe_stream_info", int(unrolled))


# The issue-rate chains of csrc/probes.cu (``IssueKind``), each with the
# SASS opcodes it times; fadd_fmnmx runs one FADD and one FMNMX a step, to
# show whether the two pipes overlap.
ISSUE_KINDS = {"fadd": ("FADD",), "fmnmx": ("FMNMX",),
               "fsetp_fsel": ("FSETP", "FSEL"), "isetp_sel": ("ISETP", "SEL"),
               "shfl": ("SHFL",), "iadd3": ("IADD3",), "lop3": ("LOP3",),
               "imad": ("IMAD",), "fadd_fmnmx": ("FADD", "FMNMX")}
# The pipes the floor sums each measured kind on (Hopper: FP32 arithmetic
# and integer multiply-add on FMA; compares, selects, min / max, integer
# adds and logic on ALU); a kind that was not measured counts only towards
# the issue term, so the floor stays a lower bound.
PIPES = {"fma": ("FADD", "IMAD"),
         "alu": ("FMNMX", "FSETP", "FSEL", "ISETP", "SEL", "IADD3", "LOP3"),
         "shfl": ("SHFL",)}
_SASS_LINE = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
# a branch's target: a label, or an address in the kernel
_BRANCH = re.compile(r"`\((\.L_x_\d+)\)|\b(0x[0-9a-f]+)\s*$")


def sass(lib_path) -> dict:
    """``parse_sass`` of the library at ``lib_path`` (``cuobjdump
    -sass``)."""
    return parse_sass(subprocess.run(
        [str(pathlib.Path(_build.nvcc()).with_name("cuobjdump")), "-sass",
         str(lib_path)], capture_output=True, text=True, timeout=300,
        check=True).stdout)


def parse_sass(text: str) -> dict:
    """The SASS of every kernel in ``cuobjdump -sass``'s ``text``: {mangled
    name: [(opcode, branch target's instruction index or None), ...]}, the
    opcode without its modifiers or predicate; a branch's target is a label
    or an address, as the toolkit prints it."""
    funcs = {}
    for chunk in text.split("Function : ")[1:]:
        name, body = chunk.split("\n", 1)
        instrs, where, targets = [], {}, []
        for line in body.splitlines():
            line = line.strip()
            if re.fullmatch(r"\.L_x_\d+:", line):
                where[line[:-1]] = len(instrs)
                continue
            m = _SASS_LINE.match(line)
            if not m:
                continue
            where[int(m.group(1), 16)] = len(instrs)
            words = m.group(2).split()
            if words[0].startswith("@"):
                words = words[1:]
            op = words[0].split(".")[0]
            b = _BRANCH.search(m.group(2)) if op == "BRA" else None
            instrs.append(op)
            targets.append(None if b is None else b.group(1)
                           or int(b.group(2), 16))
        funcs[name.strip()] = [(op, where.get(t)) for op, t in
                               zip(instrs, targets)]
    return funcs


def loops(instrs) -> list:
    """The backward branches of one kernel's SASS as (first, last)
    instruction indices of their bodies, innermost (shortest) first; the
    self-branch that ends a kernel is not a loop."""
    return sorted(((t, i) for i, (_, t) in enumerate(instrs)
                   if t is not None and t < i), key=lambda b: b[1] - b[0])


def counts(instrs, lo: int = 0, hi: int = None) -> collections.Counter:
    """Opcode counts of ``instrs[lo:hi + 1]``."""
    hi = len(instrs) - 1 if hi is None else hi
    return collections.Counter(op for op, _ in instrs[lo:hi + 1])


def dynamic_counts(instrs, trips: int) -> collections.Counter:
    """The opcodes one thread issues when the kernel's one loop runs
    ``trips`` times (predicated-off instructions included, as they issue).
    Raises unless the kernel has exactly one loop."""
    found = loops(instrs)
    if len(found) != 1:
        raise ValueError(f"expected one loop, found {len(found)}")
    lo, hi = found[0]
    body = counts(instrs, lo, hi)
    total = counts(instrs)
    return collections.Counter({op: total[op] + (trips - 1) * body[op]
                                for op in total})


def kernel_sass(funcs: dict, part: str):
    """The one kernel whose mangled name contains ``part``."""
    hits = [k for k in funcs if part in k]
    if len(hits) != 1:
        raise ValueError(f"{len(hits)} kernels match {part!r}: {hits}")
    return funcs[hits[0]]


STREAM_SASS_NAME = f"stream_kernelILi{STREAM_VEC}ELi{STREAM_ROUNDS}E"


def _events_s(fn, reps: int) -> float:
    fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / 1e3 / reps


def issue_rates(funcs: dict, iters: int = 512, reps: int = 5) -> dict:
    """Each chain of ``ISSUE_KINDS`` timed on the card over 8 blocks of 128
    threads an SM: {kind: {"per_s": instructions of its opcodes per second,
    "per_sm_clk": the same per SM and maximum SM clock, "body": the loop
    body's opcode counts, "ms": the time}}, the instructions counted from
    the kernel's SASS loop body (``funcs``: ``sass`` of the library)."""
    lib = load_probes()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    _, _, mhz = _peak_parts()
    nblocks = 8 * sms
    dev = torch.device("cuda")
    src = torch.arange(1, 9, dtype=torch.float32, device=dev).view(
        torch.int32)
    out = torch.empty(nblocks * 128, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    names = [k for k in funcs if "issue_kernel" in k]
    res = {}
    for kind, (name, ops) in enumerate(ISSUE_KINDS.items()):
        sel = [k for k in names if f"issue_kernelILi{kind}E" in k]
        if len(sel) != 1:
            raise ValueError(f"no one issue kernel {kind} in {names}")
        lo, hi = loops(funcs[sel[0]])[0]
        body = counts(funcs[sel[0]], lo, hi)

        def run():
            err = lib.probe_issue_launch(kind, src.data_ptr(),
                                         out.data_ptr(), nblocks, iters,
                                         stream)
            if err != 0:
                raise RuntimeError("probe issue launch failed: "
                                   + lib.probe_error_string(err).decode())

        dt = _events_s(run, reps)
        n = sum(body[o] for o in ops) * iters * nblocks * 128
        res[name] = {"per_s": n / dt, "per_sm_clk": n / dt / sms / mhz / 1e6,
                     "body": dict(body), "ms": dt * 1e3}
    return res


def rate_table(rates: dict) -> dict:
    """{opcode: instructions per second} from ``issue_rates``: each kind's
    rate for its own opcodes (the fadd_fmnmx mix is left out)."""
    return {op: r["per_s"] for kind, r in rates.items()
            if kind != "fadd_fmnmx" for op in ISSUE_KINDS[kind]}


def pipe_floor(mix: dict, threads: int, table: dict) -> dict:
    """The least time ``threads`` threads issuing the per-thread opcode
    counts ``mix`` can take at the measured rates ``table`` (opcode ->
    instructions per second): the largest of each pipe's measured opcodes
    summed at their rates (``PIPES``) and every instruction at the FADD
    rate, one warp instruction a clock per scheduler. Returns the seconds,
    each term and the term that bounds."""
    terms = {p: sum(mix.get(o, 0) * threads / table[o] for o in ops
                    if o in table) for p, ops in PIPES.items()}
    terms["issue"] = sum(mix.values()) * threads / table["FADD"]
    by = max(terms, key=terms.get)
    return {"floor_s": terms[by], "by": by, "terms_s": terms}


def merge_floor(funcs, table, rounds, copies, ncol) -> dict:
    """``pipe_floor`` of the merge kernel at ``copies`` x ``ncol`` columns
    and ``rounds`` rounds, with its SASS mix per column and round."""
    instrs = kernel_sass(funcs, "merge_kernel")
    lo, hi = loops(instrs)[0]
    mix = dynamic_counts(instrs, rounds)
    per_round = {o: n * MERGE_LANES for o, n in
                 counts(instrs, lo, hi).items()}
    return {**pipe_floor(mix, copies * ncol * MERGE_LANES, table),
            "per_column_round": per_round}


def stream_floor(funcs, table, nc, copies, ncol) -> dict:
    """``pipe_floor`` of the stream kernel (its rounds unrolled) at
    ``copies`` x ``ncol`` columns of ``nc`` elements, with its SASS mix per
    element and round."""
    instrs = kernel_sass(funcs, STREAM_SASS_NAME)
    lo, hi = loops(instrs)[0]
    mix = dynamic_counts(instrs, nc)
    per = STREAM_VEC * STREAM_ROUNDS
    return {**pipe_floor(mix, copies * ncol // STREAM_VEC, table),
            "per_element_round": {o: n / per for o, n in
                                  counts(instrs, lo, hi).items()}}


def stream_mix(funcs) -> dict:
    """The SASS mix per element and round of a library's stream kernel,
    also for a tree whose kernel is not this one's (its one
    ``stream_kernel``): of the loops that hold no other loop, the one with
    the most FADDs, scaled by them (4 an element and round)."""
    instrs = kernel_sass(funcs, "stream_kernel" if sum(
        "stream_kernel" in k for k in funcs) == 1 else STREAM_SASS_NAME)
    found = loops(instrs)
    inner = [(lo, hi) for lo, hi in found
             if not any(lo <= a and b <= hi and (a, b) != (lo, hi)
                        for a, b in found)]
    body = max((counts(instrs, lo, hi) for lo, hi in inner),
               key=lambda c: c["FADD"])
    return {o: 4 * n / body["FADD"] for o, n in body.items()}


def acs_work_ops(spec, nreads: int) -> int:
    """The ACS kernel's work per block step in the probe's unit (one op per
    element per arithmetic, compare or select pass), whatever kernel does
    the step: ``W * 8 * C * nreads * (L * (12 * 8L + 4L) + 88 * L)``.

    For each (read, window row, CRF destination, conv state): L merge rounds
    of 12 sweeps over the 8L candidates plus 4 ops per output slot, and the
    hash updates, 4 betas x 2 hashes x 11 ops (shift, add, 3 x (2 compares,
    subtract)) per slot. These are ``bench.py``'s merge and hash terms
    (``estimate_kernel_ops``), with the candidate rows padded to 8 as there,
    and without its TPU-only butterfly and compaction terms. ``spec`` is an
    ``ops.lva_consts.DecodeSpec``."""
    L, C, W = spec.list_size, spec.code.nstate_conv, spec.window
    merge_ops = L * (12 * 8 * L + 4 * L)
    hash_ops = 4 * 2 * 11 * L
    return W * 8 * C * nreads * (merge_ops + hash_ops)


def acs_executed_ops(spec, rows, valid) -> int:
    """The part of ``acs_work_ops(spec, 1)`` that a flat-scan ACS kernel
    (L rounds of a max scan and a knockout over every candidate, as
    ``acs_block_ref`` computes the step) executes at one block step of one
    read, with one thread per (window row, CRF destination, conv state)
    as in ``csrc/lva_acs.cu``. A thread
    whose (position, conv state) is not valid returns at once, and CRF
    destination f merges its ``rows[f]`` real candidate rows (stay plus
    moves: 8 for a flip state, 2 for a flop) instead of 8 padded ones. Per
    valid (window row, f, conv state): ``L * (12 * rows[f] * L + 4L) + 22 *
    (rows[f] - 1) * L``, the hash term being 2 hashes x 11 ops per move-row
    candidate (over the 8 flip-flop states, 4 with 7 move rows and 4 with
    1, its mean is ``acs_work_ops``'s 88 L). ``rows``: 8 counts; ``valid``:
    bool [W, C], the valid table at the window's positions."""
    L = spec.list_size
    per_cell = sum(L * (12 * n * L + 4 * L) + 22 * (n - 1) * L
                   for n in rows)
    return int(valid.sum()) * per_cell


def acs_needed_ops(spec, rows, valid) -> int:
    """The operations one ACS block step of one read needs when it merges
    the sorted candidate rows K ways, as the decoder's kernel does, in the
    unit of ``acs_work_ops``. Per valid (window row, CRF destination f,
    conv state), with ``n = rows[f]``: L first-argmax passes over the n
    heads (3 ops a head), each emitted pair checked against the ones before
    it (3 ops a pair, ``3 L (L - 1) / 2``), one score add per head loaded
    (n, then one per round but the last), the hash updates of the n - 1
    first move-row heads (22 ops each) and 4 ops per output slot. Dropped
    duplicates and the hash updates of later heads depend on the data and
    are not counted, so this is the least the function needs. ``rows`` and
    ``valid`` as in ``acs_executed_ops``."""
    L = spec.list_size
    per_cell = sum(3 * n * L + 3 * L * (L - 1) // 2 + (n + L - 1)
                   + 22 * (n - 1) + 4 * L for n in rows)
    return int(valid.sum()) * per_cell


def acs_needed_bytes(tabs, prev_sc, out_sc, sel, stay_tr, move_tr, start1,
                     active) -> int:
    """The bytes one ACS block step must move on these inputs when it merges
    the sorted candidate rows K ways, as ``csrc/lva_acs.cu`` does.

    The merge pops candidates in the order (score descending, flat index
    ``q*L + slot`` ascending) up to the one it emits last in slot L - 1, or
    every finite one when a slot stays empty; a row whose first p slots are
    popped has read min(L, p + 1) slots (its head after the last pop). A
    slot of the previous buffer is counted once however many rows read it:
    its stay row and the move rows of the next position. Trellis position 0
    reads each stay row's slot-0 score and all its hashes. Every live
    (read active, state valid) row writes its L slots, and every read its
    selections. The step's tables (under 0.1% of the bytes at m=11) are not
    counted. ``prev_sc``: the previous scores [B, P, 8, L, C]; ``out_sc`` and
    ``sel``: the step's output scores (the stale buffer after the step) and
    selections; the rest as in ``acs_block``."""
    B, P, _, L, C = prev_sc.shape
    W = sel.shape[1]
    dev = prev_sc.device
    code_shift = sel_format(L)[1]
    f = torch.arange(NCRF, device=dev)
    s = torch.arange(C, device=dev)
    j = torch.arange(L, device=dev)
    g = tabs["qmap"].long()[:, 1:]  # [8, 7], -1 pads
    gc = g.clamp(min=0)
    flat = torch.arange(NQ_MAX, device=dev)[:, None] * L + j  # [8q, L]
    nbytes = B * W * NCRF * L * C * sel.element_size()
    for b in range(B):
        if not bool(active[b]):
            continue
        pos = int(start1[b]) + torch.arange(W, device=dev)
        live = (tabs["valid"][pos] != 0) & (pos != 1)[:, None]  # [W, C]
        pat = tabs["pattern"].long()[pos]
        c = tabs["cstar"].long()[pat[:, None], f % 4]  # [W, 8f, C]
        pred = ((s << (1 + (pat != 0).long())[:, None, None]) + c) & (C - 1)
        # candidate scores [W, 8f, 8q, L, C]: the stay row, then the moves
        stay = prev_sc[b, pos] + stay_tr[b][:, None, None]
        mv = prev_sc[b][(pos - 1)[:, None, None, None, None],
                        gc[None, :, :, None, None], j[:, None],
                        pred[:, :, None, None, :]]
        mv = mv + move_tr[b][f[:, None], gc][:, :, None, None]
        cand = torch.cat([stay[:, :, None], mv], 2)
        has = torch.cat([torch.ones_like(c[:, :, None] >= 0),
                         (g >= 0)[None, :, :, None] & (c >= 0)[:, :, None]],
                        2)  # [W, 8f, 8q, C]
        last = sel[b].reshape(W, NCRF, L, C)[:, :, L - 1].long()
        s_last = out_sc[b, pos][:, :, L - 1][:, :, None, None]
        i_last = ((last // code_shift) * L + last % code_shift)[:, :, None,
                                                               None]
        ahead = (cand > s_last) | ((cand == s_last)
                                   & (flat[:, :, None] <= i_last))
        popped = torch.where((last >= 0)[:, :, None, None], ahead,
                             cand > NEG).sum(3)
        read = torch.where(has & live[:, None, None],
                           (popped + 1).clamp(max=L), 0)
        # slots read of each previous row (position, state g, conv state)
        depth = torch.zeros(P * NCRF * C, dtype=torch.long, device=dev)
        at = ((pos[:, None, None] * NCRF + f[:, None]) * C + s).reshape(-1)
        depth.scatter_reduce_(0, at, read[:, :, 0].reshape(-1), "amax")
        depth.scatter_reduce_(
            0, (((pos - 1)[:, None, None, None] * NCRF + gc[:, :, None]) * C
                + pred[:, :, None]).reshape(-1),
            read[:, :, 1:].reshape(-1), "amax")
        hdepth = depth.clone()
        first = ((tabs["valid"][pos] != 0) & (pos == 1)[:, None])[:, None]
        at0 = at.reshape(W, NCRF, C)[first.expand(W, NCRF, C)]
        depth[at0] = depth[at0].clamp(min=1)
        hdepth[at0] = L
        nlive = int((tabs["valid"][pos] != 0).sum()) * NCRF
        nbytes += 4 * int(depth.sum()) + 8 * int(hdepth.sum()) \
            + 12 * L * nlive
    return nbytes


def acs_lse_needed(tabs, prev, out, sel, stay_tr, move_tr, start1,
                   active):
    """(operations, exp calls, log calls) one logsumexp ACS block step needs
    on these inputs when it merges every candidate, as ``csrc/lva_lse.cu``
    does, in the unit of ``acs_work_ops``.

    Per live (read active, state valid, position past 0) cell, that is per
    window row, CRF destination f with ``rows[f]`` candidate rows and conv
    state, with ``n = rows[f] * L`` candidates and ``h`` rounds that pop a
    class: n score adds, ``22 (rows[f] - 1) L`` for the move rows' hashes,
    ``min(h + 1, L)`` max scans of 3 ops a candidate (a round after the
    first empty one needs none), ``h`` class passes of 4 ops a candidate
    (two compares, an and, the knockout), 4 ops per output slot, and per
    popped class a subtract and an add for each live member and the add of
    best and the log. One exp per live member of a popped class, one log
    per popped class. ``prev``: the step's previous buffers; ``out``: its
    output buffers (the stale buffers after the step); ``sel`` its
    selections; the rest as in ``acs_block``."""
    B, P, _, L, C = prev[0].shape
    W = sel.shape[1]
    dev = prev[0].device
    rows = 1 + (tabs["qmap"][:, 1:] >= 0).sum(1).to(dev)  # [8f]
    n = (rows * L)[:, None]  # [8f, 1]
    ops = exp = log = 0
    for b in range(B):
        if not bool(active[b]):
            continue
        one = slice(b, b + 1)
        pos, cand_sc, cand_key, _ = candidates(
            tabs, tuple(x[one] for x in prev), stay_tr[one], move_tr[one],
            start1[one], W)
        live = ((tabs["valid"][pos[0]] != 0)
                & (pos[0] != 1)[:, None])[:, None]  # [W, 1, C]
        hit = sel[b].reshape(W, NCRF, L, C) >= 0
        h = hit.sum(2)  # [W, 8f, C]
        key = (out[1][b, pos[0]].long() << 30) | out[2][b, pos[0]]
        finite = cand_sc[0] > NEG  # [W, 8f, C, 8q L]
        members = sum(((cand_key[0] == key[:, :, r, :, None]) & finite).sum(-1)
                      * hit[:, :, r] for r in range(L))
        cell = (n + 22 * (rows[:, None] - 1) * L + 3 * n
                * torch.clamp(h + 1, max=L) + 4 * n * h + 4 * L
                + 2 * members + h)
        ops += int(torch.where(live, cell, 0).sum())
        exp += int(torch.where(live, members, 0).sum())
        log += int(torch.where(live, h, 0).sum())
    return ops, exp, log


def _peak_parts(device: int = 0):
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    res = subprocess.run(
        ["nvidia-smi", "-i", str(device), "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    return sms, FP32_LANES_PER_SM, float(res.stdout.strip())


def lane_peak(device: int = 0):
    """(element-ops per second, formula) of the card's FP32 lanes: SMs x
    ``FP32_LANES_PER_SM`` x the maximum SM clock that ``nvidia-smi``
    reports."""
    sms, lanes, mhz = _peak_parts(device)
    return (sms * lanes * mhz * 1e6,
            f"{sms} SMs x {lanes} FP32 lanes x {mhz:g} MHz max SM clock")


def run(kind: str, rounds: int, grid: int, floor_s: float,
        reps: int = 5) -> dict:
    """Time ``grid`` copies of one probe kernel at [NC, F, CT] on the CUDA
    card (the fastest of ``reps`` launches, by CUDA events) and return its
    element-op rate, its share of the lane peak and its share of the
    kernel's pipe floor ``floor_s``."""
    if not torch.cuda.is_available():
        raise RuntimeError("the roofline probe needs a CUDA device")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(NC, F, CT)).astype(np.float32))
    h = torch.from_numpy(rng.integers(0, 1 << 30, (NC, F, CT),
                                      dtype=np.int64).astype(np.int32))
    x, h = x.cuda(), h.cuda()
    fn = merge if kind == "merge" else stream
    fn(x, h, h, rounds, grid)  # builds the library on first use
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn(x, h, h, rounds, grid)
        b.record()
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b) / 1e3)
    dt = min(ts)
    sweeps = MERGE_SWEEPS if kind == "merge" else STREAM_SWEEPS
    elem_ops = grid * rounds * sweeps * NC * F * CT
    peak, _ = lane_peak()
    rate = elem_ops / dt
    return {"kind": kind, "rounds": rounds, "grid": grid,
            "kernel_s": dt, "elem_ops_T": elem_ops / 1e12,
            "ops_per_s_T": rate / 1e12,
            "pct_of_lane_peak": 100 * rate / peak,
            "pct_of_pipe_floor": 100 * floor_s / dt}


def floors(rounds: int, grid: int) -> dict:
    """The issue rates of ``issue_rates`` and the pipe floors of the
    production merge and stream kernels at [NC, F, CT] x ``grid`` copies."""
    funcs = sass(_build.build("probes", ["probes.cu"]))
    rates = issue_rates(funcs)
    table = rate_table(rates)
    return {"issue_rates": rates,
            "merge": merge_floor(funcs, table, rounds, grid, F * CT),
            "stream": stream_floor(funcs, table, NC, grid, F * CT)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--grid", type=int, default=256)
    ap.add_argument("--write", action="store_true",
                    help="write the result to docs/GPU_ROOFLINE.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("merge_roofline: needs a CUDA device")
    peak, formula = lane_peak()
    out = {"device": torch.cuda.get_device_name(0),
           "shape": [NC, F, CT],
           "lane_peak_ops_per_s_T": peak / 1e12,
           "lane_peak_formula": formula,
           "note": "pct_of_lane_peak = measured element-ops/s vs the FP32 "
                   "lane peak; pct_of_pipe_floor = the kernel's floor from "
                   "its SASS at the issue rates measured per kind vs its "
                   "time; 'stream' = independent elementwise sweeps (best "
                   "case for this shape), 'merge' = the exact production "
                   "suppression-merge round (serial reductions + "
                   "knockout), candidates in registers over "
                   f"{MERGE_LANES} lanes a column"}
    print(json.dumps({"lane_peak_ops_per_s_T": peak / 1e12,
                      "lane_peak_formula": formula}), flush=True)
    fl = floors(args.rounds, args.grid)
    out["issue_rates"] = fl["issue_rates"]
    print(json.dumps({"issue_rates_per_sm_clk": {
        k: r["per_sm_clk"] for k, r in fl["issue_rates"].items()}}),
        flush=True)
    for kind in ("stream", "merge"):
        r = run(kind, args.rounds, args.grid, fl[kind]["floor_s"])
        r["pipe_floor"] = fl[kind]
        out[kind] = r
        print(json.dumps(r), flush=True)
    if args.write:
        path = (pathlib.Path(__file__).resolve().parents[2] / "docs"
                / "GPU_ROOFLINE.json")
        path.write_text(json.dumps(out, indent=1) + "\n")
    return out


if __name__ == "__main__":
    main()
