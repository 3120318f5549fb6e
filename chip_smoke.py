#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

0. setup: needs a CUDA device; builds every kernel library from
   ``nanopore_dna_storage_tpu_torch/csrc``, one nvcc per source, all at
   once (each timed, with its ptxas registers, stack and spills); fails if
   the K-way ACS kernel's L = 8 build uses local memory (a stack frame or
   spills); logs the logsumexp kernel's registers, local bytes and
   threads per SM (its candidates live in local memory by design);
1. the ACS kernel (the K-way merge) against its plain PyTorch version on
   the card, at the headline decode config (experiment 7: m=11, r=5/6,
   msg_len 180, L=8, max deviation 20) on one synthetic read: buffers and
   selections bit-equal on blocks spread over the read (position 0 and an
   inactive block included), the buffers' rows sorted in slot (the K-way
   merge's precondition), then the whole read decoded both ways; then the
   same at the main path's shapes: phase 3's first batch of reads through
   ``PipelineDecoder.decode_posts``, split by orientation into launches
   of several reads of different lengths, every block checked; and the
   kernel's L <= 16 bucket at L = 12 on a few blocks of the first read;
2. every golden vector of ``tests/golden/decode``, ``tests/golden/sync``
   (sync markers) and ``tests/golden/decode14`` (m=14, C = 16384) through
   the kernel, bit-identical to the reference binary's lists, each timed;
3. the main path: ``sim-decode`` at experiment 7 on a 100-byte file, which
   must recover the file byte for byte, with one kernel launch per forward
   block step;
4. the merge-family probes (``probes/merge_roofline.py``,
   ``probes/treepop.py``): merge and stream bit-equal to their plain
   versions at [64, 8, 512] with 256 copies and 8 rounds, every copy's
   slot equal; each tree-pop variant and the guarded tree bit-equal; each
   kernel and plain version timed; then the probes' entry points; the
   roofline line sets their rates beside the ACS kernel's (phase 1, one
   read) in the operations it needs;
5. the expansion-family probes (``probes/expand.py``,
   ``probes/mxu_expand.py``): every lane-map form (gather, shfl,
   butterfly), the transpose and every one-hot product mode (tf32, bf16,
   u8x4) bit-equal to its plain version at the scripts' shapes, all copies
   equal, u8x4 bit-exact on P5's hashes and P7's payloads, the tf32
   mismatches counted; each kernel, plain version and library call timed;
   then both entry points, with their launch counts set to 0 before;
6. the lowering probes (``probes/lowering.py``): every P1 kernel (repeat
   through ``lane_map``, dynrow, int16, fori in both placements, reshape,
   alias) bit-equal to its plain version and to the numpy result at the
   script's shapes, fori also at the ACS kernel's merge shape (NQ = 64,
   R = 8) and over 256 copies, at one thread per item and at 128 threads
   per SM; alias returning its own buffer with every row outside a random
   window unchanged; dynrow and alias at indices and windows outside
   [0, P), reading and writing nothing outside the buffer; each kernel,
   plain version and library call timed; P7's plain version and library
   call at its shape; then the entry point, with its launch counts set to
   0 before, which also gives the fori rates (both placements at both NQ,
   and ``local`` at ``regs``'s residency);
7. logsumexp path combining through its flat-merge kernel
   (``acs_block_lse``, ``csrc/lva_lse.cu``) at the headline config: the
   kernel bit-equal to its plain version on one read at B=1 (blocks over
   the read, position 0 and an inactive block, then the whole read's lists,
   scores and validity), at L = 12 on a few blocks, and on every 16th block
   of phase 3's first batch at B=4, one block timed there; then phase 3's
   32 reads through ``PipelineDecoder(..., path_combine="logsumexp")``,
   which must recover the file byte for byte with one lse launch per block
   step and no K-way launch.

Every entry of the kernels line has its bound: the larger of the bytes
the function must move over the memory rate and its operations over the
card's peak for their type (``bound``).

Before the last lines come ``{"lva_acs": {...}}`` (the ACS kernel's
times at B=1 and B=4, its registers, local bytes and resident threads
per SM, its bound and its share of it), ``{"lva_acs_lse": {...}}`` (the
same for the logsumexp kernel, its bound's three terms and the lse path's
s/read), ``{"roofline": {...}}``,
``{"lowering": {...}}`` (the fori rates and P7's times), the card's name
and power limit, and ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``. Without a CUDA device, or away from the
package, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

try:
    from nanopore_dna_storage_tpu_torch import cli
    from nanopore_dna_storage_tpu_torch.config import (ConvCodeConfig,
                                                       DecodeConfig)
    from nanopore_dna_storage_tpu_torch.ops import _build, lva_acs, lva_decode
    from nanopore_dna_storage_tpu_torch.ops.lva import LVADecoder
    from nanopore_dna_storage_tpu_torch.ops.lva_consts import sel_format
    from nanopore_dna_storage_tpu_torch.pipeline import (encode_bytes,
                                                         experiment)
    from nanopore_dna_storage_tpu_torch.pipeline.decode import (
        PipelineDecoder, majority_vote, recover_file)
    from nanopore_dna_storage_tpu_torch.pipeline.simulate import \
        simulate_posts
    from nanopore_dna_storage_tpu_torch.probes import (expand, lowering,
                                                       merge_roofline,
                                                       mxu_expand, treepop)
except ImportError as e:
    sys.exit(f"chip_smoke: FAIL: the port package is not beside this "
             f"script: {e}")

ROOT = pathlib.Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "golden"
# the reference binary's golden lists: plain, with sync markers, and m=14
GOLDEN_SETS = ("decode", "sync", "decode14")
SEED = 0
LSE = "logsumexp"
# phase 7c checks every 16th block against the plain version, which at
# full width takes ~0.1-0.3 s a block step
LSE_CHECK_EVERY = 16
# every kernel library and its sources in csrc/
LIBS = {"lva_acs": ["lva_acs.cu"], "lva_lse": ["lva_lse.cu"],
        "probes": ["probes.cu"], "expand": ["expand.cu"],
        "mxu_expand": ["mxu_expand.cu"], "lowering": ["lowering.cu"]}
CSRC = "nanopore_dna_storage_tpu_torch/csrc"
PROBE_SOURCE = f"{CSRC}/probes.cu"
# H100 SXM peaks from NVIDIA's data sheet (dense, 700 W): device
# memory, and the tensor cores in operations
# (2 per MAC) per second by operand type; u8x4 runs on the int8 rate
HBM_BYTES_PER_S = 3.35e12
TC_OPS_PER_S = {"tf32": 495e12, "bf16": 989e12, "u8x4": 1979e12}
# special function units of one Hopper SM: transcendental results per clock
# (exp, log), against its 128 FP32 lanes
SFU_PER_SM = 16
# the script kernel each one-hot mode stands in for (f32 DEFAULT, bf16,
# HIGHEST)
REPLACES_MXU = {"tf32": "scripts/tpu_mxu_probe2.py:33",
                "bf16": "scripts/tpu_mxu_probe2.py:33",
                "u8x4": "scripts/tpu_mxu_expand_probe.py:53"}


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def gpu_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip()


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn()`` in ms, by CUDA events over ``reps``."""
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


def same_bufs(got, want) -> float:
    """Fails unless scores, hashes and -inf positions are bit-equal (the
    message gives the largest score difference in units in the last place);
    returns the max |score difference| over finite scores."""
    fin = torch.isfinite(want[0])
    if not torch.equal(torch.isfinite(got[0]), fin):
        fail("kernel and its plain version disagree on which scores are "
             "-inf")
    err = float((got[0][fin] - want[0][fin]).abs().max()) \
        if bool(fin.any()) else 0.0
    for x, y in zip(got, want):
        if not torch.equal(x, y):
            ulps = int((got[0][fin].view(torch.int32).long()
                        - want[0][fin].view(torch.int32).long()).abs().max()) \
                if bool(fin.any()) else 0
            fail(f"kernel buffers differ from the plain version (score error "
                 f"{err}, {ulps} ulp)")
    return err


def acs_steps(lse: bool):
    """(kernel, plain version) of the ACS step: the K-way merge under max
    combining, whose buffer rows stay sorted in slot, or the flat merge
    under logsumexp combining (``lse``), whose rows do not."""
    if lse:
        return lva_acs.acs_block_lse, lva_acs.acs_block_lse_ref
    return lva_acs.acs_block, lva_acs.acs_block_ref


def check_sorted(bufs, what: str) -> None:
    """Fails unless every (read, position, CRF state, conv state) row of the
    buffer triple ``bufs`` has scores that do not increase with the slot:
    the K-way merge's precondition."""
    sc = bufs[0]
    if not bool((sc[:, :, :, 1:] <= sc[:, :, :, :-1]).all()):
        fail(f"{what}: a buffer row's scores increase with the slot")


def phase_kernel(dec, post, tag="phase 1"):
    """Phase 1 (and 7a under logsumexp combining): the ACS kernel of
    decoder ``dec`` against its plain version on one read; under max
    combining the rows are also held sorted. Returns the kernel's and the
    plain version's ms at the timed block, the max |score error| and the
    timed block's window start (padded row)."""
    spec, tabs, dev = dec.spec, dec.tabs, dec.device
    kern, ref = acs_steps(spec.combine_lse)
    sorted_rows = not spec.combine_lse
    T = post.shape[0]
    L, C, W = spec.list_size, spec.code.nstate_conv, spec.window
    log(f"{tag}: m={spec.code.mem} L={L}: C={C} W={W} "
        f"P={spec.npos_pad} T={T} rc={spec.code.config.rc} "
        f"{'logsumexp' if spec.combine_lse else 'max'} combining")
    starts = dec.schedule(np.array([T]), T)[0]
    postf = torch.from_numpy(post.reshape(1, T, 40)).to(dev)
    stay = postf[:, :, tabs["stay_idx"]]
    move = postf[:, :, tabs["move_idx"]]
    prev, stale = lva_decode.init_buffers(spec, dec.consts.init_state, 1,
                                          dev)
    sel = torch.empty((1, W, 8 * L, C), dtype=sel_format(L)[0], device=dev)
    check = sorted({0, 1, 2, T // 8, T // 4, 3 * T // 8, T // 2,
                    5 * T // 8, 3 * T // 4, T - 2, T - 1})
    timed_block = T // 2
    ms = plain_ms = None
    written, err = 0, 0.0
    for t in range(T):
        args = (stay[:, t].contiguous(), move[:, t].contiguous(),
                torch.tensor([starts[t] + 1], dtype=torch.int32,
                             device=dev),
                torch.ones(1, dtype=torch.bool, device=dev))
        if t in check:
            if sorted_rows:
                check_sorted(prev, f"block {t} prev")
            st_ref = [x.clone() for x in stale]
            sel_ref = torch.empty_like(sel)
            ref(tabs, prev, st_ref, *args, sel_ref)
        if t == timed_block:
            # both steps only read prev and rewrite the same stale cells,
            # so repeating them leaves the state as one call would
            scratch = [x.clone() for x in stale]
            ms = cuda_ms(lambda: kern(tabs, prev, scratch, *args, sel),
                         reps=20, warmup=3)
            plain_ms = cuda_ms(lambda: ref(tabs, prev, scratch, *args, sel),
                               reps=3)
        kern(tabs, prev, stale, *args, sel)
        if t in check:
            if sorted_rows:
                check_sorted(stale, f"block {t} output")
            err = max(err, same_bufs(stale, st_ref))
            if not torch.equal(sel, sel_ref):
                fail(f"kernel selections differ at block {t}")
            written += int((sel >= 0).sum())
        if t == 0 and not (sel[0, 0] >= 0).any():
            fail("block 0 wrote nothing at position 0")
        prev, stale = stale, prev
    # an inactive block leaves the stale buffer alone and selects nothing
    args = (stay[:, -1].contiguous(), move[:, -1].contiguous(),
            torch.tensor([starts[-1] + 1], dtype=torch.int32, device=dev),
            torch.zeros(1, dtype=torch.bool, device=dev))
    before = [x.clone() for x in stale]
    st_ref = [x.clone() for x in stale]
    sel_ref = torch.empty_like(sel)
    ref(tabs, prev, st_ref, *args, sel_ref)
    kern(tabs, prev, stale, *args, sel)
    same_bufs(stale, st_ref)
    same_bufs(stale, before)
    if not (torch.equal(sel, sel_ref) and bool((sel == -1).all())):
        fail("inactive block selected something")
    torch.cuda.synchronize()
    log(f"{tag}: {len(check)} active blocks + 1 inactive bit-equal"
        f"{', rows sorted' if sorted_rows else ''} ({written} selections "
        f"written); block {timed_block}: kernel {ms:.4f} ms/block, plain "
        f"{plain_ms:.4f} ms/block")

    out = {}
    for name, acs in (("kernel", kern), ("plain version", ref)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[name] = dec.decode(post[None], acs=acs)
        torch.cuda.synchronize()
        log(f"{tag}: whole read via the {name}: "
            f"{time.perf_counter() - t0:.3f} s/read")
    (mk, sk, vk), (mr, sr, vr) = out["kernel"], out["plain version"]
    if not (np.array_equal(mk, mr) and np.array_equal(sk, sr)
            and np.array_equal(vk, vr)):
        fail("kernel and plain version decode different lists")
    if not vk[0, 0]:
        fail("headline read decoded to an empty list")
    log(f"{tag}: lists identical; {int(vk.sum())} valid entries, "
        f"top score {sk[0, 0]:.4f}")
    return ms, plain_ms, err, int(starts[timed_block]) + 1


class CheckedACS:
    """An ACS step that runs the plain version on a copy of the stale
    buffers, then the kernel on the buffers themselves, and fails unless
    the two agree bit for bit (and, under max combining, the rows of both
    buffers are sorted), at every block whose index ``check`` accepts and
    at the first block that mixes active and inactive reads (the kernel
    alone at the others); at block ``timed`` it also times both and counts
    what the step must do: the bytes (``acs_needed_bytes``) under max
    combining, the operations and exp/log calls (``acs_lse_needed``) under
    logsumexp combining. ``lse`` picks the kernel."""

    def __init__(self, timed: int, check=lambda t: True, lse=False):
        self.timed, self.check, self.lse = timed, check, lse
        self.kern, self.ref = acs_steps(lse)
        self.blocks = self.checked = self.mixed = 0
        self.err = 0.0
        self.ms = self.plain_ms = self.timed_B = self.needed = None
        self.timed_args = None  # (start1, active) of the timed block

    def __call__(self, tabs, prev, stale, *args):
        *rest, sel = args
        active = rest[-1]
        mixed = 0 < int(active.sum()) < active.numel()
        if not (self.check(self.blocks) or self.blocks == self.timed
                or (mixed and self.mixed == 0)):
            self.kern(tabs, prev, stale, *args)
            self.blocks += 1
            return sel
        if not self.lse:
            check_sorted(prev, f"batch block {self.blocks} prev")
        st_ref = [x.clone() for x in stale]
        sel_ref = torch.empty_like(sel)
        self.ref(tabs, prev, st_ref, *rest, sel_ref)
        if self.blocks == self.timed:
            self.timed_B = sel.shape[0]
            self.timed_args = (rest[2].tolist(), rest[3].tolist())
            self.needed = (
                merge_roofline.acs_lse_needed(tabs, prev, st_ref, sel_ref,
                                              *rest) if self.lse else
                merge_roofline.acs_needed_bytes(tabs, prev[0], st_ref[0],
                                                sel_ref, *rest))
            # both steps only read prev and rewrite the same stale cells,
            # so repeating them leaves the state as one call would
            scratch = [x.clone() for x in stale]
            self.ms = cuda_ms(lambda: self.kern(tabs, prev, scratch, *args),
                              reps=20, warmup=3)
            self.plain_ms = cuda_ms(lambda: self.ref(tabs, prev, scratch,
                                                     *args), reps=3)
        self.kern(tabs, prev, stale, *args)
        if not self.lse:
            check_sorted(stale, f"batch block {self.blocks} output")
        self.err = max(self.err, same_bufs(stale, st_ref))
        if not torch.equal(sel, sel_ref):
            fail(f"kernel selections differ at batch block {self.blocks}")
        self.mixed += mixed
        self.blocks += 1
        self.checked += 1
        return sel


def phase_bucket16(headline, post, tag="phase 1"):
    """Phase 1 (and 7b), last part: the kernel's L <= 16 bucket (int8
    selections; emitted pairs or candidates in local memory), which no
    golden reaches, at L = 12 on one read: blocks at position 0, spread over
    the read and at its end held bit-equal to the plain version."""
    dec = LVADecoder(dataclasses.replace(headline, list_size=12),
                     device="cuda")
    T = post.shape[0]
    blocks = {0, 1, T // 4, T // 2, 3 * T // 4, T - 1}
    check = CheckedACS(timed=-1, check=blocks.__contains__,
                       lse=dec.spec.combine_lse)
    _, _, valid = dec.decode(post[None], acs=check)
    if check.checked != len(blocks) or not valid[0, 0]:
        fail(f"L = 12: {check.checked} of {len(blocks)} blocks checked, "
             f"top entry valid: {bool(valid[0, 0])}")
    log(f"{tag}: L = 12: blocks {sorted(blocks)} of {T} bit-equal"
        f"{'' if check.lse else ', rows sorted'}; {int(valid.sum())} valid "
        f"entries")


def phase_batch(enc, exp, device, path_combine="max", every=1,
                tag="phase 1b"):
    """Phase 1b (and 7c): the kernel against its plain version at the main
    path's shapes. The reads are phase 3's first batch (same seed and
    channel) through ``PipelineDecoder.decode_posts``, which splits them by
    orientation, so each launch holds several reads of different lengths,
    each with its own beam start, some of them past their end. Every
    ``every``-th block of both decodes is checked, and the first that
    mixes active and inactive reads. Returns (B, kernel ms, plain ms) of
    the timed block, its (start1, active), what its step must do
    (``CheckedACS.needed``), and the max |score error|."""
    posts, rcs, _ = simulate_posts(enc.oligos, 8,
                                   np.random.default_rng(SEED))
    for flag in (False, True):
        log(f"{tag}: rc={flag}: nblk "
            f"{[len(p) for p, r in zip(posts, rcs) if r == flag]}")
    check = CheckedACS(timed=min(map(len, posts)) // 2,
                       check=lambda t: t % every == 0,
                       lse=path_combine == LSE)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = PipelineDecoder(exp, 8, 20, path_combine=path_combine,
                          device=device).decode_posts(
        posts, rcs, enc.num_oligos_data + enc.num_oligos_rs, acs=check)
    log(f"{tag}: {check.checked} of {check.blocks} blocks bit-equal"
        f"{'' if check.lse else ', rows sorted'}, {check.mixed} of them "
        f"with active and inactive reads ({time.perf_counter() - t0:.1f} s, "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        f"GiB); {int((out.index >= 0).sum())} of {len(posts)} reads pass "
        f"CRC; block {check.timed} at B={check.timed_B}: kernel "
        f"{check.ms:.4f} ms/block, plain {check.plain_ms:.4f} ms/block")
    if check.mixed == 0:
        fail("no checked block mixed active and inactive reads")
    return (check.timed_B, check.ms, check.plain_ms), check.timed_args, \
        check.needed, check.err


def acs_bound(dec, start1, active, nbytes: int) -> dict:
    """The bound of one ACS block step whose reads have window starts
    ``start1`` and flags ``active``: the ``nbytes`` it must move on its
    inputs (``acs_needed_bytes``) over the memory rate, against its
    operations over the FP32 lane peak, counted over the valid states and
    real merge rows of each active read as the K-way merge needs them
    (``acs_needed_ops``). Beside it, for reference, two counts that do not
    depend on the data: every slot of the W + 1 previous rows read and the
    W rows written (``bytes_every_slot``), and the operations of a flat
    scan over every candidate (``acs_executed_ops``)."""
    spec, tabs = dec.spec, dec.tabs
    L, C, W = spec.list_size, spec.code.nstate_conv, spec.window
    rows = (1 + (tabs["qmap"][:, 1:] >= 0).sum(1)).tolist()
    windows = [tabs["valid"][s:s + W] != 0
               for s, a in zip(start1, active) if a]
    needed = sum(merge_roofline.acs_needed_ops(spec, rows, v)
                 for v in windows)
    flat = sum(merge_roofline.acs_executed_ops(spec, rows, v)
               for v in windows)
    cells = 8 * L * C
    every = sum(active) * (2 * W + 1) * cells * 12 + len(start1) * W * cells
    peak, _ = merge_roofline.lane_peak()
    bound_ms, bound_by = bound(nbytes, needed, peak)
    return {"bytes": nbytes, "bytes_ms": 1e3 * nbytes / HBM_BYTES_PER_S,
            "needed_ops": needed, "needed_ops_ms": 1e3 * needed / peak,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes_every_slot": every,
            "bytes_every_slot_ms": 1e3 * every / HBM_BYTES_PER_S,
            "flat_ops": flat, "flat_ops_ms": 1e3 * flat / peak}


def lse_bound(dec, start1, active, needed) -> dict:
    """The bound of one logsumexp ACS block step whose reads have window
    starts ``start1`` and flags ``active``: the largest of the bytes a flat
    merge must move (every slot of the W + 1 previous rows read, the W rows
    written and the selections: ``bytes_every_slot``) over the memory rate,
    its operations (``acs_lse_needed``: the scans and class passes over
    every candidate, as this step's data needs them) over the FP32 lane
    peak, and its exp and log calls over the special function units' peak.
    ``needed``: (operations, exp calls, log calls) of the step."""
    spec = dec.spec
    L, C, W = spec.list_size, spec.code.nstate_conv, spec.window
    cells = 8 * L * C
    nbytes = sum(active) * (2 * W + 1) * cells * 12 + len(start1) * W * cells
    ops, nexp, nlog = needed
    peak, _ = merge_roofline.lane_peak()
    sfu = peak * SFU_PER_SM / merge_roofline.FP32_LANES_PER_SM
    times = {"bytes": 1e3 * nbytes / HBM_BYTES_PER_S,
             "operations": 1e3 * ops / peak,
             "sfu": 1e3 * (nexp + nlog) / sfu}
    by = max(times, key=times.get)
    return {"bytes": nbytes, "bytes_ms": times["bytes"], "ops": ops,
            "ops_ms": times["operations"], "exp_calls": nexp,
            "log_calls": nlog, "sfu_per_s": sfu, "sfu_ms": times["sfu"],
            "bound_ms": times[by],
            # the kernels line's unit: the SFU calls are operations
            "bound_by": "bytes" if by == "bytes" else "operations",
            "bound_term": by}


def acs_resources() -> dict:
    """The ACS kernel's L = 8 build on the card: registers, local bytes
    (stack frame and spills) and resident threads per SM. Fails if it uses
    local memory."""
    info = lva_acs.kernel_info(8)
    if info["local_bytes"]:
        fail(f"the ACS kernel at L = 8 uses local memory: {info}")
    return info


def phase_goldens(device):
    """Phase 2: the reference binary's golden lists of every set in
    ``GOLDEN_SETS`` through the K-way kernel, with sync markers where a case
    has them, each list bit-identical. Returns the number of cases."""
    n = 0
    for name in GOLDEN_SETS:
        root = GOLDEN / name
        torch.cuda.reset_peak_memory_stats()
        for case in json.loads((root / "manifest.json").read_text()):
            cfg = DecodeConfig(
                code=ConvCodeConfig(
                    mem=case["mem"], rate=case["rate"],
                    msg_len=case["msg_len"], rc=case["rc"],
                    sync_marker=case.get("sync_marker", ""),
                    sync_period=case.get("sync_period", 0)),
                list_size=case["list_size"],
                max_deviation=case["max_deviation"])
            post = np.fromfile(root / f"{case['name']}.post",
                               dtype="<f4").reshape(-1, 5, 8)
            t0 = time.perf_counter()
            msgs, _, valid = LVADecoder(cfg, device=device).decode(
                post[None])
            got = ["".join(map(str, m))
                   for m, v in zip(msgs[0], valid[0]) if v]
            want = (root / f"{case['name']}.lists").read_text().split()
            log(f"phase 2: {name}/{case['name']}: T={post.shape[0]} "
                f"{'identical' if got == want else 'DIFFERENT'} "
                f"({time.perf_counter() - t0:.3f} s)")
            if got != want:
                fail(f"golden {name}/{case['name']} differs from the "
                     f"reference lists")
            n += 1
        log(f"phase 2: {name}: peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return n


def phase_sim_decode(data: bytes, args):
    """Phase 3: the port's ``sim-decode`` CLI in-process on ``data``.
    Returns (its JSON record, SimStats, kernel launches, seconds)."""
    with tempfile.TemporaryDirectory() as tmp:
        f = pathlib.Path(tmp) / "data.bin"
        f.write_bytes(data)
        argv = ["sim-decode", "-i", str(f), *args]
        log("phase 3: cli " + " ".join(args))
        torch.cuda.synchronize()
        lva_acs.LAUNCHES = 0
        t0 = time.perf_counter()
        rec, stats = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = lva_acs.LAUNCHES
    log(f"phase 3: {wall:.3f} s for {stats.num_reads} reads = "
        f"{wall / stats.num_reads:.4f} s/read; {launches} kernel launches "
        f"for {stats.steps} forward block steps")
    if not (rec["recovered"] and rec["byte_exact"]):
        fail(f"sim-decode did not recover the file: {rec}")
    return rec, stats, launches, wall


def build_kernels() -> None:
    """Phase 0: every library of ``LIBS``, one nvcc per source, started
    together; logs each build's time and its ptxas resource lines."""
    def one(name):
        t0 = time.perf_counter()
        return _build.build(name, LIBS[name]), time.perf_counter() - t0

    with ThreadPoolExecutor(len(LIBS)) as ex:
        built = list(ex.map(one, LIBS))
    for path, sec in built:
        log(f"phase 0: built {path.name} in {sec:.2f} s")
        for line in path.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"  ptxas: {line.strip()}")
    _build.load_lva_acs()
    _build.load_lva_lse()
    _build.load_probes()
    _build.load_expand()
    _build.load_mxu_expand()
    _build.load_lowering()


def bound(nbytes: float, ops: float, ops_per_s: float):
    """(bound_ms, bound_by): the least time the card could take for work
    that moves ``nbytes`` (each input read once, each output written once)
    and does ``ops`` operations at a peak of ``ops_per_s``."""
    by_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    by_ops = 1e3 * ops / ops_per_s
    return (by_bytes, "bytes") if by_bytes >= by_ops else \
        (by_ops, "operations")


def same_bits(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Fails unless ``got`` and ``want`` are bit-equal; returns the max
    |difference| over finite values (0.0 when they are)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{name}: {got.dtype}{tuple(got.shape)} against "
             f"{want.dtype}{tuple(want.shape)}")
    if got.dtype == torch.float32:
        fin = torch.isfinite(want) & torch.isfinite(got)
        err = float((got[fin] - want[fin]).abs().max()) \
            if bool(fin.any()) else 0.0
        got, want = got.view(torch.int32), want.view(torch.int32)
    else:
        err = float((got - want).abs().max())
    if not torch.equal(got, want):
        fail(f"{name}: kernel and plain version differ (max |error| {err})")
    return err


def probe_inputs(rng, shape, scores="normal", hashes="random"):
    """Scores f32 and two int32 hash arrays of ``shape`` on the card."""
    if scores == "normal":
        x = rng.normal(size=shape).astype(np.float32)
    else:  # integer scores in {0, 1, 2}, some columns all -inf: ties
        x = rng.integers(0, 3, shape).astype(np.float32)
        x[:, 0, :4] = -np.inf
    if hashes == "random":
        h = [rng.integers(0, 1 << 30, shape, dtype=np.int64).astype(np.int32)
             for _ in range(2)]
    else:  # a permutation, so every payload is unique
        h = [rng.permutation(x.size).astype(np.int32).reshape(shape)] * 2
    return [torch.from_numpy(a).cuda() for a in (x, *h)]


def phase_probes(dec, acs_ms: float, acs_start1: int):
    """Phase 4: the merge-family probes. Each kernel against its plain
    version on the card, bit for bit, and both timed; then the probes'
    entry points as a user runs them, with the launch counts set to 0 just
    before and read just after. ``acs_ms`` is phase 1's ACS block step at
    B=1 through decoder ``dec``, its window starting at padded row
    ``acs_start1``: K1's rate in the probes' unit, in the ops the K-way
    merge needs. Returns the kernels' JSON entries and the roofline."""
    nc, f, ct = merge_roofline.NC, merge_roofline.F, merge_roofline.CT
    G, R = 256, 8
    rng = np.random.default_rng(SEED)
    x, h1, h2 = probe_inputs(rng, (nc, f, ct))
    found = {}
    for kind in ("merge", "stream"):
        kern = getattr(merge_roofline, kind)
        ref = getattr(merge_roofline, f"{kind}_ref")

        def plain(a, b, c):
            return ref(*(t.expand(G, *t.shape) for t in (a, b, c)), R)

        err = 0.0
        for b, c, what in ((h1, h1, "h1 = h2"), (h1, h2, "h1 != h2")):
            got = kern(x, b, c, R, G)
            err = max(err, same_bits(f"{kind} ({what})", got, plain(x, b, c)))
            same_bits(f"{kind} copies ({what})", got, got[:1].expand_as(got))
        ms = cuda_ms(lambda: kern(x, h1, h2, R, G), reps=20, warmup=2)
        plain_ms = cuda_ms(lambda: plain(x, h1, h2), reps=3)
        log(f"phase 4: {kind} [{nc},{f},{ct}] x {G} copies, {R} rounds: "
            f"bit-equal, all copies equal; kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms")
        found[kind] = (err, ms, plain_ms)

    err = 0.0
    shape = (nc, f, treepop.CT)
    for variant in treepop.VARIANTS:
        for scores in ("normal", "ties"):
            a, h, _ = probe_inputs(rng, shape, scores, "perm")
            for got, want in zip(treepop.treepop(a, h, variant),
                                 treepop.treepop_ref(a, h, variant)):
                err = max(err, same_bits(f"treepop {variant} {scores}", got,
                                         want))
    for c in (128, 512):
        a, h, _ = probe_inputs(rng, (nc, f, c), hashes="perm")
        for guard_holds in (True, False):
            if not guard_holds:
                a[0, 0, 0] = 2e9
            for got, want in zip(
                    treepop.treepop(a, h, "reshape_pair", guarded=True),
                    treepop.treepop_ref(a, h, "reshape_pair", guarded=True)):
                err = max(err, same_bits(f"treepop when ct={c}", got, want))
    a, h, _ = probe_inputs(rng, shape, hashes="perm")
    ms = cuda_ms(lambda: treepop.treepop(a, h, "reshape_pair"), reps=50,
                 warmup=3)
    plain_ms = cuda_ms(lambda: treepop.treepop_ref(a, h, "reshape_pair"),
                       reps=10)
    log(f"phase 4: treepop {len(treepop.VARIANTS)} variants x 2 score "
        f"kinds, guarded ct 128 and 512 bit-equal; reshape_pair at "
        f"{list(shape)}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    found["treepop"] = (err, ms, plain_ms)

    torch.cuda.synchronize()
    for k in merge_roofline.LAUNCHES:
        merge_roofline.LAUNCHES[k] = 0
    treepop.LAUNCHES = 0
    roof = merge_roofline.main(["--rounds", str(R), "--grid", str(G)])
    ok = treepop.main([*treepop.VARIANTS, "--when", "128", "--when", "512"])
    torch.cuda.synchronize()
    launches = {**merge_roofline.LAUNCHES, "treepop": treepop.LAUNCHES}
    log(f"phase 4: probe entry points launched {launches}")
    if not ok:
        fail("a tree-pop variant disagrees with numpy's first argmax")
    if not all(launches.values()):
        fail(f"a probe kernel was not launched by its entry point: "
             f"{launches}")

    peak, formula = merge_roofline.lane_peak()
    spec, tabs = dec.spec, dec.tabs
    # K1's work three ways: bench.py's count with flop rows padded to 8,
    # what a flat scan executes over valid states and real merge rows, and
    # what the K-way merge needs; only the last is a rate of this kernel
    valid = tabs["valid"][acs_start1:acs_start1 + spec.window] != 0
    rows = (1 + (tabs["qmap"][:, 1:] >= 0).sum(1)).tolist()
    needed = merge_roofline.acs_needed_ops(spec, rows, valid)
    need_rate = needed / (acs_ms / 1e3)
    rate = {k: roof[k]["ops_per_s_T"] * 1e12 for k in ("merge", "stream")}
    roofline = {
        "lane_peak_ops_per_s": peak,
        "lane_peak_formula": formula,
        "merge_ops_per_s": rate["merge"],
        "merge_share_of_lane_peak": rate["merge"] / peak,
        "stream_ops_per_s": rate["stream"],
        "stream_share_of_lane_peak": rate["stream"] / peak,
        "acs_ms_per_block_step": acs_ms,
        "acs_valid_share_of_window": float(valid.float().mean()),
        "acs_merge_rows_per_crf_state": rows,
        "acs_work_ops_per_block_step": merge_roofline.acs_work_ops(spec, 1),
        "acs_flat_ops_per_block_step": merge_roofline.acs_executed_ops(
            spec, rows, valid),
        "acs_needed_ops_per_block_step": needed,
        "acs_needed_ops_per_s": need_rate,
        "acs_needed_share_of_lane_peak": need_rate / peak,
    }
    replaces = {"merge": "scripts/tpu_vpu_roofline.py:48",
                "stream": "scripts/tpu_vpu_roofline.py:68",
                "treepop": "scripts/tpu_treepop_probe.py:19"}
    # merge and stream: 12 element-ops per element and round over the G
    # copies, reading scores and two hashes once and writing G slots;
    # tree-pop: 63 pair steps (a compare, two selects) per column, reading
    # [NC, F, CT] scores and payloads and writing one of each per column
    cols = f * ct
    work = {k: (G * R * merge_roofline.MERGE_SWEEPS * nc * cols,
                3 * 4 * nc * cols + 4 * G * cols)
            for k in ("merge", "stream")}
    tcols = shape[1] * shape[2]
    work["treepop"] = ((shape[0] - 1) * 3 * tcols,
                       8 * shape[0] * tcols + 8 * tcols)
    entries = []
    for k, (err, ms, plain_ms) in found.items():
        ops, nbytes = work[k]
        bound_ms, bound_by = bound(nbytes, ops, peak)
        entries.append({
            "name": f"probe_{k}", "route": "cuda", "source": PROBE_SOURCE,
            "replaces": replaces[k], "launches": launches[k],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            # no one PyTorch call computes a merge with dual-hash knockout,
            # the stream's op chain or a max with the winner's payload
            "library_ms": None})
    return entries, roofline


def graph_ms(fn) -> float:
    """Device ms of one ``fn()``, replayed from a CUDA graph (launch-bound
    shapes: the host's launch cost drops out)."""
    return expand.graph_us(fn) / 1e3


def time_lane_map(case_name: str, form: str):
    """(kernel, plain, library) ms of one script case at its shape, all
    three from CUDA graphs, its (bound_ms, bound_by) (the function reads
    its source columns once and writes its output once), and the script's
    kernel it replaces."""
    case = next(c for c in expand.CASES if c.name == case_name)
    _, xt = case.inputs("cuda")
    kernel, plain = case.bind(xt, form)
    if case.map_ == "transpose":
        def library():
            return xt.t().contiguous()
        nbytes = 2 * 4 * xt.numel()
    else:  # the element map: repeat_interleave of the first C / k columns
        n = xt.shape[1] // case.k

        def library():
            return torch.repeat_interleave(xt[:, :n], case.k, dim=1,
                                           output_size=xt.shape[1])
        nbytes = 4 * (xt.shape[0] * n + xt.numel())
    same_bits(f"{case_name} library call", library(), plain())
    return (*(graph_ms(f) for f in (kernel, plain, library)),
            *bound(nbytes, 0, 1.0), case.replaces)


def onehot_library(xt, et, mode: str, G: int):
    """One PyTorch call computing ``mode``'s product over G copies: the
    TF32 matmul, the bf16 matmul (bf16 out) or, for u8x4, the full-f32
    matmul, exact on a one-hot E."""
    if mode == "tf32":
        def call():
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                return torch.matmul(xt.expand(G, *xt.shape), et)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
        return call
    if mode == "bf16":
        xb, eb = xt.bfloat16(), et.bfloat16()
        return lambda: torch.matmul(xb.expand(G, *xb.shape), eb)
    xf, ef = xt.view(torch.float32), et.float()
    return lambda: torch.matmul(xf.expand(G, *xf.shape), ef)


def phase_expand():
    """Phase 5: the expansion-family probes. Every lane-map form, the
    transpose and every one-hot product mode against its plain version on
    the card, bit for bit, at the scripts' shapes, with all copies equal;
    the tf32 mismatches counted; each kernel, plain version and library
    call timed; then both entry points, with the launch counts set to 0
    before and read after. Returns the kernels' JSON entries."""
    err = {f: 0.0 for f in (*expand.FORMS, "transpose")}
    for case in expand.CASES:
        _, xt = case.inputs("cuda")
        for form in case.forms:
            kernel, plain = case.bind(xt, form)
            got = kernel(4)
            err[form] = max(err[form], same_bits(
                f"{case.name} [{form}]", got, plain().expand_as(got)))
    log(f"phase 5: {len(expand.CASES)} lane-map and transpose cases, every "
        f"form bit-equal to its plain version, 4 copies each, all equal")

    mx = mxu_expand
    h, x5, E5 = mx.p5_inputs()
    x7, E7 = mx.p7_inputs()
    checks = [*(("P5 halves", x5, E5, m, 256) for m in ("u8x4", "tf32")),
              ("P5 hashes", h, E5, "u8x4", 256),
              *((f"P6 {label.strip()}", *mx.p6_inputs(r, k, n), m, 256)
                for r, k, n, m, label in mx.P6_POINTS),
              *(("P7 payloads", x7, E7, m, 512) for m in ("u8x4", "tf32"))]
    for label, x, E, mode, G in checks:
        xt, et = mx.mode_inputs(x, E, mode, "cuda")
        got = mx.onehot_mma(xt, et, mode, G)
        want = mx.onehot_mma_ref(xt, et, mode)
        err[mode] = max(err.get(mode, 0.0), same_bits(
            f"onehot {mode} {label}", got, want.expand_as(got)))
        K, N = E.shape
        wrong = mx._wrong(got[:1], x[:, (np.arange(N) * K) // N])
        log(f"phase 5: onehot {mode} {label} [{x.shape[0]},{K}]@[{K},{N}] "
            f"x{G}: bit-equal to its plain version, all copies equal; "
            f"{wrong} of {x.shape[0] * N} elements differ from the exact "
            f"selection")
        if mode == "u8x4" and wrong:
            fail(f"u8x4 is not bit-exact on {label}")
        del got, want
    torch.cuda.empty_cache()

    timed = {}
    for form, name in (("gather", "p3.jnp_repeat.k4"),
                       ("shfl", "p3.jnp_repeat.k4"),
                       ("butterfly", "p4.butterfly.k4"),
                       ("transpose", "p2.transpose")):
        timed[form] = time_lane_map(name, form)
        ms, plain_ms, lib_ms, bms = timed[form][:4]
        log(f"phase 5: {form} at {name}: kernel {ms:.6f} ms, plain "
            f"{plain_ms:.6f} ms, library {lib_ms:.6f} ms, bound {bms:.6f} "
            f"ms (CUDA graphs of {expand.GRAPH_CALLS} calls)")
    big = 4096  # copies: the device rate of each form, past launch latency
    for form in expand.FORMS:
        case = next(c for c in expand.CASES if c.name == (
            "p4.butterfly.k4" if form == "butterfly" else "p3.jnp_repeat.k4"))
        _, xt = case.inputs("cuda")
        kernel, _ = case.bind(xt, form)
        ms = cuda_ms(lambda: kernel(big), reps=5, warmup=1)
        log(f"phase 5: {form} [8,2048] k=4 x {big} copies: {ms:.4f} ms, "
            f"{big * xt.numel() / (ms / 1e3) / 1e9:.3f} G elements/s "
            f"written ({big * xt.numel() * 4 / (ms / 1e3) / 1e9:.1f} GB/s)")
    torch.cuda.empty_cache()

    G = 256
    for mode, (x, E) in (("tf32", (x5, E5)), ("bf16", mx.p6_inputs(256, 128,
                                                                   512)),
                         ("u8x4", (x5, E5))):
        xt, et = mx.mode_inputs(x, E, mode, "cuda")
        (M, K), N = xt.shape, et.shape[1]
        ms = cuda_ms(lambda: mx.onehot_mma(xt, et, mode, G), reps=10,
                     warmup=2)
        plain_ms = cuda_ms(lambda: mx.onehot_mma_ref(
            xt.expand(G, M, K), et, mode), reps=3)
        lib_ms = cuda_ms(onehot_library(xt, et, mode, G), reps=10, warmup=2)
        nbytes = 4 * xt.numel() + et.numel() * et.element_size() \
            + 4 * G * M * N
        ops = 2 * G * M * K * N * (4 if mode == "u8x4" else 1)
        timed[mode] = (ms, plain_ms, lib_ms,
                       *bound(nbytes, ops, TC_OPS_PER_S[mode]),
                       REPLACES_MXU[mode])
        log(f"phase 5: onehot {mode} [{M},{K}]@[{K},{N}] x{G}: kernel "
            f"{ms:.4f} ms ({G * M * K * N / (ms / 1e3) / 1e12:.3f} T MAC/s), "
            f"plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound "
            f"{timed[mode][3]:.4f} ms by {timed[mode][4]}")
        torch.cuda.empty_cache()

    torch.cuda.synchronize()
    for counts in (expand.LAUNCHES, mx.LAUNCHES):
        for k in counts:
            counts[k] = 0
    ok = expand.main([])
    ok = mx.main([]) and ok
    torch.cuda.synchronize()
    launches = {**expand.LAUNCHES, **mx.LAUNCHES}
    log(f"phase 5: probe entry points launched {launches}")
    if not ok:
        fail("an expansion probe disagrees with the result its script "
             "checks against")
    if not all(launches.values()):
        fail(f"an expansion kernel was not launched by its entry point: "
             f"{launches}")

    entries = []
    for k, (ms, plain_ms, lib_ms, bound_ms, bound_by, replaces) in \
            timed.items():
        mxu = k in mx.MODES
        entries.append({
            "name": f"mxu_onehot_{k}" if mxu else
            "expand_transpose" if k == "transpose" else
            f"expand_lane_map_{k}",
            "route": "cuda",
            "source": f"{CSRC}/{'mxu_expand' if mxu else 'expand'}.cu",
            "replaces": replaces, "launches": launches[k],
            "max_abs_err": err[k], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms})
    return entries


def lowering_key(case, form: str) -> str:
    """The kernels-line key of ``case``'s ``form``: repeat by lane-map form,
    fori by placement (both shapes), the rest by probe."""
    probe = case.name.split(".")[0]
    return probe if form == probe else f"{probe}_{form}"


def lowering_work(case, ts):
    """(ops, bytes) of one call of ``case`` at its shape: each input read
    once and each output written once; fori's operations are what the
    function needs, ``lowering.fori_ops`` per column and round, then the
    pointers' sum."""
    probe = case.name.split(".")[0]
    if probe == "repeat":
        x = ts[0]
        return 0, 4 * (x.numel() // lowering.REPEAT_K + x.numel())
    if probe == "dynrow":
        return 0, 8 * ts[1].shape[1] + 4
    if probe == "int16":
        return 0, 6 * ts[0].numel()
    if probe == "fori":
        (nq, C), rounds = ts[0].shape, dict(lowering.FORI_POINTS)[
            ts[0].shape[0]]
        return C * (rounds * lowering.fori_ops(nq) + nq + 1), \
            8 * nq * C + 4 * C
    if probe == "reshape":
        return 0, 8 * ts[0].numel()
    # alias: the window's rows of stale and x read, of stale written
    row = ts[2][0].numel()
    return 0, 3 * 4 * lowering.ALIAS_WINDOW * row + 4


def lowering_library(case, ts):
    """One PyTorch call computing ``case``'s function, or None where it
    takes several (int16: a product, an add and a cast; fori: a loop of
    reductions; alias: an add, an add and a masked write)."""
    probe = case.name.split(".")[0]
    if probe == "repeat":
        x = ts[0]
        n = x.shape[1] // lowering.REPEAT_K
        return lambda: torch.repeat_interleave(
            x[:, :n], lowering.REPEAT_K, dim=1, output_size=x.shape[1])
    if probe == "dynrow":
        return lambda: torch.index_select(ts[1], 0, ts[0])
    if probe == "reshape":
        x = ts[0]
        return lambda: x.view(-1, x.shape[-1]).clone()
    return None


def phase_lowering(peak: float):
    """Phase 6: the lowering probes. Every P1 kernel against its plain
    version and the numpy result on the card, bit for bit, at the script's
    shapes, fori also at the ACS kernel's merge shape and over 256 copies,
    in both placements, one thread per item and at 128 threads per SM;
    alias's aliasing, its rows outside a random window and the edges of
    alias and dynrow; each kernel, plain version and library call timed;
    P7's plain version and library call at its shape; then the entry point,
    with the launch counts set to 0 before and read after, and its fori
    rates. ``peak`` is the FP32 lane peak. Returns the kernels' JSON entries
    and the rates and times for the ``lowering`` line."""
    lo = lowering
    G = lo.FORI_COPIES
    err = {}
    for case in lo.CASES:
        arrays, ts = case.inputs("cuda")
        want = torch.from_numpy(np.ascontiguousarray(case.want(*arrays)))
        for form in case.forms:
            kernel, plain = case.bind(ts, form)
            got = kernel()
            key = lowering_key(case, form)
            err[key] = max(err.get(key, 0.0), same_bits(
                f"{case.name} [{form}]", got, plain()))
            same_bits(f"{case.name} [{form}] against numpy", got.cpu(), want)
            if form in lo.PLACEMENTS:
                rounds = dict(lo.FORI_POINTS)[ts[0].shape[0]]
                for per_sm in (0, 128):
                    many = lo.fori(*ts, rounds, form, G, per_sm)
                    same_bits(f"{case.name} [{form}] x {G} copies at "
                              f"{per_sm or 'all'} threads/SM", many,
                              plain().expand_as(many))
    log(f"phase 6: {len(lo.CASES)} lowering cases, every kernel bit-equal "
        f"to its plain version and to numpy; fori over {G} copies too, at "
        f"one thread per item and at 128 threads/SM")

    rng = np.random.default_rng(SEED)
    P, C, W = 16, 256, lo.ALIAS_WINDOW
    x = torch.from_numpy(rng.standard_normal((P, 8, C)).astype(
        np.float32)).cuda()
    for start in (3, P - W, P - 2, -2, 100, -100):
        # stale lies between two NaN rows that nothing may touch
        guard = torch.full((P + 2, 8, C), float("nan"), device="cuda")
        guard[1:P + 1] = torch.from_numpy(rng.standard_normal(
            (P, 8, C)).astype(np.float32)).cuda()
        before = guard.clone()
        stale = guard[1:P + 1]
        s = torch.tensor([start], dtype=torch.int32, device="cuda")
        got = lo.alias(stale, x, s, W)
        if got.data_ptr() != stale.data_ptr():
            fail("alias did not update its own buffer")
        same_bits(f"alias at s={start}", got,
                  lo.alias_ref(before[1:P + 1].clone(), x, s, W))
        outside = [p for p in range(P) if not 0 <= p - start < W]
        same_bits(f"alias rows outside the window at s={start}",
                  got[outside], before[1:P + 1][outside])
        same_bits(f"alias guard rows at s={start}", guard[[0, P + 1]],
                  before[[0, P + 1]])
    rows, cols = 136, 1024
    guard = torch.full((rows + 2, cols), float("nan"), device="cuda")
    guard[1:rows + 1] = torch.from_numpy(rng.standard_normal(
        (rows, cols)).astype(np.float32)).cuda()
    xr = guard[1:rows + 1]
    for index in (0, rows - 1, rows, 1000, 2**31 - 1, -1, -2**31):
        i = torch.tensor([index], dtype=torch.int32, device="cuda")
        same_bits(f"dynrow at {index}", lo.dynrow(xr, i),
                  xr[min(max(index, 0), rows - 1)][None])
    log("phase 6: alias updates its own buffer, keeps every row outside a "
        "random window, skips window rows outside [0, P); dynrow clamps its "
        "index; neither touches the NaN rows around its buffer")

    timed = {}
    for case in lo.CASES:
        if case.name == "fori.k1":
            continue
        _, ts = case.inputs("cuda")
        ops, nbytes = lowering_work(case, ts)
        library = lowering_library(case, ts)
        for form in case.forms:
            kernel, plain = case.bind(ts, form)
            lib_ms = None
            if library is not None:
                same_bits(f"{case.name} library call", library(), plain())
                lib_ms = graph_ms(library)
            key = lowering_key(case, form)
            timed[key] = (graph_ms(kernel), graph_ms(plain), lib_ms,
                          *bound(nbytes, ops, peak), case.replaces)
            ms, plain_ms, _, bms, by, _ = timed[key]
            log(f"phase 6: {key} at {[list(t.shape) for t in ts]}: kernel "
                f"{ms:.6f} ms, plain {plain_ms:.6f} ms, library "
                f"{'none' if lib_ms is None else f'{lib_ms:.6f} ms'}, bound "
                f"{bms:.3e} ms by {by} (CUDA graphs of "
                f"{expand.GRAPH_CALLS} calls)")

    mx = mxu_expand
    x7, E7 = mx.p7_inputs()
    p7 = {}
    for mode in ("u8x4", "tf32"):
        G7 = 512
        xt, et = mx.mode_inputs(x7, E7, mode, "cuda")
        (M, K), N = xt.shape, et.shape[1]
        p7[mode] = {
            "ms": cuda_ms(lambda: mx.onehot_mma(xt, et, mode, G7), reps=10,
                          warmup=2),
            # the float64 product warmed up, then the mean of 10 calls
            "plain_ms": cuda_ms(lambda: mx.onehot_mma_ref(
                xt.expand(G7, M, K), et, mode), reps=10, warmup=3),
            "library_ms": cuda_ms(onehot_library(xt, et, mode, G7),
                                  reps=10, warmup=2)}
        log(f"phase 6: P7 onehot {mode} [{M},{K}]@[{K},{N}] x{G7}: kernel "
            f"{p7[mode]['ms']:.4f} ms, plain {p7[mode]['plain_ms']:.4f} ms, "
            f"library {p7[mode]['library_ms']:.4f} ms")
        torch.cuda.empty_cache()

    torch.cuda.synchronize()
    for counts in (lo.LAUNCHES, expand.LAUNCHES):
        for k in counts:
            counts[k] = 0
    ok, rates = lo.main([])
    torch.cuda.synchronize()
    launches = {**lo.LAUNCHES,
                **{f"repeat_{f}": expand.LAUNCHES[f] for f in
                   lo.CASES[0].forms}}
    log(f"phase 6: the entry point launched {launches}")
    if not ok:
        fail("a lowering probe disagrees with the result its script checks "
             "against, or a fori rate run with its plain version")
    if not all(launches.values()):
        fail(f"a lowering kernel was not launched by its entry point: "
             f"{launches}")

    entries = [{
        "name": f"lowering_{k}", "route": "cuda",
        "source": f"{CSRC}/expand.cu" if k.startswith("repeat")
        else f"{CSRC}/lowering.cu",
        "replaces": replaces, "launches": launches[k],
        "max_abs_err": err[k], "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        # int16, fori and alias take several PyTorch calls each
        "library_ms": lib_ms}
        for k, (ms, plain_ms, lib_ms, bound_ms, bound_by, replaces)
        in timed.items()]
    return entries, {"fori_rates": rates, "p7": p7}


def phase_lse(enc, exp, data: bytes, headline, post, gpu: str):
    """Phase 7: logsumexp path combining through its flat-merge kernel
    (``acs_block_lse``) at the headline config. (a) The kernel against its
    plain version on one read at B=1, as phase 1 does for the K-way kernel
    but without the sorted-rows check (lse rows are unsorted by design);
    (b) the L <= 16 bucket at L = 12; (c) phase 3's first batch at the main
    path's shapes (B=4 by orientation), every ``LSE_CHECK_EVERY``-th block
    checked, one block timed and its bound counted; (d) the lse path end to
    end: phase 3's 32 reads in batches of 8 through ``PipelineDecoder(...,
    path_combine="logsumexp")``, ``majority_vote`` and ``recover_file``,
    with the launch counts set to 0 just before. Returns the kernels-line
    entry and the ``lva_acs_lse`` line."""
    cfg = dataclasses.replace(headline, path_combine=LSE)
    dec = LVADecoder(cfg, device="cuda")
    ms_b1, plain_b1, err, _ = phase_kernel(dec, post, tag="phase 7a")
    phase_bucket16(cfg, post, tag="phase 7b")
    (B, ms, plain_ms), (start1, active), needed, err_b = phase_batch(
        enc, exp, "cuda", LSE, every=LSE_CHECK_EVERY, tag="phase 7c")
    bnd = lse_bound(dec, start1, active, needed)
    log(f"lva_acs_lse bound at B={B}: {bnd['bytes']} bytes (every slot) "
        f"{bnd['bytes_ms']:.4f} ms, {bnd['ops']} ops {bnd['ops_ms']:.4f} ms, "
        f"{bnd['exp_calls']} exp + {bnd['log_calls']} log calls "
        f"{bnd['sfu_ms']:.4f} ms: {bnd['bound_ms']:.4f} ms by "
        f"{bnd['bound_term']}; the kernel reaches "
        f"{100 * bnd['bound_ms'] / ms:.1f}% of it")

    num_oligos = enc.num_oligos_data + enc.num_oligos_rs
    n_reads, batch = 32, 8
    rng = np.random.default_rng(SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lva_acs.LAUNCHES = lva_acs.LSE_LAUNCHES = 0
    t0 = time.perf_counter()
    pdec = PipelineDecoder(exp, 8, 20, path_combine=LSE, device="cuda")
    index, payload = [], []
    for _ in range(n_reads // batch):
        posts, rcs, _ = simulate_posts(enc.oligos, batch, rng)
        out = pdec.decode_posts(posts, rcs, num_oligos)
        index.append(out.index)
        payload.append(out.payload)
    ok, got = recover_file(majority_vote(np.concatenate(index),
                                         np.concatenate(payload)),
                           exp, len(data))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, kway = lva_acs.LSE_LAUNCHES, lva_acs.LAUNCHES
    crc = int((np.concatenate(index) >= 0).sum())
    log(f"phase 7d: logsumexp path: {wall:.3f} s for {n_reads} reads = "
        f"{wall / n_reads:.4f} s/read; {crc} pass CRC; {launches} lse kernel "
        f"launches and {kway} K-way launches for {pdec.steps} block steps; "
        f"peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not (ok and got == data):
        fail("the logsumexp path did not recover the file byte for byte")
    if launches == 0 or launches != pdec.steps or kway:
        fail(f"{launches} lse and {kway} K-way launches for {pdec.steps} "
             f"block steps")
    entry = {
        "name": "lva_acs_lse", "route": "cuda",
        "source": f"{CSRC}/lva_lse.cu",
        "replaces": "nanopore_dna_storage_tpu/ops/lva_pallas.py:929 "
                    "(logsumexp branch :614-646)",
        "launches": launches, "max_abs_err": max(err, err_b), "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bnd["bound_ms"],
        "bound_by": bnd["bound_by"],
        # no one PyTorch call computes a list-Viterbi block step
        "library_ms": None}
    line = {"gpu": gpu, "ms_B1": ms_b1, "plain_ms_B1": plain_b1,
            f"ms_B{B}": ms, f"plain_ms_B{B}": plain_ms,
            "L8": lva_acs.lse_kernel_info(8), f"bound_B{B}": bnd,
            "share_of_bound": bnd["bound_ms"] / ms,
            "s_per_read": wall / n_reads, "launches": launches,
            "steps": pdec.steps, "crc_pass": crc}
    return entry, line


def main() -> int:
    t_all = time.perf_counter()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = gpu_line()
    log(f"gpu: {gpu}; torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    build_kernels()
    resources = acs_resources()
    log(f"phase 0: ACS kernel at L = 8: {json.dumps(resources)}")
    # the lse kernel keeps its candidates in local memory by design
    log(f"phase 0: lse ACS kernel at L = 8: "
        f"{json.dumps(lva_acs.lse_kernel_info(8))}")
    log(f"phase 0: done in {time.perf_counter() - t0:.1f} s")

    data = np.random.default_rng(SEED).integers(
        0, 256, 100, dtype=np.uint8).tobytes()
    exp = experiment(7)
    enc = encode_bytes(data, exp)
    posts, rcs, _ = simulate_posts(enc.oligos, 1,
                                   np.random.default_rng(SEED + 1))
    headline = DecodeConfig(
        code=ConvCodeConfig(mem=exp.conv_mem, rate=exp.conv_rate,
                            msg_len=exp.msg_len(), rc=bool(rcs[0])),
        list_size=8, max_deviation=20)
    t0 = time.perf_counter()
    dec = LVADecoder(headline, device="cuda")
    acs_ms, _, err, acs_start1 = phase_kernel(dec, posts[0])
    phase_bucket16(headline, posts[0])
    log(f"phase 1: done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    (B, ms, plain_ms), (start1, active), nbytes, err_b = phase_batch(
        enc, exp, "cuda")
    log(f"phase 1b: done in {time.perf_counter() - t0:.1f} s")
    acs = acs_bound(dec, start1, active, nbytes)
    log(f"lva_acs bound at B={B}: {acs['needed_ops']} needed ops over the "
        f"lane peak, {nbytes} bytes needed ({acs['bytes_every_slot']} "
        f"with every slot): {acs['bound_ms']:.4f} ms, by {acs['bound_by']}")
    err = max(err, err_b)
    lva_line = {
        "gpu": gpu, "ms_B1": acs_ms, f"ms_B{B}": ms, "L8": resources,
        f"bound_B{B}": acs, "share_of_bound": acs["bound_ms"] / ms,
        "share_of_bytes_every_slot": acs["bytes_every_slot_ms"] / ms}

    t0 = time.perf_counter()
    n = phase_goldens("cuda")
    log(f"phase 2: {n} goldens identical in {time.perf_counter() - t0:.1f} s")

    torch.cuda.reset_peak_memory_stats()
    _, stats, launches, wall = phase_sim_decode(data, [
        "--experiment", "7", "--list-size", "8", "--num-reads", "32",
        "--batch", "8", "--seed", str(SEED), "--device", "cuda"])
    log(f"phase 3: peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; done in "
        f"{wall:.1f} s")
    if launches == 0 or launches != stats.steps:
        fail(f"{launches} kernel launches for {stats.steps} block steps")

    t0 = time.perf_counter()
    probes, roofline = phase_probes(dec, acs_ms, acs_start1)
    log(f"phase 4: done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    expansions = phase_expand()
    log(f"phase 5: done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    lowerings, lowering_rates = phase_lowering(
        roofline["lane_peak_ops_per_s"])
    log(f"phase 6: done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    lse_entry, lse_line = phase_lse(enc, exp, data, headline, posts[0], gpu)
    log(f"phase 7: done in {time.perf_counter() - t0:.1f} s")

    log(f"total {time.perf_counter() - t_all:.1f} s")
    log(f"lva_acs and lva_acs_lse times below: one block step at the main "
        f"path's B={B}")
    log(json.dumps({"lva_acs": lva_line}))
    log(json.dumps({"lva_acs_lse": lse_line}))
    log(json.dumps({"roofline": roofline}))
    log(json.dumps({"lowering": lowering_rates}))
    log(f"gpu: {gpu}")
    log(json.dumps({"kernels": [{
        "name": "lva_acs",
        "route": "cuda",
        "source": "nanopore_dna_storage_tpu_torch/csrc/lva_acs.cu",
        "replaces": "nanopore_dna_storage_tpu/ops/lva_pallas.py:929",
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": acs["bound_ms"],
        "bound_by": acs["bound_by"],
        # no one PyTorch call computes a list-Viterbi block step
        "library_ms": None,
    }, lse_entry, *probes, *expansions, *lowerings]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
